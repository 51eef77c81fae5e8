"""Base-21 k-mer encoding.

Reference semantics (``src/protein.rs:9-54``):
  * 21-letter alphabet ``C S T A G P D E Q N H R K M I L V W Y F *`` in that
    exact order; index 20 (``*``) is the catch-all for ANY byte not in the
    list (``amino_acid_to_bits`` falls back via ``unwrap_or(20)``) — the
    match is exact, so lowercase letters also map to 20.
  * k-mer code = Σ_{i<k} aa_index[i] · 21^(k−1−i), big-endian base-21
    (``create_five_mer``, src/protein.rs:29-37). 21^5 = 4,084,101 < 2^32;
    21^7 = 1,801,088,541 < 2^31 so int64 accumulation is comfortable for
    both supported k.
  * every overlapping window is taken: positions 0..len−k inclusive,
    i.e. len−k+1 k-mers per protein (``Protein::new``, src/protein.rs:113-122).
  * "random10" sampling mode: ⌊(len−k+1)/10⌋ windows — one tenth of the
    window count, exactly ⌊(len−4)/10⌋ for k=5 — sampled without replacement
    (``Protein::new_with_rand_fivemers``, src/protein.rs:83-94). The
    reference uses a nondeterministic RNG; we derive a per-protein
    deterministic stream from (seed, protein index) instead.

The port's own copy of the JAX package's ``kmers/encode.py``; the
device stencil encoder (:func:`encode_kmers_device`) takes torch tensors.
"""

from __future__ import annotations

import numpy as np

AMINO_ACIDS = "CSTAGPDEQNHRKMILVWYF*"
CATCH_ALL = 20  # '*' — any unrecognized byte (src/protein.rs:50-51)

# 256-entry LUT: exact byte match on the 21 uppercase letters, else 20.
_LUT = np.full(256, CATCH_ALL, dtype=np.uint8)
for _i, _c in enumerate(AMINO_ACIDS):
    _LUT[ord(_c)] = _i


def residues_to_indices(seq_buf: np.ndarray) -> np.ndarray:
    """uint8 residue bytes → uint8 alphabet indices in [0, 20]."""
    return _LUT[seq_buf]


def decode_kmer(code: int, k: int) -> str:
    """Inverse of the base-21 encoding (``five_mer_back_to_amino_acid``,
    src/protein.rs:38-48)."""
    out = []
    for i in range(k):
        p = 21 ** (k - 1 - i)
        out.append(AMINO_ACIDS[code // p])
        code %= p
    return "".join(out)


def _window_codes(idx: np.ndarray, k: int) -> np.ndarray:
    """All length-k window codes over a flat index buffer (int64 [R−k+1])."""
    r = idx.shape[0]
    if r < k:
        return np.zeros(0, dtype=np.int64)
    codes = np.zeros(r - k + 1, dtype=np.int64)
    for j in range(k):
        codes += idx[j : r - k + 1 + j].astype(np.int64) * (21 ** (k - 1 - j))
    return codes


def seqs_to_buffer(seqs) -> tuple[np.ndarray, np.ndarray]:
    """Sequence strings → (uint8 buffer, int64 offsets [n+1]).

    latin-1 keeps byte-for-byte parity with the pipeline's raw-byte
    ingest: any byte outside the 21-letter alphabet routes through the
    '*' catch-all exactly as in a FASTA record (src/protein.rs:49-54);
    characters above U+00FF have no byte form and raise.
    """
    buf = np.frombuffer("".join(seqs).encode("latin-1"), np.uint8)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    return buf, offsets


def encode_kmers(
    seq_buf: np.ndarray,
    offsets: np.ndarray,
    k: int,
    sampling: str = "all",
    seed: int = 0,
    engine: str = "auto",
) -> tuple[np.ndarray, np.ndarray]:
    """Encode every protein's k-mers from the concatenated residue buffer.

    Returns ``(codes, kmer_offsets)``: protein n's k-mer codes (in sequence
    order, duplicates retained — matching ``Protein::five_mers``) are
    ``codes[kmer_offsets[n]:kmer_offsets[n+1]]``.

    ``engine="auto"`` uses the native C++ rolling encoder when built
    (~20× the vectorized-numpy rate, parity-pinned in tests); "numpy"
    forces the pure-python path. Sampling modes always run in numpy.
    """
    if engine not in ("auto", "numpy"):
        raise ValueError(f"unknown encode engine {engine!r}")
    if sampling == "all" and engine == "auto":
        from uniprot_kmer_based_clustering_tpu_torch.io import native

        out = native.encode_kmers(seq_buf, offsets, k)
        if out is not None:
            return out

    idx = residues_to_indices(seq_buf)
    n = offsets.shape[0] - 1
    lengths = np.diff(offsets)

    # Codes over the whole concatenated buffer; windows that straddle a
    # protein boundary are cut away by per-protein valid ranges below.
    # Proteins shorter than k contribute zero windows (the reference's
    # `0..len-4` range underflows there, src/protein.rs:114 — we are
    # deliberately permissive for fragment-heavy datasets).
    all_codes = _window_codes(idx, k)

    counts = np.maximum(lengths - k + 1, 0).astype(np.int64)
    if sampling == "all":
        kmer_offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=kmer_offsets[1:])
        # Gather the valid window positions: for protein n they start at
        # offsets[n] and there are counts[n] of them.
        pos = np.repeat(offsets[:-1], counts) + _ranges(counts)
        return all_codes[pos], kmer_offsets

    if sampling == "random10":
        sample_counts = counts // 10  # ⌊(len−k+1)/10⌋ = ⌊(len−4)/10⌋ for k=5
        kmer_offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sample_counts, out=kmer_offsets[1:])
        out = np.empty(int(kmer_offsets[-1]), dtype=np.int64)
        root = np.random.SeedSequence(seed)
        for i, child in enumerate(root.spawn(n)):
            m = int(sample_counts[i])
            if m == 0:
                continue
            rng = np.random.Generator(np.random.PCG64(child))
            sel = rng.choice(int(counts[i]), size=m, replace=False)
            out[kmer_offsets[i] : kmer_offsets[i + 1]] = all_codes[
                offsets[i] + sel
            ]
        return out, kmer_offsets

    raise ValueError(f"unknown sampling mode {sampling!r}")


def _ranges(counts: np.ndarray) -> np.ndarray:
    """Concatenated [0..c) ranges for each count (vectorized)."""
    if counts.size == 0:  # empty table (n=0 FASTA) — no windows
        return np.zeros(0, dtype=np.int64)
    total = int(counts.sum())
    out = np.arange(total, dtype=np.int64)
    starts = np.repeat(np.cumsum(np.concatenate([[0], counts[:-1]])), counts)
    return out - starts


def encode_kmers_device(residue_idx, lengths, k: int):
    """Device k-mer encoding over a padded residue-index matrix.

    Args:
      residue_idx: int32 tensor ``[N, Lmax]`` of alphabet indices (pad
        value arbitrary), on the device the build runs on.
      lengths: int32 tensor ``[N]`` of true lengths.
      k: k-mer size.

    Returns (codes int32 ``[N, Lmax−k+1]``, valid bool mask of the real
    windows): the stencil sum over every window, padding windows masked
    rather than cut, as the JAX package's encoder returns them.
    """
    import torch

    if k > 7:
        # 21^8 > 2^31: the int32 stencil would wrap silently, and wrapped
        # codes still sort/dedup "successfully" into a corrupt index
        raise ValueError(f"k={k} overflows int32 k-mer codes (max 7)")
    n, lmax = residue_idx.shape
    if lmax < k:
        # every sequence shorter than k: zero real windows; pad to one
        # fully-masked window so the callers' empty-index paths get a
        # well-formed (all-invalid) window matrix
        residue_idx = torch.nn.functional.pad(residue_idx, (0, k - lmax))
        lmax = k
    w = lmax - k + 1
    codes = torch.zeros((n, w), dtype=torch.int32, device=residue_idx.device)
    for j in range(k):
        codes += residue_idx[:, j : j + w].to(torch.int32) * (21 ** (k - 1 - j))
    pos = torch.arange(w, dtype=torch.int32, device=residue_idx.device)
    valid = pos[None, :] < (lengths.to(torch.int32)[:, None] - (k - 1))
    return codes, valid
