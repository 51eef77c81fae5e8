"""Global k-mer document-frequency index and dense-rank hashing.

Reference pipeline (``src/main.rs:77-199``):
  1. per-protein sort+dedup of k-mer codes → *document* frequency counting
     into one global sorted list (the mutexed ``merge_sort`` insertion,
     src/main.rs:23-48,101-114 — the serialization bottleneck);
  2. split into unique (docfreq==1) and repeated codes (src/main.rs:126-137);
  3. build boomphf ``Mphf`` minimal perfect hash functions over both sets
     (γ=3.0, src/main.rs:139-140) and re-key every protein's k-mers into the
     dense repeated-hash space (src/protein.rs:151-174);
  4. recompute docfreq in hash space (src/main.rs:187-193).

The MPHF is an arbitrary bijection {repeated codes} → [0, R); every
downstream quantity (pairwise intersection sizes, docfreqs, edge counts)
is invariant under that bijection. We use the **dense rank in ascending
code order** — a deterministic minimal perfect hash by construction —
computed by the C++ radix builder or with numpy sort/unique.

The port's own copy of the JAX package's ``kmers/index.py``: the same
``KmerIndex`` fields and the same index, so checkpoints cross between the
packages. The device doc-freq build (:func:`doc_freq_dense_device`) takes
torch tensors; ``kmers/index_device.py`` builds on it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.utils.timing import span


@dataclasses.dataclass
class KmerIndex:
    """Doc-freq index over the k-mer universe of one dataset.

    Attributes:
      k: k-mer size.
      codes: int64 [D] — all distinct codes, ascending (D = distinct k-mers).
      doc_freq: int64 [D] — #proteins containing each code.
      repeated_codes: int64 [R] — codes with doc_freq ≥ 2, ascending; the
        rank hash maps repeated_codes[r] → r.
      incidence_protein: int32 [nnz] — protein row of each (protein,
        repeated-kmer) incidence, sorted by (protein, rank).
      incidence_rank: int32 [nnz] — rank-hash column of each incidence.
      hash_doc_freq: int64 [R] — docfreq in rank space (src/main.rs:187-193);
        equals doc_freq[repeated mask] by construction.
    """

    k: int
    codes: np.ndarray
    doc_freq: np.ndarray
    repeated_codes: np.ndarray
    incidence_protein: np.ndarray
    incidence_rank: np.ndarray
    hash_doc_freq: np.ndarray
    # Set by an index built without host incidence lists (the JAX
    # package's device path); equals Σ hash_doc_freq either way.
    nnz_count: Optional[int] = None
    # int32 [n_unique], aligned with codes[doc_freq == 1]: the single
    # protein containing each unique code. A unique code carries no
    # pairwise signal today, but an APPENDED protein can promote it to
    # repeated (docfreq 2) — and then its owner's bitset bit must be set
    # without re-encoding the standing corpus (kmers.append). The
    # reference's incremental analogue is Tree::add_protein
    # (src/tree.rs:524-536). None on device-built indexes (no host
    # incidences) — append requires a host/native-built index.
    unique_owner: Optional[np.ndarray] = None
    # Sampling mode the corpus k-mer stream was encoded with ("all" or
    # "random10", src/protein.rs:77-104). build_index cannot see it (it
    # receives pre-encoded codes), so the PIPELINE stamps it; kmers.append
    # refuses non-"all" indexes — appended sequences are encoded with the
    # full stream, and mixing streams silently breaks append ≡ rebuild.
    sampling: str = "all"

    @property
    def n_distinct(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_unique(self) -> int:
        return self.n_distinct - self.n_repeated

    @property
    def n_repeated(self) -> int:
        return int(self.repeated_codes.shape[0])

    @property
    def nnz(self) -> int:
        if self.nnz_count is not None:
            return self.nnz_count
        return int(self.incidence_rank.shape[0])

    @property
    def has_incidences(self) -> bool:
        return self.incidence_rank.shape[0] > 0 or self.nnz == 0

    @classmethod
    def from_dense_freq(cls, freq: np.ndarray, k: int) -> "KmerIndex":
        """Index view over a dense doc-freq vector (device path output)."""
        codes = np.nonzero(freq)[0].astype(np.int64)
        doc_freq = freq[codes].astype(np.int64)
        repeated = doc_freq >= 2
        return cls(
            k=k,
            codes=codes,
            doc_freq=doc_freq,
            repeated_codes=codes[repeated],
            incidence_protein=np.zeros(0, np.int32),
            incidence_rank=np.zeros(0, np.int32),
            hash_doc_freq=doc_freq[repeated],
            nnz_count=int(doc_freq[repeated].sum()),
        )

    @classmethod
    def from_sparse_freq(
        cls, codes: np.ndarray, doc_freq: np.ndarray, k: int
    ) -> "KmerIndex":
        """Index view over (ascending codes, doc-freq) pairs — the sorted
        device path's output (k=7: the 21⁷ universe has no dense form)."""
        codes = np.asarray(codes, np.int64)
        doc_freq = np.asarray(doc_freq, np.int64)
        repeated = doc_freq >= 2
        return cls(
            k=k,
            codes=codes,
            doc_freq=doc_freq,
            repeated_codes=codes[repeated],
            incidence_protein=np.zeros(0, np.int32),
            incidence_rank=np.zeros(0, np.int32),
            hash_doc_freq=doc_freq[repeated],
            nnz_count=int(doc_freq[repeated].sum()),
        )

    def multigraph_edge_count(self) -> int:
        """Σ f(f−1)/2 over rank-space docfreq — the number of edge slots the
        reference materializes (src/graph/mod.rs:44-48): 258,621,291 on the
        bundled dataset."""
        f = self.hash_doc_freq.astype(np.int64)
        return int((f * (f - 1) // 2).sum())

    def rank_of(self, codes: np.ndarray) -> np.ndarray:
        """Map k-mer codes → rank-hash ids (-1 for non-repeated codes)."""
        if self.n_repeated == 0:
            return np.full(np.shape(codes), -1, dtype=np.int64)
        pos = np.searchsorted(self.repeated_codes, codes)
        pos = np.clip(pos, 0, self.n_repeated - 1)
        ok = self.repeated_codes[pos] == codes
        return np.where(ok, pos, -1).astype(np.int64)


def build_index(
    codes: np.ndarray, kmer_offsets: np.ndarray, k: int,
    engine: str = "auto",
) -> KmerIndex:
    """Build the doc-freq index from per-protein k-mer code lists.

    ``codes``/``kmer_offsets`` are the ragged output of
    ``kmers.encode.encode_kmers``.

    ``engine``: "native" uses the C++ radix-sort builder
    (native/ukc_native.cpp — ~6× the numpy path at 100k proteins),
    "numpy" forces the pure-numpy path, "auto" prefers native when the
    library builds. Both are bit-identical (tests/test_native.py).
    """
    if engine in ("auto", "native"):
        from uniprot_kmer_based_clustering_tpu_torch.io import native

        with span("index.build"):
            res = native.index_build(codes, kmer_offsets, k)
        if res is not None:
            distinct, freq, inc_p, inc_r, _ = res
            repeated_mask = freq >= 2
            with span("index.owners"):
                owners = _unique_owners(
                    distinct[~repeated_mask], codes, kmer_offsets
                )
            return KmerIndex(
                k=k,
                codes=distinct,
                doc_freq=freq,
                repeated_codes=distinct[repeated_mask],
                incidence_protein=inc_p,
                incidence_rank=inc_r,
                hash_doc_freq=freq[repeated_mask],
                unique_owner=owners,
            )
        if engine == "native":
            raise RuntimeError("native index builder unavailable")

    with span("index.build"):
        index, owner_protein, owner_code = _build_index_numpy(
            codes, kmer_offsets, k
        )
    with span("index.owners"):
        # owners fall straight out of the deduped incidences here — a
        # docfreq-1 code has exactly one (protein, code) row; re-scanning
        # the raw window stream (_unique_owners, needed only for the
        # native path which never materializes inc arrays) would add an
        # np.repeat + searchsorted over every raw k-mer to every build
        index.unique_owner = _owners_from_incidences(owner_protein,
                                                     owner_code)
    return index


def _build_index_numpy(codes: np.ndarray, kmer_offsets: np.ndarray,
                       k: int):
    """The pure-numpy build, with no owners: (index, protein, code) of
    the unique codes' incidences, from which :func:`build_index` takes
    the owners."""
    n = kmer_offsets.shape[0] - 1
    per_protein_counts = np.diff(kmer_offsets)
    protein_of = np.repeat(
        np.arange(n, dtype=np.int64), per_protein_counts
    )

    # Distinct (protein, code) incidences — the per-protein sort+dedup of
    # src/main.rs:100-102 for all proteins at once. Key fits int64 for both
    # k (21^7 < 2^31) and UniProt-scale N.
    universe = 21**k
    keys = protein_of * universe + codes
    keys = np.unique(keys)
    inc_protein = (keys // universe).astype(np.int32)
    inc_code = keys % universe

    distinct_codes, doc_freq = np.unique(inc_code, return_counts=True)
    repeated_mask = doc_freq >= 2
    repeated_codes = distinct_codes[repeated_mask]
    hash_doc_freq = doc_freq[repeated_mask].astype(np.int64)

    # Strip unique-kmer incidences and re-key to rank space
    # (src/protein.rs:151-174). keys are sorted ⇒ incidences stay sorted by
    # (protein, rank) since rank order == code order.
    rank = np.searchsorted(repeated_codes, inc_code)
    rank = np.clip(rank, 0, max(len(repeated_codes) - 1, 0))
    keep = (
        repeated_codes[rank] == inc_code
        if len(repeated_codes)
        else np.zeros_like(inc_code, dtype=bool)
    )

    index = KmerIndex(
        k=k,
        codes=distinct_codes,
        doc_freq=doc_freq.astype(np.int64),
        repeated_codes=repeated_codes,
        incidence_protein=inc_protein[keep],
        incidence_rank=rank[keep].astype(np.int32),
        hash_doc_freq=hash_doc_freq,
    )
    return index, inc_protein[~keep], inc_code[~keep]


def _owners_from_incidences(
    prot: np.ndarray, code: np.ndarray
) -> np.ndarray:
    """int32 owner row per ascending unique code, from the already-
    deduped unique-code incidences (each appears exactly once)."""
    order = np.argsort(code, kind="stable")
    return np.ascontiguousarray(prot[order]).astype(np.int32)


def _unique_owners(
    unique_codes: np.ndarray,
    codes: np.ndarray,
    kmer_offsets: np.ndarray,
) -> np.ndarray:
    """int32 owner row of each unique (docfreq==1) code.

    A docfreq-1 code appears in exactly one protein; one vectorized
    searchsorted over the raw window codes finds it. Repeated windows of
    the same code inside that protein overwrite with the same owner —
    idempotent. Engine-independent (derived from the raw encoder output,
    not the builder's internals), so native- and numpy-built indexes
    carry identical owners.
    """
    n = kmer_offsets.shape[0] - 1
    owner = np.full(unique_codes.shape[0], -1, np.int32)
    if unique_codes.shape[0] == 0 or codes.shape[0] == 0:
        return owner
    protein_of = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(kmer_offsets)
    )
    pos = np.searchsorted(unique_codes, codes)
    pos = np.clip(pos, 0, unique_codes.shape[0] - 1)
    hit = unique_codes[pos] == codes
    owner[pos[hit]] = protein_of[hit].astype(np.int32)
    return owner


def doc_freq_dense_device(codes, valid, k: int):
    """Device doc-freq over the dense 21^k universe (k=5 only).

    Args:
      codes: int32 tensor [N, W] of window codes (``encode_kmers_device``).
      valid: bool tensor [N, W], the real-window mask.

    Returns int32 [21^k] document frequencies on the codes' device. Each
    row is sorted and only the first occurrence of a code survives
    (``index_device._row_dedup``), so the bincount counts documents, not
    windows. The 21⁷ universe of k=7 has no dense form: the sorted build
    (``index_device.build_bitset_device_sorted``) covers it.
    """
    import torch

    if k != 5:
        raise ValueError("dense device doc-freq supports k=5 only")
    # late import: index_device imports this module
    from uniprot_kmer_based_clustering_tpu_torch.kmers.index_device import (
        _row_dedup,
    )

    universe = 21**k
    # padding and duplicate windows carry the out-of-range sentinel code,
    # counted into the extra slot that is cut away
    flat = _row_dedup(codes, valid, sent=universe).reshape(-1)
    counts = torch.zeros(universe + 1, dtype=torch.int32, device=codes.device)
    counts.index_add_(0, flat.to(torch.int64),
                      torch.ones_like(flat, dtype=torch.int32))
    return counts[:universe]
