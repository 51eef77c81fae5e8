"""Packed k-mer presence bitsets.

The reference's per-vertex edge-incidence "bit arrays"
(``src/graph/vertex.rs:143-157``, ``src/tree.rs`` u/c bitarrays) are
``Vec<bool>`` — one byte per bit, reallocated per query. Here the whole
dataset is one packed ``[N, W]`` uint32 matrix: protein n contains the
repeated k-mer of rank r iff bit ``r % 32`` (LSB-first) of word
``words[n, r // 32]`` is set. 231,253 repeated 5-mers → 7,227 words →
28.9 KB/protein; 10,619 proteins ≈ 307 MB — comfortably HBM-resident, and
the layout a tiled AND+popcount sweep wants.

Padding: the word axis is padded to a multiple of 128 (TPU lane count) and
the protein axis to a multiple of the sweep tile; pad bits are zero so they
never contribute to a popcount.

The port's own copy of the JAX package's ``kmers/bitset.py``:
``state.bitset_to_torch`` carries the words to a torch device, the stream
engine reads them from the host block by block, and
:func:`pack_bitsets_device` packs the incidences on the device instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class BitsetMatrix:
    """Packed presence matrix plus its true (unpadded) dimensions."""

    words: np.ndarray  # uint32 [N_pad, W_pad]
    n: int             # true protein count
    n_bits: int        # true k-mer (rank-space) count

    @property
    def n_pad(self) -> int:
        return int(self.words.shape[0])

    @property
    def w_pad(self) -> int:
        return int(self.words.shape[1])

    def row_bits(self, i: int) -> np.ndarray:
        """Unpacked bool row (testing/debug only)."""
        return _row_bits_impl(self, i)


class _NeverWords:
    """Stands in for the dense matrix in packless runs: ANY attribute
    access (shape, dtype, slicing …) raises with the reason, so a
    dense-path dispatch fails loudly instead of computing on nothing."""

    def __getattr__(self, name):
        raise RuntimeError(
            "the dense packed matrix was never materialized "
            "(stream_source='csr' packless run); this code path needs "
            "the host words — re-run with stream_source='host' or a "
            "dense-matrix engine"
        )

    def __getitem__(self, *_):
        self.shape  # raises


@dataclasses.dataclass
class VirtualBitsetMatrix(BitsetMatrix):
    """Geometry-only stand-in for runs that never build the dense matrix
    (the stream engine with the CSR block source): it carries the padded
    dimensions the engines key their tile enumeration on; touching
    ``.words`` raises."""

    pad_rows: int = 0
    pad_words: int = 0

    @classmethod
    def make(cls, n: int, n_bits: int, row_multiple: int = 512,
             word_multiple: int = 128) -> "VirtualBitsetMatrix":
        n_pad = _round_up(max(n, 1), row_multiple)
        w_pad = _round_up(_round_up(max(n_bits, 1), 32) // 32, word_multiple)
        return cls(words=_NeverWords(), n=n, n_bits=n_bits,
                   pad_rows=n_pad, pad_words=w_pad)

    @property
    def n_pad(self) -> int:
        return self.pad_rows

    @property
    def w_pad(self) -> int:
        return self.pad_words


def _row_bits_impl(bs: BitsetMatrix, i: int) -> np.ndarray:
    bits = np.unpackbits(
        bs.words[i].view(np.uint8), bitorder="little"
    )
    return bits[: bs.n_bits].astype(bool)


def pack_bitsets(
    incidence_protein: np.ndarray,
    incidence_rank: np.ndarray,
    n: int,
    n_bits: int,
    row_multiple: int = 512,
    word_multiple: int = 128,
    chunk_rows: int = 2048,
) -> BitsetMatrix:
    """Pack (protein, rank) incidences into the uint32 presence matrix.

    Chunked over protein rows so the transient bool matrix stays small
    (``chunk_rows × n_bits`` bytes).
    """
    n_pad = _round_up(max(n, 1), row_multiple)
    w = _round_up(max(n_bits, 1), 32) // 32
    w_pad = _round_up(w, word_multiple)

    # Native scatter packer when built (native/ukc_native.cpp) — an order
    # of magnitude faster than the chunked packbits fallback below.
    try:
        from uniprot_kmer_based_clustering_tpu_torch.io import native

        words = native.pack_bits(
            np.asarray(incidence_protein, np.int32),
            np.asarray(incidence_rank, np.int32),
            n_pad,
            w_pad,
        )
        if words is not None:
            return BitsetMatrix(words=words, n=n, n_bits=n_bits)
    except Exception:
        pass

    words = np.zeros((n_pad, w_pad), dtype=np.uint32)

    bit_cols = w_pad * 32
    order = np.argsort(incidence_protein, kind="stable")
    ip = incidence_protein[order]
    ir = incidence_rank[order]
    starts = np.searchsorted(ip, np.arange(0, n + 1, dtype=ip.dtype))

    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        s, e = starts[lo], starts[hi]
        if s == e:
            continue
        bits = np.zeros((hi - lo, bit_cols), dtype=np.uint8)
        bits[ip[s:e] - lo, ir[s:e]] = 1
        packed = np.packbits(bits, axis=1, bitorder="little")
        words[lo:hi] = packed.view(np.uint32)
    return BitsetMatrix(words=words, n=n, n_bits=n_bits)



# The JAX package's refusal size, set for one 16 GB TPU (~15.75 GB with
# working space); kept so both packages refuse alike
_DEVICE_PACK_LIMIT_GB = 13.0
# incidences uploaded and scattered per step of pack_bitsets_device
_PACK_CHUNK = 1 << 22


def pack_bitsets_device(
    incidence_protein: np.ndarray,
    incidence_rank: np.ndarray,
    n: int,
    n_bits: int,
    row_multiple: int = 512,
    word_multiple: int = 128,
    device="cuda",
) -> BitsetMatrix:
    """Pack the presence matrix ON the device: the (protein, rank)
    incidences (8 bytes each) go up in chunks of ``_PACK_CHUNK`` and each
    adds its own power of two into ``words[p, r >> 5]``.

    Several distinct ranks of one protein can share a word, so the
    scatter accumulates (``index_add_`` of int32 bit patterns, bit 31 the
    sign bit): distinct bits never carry, and the sum is the OR.

    Returns a BitsetMatrix whose ``words`` is an int32 tensor [N_pad,
    W_pad] on ``device`` holding the uint32 bit patterns.
    """
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import _BIT

    n_pad = _round_up(max(n, 1), row_multiple)
    w = _round_up(max(n_bits, 1), 32) // 32
    w_pad = _round_up(w, word_multiple)
    gb = n_pad * w_pad * 4 / 2**30
    if gb > _DEVICE_PACK_LIMIT_GB:
        raise ValueError(
            f"packed bitset would be {gb:.1f} GB — beyond the "
            f"{_DEVICE_PACK_LIMIT_GB:.0f} GB device-pack limit (the JAX "
            f"package's, kept so both refuse alike). Pack on the host "
            f"(pack_bitsets), or stream the corpus (engine='stream')."
        )
    device = resolve_device(device)
    words = torch.zeros(n_pad * w_pad, dtype=torch.int32, device=device)
    table = torch.tensor(_BIT, dtype=torch.int32, device=device)
    ip = np.asarray(incidence_protein, np.int32)
    ir = np.asarray(incidence_rank, np.int32)
    for lo in range(0, ip.shape[0], _PACK_CHUNK):
        p = torch.from_numpy(ip[lo : lo + _PACK_CHUNK]).to(device)
        r = torch.from_numpy(ir[lo : lo + _PACK_CHUNK]).to(device)
        flat = p.to(torch.int64) * w_pad + (r >> 5).to(torch.int64)
        words.index_add_(0, flat, table[(r & 31).to(torch.int64)])
    return BitsetMatrix(words=words.view(n_pad, w_pad), n=n, n_bits=n_bits)
