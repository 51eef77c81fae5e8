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
Words bound for a CUDA device may be packed into page-locked host memory
(:func:`pinned_words`), so that their upload is an asynchronous DMA.
The device index build's bitset (:class:`DeviceBitsetMatrix`) keeps its
words on the device and fetches a host copy only when one is read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def padded_shape(n: int, n_bits: int, row_multiple: int = 512,
                 word_multiple: int = 128) -> Tuple[int, int]:
    """``(N_pad, W_pad)`` of the packed matrix of ``n`` proteins over
    ``n_bits`` ranks."""
    n_pad = _round_up(max(n, 1), row_multiple)
    w_pad = _round_up(_round_up(max(n_bits, 1), 32) // 32, word_multiple)
    return n_pad, w_pad


def wants_pinned(device, nbytes: int) -> bool:
    """Whether host words of ``nbytes`` bound for ``device`` are packed
    into page-locked memory: only for a CUDA device, whose upload then is
    a DMA, and only while the block that holds them takes at most a
    quarter of the host's physical memory, which page-locking withholds
    from the rest of the host. Torch's caching host allocator rounds a
    block up to a power of two."""
    import torch

    if torch.device(device).type != "cuda":
        return False
    block = 1 << max(nbytes - 1, 0).bit_length()
    physical = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return block <= physical // 4


def pinned_words(shape: Tuple[int, int], device):
    """A page-locked int32 tensor of ``shape`` from torch's caching host
    allocator, to pack words bound for ``device`` into
    (``pack_bitsets(out=)``); None where :func:`wants_pinned` says no or
    the allocation fails, and the words then take plain pageable memory.
    The block may hold an earlier user's bytes: the pack zeroes it."""
    import torch

    if not wants_pinned(device, shape[0] * shape[1] * 4):
        return None
    try:
        return torch.empty(shape, dtype=torch.int32, pin_memory=True)
    except RuntimeError:
        return None


@dataclasses.dataclass
class BitsetMatrix:
    """Packed presence matrix plus its true (unpadded) dimensions.

    ``pinned``, when the words were packed into page-locked memory, is
    the int32 tensor of torch's caching host allocator that owns them
    (``words`` is a uint32 view of it): uploads copy from it
    asynchronously, and the allocator, which records each such copy,
    hands the block out again only after the copies have read it."""

    words: np.ndarray  # uint32 [N_pad, W_pad]
    n: int             # true protein count
    n_bits: int        # true k-mer (rank-space) count
    pinned: Optional["torch.Tensor"] = None  # noqa: F821

    @property
    def n_pad(self) -> int:
        return int(self.words.shape[0])

    @property
    def w_pad(self) -> int:
        return int(self.words.shape[1])

    def row_bits(self, i: int) -> np.ndarray:
        """Unpacked bool row (testing/debug only)."""
        return _row_bits_impl(self, i)


def pinned_of(bitset):
    """The page-locked tensor that owns ``bitset``'s words, or None: for
    pageable words, and for any object with ``.words`` (the JAX package's
    bitsets carry no ``pinned``)."""
    return getattr(bitset, "pinned", None)


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
        n_pad, w_pad = padded_shape(n, n_bits, row_multiple, word_multiple)
        return cls(words=_NeverWords(), n=n, n_bits=n_bits,
                   pad_rows=n_pad, pad_words=w_pad)

    @property
    def n_pad(self) -> int:
        return self.pad_rows

    @property
    def w_pad(self) -> int:
        return self.pad_words


class DeviceBitsetMatrix(BitsetMatrix):
    """A bitset built on a torch device (``kmers/index_device.py``):
    ``device_words`` is its int32 tensor [N_pad, W_pad] of uint32 bit
    patterns, which ``state.bitset_to_torch`` hands to the sweep without
    a copy. ``.words``, the host uint32 matrix, is fetched the first
    time something reads it (tree and agglomerative clustering, the host
    engines, dumps) and then kept."""

    def __init__(self, device_words, n: int, n_bits: int):
        self.device_words = device_words
        self.n = n
        self.n_bits = n_bits
        self._host_words = None

    @property
    def words(self) -> np.ndarray:
        if self._host_words is None:
            self._host_words = (
                self.device_words.cpu().numpy().view(np.uint32))
        return self._host_words

    @property
    def n_pad(self) -> int:
        return int(self.device_words.shape[0])

    @property
    def w_pad(self) -> int:
        return int(self.device_words.shape[1])


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
    out=None,
) -> BitsetMatrix:
    """Pack (protein, rank) incidences into the uint32 presence matrix.

    The words live in a fresh pageable numpy array, or in ``out``: a
    contiguous CPU int32 tensor [N_pad, W_pad] (:func:`pinned_words`
    gives a page-locked one), zeroed here by a parallel fill whatever it
    held, whose uint32 view becomes ``words``. A page-locked ``out``
    becomes the result's ``pinned``, and ``state.bitset_to_torch`` then
    uploads it asynchronously.

    The numpy fallback is chunked over protein rows so the transient bool
    matrix stays small (``chunk_rows × n_bits`` bytes).
    """
    import torch

    n_pad, w_pad = padded_shape(n, n_bits, row_multiple, word_multiple)
    pinned = None
    if out is None:
        words = np.zeros((n_pad, w_pad), dtype=np.uint32)
    else:
        if (tuple(out.shape) != (n_pad, w_pad) or out.dtype != torch.int32
                or out.device.type != "cpu" or not out.is_contiguous()):
            raise ValueError(
                f"out must be a contiguous CPU int32 tensor [{n_pad}, "
                f"{w_pad}], got {tuple(out.shape)} {out.dtype}")
        out.zero_()
        words = out.numpy().view(np.uint32)
        if out.is_pinned():
            pinned = out

    # Native scatter packer when built (csrc/ukc_native.cpp) — an order
    # of magnitude faster than the chunked packbits fallback below.
    try:
        from uniprot_kmer_based_clustering_tpu_torch.io import native

        packed = native.pack_bits(
            np.asarray(incidence_protein, np.int32),
            np.asarray(incidence_rank, np.int32),
            n_pad,
            w_pad,
            out=words,
        )
        if packed is not None:
            return BitsetMatrix(words=words, n=n, n_bits=n_bits,
                                pinned=pinned)
    except Exception:
        pass

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
    return BitsetMatrix(words=words, n=n, n_bits=n_bits, pinned=pinned)


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

    n_pad, w_pad = padded_shape(n, n_bits, row_multiple, word_multiple)
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


def unpack_ranks(bitset: BitsetMatrix, i: int) -> np.ndarray:
    """Rank ids present in row i (testing/debug)."""
    return np.nonzero(bitset.row_bits(i))[0]
