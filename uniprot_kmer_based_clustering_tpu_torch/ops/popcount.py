"""Popcount engines: pairwise shared-k-mer counts as AND + popcount (K4).

Counterpart of the JAX package's ``ops/popcount.py``. The shared count of
proteins i and j is ``Σ_w popcount(words[i, w] & words[j, w])`` over the
packed words; every (ti, tj) tile pair of the upper triangle reduces its
counts at once to the 8 row-stat lanes and four hit counts, so the count
matrix is never stored.

- :func:`popcount_sweep` is the tile sweep: on a CUDA tensor it launches
  the hand-written kernel ``csrc/popcount_sweep.cu`` (K4, the counterpart
  of the Pallas ``sweep_pallas``); on a CPU tensor it runs
  :func:`sweep_reference`, the same sweep tile by tile in plain torch.
- :func:`sweep_pallas`, :func:`sweep_xla` and :func:`sweep` keep the JAX
  package's signatures: K4 behind the Pallas entry's arguments, the plain
  sweep returning numpy arrays, and the engines' dispatcher.

torch has no popcount op: :func:`popcount32_` counts bits in place with
the SWAR shifts and masks on int32 (``>>`` is missing for uint32 on the
CPU; the mask after each arithmetic shift clears the sign copies).

Row-stat lanes, per stationary protein row over all j > i:
  0 cross_weight  Σ counts where class differs
  1 cross_pairs   #pairs with counts ≥ w_thresh (1 here), class differs
  2 cross_over    #pairs with counts > threshold, class differs
  3 cross_max     max count, class differs
  4..7 the same four for class-equal pairs
``tile_hits`` [nT, 4]: #cross/#same pairs over threshold, then #cross/
#same pairs with count ≥ 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.ops import _build
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import (
    merge_row_stats_at,
    stack_row_stats,
)

ROW_STAT_NAMES = (
    "cross_weight",
    "cross_pairs",
    "cross_over",
    "cross_max",
    "same_weight",
    "same_pairs",
    "same_over",
    "same_max",
)

# elements of the [rows, B, W] AND temporary of one pairwise_counts chunk
_CHUNK_ELEMS = 1 << 26


def upper_triangle_tiles(n_pad: int, tile: int) -> Tuple[np.ndarray, np.ndarray]:
    """(i_tile, j_tile) enumeration of the upper triangle, row-major so
    that all tiles sharing a stationary i are consecutive."""
    nt = n_pad // tile
    i, j = np.triu_indices(nt)
    return i.astype(np.int32), j.astype(np.int32)


def popcount32_(x):
    """Per-element bit count of an int32 tensor, in place (SWAR)."""
    x.sub_((x >> 1).bitwise_and_(0x55555555))
    t = (x >> 2).bitwise_and_(0x33333333)
    x.bitwise_and_(0x33333333).add_(t)
    x.add_(x >> 4).bitwise_and_(0x0F0F0F0F)
    x.add_(x >> 8)
    x.add_(x >> 16)
    return x.bitwise_and_(0x3F)


def pairwise_counts_xla(a_words, b_words):
    """int32 [A, B] shared-bit counts of packed rows a [A, W] and b [B, W]
    (int32 bit patterns), in row chunks of at most ``_CHUNK_ELEMS``
    AND results."""
    a_rows, w = a_words.shape
    b_rows = b_words.shape[0]
    out = torch.empty((a_rows, b_rows), dtype=torch.int32,
                      device=a_words.device)
    step = max(1, _CHUNK_ELEMS // max(1, b_rows * w))
    for r0 in range(0, a_rows, step):
        x = a_words[r0 : r0 + step, None, :] & b_words[None, :, :]
        out[r0 : r0 + step] = popcount32_(x).sum(dim=2, dtype=torch.int32)
    return out


def _masks(i0: int, j0: int, n: int, tile: int, classes_row, classes_col):
    """Cross/same pair masks of one (i, j) tile: valid = gi < gj < n and
    gi < n; cross by class inequality ([tile, 1] vs [1, tile])."""
    dev = classes_row.device
    gi = i0 + torch.arange(tile, dtype=torch.int64, device=dev)[:, None]
    gj = j0 + torch.arange(tile, dtype=torch.int64, device=dev)[None, :]
    valid = (gi < gj) & (gj < n) & (gi < n)
    cross = classes_row != classes_col
    return valid & cross, valid & ~cross


def _tile_stats_xla(a, b, crow, ccol, i0: int, j0: int, *, n: int,
                    threshold: int, tile: int):
    """One tile pair: (stats int32 [tile, 8], hits int32 [4])."""
    counts = pairwise_counts_xla(a, b)
    cross, same = _masks(i0, j0, n, tile, crow, ccol)
    stats, _, _ = stack_row_stats(counts, cross, same, threshold)
    hits = stats[:, [2, 6, 1, 5]].sum(dim=0, dtype=torch.int64)
    return stats, hits.to(torch.int32)


def sweep_reference(words, classes, n: int, threshold: int, tile: int,
                    tiles=None):
    """Plain-torch K4 on any device: the listed tile pairs (default: the
    whole upper triangle) one at a time. Lanes 3/7 merge by max, the rest
    by sum, in int32 like the kernel. Returns (row_stats int32 [N_pad, 8],
    tile_hits int32 [nT, 4], (ti, tj, tile))."""
    n_pad = words.shape[0]
    if n_pad % tile:
        raise ValueError(
            f"n_pad={n_pad} must be a multiple of tile={tile} (pack with "
            "a matching row_multiple)"
        )
    ti, tj = upper_triangle_tiles(n_pad, tile) if tiles is None else tiles
    dev = words.device
    classes = torch.as_tensor(classes, dtype=torch.int32, device=dev)
    row_stats = torch.zeros((n_pad, 8), dtype=torch.int32, device=dev)
    tile_hits = torch.zeros((len(ti), 4), dtype=torch.int32, device=dev)
    for t in range(len(ti)):
        i0, j0 = int(ti[t]) * tile, int(tj[t]) * tile
        stats, hits = _tile_stats_xla(
            words[i0 : i0 + tile], words[j0 : j0 + tile],
            classes[i0 : i0 + tile, None], classes[None, j0 : j0 + tile],
            i0, j0, n=n, threshold=threshold, tile=tile,
        )
        merge_row_stats_at(row_stats, stats, i0)
        tile_hits[t] = hits
    return row_stats, tile_hits, (ti, tj, tile)


def popcount_sweep(words, classes, n: int, threshold: int, tile: int,
                   tiles=None):
    """AND + popcount sweep over the listed upper-triangle tile pairs
    (default: all of them) at protein tile ``tile``.

    ``words`` int32 [N_pad, W] and ``classes`` int32 [N_pad] on one
    device. Returns (row_stats int32 [N_pad, 8], tile_hits int32 [nT, 4],
    (ti, tj, tile)) on that device. CPU tensors take
    :func:`sweep_reference`; CUDA tensors launch the kernel, counted in
    ``popcount_sweep.launches``. On the card the tile is any multiple of
    32 that divides N_pad, up to 4096: the TPU kernel's VMEM-derived tile
    and its 1 GiB tile_hits guard are facts of the TPU's layout and are
    not carried over.
    """
    if words.device.type == "cpu":
        return sweep_reference(words, classes, n, threshold, tile, tiles)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    n_pad, w = words.shape
    if n_pad % tile:
        raise ValueError(f"n_pad={n_pad} must be a multiple of tile={tile}")
    if tile % 32 or tile > 4096:
        raise ValueError(
            f"the CUDA popcount sweep takes tiles that are multiples of 32 "
            f"up to 4096, got {tile}"
        )
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError("words must be a contiguous int32 tensor")
    ti, tj = upper_triangle_tiles(n_pad, tile) if tiles is None else tiles
    dev = words.device
    classes = torch.as_tensor(classes, dtype=torch.int32, device=dev)
    classes = classes.contiguous()
    if classes.shape != (n_pad,):
        raise ValueError("classes must be int32 [N_pad]")
    tile_ij = torch.from_numpy(
        np.stack([ti, tj], axis=1).astype(np.int32)
    ).to(dev)
    row_stats = torch.zeros((n_pad, 8), dtype=torch.int32, device=dev)
    tile_hits = torch.zeros((len(ti), 4), dtype=torch.int32, device=dev)
    lib = _build.load_kernels()
    with torch.cuda.device(dev):
        err = lib.ukc_popcount_sweep(
            words.data_ptr(), w, classes.data_ptr(), tile_ij.data_ptr(),
            len(ti), tile, n, threshold, row_stats.data_ptr(),
            tile_hits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "ukc_popcount_sweep")
    popcount_sweep.launches += 1
    return row_stats, tile_hits, (ti, tj, tile)


popcount_sweep.launches = 0


def sweep_pallas(words, classes, n: int, threshold: int, tile: int = 128,
                 word_block: int = 512, device="cuda"):
    """The JAX ``sweep_pallas`` entry — its arguments (``word_block`` is
    unused there too) and its return, (row_stats int32 [N_pad, 8],
    tile_hits int32 [nT, 4], (ti, tj, tile)) — on K4 through
    :func:`popcount_sweep`. ``words`` is an int32 tensor, whose device the
    sweep runs on, or uint32 numpy [N_pad, W], copied to ``device`` first
    ("cuda" raises without a GPU). There is no ``interpret`` flag: a CPU
    tensor takes the plain sweep."""
    del word_block
    if not torch.is_tensor(words):
        words = torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)
        ).to(resolve_device(device))
    return popcount_sweep(words, classes, n, threshold, tile)


def to_host(row_stats, tile_hits, tiles):
    """The host copy of a sweep's device outputs: (row_stats int64,
    tile_hits, tiles) as numpy arrays."""
    return (row_stats.cpu().numpy().astype(np.int64),
            tile_hits.cpu().numpy(), tiles)


def sweep_xla(words, classes, n: int, threshold: int, tile: int = 512):
    """The plain tile-by-tile sweep with the JAX ``sweep_xla`` contract:
    (row_stats int64 [N_pad, 8], tile_hits int32 [nT, 4], (ti, tj, tile))
    as numpy arrays."""
    return to_host(*sweep_reference(words, classes, n, threshold, tile))


def sweep(words, classes, n: int, threshold: int, tile: int = 512):
    """The popcount engines (``popcount`` and ``xla`` alike) at ``tile``:
    :func:`popcount_sweep`, so K4 on a CUDA tensor and the plain sweep on
    a CPU tensor. Returns what :func:`sweep_xla` returns."""
    return to_host(*popcount_sweep(words, classes, n, threshold, tile))
