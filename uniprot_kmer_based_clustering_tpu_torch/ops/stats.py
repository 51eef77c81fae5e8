"""Statistics epilogues over a materialized counts block (K1, K2).

Counterpart of ``uniprot_kmer_based_clustering_tpu/ops/stats_pallas.py``.
:func:`stats_from_counts` walks the tiles of an int32 counts block that
are not wholly below the pair diagonal and returns

  row_stats int32 [S, 8]  — ops.popcount.ROW_STAT_NAMES per stationary row
  tile_hits int32 [nT, 2] — #pairs over threshold (cross/same) per tile

with no lane or sublane padding. On a CUDA tensor it launches the
hand-written kernel ``csrc/stats_epilogue.cu``; on a CPU tensor it runs
:func:`stats_from_counts_reference`, the same statistics in plain torch.
There is no other route: a CUDA tensor never reaches the plain version
through the wrapper.

:func:`stats_from_counts_traced` (K2) is the block-pair scan's epilogue:
the same statistics over every tile of the block, returned as
``block_hits [S/tile, J/tile, 2]``. Its CUDA kernel is K1's on the full
tile grid (``ukc_stats_epilogue_traced`` in the same source); its plain
version is :func:`stats_from_counts_traced_reference`.

The plain epilogue primitives :func:`stack_row_stats`,
:func:`pair_block_stats` and :func:`merge_row_stats_at` (``ops/bitmul.py``
in the JAX package) live here because the references are built from
them; ``ops.bitmul`` re-exports them.
"""

from __future__ import annotations

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.ops import _build


def stats_tiles(s: int, j: int, i_off: int, j_off: int, tile: int):
    """Tile enumeration for a counts block at global offset (i_off, j_off):
    row-major over the local grid, skipping tiles entirely below the pair
    diagonal (no gj > gi element)."""
    nti, ntj = s // tile, j // tile
    ti, tj = np.meshgrid(
        np.arange(nti, dtype=np.int32),
        np.arange(ntj, dtype=np.int32),
        indexing="ij",
    )
    keep = (j_off + (tj + 1) * tile - 1) > (i_off + ti * tile)
    return ti[keep].ravel(), tj[keep].ravel()


def _kept_tiles(s: int, j: int, i_off: int, j_off: int, tile: int):
    """:func:`stats_tiles`, refusing blocks where a tile row keeps no tile
    (its row_stats would never be visited by the tile walk)."""
    if s % tile or j % tile:
        raise ValueError(
            f"counts block [{s}, {j}] is not a multiple of tile {tile}"
        )
    ti, tj = stats_tiles(s, j, i_off, j_off, tile)
    covered = np.zeros(s // tile, bool)
    covered[ti] = True
    if not covered.all():
        raise ValueError(
            "stats_from_counts: some tile rows keep no tile (block lies "
            "entirely below the pair diagonal) — their row_stats would "
            "be uninitialized; pass diagonal-or-above blocks only"
        )
    return ti, tj


def stack_row_stats(counts, cross, same, threshold: int, w_thresh: int = 1):
    """The canonical 8-lane per-row statistics over one counts block
    (lanes %4==3 merge by max, the rest by sum). Sums wrap modulo 2^32
    like the device's int32 accumulators. Returns (row_stats int32
    [S, 8], over_c, over_s)."""
    zero = torch.zeros((), dtype=counts.dtype, device=counts.device)
    czero = torch.where(cross, counts, zero)
    szero = torch.where(same, counts, zero)
    over_c = cross & (counts > threshold)
    over_s = same & (counts > threshold)

    def total(x):
        return x.sum(dim=1, dtype=torch.int64).to(torch.int32)

    row_stats = torch.stack(
        [
            total(czero),
            total(cross & (counts >= w_thresh)),
            total(over_c),
            czero.amax(dim=1),
            total(szero),
            total(same & (counts >= w_thresh)),
            total(over_s),
            szero.amax(dim=1),
        ],
        dim=1,
    )
    return row_stats, over_c, over_s


def merge_row_stats_at(row_stats, rs, i0: int):
    """Merge one block's row stats into ``row_stats`` at row ``i0``, in
    place: lanes %4==3 by max, the rest by sum (the ROW_STAT_NAMES
    contract), shared by the scan and the plain popcount sweep. Returns
    ``row_stats``."""
    prev = row_stats[i0 : i0 + rs.shape[0]]
    max_lane = torch.arange(8, device=rs.device) % 4 == 3
    prev.copy_(torch.where(max_lane, torch.maximum(prev, rs), prev + rs))
    return row_stats


def pair_block_stats(counts, ca, cb, i0: int, j0: int, *, n: int,
                     threshold: int, block: int, w_thresh: int):
    """Plain statistics epilogue for one [S, J] counts block at global
    offset (i0, j0): validity/class masks, the 8-lane row stats, and
    per-``block`` sub-tile hit counts. Returns (rs int32 [S, 8], bh int32
    [S/block, J/block, 2], over_c, over_s)."""
    s, j = counts.shape
    dev = counts.device
    gi = i0 + torch.arange(s, dtype=torch.int64, device=dev)[:, None]
    gj = j0 + torch.arange(j, dtype=torch.int64, device=dev)[None, :]
    valid = (gi < gj) & (gj < n)
    cross = valid & (ca[:, None] != cb[None, :])
    same = valid & ~cross
    rs, over_c, over_s = stack_row_stats(
        counts, cross, same, threshold, w_thresh
    )
    nbi, nbj = s // block, j // block

    def per_block(m):
        return (
            m.reshape(nbi, block, nbj, block)
            .sum(dim=(1, 3), dtype=torch.int64)
            .to(torch.int32)
        )

    bh = torch.stack([per_block(over_c), per_block(over_s)], dim=-1)
    return rs, bh, over_c, over_s


def stats_from_counts_reference(counts, classes_row, classes_col, *,
                                i_off: int, j_off: int, n: int,
                                threshold: int, w_thresh: int = 1,
                                tile: int = 512):
    """Plain-torch K1: the same outputs as the tile walk, on any device.

    Tiles wholly below the diagonal are all masked, so the whole block
    is reduced at once. The max lanes are clamped at 0 as the tile walk
    clamps them (its first tile starts from 0)."""
    s, j = counts.shape
    ti, tj = _kept_tiles(s, j, i_off, j_off, tile)
    dev = counts.device
    ca = torch.as_tensor(classes_row, dtype=torch.int32, device=dev)
    cb = torch.as_tensor(classes_col, dtype=torch.int32, device=dev)
    rs, bh, _, _ = pair_block_stats(
        counts, ca, cb, i_off, j_off,
        n=n, threshold=threshold, block=tile, w_thresh=w_thresh,
    )
    rs[:, 3].clamp_(min=0)
    rs[:, 7].clamp_(min=0)
    sel_i = torch.from_numpy(ti.astype(np.int64)).to(dev)
    sel_j = torch.from_numpy(tj.astype(np.int64)).to(dev)
    return rs, bh[sel_i, sel_j], (ti, tj, tile)


def _cuda_inputs(counts, classes_row, classes_col, tile: int):
    """Check what the CUDA epilogue takes; the class vectors as
    contiguous int32 on the counts' device."""
    if counts.dtype != torch.int32 or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous int32 tensor")
    if tile % 32 or tile > 12288:
        raise ValueError(
            f"the CUDA epilogue takes tiles that are multiples of 32 up "
            f"to 12288, got {tile}"
        )
    dev = counts.device
    crow = torch.as_tensor(classes_row, dtype=torch.int32, device=dev)
    ccol = torch.as_tensor(classes_col, dtype=torch.int32, device=dev)
    if crow.shape != counts.shape[:1] or ccol.shape != counts.shape[1:]:
        raise ValueError("class vectors must match the counts block")
    return crow.contiguous(), ccol.contiguous()


def stats_from_counts(counts, classes_row, classes_col, *, i_off: int,
                      j_off: int, n: int, threshold: int, w_thresh: int = 1,
                      tile: int = 512):
    """Tile-walk statistics over a counts block at global offset
    (i_off, j_off).

    ``counts`` is int32 [S, J]; ``classes_row``/``classes_col`` are int32
    [S]/[J]. Tiles entirely below the pair diagonal are skipped; partial
    diagonal tiles are masked per element. Returns (row_stats int32
    [S, 8], tile_hits int32 [nT, 2], tiles (ti, tj, tile) in local tile
    coordinates). CPU tensors take :func:`stats_from_counts_reference`;
    CUDA tensors launch the kernel, counted in
    ``stats_from_counts.launches``.
    """
    if counts.device.type == "cpu":
        return stats_from_counts_reference(
            counts, classes_row, classes_col, i_off=i_off, j_off=j_off,
            n=n, threshold=threshold, w_thresh=w_thresh, tile=tile,
        )
    if counts.device.type != "cuda":
        raise ValueError(f"unsupported device {counts.device}")
    s, j = counts.shape
    ti, tj = _kept_tiles(s, j, i_off, j_off, tile)
    crow, ccol = _cuda_inputs(counts, classes_row, classes_col, tile)
    dev = counts.device
    tiles = torch.from_numpy(np.stack([ti, tj], axis=1)).to(dev)
    row_stats = torch.zeros((s, 8), dtype=torch.int32, device=dev)
    tile_hits = torch.zeros((len(ti), 2), dtype=torch.int32, device=dev)
    lib = _build.load_kernels()
    with torch.cuda.device(dev):
        err = lib.ukc_stats_epilogue(
            counts.data_ptr(), j, crow.data_ptr(), ccol.data_ptr(),
            tiles.data_ptr(), len(ti), tile, i_off, j_off, n, threshold,
            w_thresh, row_stats.data_ptr(), tile_hits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "ukc_stats_epilogue")
    stats_from_counts.launches += 1
    return row_stats, tile_hits, (ti, tj, tile)


stats_from_counts.launches = 0


def stats_from_counts_traced_reference(counts, classes_row, classes_col,
                                       i_off: int, j_off: int, *, n: int,
                                       threshold: int, w_thresh: int = 1,
                                       tile: int = 512):
    """Plain-torch K2: :func:`pair_block_stats` over the whole block with
    the max lanes clamped at 0, as the Pallas walk clamps them (its first
    tile of each row starts from 0). Returns (row_stats int32 [S, 8],
    block_hits int32 [S/tile, J/tile, 2])."""
    s, j = counts.shape
    if s % tile or j % tile:
        raise ValueError(
            f"counts block [{s}, {j}] is not a multiple of tile {tile}"
        )
    dev = counts.device
    ca = torch.as_tensor(classes_row, dtype=torch.int32, device=dev)
    cb = torch.as_tensor(classes_col, dtype=torch.int32, device=dev)
    rs, bh, _, _ = pair_block_stats(
        counts, ca, cb, i_off, j_off,
        n=n, threshold=threshold, block=tile, w_thresh=w_thresh,
    )
    rs[:, 3].clamp_(min=0)
    rs[:, 7].clamp_(min=0)
    return rs, bh


def stats_from_counts_traced(counts, classes_row, classes_col, i_off: int,
                             j_off: int, *, n: int, threshold: int,
                             w_thresh: int = 1, tile: int = 512):
    """Statistics over EVERY tile of a counts block at global offset
    (i_off, j_off) — the block-pair scan's epilogue (K2).

    The JAX package traces the offsets inside one compiled ``lax.scan``;
    here they are plain arguments of each launch. Tiles wholly below the
    pair diagonal are visited and mask to zero. Returns (row_stats int32
    [S, 8], block_hits int32 [S/tile, J/tile, 2]). CPU tensors take
    :func:`stats_from_counts_traced_reference`; CUDA tensors launch the
    kernel, counted in ``stats_from_counts_traced.launches``.
    """
    if counts.device.type == "cpu":
        return stats_from_counts_traced_reference(
            counts, classes_row, classes_col, i_off, j_off, n=n,
            threshold=threshold, w_thresh=w_thresh, tile=tile,
        )
    if counts.device.type != "cuda":
        raise ValueError(f"unsupported device {counts.device}")
    s, j = counts.shape
    if s % tile or j % tile:
        raise ValueError(
            f"counts block [{s}, {j}] is not a multiple of tile {tile}"
        )
    crow, ccol = _cuda_inputs(counts, classes_row, classes_col, tile)
    dev = counts.device
    row_stats = torch.zeros((s, 8), dtype=torch.int32, device=dev)
    block_hits = torch.zeros((s // tile, j // tile, 2), dtype=torch.int32,
                             device=dev)
    lib = _build.load_kernels()
    with torch.cuda.device(dev):
        err = lib.ukc_stats_epilogue_traced(
            counts.data_ptr(), j, s, crow.data_ptr(), ccol.data_ptr(), tile,
            int(i_off), int(j_off), n, threshold, w_thresh,
            row_stats.data_ptr(), block_hits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "ukc_stats_epilogue_traced")
    stats_from_counts_traced.launches += 1
    return row_stats, block_hits


stats_from_counts_traced.launches = 0
