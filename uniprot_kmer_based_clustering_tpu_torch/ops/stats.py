"""Statistics epilogues over a materialized counts block (K1, K2).

Counterpart of ``uniprot_kmer_based_clustering_tpu/ops/stats_pallas.py``.
Both reduce an int32 counts block [S, J] at global offset (i_off, j_off),
over its pairs gi < gj < n, to

  row stats int32 [S, 8] — ops.popcount.ROW_STAT_NAMES per stationary row
  tile hits int32 (cross, same) — #pairs over threshold per tile

The sweeps call the accumulate-into entries, which write into the
sweep's own buffers:

- :func:`stats_from_counts_into` (K1, once per strip of the strip
  schedule) stores the strip's rows of ``row_stats`` and adds its tile
  hits into a ``block_hits`` view; handed pair buffers, it also appends
  the block's survivors (:func:`survivor_mask`) to them behind their
  device cursor;
- :func:`stats_from_counts_traced_into` (K2, once per step of the
  block-pair scan) merges the block's rows into the scan's accumulators
  (lanes %4==3 by max, the rest by sum) and adds its hits.

On a CUDA tensor each launches the hand-written kernel of
``csrc/stats_epilogue.cu`` once (counted in its ``.launches``), with no
host copy, no allocation and no synchronisation; on a CPU tensor it runs
its plain version (``..._reference``), built from
:func:`pair_block_stats`. There is no other route.

:func:`stats_from_counts` and :func:`stats_from_counts_traced` keep the
JAX package's contracts (fresh outputs; K1's tile hits listed for the
tiles not wholly below the pair diagonal) as thin layers over the two
entries. The plain epilogue primitives :func:`stack_row_stats`,
:func:`pair_block_stats`, :func:`merge_row_stats_at` and
:func:`survivor_mask` (``ops/bitmul.py`` in the JAX package) live here
because the references are built from them; ``ops.bitmul`` re-exports
them.
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
    keep = tj >= first_kept_tile(ti, i_off, j_off, tile)
    return ti[keep].ravel(), tj[keep].ravel()


def first_kept_tile(ti, i_off: int, j_off: int, tile: int):
    """The first tile column that tile row ``ti`` keeps (an int, array or
    tensor): the least tj with j_off + (tj+1)·tile − 1 > i_off + ti·tile,
    so that the tile holds a pair gj > gi; ≤ 0 when the row keeps every
    tile."""
    return (i_off - j_off + ti * tile + 1) // tile


def kept_tile_mask(nti: int, ntj: int, i_off: int, j_off: int, tile: int,
                   device=None):
    """bool [nti, ntj]: the tiles :func:`stats_tiles` keeps, from device
    ``arange``s."""
    ti = torch.arange(nti, device=device)[:, None]
    tj = torch.arange(ntj, device=device)[None, :]
    return tj >= first_kept_tile(ti, i_off, j_off, tile)


def _check_block(s: int, j: int, tile: int):
    if s % tile or j % tile:
        raise ValueError(
            f"counts block [{s}, {j}] is not a multiple of tile {tile}"
        )


def _check_kept(s: int, j: int, i_off: int, j_off: int, tile: int):
    """Refuse blocks where a tile row keeps no tile (its row_stats would
    never be visited by the tile walk). The last tile row keeps the
    fewest, so it alone is checked."""
    _check_block(s, j, tile)
    if s and max(first_kept_tile(s // tile - 1, i_off, j_off, tile),
                 0) >= j // tile:
        raise ValueError(
            "stats_from_counts: some tile rows keep no tile (block lies "
            "entirely below the pair diagonal) — their row_stats would "
            "be uninitialized; pass diagonal-or-above blocks only"
        )


def _kept_tiles(s: int, j: int, i_off: int, j_off: int, tile: int):
    """:func:`stats_tiles` after :func:`_check_kept`."""
    _check_kept(s, j, i_off, j_off, tile)
    return stats_tiles(s, j, i_off, j_off, tile)


def _kept_hits(block_hits, i_off: int, j_off: int, tile: int, count: int):
    """The hits of the kept tiles, row-major, from a dense [nti, ntj, 2]
    block_hits: a stable sort of the kept mask (``count`` is known on the
    host), so no index crosses from the host and nothing synchronises."""
    nti, ntj = block_hits.shape[:2]
    keep = kept_tile_mask(nti, ntj, i_off, j_off, tile, block_hits.device)
    order = torch.argsort((~keep).flatten().to(torch.int32), stable=True)
    return block_hits.reshape(-1, 2)[order[:count]]


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


def survivor_mask(counts, ca, cb, i0: int, j0: int, *, n: int,
                  threshold: int, include_same: bool):
    """The survivor mask of one counts block at global offset (i0, j0):
    valid (gi < gj < n) pairs over threshold, cross-class only unless
    ``include_same``. It equals the plain epilogue's ``over_c`` (or
    ``over_c | over_s``): the fused scan computes it from the counts under
    either epilogue, K1 appends what it marks, and two-pass extraction
    masks its recomputed tiles with it."""
    dev = counts.device
    gi = i0 + torch.arange(counts.shape[0], dtype=torch.int64, device=dev)
    gj = j0 + torch.arange(counts.shape[1], dtype=torch.int64, device=dev)
    mask = (gi[:, None] < gj[None, :]) & (gj[None, :] < n)
    mask &= counts > threshold
    if not include_same:
        mask &= ca[:, None] != cb[None, :]
    return mask


def append_survivors_reference(counts, classes_row, classes_col, pairs, *,
                               i_off: int, j_off: int, n: int,
                               threshold: int, include_same: bool,
                               pair_origin=None, transposed: bool = False):
    """Plain form of K1's survivor append: every survivor of
    :func:`survivor_mask` at the mask offsets (i_off, j_off, n) into
    ``pairs`` = (bi, bj, bc, cursor; the format of ``ops.pairlist``), at
    the slots from the cursor on; slots past the buffers' length are not
    stored, but the cursor advances by every survivor, as the kernel's
    does. The survivor at local (r, c) is stored as (pi0 + r, pj0 + c,
    count) from ``pair_origin`` = (pi0, pj0) (None: the offsets), as
    (pj0 + c, pi0 + r, count) when ``transposed``. Returns ``pairs``."""
    bi, bj, bc, cursor = pairs
    pi0, pj0 = (i_off, j_off) if pair_origin is None else pair_origin
    dev = counts.device
    ca = torch.as_tensor(classes_row, dtype=torch.int32, device=dev)
    cb = torch.as_tensor(classes_col, dtype=torch.int32, device=dev)
    r, c = torch.nonzero(
        survivor_mask(counts, ca, cb, i_off, j_off, n=n, threshold=threshold,
                      include_same=include_same),
        as_tuple=True,
    )
    start = int(cursor)
    room = max(0, min(r.numel(), bi.numel() - start))
    r, c, found = r[:room], c[:room], r.numel()
    gi, gj = pi0 + r, pj0 + c
    if transposed:
        gi, gj = gj, gi
    bi[start : start + room] = gi
    bj[start : start + room] = gj
    bc[start : start + room] = counts[r, c]
    cursor += found
    return pairs


def stats_from_counts_traced_reference(counts, classes_row, classes_col,
                                       i_off: int, j_off: int, *, n: int,
                                       threshold: int, w_thresh: int = 1,
                                       tile: int = 512):
    """Plain-torch K2: :func:`pair_block_stats` over the whole block with
    the max lanes clamped at 0, as the Pallas walk clamps them (its first
    tile of each row starts from 0). Returns (row_stats int32 [S, 8],
    block_hits int32 [S/tile, J/tile, 2])."""
    s, j = counts.shape
    _check_block(s, j, tile)
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


def stats_from_counts_reference(counts, classes_row, classes_col, *,
                                i_off: int, j_off: int, n: int,
                                threshold: int, w_thresh: int = 1,
                                tile: int = 512):
    """Plain-torch K1: the same outputs as the tile walk, on any device.

    Tiles wholly below the diagonal are all masked, so the whole block
    is reduced at once (:func:`stats_from_counts_traced_reference`) and
    the kept tiles' hits are listed."""
    s, j = counts.shape
    ti, tj = _kept_tiles(s, j, i_off, j_off, tile)
    rs, bh = stats_from_counts_traced_reference(
        counts, classes_row, classes_col, i_off, j_off, n=n,
        threshold=threshold, w_thresh=w_thresh, tile=tile,
    )
    return rs, _kept_hits(bh, i_off, j_off, tile, len(ti)), (ti, tj, tile)


def stats_from_counts_into_reference(counts, classes_row, classes_col,
                                     row_stats, block_hits, *, i_off: int,
                                     j_off: int, n: int, threshold: int,
                                     w_thresh: int = 1, tile: int = 512,
                                     pairs=None, include_same: bool = False,
                                     pair_origin=None,
                                     transposed: bool = False):
    """Plain K1 into a strip: ``row_stats`` [S, 8] ← the block's row
    stats; ``block_hits[:S/tile, :J/tile] +=`` its tile hits (the tiles
    wholly below the diagonal add 0); with ``pairs`` its survivors
    appended by :func:`append_survivors_reference` at ``pair_origin``,
    ``transposed``. Returns (row_stats, block_hits)."""
    rs, bh = stats_from_counts_traced_reference(
        counts, classes_row, classes_col, i_off, j_off, n=n,
        threshold=threshold, w_thresh=w_thresh, tile=tile,
    )
    row_stats.copy_(rs)
    block_hits[: bh.shape[0], : bh.shape[1]] += bh
    if pairs is not None:
        append_survivors_reference(
            counts, classes_row, classes_col, pairs, i_off=i_off,
            j_off=j_off, n=n, threshold=threshold, include_same=include_same,
            pair_origin=pair_origin, transposed=transposed,
        )
    return row_stats, block_hits


def stats_from_counts_traced_into_reference(counts, classes_row,
                                            classes_col, row_stats,
                                            block_hits, i_off: int,
                                            j_off: int, *, n: int,
                                            threshold: int,
                                            w_thresh: int = 1,
                                            tile: int = 512):
    """Plain K2 into the scan's accumulators: the block's row stats merged
    into ``row_stats`` [S, 8] by :func:`merge_row_stats_at`, its hits
    added into ``block_hits[:S/tile, :J/tile]``. Returns (row_stats,
    block_hits)."""
    rs, bh = stats_from_counts_traced_reference(
        counts, classes_row, classes_col, i_off, j_off, n=n,
        threshold=threshold, w_thresh=w_thresh, tile=tile,
    )
    merge_row_stats_at(row_stats, rs, 0)
    block_hits[: bh.shape[0], : bh.shape[1]] += bh
    return row_stats, block_hits


def _check_outputs(counts, row_stats, block_hits, tile: int):
    """The accumulators an entry writes: row_stats a contiguous int32
    [S, 8], block_hits an int32 view [≥ S/tile, ≥ J/tile, 2] with strides
    (*, 2, 1), both on the counts' device."""
    s, j = counts.shape
    dev = counts.device
    if (row_stats.dtype != torch.int32 or row_stats.device != dev
            or tuple(row_stats.shape) != (s, 8)
            or row_stats.stride() != (8, 1)):
        raise ValueError(
            f"row_stats must be a contiguous int32 [{s}, 8] tensor on "
            f"{dev}"
        )
    if (block_hits.dtype != torch.int32 or block_hits.device != dev
            or block_hits.dim() != 3 or block_hits.shape[0] < s // tile
            or block_hits.shape[1] < j // tile or block_hits.shape[2] != 2
            or block_hits.stride()[1:] != (2, 1)):
        raise ValueError(
            f"block_hits must be an int32 [>= {s // tile}, >= {j // tile}, "
            f"2] view with strides (*, 2, 1) on {dev}"
        )


def _check_pairs(counts, pairs):
    """Pair buffers as K1 appends to them (``ops.pairlist.
    new_pair_buffers``): three contiguous int32 [cap] and an int64
    scalar cursor, on the counts' device."""
    dev = counts.device
    *bufs, cursor = pairs
    cap = bufs[0].shape
    if (len(bufs) != 3 or cursor.dtype != torch.int64 or cursor.dim()
            or cursor.device != dev
            or any(b.dtype != torch.int32 or b.dim() != 1 or b.shape != cap
                   or not b.is_contiguous() or b.device != dev
                   for b in bufs)):
        raise ValueError(
            f"pairs must be three contiguous int32 [cap] buffers and an "
            f"int64 scalar cursor on {dev}"
        )


def _cuda_inputs(counts, classes_row, classes_col, tile: int):
    """Check what the CUDA epilogue takes; the class vectors as
    contiguous int32 on the counts' device."""
    if counts.dtype != torch.int32 or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous int32 tensor")
    if tile % 32:
        raise ValueError(
            f"the CUDA epilogue takes tiles that are multiples of 32, got "
            f"{tile}"
        )
    dev = counts.device
    crow = torch.as_tensor(classes_row, dtype=torch.int32, device=dev)
    ccol = torch.as_tensor(classes_col, dtype=torch.int32, device=dev)
    if crow.shape != counts.shape[:1] or ccol.shape != counts.shape[1:]:
        raise ValueError("class vectors must match the counts block")
    return crow.contiguous(), ccol.contiguous()


def _launch(name: str, counts, classes_row, classes_col, row_stats,
            block_hits, i_off: int, j_off: int, n: int, threshold: int,
            w_thresh: int, tile: int, append=()):
    """One launch of a ``csrc/stats_epilogue.cu`` entry on the current
    stream; ``append`` are the append entry's extra arguments."""
    crow, ccol = _cuda_inputs(counts, classes_row, classes_col, tile)
    s, j = counts.shape
    dev = counts.device
    lib = _build.load_kernels()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            counts.data_ptr(), j, s, j, crow.data_ptr(), ccol.data_ptr(),
            tile, int(i_off), int(j_off), int(n), int(threshold),
            int(w_thresh), row_stats.data_ptr(), block_hits.data_ptr(),
            block_hits.stride(0), *append,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, name)


def _device_route(counts):
    """True for the CUDA kernel, False for the plain version (CPU)."""
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {counts.device}")
    return counts.device.type == "cuda"


def stats_from_counts_into(counts, classes_row, classes_col, row_stats,
                           block_hits, *, i_off: int, j_off: int, n: int,
                           threshold: int, w_thresh: int = 1,
                           tile: int = 512, pairs=None,
                           include_same: bool = False, pair_origin=None,
                           transposed: bool = False):
    """K1 into a strip: the statistics of the counts block [S, J] at
    global offset (i_off, j_off), written into the caller's buffers.

    ``row_stats`` (contiguous int32 [S, 8], e.g. the strip's rows of the
    sweep's [N_pad, 8]) is overwritten: the launch owns those rows, so no
    zero-fill is needed. The tile hits are ADDED into ``block_hits``, an
    int32 view [≥ S/tile, ≥ J/tile, 2] with strides (*, 2, 1) (e.g. the
    sweep's dense [nb, nb, 2] from tile (i_off/tile, j_off/tile) on).
    With ``pairs`` (bi, bj, bc, cursor: ``ops.pairlist.
    new_pair_buffers``) the block's survivors (:func:`survivor_mask`,
    same-class ones too with ``include_same``) are appended behind the
    cursor, which advances by each of them even past the buffers'
    capacity. The offsets decide only which lanes survive; the survivor
    at local (r, c) is stored as (pi0 + r, pj0 + c, count) from
    ``pair_origin`` = (pi0, pj0) (None: the offsets, as the strip sweep
    stores), or as (pj0 + c, pi0 + r, count) when ``transposed`` (a ring
    sub-step, launched at fake offsets, stores at its block pair's real
    position, transposed where its moving rows lie below its stationary
    ones). Raises
    ``ValueError`` where a tile row keeps no tile, as the tile walk does.
    CPU tensors take :func:`stats_from_counts_into_reference`; CUDA
    tensors launch the kernel, counted in
    ``stats_from_counts_into.launches``. Returns (row_stats, block_hits).
    """
    cuda = _device_route(counts)
    _check_kept(*counts.shape, i_off, j_off, tile)
    _check_outputs(counts, row_stats, block_hits, tile)
    if pairs is not None:
        _check_pairs(counts, pairs)
    kw = dict(n=n, threshold=threshold, w_thresh=w_thresh, tile=tile)
    if not cuda:
        return stats_from_counts_into_reference(
            counts, classes_row, classes_col, row_stats, block_hits,
            i_off=i_off, j_off=j_off, pairs=pairs,
            include_same=include_same, pair_origin=pair_origin,
            transposed=transposed, **kw,
        )
    if pairs is None:
        _launch("ukc_stats_epilogue_into", counts, classes_row,
                classes_col, row_stats, block_hits, i_off, j_off, **kw)
    else:
        pi0, pj0 = (i_off, j_off) if pair_origin is None else pair_origin
        append = (int(include_same), *(t.data_ptr() for t in pairs),
                  pairs[0].numel(), int(pi0), int(pj0), int(transposed))
        _launch("ukc_stats_epilogue_append_into", counts, classes_row,
                classes_col, row_stats, block_hits, i_off, j_off,
                append=append, **kw)
    stats_from_counts_into.launches += 1
    return row_stats, block_hits


stats_from_counts_into.launches = 0


def stats_from_counts_traced_into(counts, classes_row, classes_col,
                                  row_stats, block_hits, i_off: int,
                                  j_off: int, *, n: int, threshold: int,
                                  w_thresh: int = 1, tile: int = 512):
    """K2 into the scan's accumulators: the statistics of EVERY tile of
    the counts block [S, J] at global offset (i_off, j_off), merged into
    the caller's buffers.

    ``row_stats`` (contiguous int32 [S, 8], e.g. rows i0.. of the scan's
    [N_pad, 8]) takes the block's rows by :func:`merge_row_stats_at`
    (sums added, lanes 3 and 7 by max; from zeroed accumulators that is
    the Pallas walk's clamp at 0; the kernel merges a max lane only where
    the block's is positive, so those lanes of ``row_stats`` must hold
    ≥ 0, as the scan's do); the tile hits are ADDED into
    ``block_hits`` as in :func:`stats_from_counts_into`. A block wholly
    below the pair diagonal adds nothing. CPU tensors take
    :func:`stats_from_counts_traced_into_reference`; CUDA tensors launch
    the kernel, counted in ``stats_from_counts_traced_into.launches``.
    Returns (row_stats, block_hits).
    """
    cuda = _device_route(counts)
    _check_block(*counts.shape, tile)
    _check_outputs(counts, row_stats, block_hits, tile)
    kw = dict(n=n, threshold=threshold, w_thresh=w_thresh, tile=tile)
    if not cuda:
        return stats_from_counts_traced_into_reference(
            counts, classes_row, classes_col, row_stats, block_hits, i_off,
            j_off, **kw,
        )
    _launch("ukc_stats_epilogue_traced_into", counts, classes_row,
            classes_col, row_stats, block_hits, i_off, j_off, **kw)
    stats_from_counts_traced_into.launches += 1
    return row_stats, block_hits


stats_from_counts_traced_into.launches = 0


def stats_from_counts(counts, classes_row, classes_col, *, i_off: int,
                      j_off: int, n: int, threshold: int, w_thresh: int = 1,
                      tile: int = 512):
    """Tile-walk statistics over a counts block at global offset
    (i_off, j_off), the JAX contract: :func:`stats_from_counts_into` on
    fresh outputs.

    ``counts`` is int32 [S, J]; ``classes_row``/``classes_col`` are int32
    [S]/[J]. Tiles entirely below the pair diagonal are skipped; partial
    diagonal tiles are masked per element. Returns (row_stats int32
    [S, 8], tile_hits int32 [nT, 2], tiles (ti, tj, tile) in local tile
    coordinates).
    """
    s, j = counts.shape
    _device_route(counts)
    ti, tj = _kept_tiles(s, j, i_off, j_off, tile)
    dev = counts.device
    row_stats = torch.empty((s, 8), dtype=torch.int32, device=dev)
    block_hits = torch.zeros((s // tile, j // tile, 2), dtype=torch.int32,
                             device=dev)
    stats_from_counts_into(
        counts, classes_row, classes_col, row_stats, block_hits,
        i_off=i_off, j_off=j_off, n=n, threshold=threshold,
        w_thresh=w_thresh, tile=tile,
    )
    hits = _kept_hits(block_hits, i_off, j_off, tile, len(ti))
    return row_stats, hits, (ti, tj, tile)


def stats_from_counts_traced(counts, classes_row, classes_col, i_off: int,
                             j_off: int, *, n: int, threshold: int,
                             w_thresh: int = 1, tile: int = 512):
    """Statistics over EVERY tile of a counts block at global offset
    (i_off, j_off), the JAX contract of the block-pair scan's epilogue:
    :func:`stats_from_counts_traced_into` on zeroed outputs.

    The JAX package traces the offsets inside one compiled ``lax.scan``;
    here they are plain arguments of each launch. Tiles wholly below the
    pair diagonal mask to zero. Returns (row_stats int32 [S, 8],
    block_hits int32 [S/tile, J/tile, 2]).
    """
    s, j = counts.shape
    _device_route(counts)
    _check_block(s, j, tile)
    dev = counts.device
    row_stats = torch.zeros((s, 8), dtype=torch.int32, device=dev)
    block_hits = torch.zeros((s // tile, j // tile, 2), dtype=torch.int32,
                             device=dev)
    return stats_from_counts_traced_into(
        counts, classes_row, classes_col, row_stats, block_hits, i_off,
        j_off, n=n, threshold=threshold, w_thresh=w_thresh, tile=tile,
    )
