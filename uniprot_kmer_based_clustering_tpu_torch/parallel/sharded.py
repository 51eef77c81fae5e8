"""Sharded O(N²) pair sweep: the flat row ring over a :class:`Mesh`.

Counterpart of the flat-ring part of the JAX package's
``parallel/sharded.py``. The packed matrix is row-sharded, one block of
``block = N_pad / D`` rows a device. Each device keeps its block
stationary while a moving copy goes round the ring (``ring_shift``), and
the JAX package's no-wasted-MACs schedule decides what each step
computes (:func:`ring_substeps`):

* step 0, the diagonal: tile-aligned row strips of the block against
  their column suffix (in-block upper triangle);
* steps 1..⌈(D−1)/2⌉: the whole (stationary × moving) block pair;
* for even D, the final step sees each unordered block pair on two
  devices, so the pair region is split between them (two half-block
  products each, the partner in the transposed orientation), or, where
  the half block is not a whole number of tiles, computed by the first
  device alone.

Every pair (i<j) is counted exactly once for every D, and a pair is
credited to its stationary row: ``row_stats`` equals the JAX ring's row
by row, and the tile hits fold both orientations into the upper-triangle
enumeration. The JAX device loop is SPMD; here one process walks the
devices in turn, so a device-dependent choice (which half, or nothing)
is a plain branch.

Each sub-step's counts come from ``ops.bitmul.counts_window_pair``,
word-chunked so that no shard is ever unpacked whole
(:func:`ring_word_chunk`), and its statistics from K1
(``ops.stats.stats_from_counts_into``: the CUDA kernel on a CUDA tensor,
its plain version on a CPU one), once a sub-step. K1 masks pairs by
``gi < gj < n`` from the block's global offsets, which a wrapped ring
block (moving rows below the stationary ones) would fail everywhere. As
the JAX package's Pallas ring epilogue does, every sub-step runs K1 at
fake offsets instead (:func:`fake_offsets`): ``(0, 0)`` keeps the
diagonal strips' in-block triangle, ``(0, rows)`` makes every pair of a
block pair valid, and ``n = 2^30`` lifts the bound. Rows at and past the
real ``n`` must therefore be all-zero (the pipeline pads them so, and the
staging checks it): they then add 0 to every lane and never pass a gate.
The extraction masks its survivors with the same offsets
(``ops.bitmul.survivor_mask``) and appends them at their real global
indices, transposed on a wrapped block so every pair is (min, max),
with the stream engine's append behind a cursor that stays on the
device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
    bucket_pow2,
    counts_window_pair,
    merge_row_stats_at,
    survivor_mask,
    topk_subtile_candidates,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (
    upper_triangle_tiles,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import (
    stats_from_counts_into,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
    _BIT,
    _append_block,
    _materialize_block,
    sort_compact_append,
    split_incidence_blocks,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_from_first,
    gather_to_first,
    require_flat,
    ring_shift,
    shard_rows,
    sum_to_first,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
    _new_pair_buffers,
    _sort_pairs,
)

#: ``n`` of every K1 launch and survivor mask of the ring (see module doc)
FAKE_N = 1 << 30

#: bytes of the two unpacked int8 operands of one sub-step, at most
RING_UNPACK_BYTES = 2 << 30

# lanes of one append window (its sort temporaries and each shard's
# buffer slack scale with it)
_APPEND_LANES = 1 << 22


@dataclasses.dataclass(frozen=True)
class SubStep:
    """One product of a ring step on one device: stationary rows
    ``[r0, r0 + rows)`` of the device's block against moving rows
    ``[c0, c0 + cols)`` of the block it holds, whose first pair sits at
    global ``(gi0, gj0)``; ``triangle`` keeps only the in-block pairs
    above the diagonal (step 0)."""

    r0: int
    rows: int
    c0: int
    cols: int
    gi0: int
    gj0: int
    triangle: bool


def diag_strip_bounds(nbl: int, max_strips: int = 8):
    """Tile-aligned strip bounds for the diagonal step: ~``max_strips``
    equal strips over ``nbl`` tiles (the last may be short). Returns
    [(tile_lo, tile_hi), ...]."""
    per = -(-nbl // max_strips)
    return [(r, min(nbl, r + per)) for r in range(0, nbl, per)]


def ring_substeps(s: int, d_count: int, dev: int, block: int,
                  block_tile: int, max_strips: int = 8) -> List[SubStep]:
    """The products of ring step ``s`` on device ``dev`` (the JAX
    ``_ring_substeps`` with ``_substeps_diag``, ``_substep_full`` and
    ``_substeps_split``): exact, disjoint coverage of the pairs for every
    D. At the even-D final step the first half of the ring covers rows
    [0, h) of each pair region, the partner rows [h, 2h) transposed;
    when h is not a whole number of tiles the first device takes the
    whole block pair and the partner nothing."""
    row_base = dev * block
    moving_base = (dev + s) % d_count * block
    if s == 0:
        out = []
        for t0, t1 in diag_strip_bounds(block // block_tile, max_strips):
            r0, r1 = t0 * block_tile, t1 * block_tile
            out.append(SubStep(r0, r1 - r0, r0, block - r0, row_base + r0,
                               row_base + r0, True))
        return out
    full = SubStep(0, block, 0, block, row_base, moving_base, False)
    if 2 * s != d_count:
        return [full]
    first = dev < d_count // 2
    h = block // 2
    if h % block_tile:
        return [full] if first else []
    b1 = a2 = 0 if first else h
    return [
        SubStep(0, h, b1, h, row_base, moving_base + b1, False),
        SubStep(a2, h, h, h, row_base + a2, moving_base + h, False),
    ]


def ring_schedule(d_count: int, block: int, block_tile: int):
    """Every step's sub-steps, ``[step][device] -> [SubStep, ...]``."""
    return [
        [ring_substeps(s, d_count, dev, block, block_tile)
         for dev in range(d_count)]
        for s in range(d_count // 2 + 1)
    ]


def count_substeps(d_count: int, n_pad: int, block_tile: int = 128) -> int:
    """Products of one ring pass over an ``n_pad``-row matrix on ``d_count``
    devices: the K1 launches of one sweep or fused pass."""
    sched = ring_schedule(d_count, n_pad // d_count, block_tile)
    return sum(len(subs) for step in sched for subs in step)


def fake_offsets(sub: SubStep):
    """(i_off, j_off) of a sub-step's K1 launch and survivor mask: the
    local triangle on the diagonal, every pair valid elsewhere."""
    return 0, 0 if sub.triangle else sub.rows


def ring_word_chunk(block: int, w_words: int,
                    budget: int = RING_UNPACK_BYTES) -> int:
    """Contraction chunk of the ring's products: 0 (whole) when both
    unpacked operands of the widest sub-step (2·block rows) fit
    ``budget``, else the largest divisor of ``w_words`` that does (at
    least 1)."""
    per_word = 2 * block * 32
    if w_words * per_word <= budget:
        return 0
    best = 1
    for d in range(1, w_words + 1):
        if w_words % d == 0 and d * per_word <= budget:
            best = d
    return best


def _check_shards(mesh: Mesh, words_s, block_tile: int) -> int:
    d = mesh.size
    block = words_s[0].shape[0]
    n_pad = block * d
    if any(w.shape != words_s[0].shape for w in words_s) or (
            n_pad % (d * block_tile)):
        raise ValueError(
            f"N_pad={n_pad} must be divisible by devices×block_tile="
            f"{d * block_tile}, in equal shards"
        )
    return n_pad


def _check_zero_padding(words_s, n: int) -> None:
    """Rows at and past ``n`` must be all-zero (module doc); one read of
    the padding rows."""
    block = words_s[0].shape[0]
    for d, w in enumerate(words_s):
        lo = max(0, n - d * block)
        if lo < block and bool(w[lo:].any()):
            raise ValueError(
                f"rows from n={n} on must be all-zero bitsets (shard {d})"
            )


def stage_mesh_inputs(mesh: Mesh, words, classes):
    """Stage (words, classes) onto the mesh's row layout ONCE, so a sweep
    followed by an extraction does not copy the matrix twice: shard d on
    device d, the words as int32 bits (from numpy uint32, or an int32
    tensor), the classes as int32. Staged inputs (a list or tuple of
    shards each) pass through unchanged. Returns ``(words_shards,
    classes_shards)``."""
    require_flat(mesh)
    if not isinstance(words, (list, tuple)) and not torch.is_tensor(words):
        words = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    if not isinstance(classes, (list, tuple)):
        classes = (classes.to(torch.int32) if torch.is_tensor(classes)
                   else torch.from_numpy(np.asarray(classes, np.int32)))
    return shard_rows(mesh, words), shard_rows(mesh, classes)


def stage_mesh_inputs_csr(mesh: Mesh, incidence_protein, incidence_rank,
                          n_pad: int, w_pad: int, classes):
    """Stage the row-sharded packed bitset by building each device's
    shard ON THE DEVICE from the sparse incidence lists: the dense host
    matrix is never copied. Each shard is ``ops.stream``'s accumulating
    single-bit ``index_add_`` (two ranks of one protein in one word
    add distinct powers of two), so the bits equal ``pack_bitsets``'
    rows. ``classes`` are padded to ``n_pad`` with -1. Returns
    ``(words_shards, classes_shards)``."""
    require_flat(mesh)
    d = mesh.size
    if n_pad % d:
        raise ValueError(f"n_pad={n_pad} does not divide over {d} devices")
    shard = n_pad // d
    p = np.asarray(incidence_protein, np.int32)
    r = np.asarray(incidence_rank, np.int32)
    if p.shape[0] and np.any(np.diff(p) < 0):
        order = np.argsort(p, kind="stable")
        p, r = p[order], r[order]
    rows, ranks, valid = split_incidence_blocks(p, r, shard, d)
    words_s = []
    for b, dev in enumerate(mesh.devices):
        words_s.append(_materialize_block(
            torch.from_numpy(rows[b : b + 1]).to(dev),
            torch.from_numpy(ranks[b : b + 1]).to(dev),
            torch.from_numpy(valid[b : b + 1]).to(dev),
            torch.tensor(_BIT, dtype=torch.int32, device=dev), 0,
            bs=shard, w=w_pad,
        ))
    cls = np.full(n_pad, -1, np.int32)
    ids = np.asarray(classes, np.int32)[:n_pad]
    cls[: ids.shape[0]] = ids
    return words_s, shard_rows(mesh, cls)


def _stage_inputs(mesh: Mesh, words, classes, weights, n: int,
                  block_tile: int):
    """Staged shards, the weights replicated on every device (None when
    unweighted), and the checks every wrapper makes."""
    if block_tile % 32 and any(d.type == "cuda" for d in mesh.devices):
        raise ValueError(
            f"block_tile {block_tile}: on CUDA the ring takes multiples of "
            f"32 (K1's tiles; torch._int_mm needs more than 16 rows)"
        )
    words_s, classes_s = stage_mesh_inputs(mesh, words, classes)
    _check_shards(mesh, words_s, block_tile)
    _check_zero_padding(words_s, n)
    weights_s = None
    if weights is not None:
        w0 = (weights if torch.is_tensor(weights)
              else torch.from_numpy(np.asarray(weights, np.int8)))
        w0 = w0.to(device=mesh.devices[0], dtype=torch.int8)
        if w0.shape != (words_s[0].shape[1] * 32,):
            raise ValueError("weights must be int8 [W*32]")
        weights_s = broadcast_from_first(w0, mesh)
    return words_s, classes_s, weights_s


def append_window(block: int) -> int:
    """Lanes of the ring's largest append: a compaction window is at most
    ``_APPEND_LANES`` lanes (or one row), never more than a block pair.
    Each shard's pair buffers carry this much slack past ``cap``
    (``ops.stream.sort_compact_append``)."""
    return min(block * block, max(block, _APPEND_LANES))


def _compact(bufs, keep, counts, sub: SubStep, *, block_tile: int, k: int):
    """Append one sub-step's survivors to a shard's pair buffers (JAX
    ``_compact_step``) with ``ops.stream``'s sort-based append, in
    windows of at most :func:`append_window` lanes. A wrapped sub-step
    (moving rows below the stationary ones) writes its pairs transposed,
    so every pair is (min, max). ``k`` > 0 selects up to ``k`` per
    ``block_tile``² sub-tile with ``torch.topk`` and drops a sub-tile with
    more survivors WHOLE, never truncated (the caller sees the shortfall
    against the exact tile hits); ``k`` = 0 appends the whole mask, in
    row windows."""
    transposed = sub.gj0 < sub.gi0
    rows, cols = keep.shape
    if k > 0:
        m = keep.to(torch.int32)
        qj = cols // block_tile
        sub_hits = m.reshape(-1, block_tile, qj, block_tile).sum(dim=(1, 3))
        gi, gj, cnt = topk_subtile_candidates(
            m, counts, sub.gi0, sub.gj0, tile=block_tile, k=k,
        )
        if transposed:
            gi, gj = gj, gi
        hit = ((cnt >= 0) & (sub_hits.reshape(-1, 1) <= k)).reshape(-1)
        gi, gj, cnt = gi.reshape(-1), gj.reshape(-1), cnt.reshape(-1)
        for a in range(0, hit.numel(), _APPEND_LANES):
            b = a + _APPEND_LANES
            bufs = sort_compact_append(*bufs, hit[a:b], gi[a:b], gj[a:b],
                                       cnt[a:b])
        return bufs
    step = max(1, _APPEND_LANES // cols)
    for a in range(0, rows, step):
        bufs = _append_block(*bufs, keep[a : a + step],
                             counts[a : a + step], sub.gi0 + a, sub.gj0,
                             transposed=transposed)
    return bufs


def _ring_pass(mesh: Mesh, words_s, classes_s, weights_s, *, threshold: int,
               block_tile: int, stats: bool, cap: int = 0, k: int = 0,
               cross_amr_only: bool = True):
    """One pass of the ring over staged shards. With ``stats`` each
    sub-step launches K1 (step 0 stores the diagonal strips' rows, later
    steps merge theirs) and adds its tile hits; with ``cap`` > 0 each
    sub-step also compacts its survivors into the shard's pair buffers.
    Returns (row_stats [block, 8] per shard, hits [nb, nb, 2] per shard,
    pair buffers per shard); the unused ones are None."""
    d_count = mesh.size
    block, w_words = words_s[0].shape
    nb = block * d_count // block_tile
    wc = ring_word_chunk(block, w_words)
    row_stats = hits = bufs = None
    if stats:
        row_stats = [torch.empty((block, 8), dtype=torch.int32, device=dev)
                     for dev in mesh.devices]
        hits = [torch.zeros((nb, nb, 2), dtype=torch.int32, device=dev)
                for dev in mesh.devices]
    if cap:
        bufs = [_new_pair_buffers(cap + append_window(block), dev)
                for dev in mesh.devices]
    moving_w, moving_c = list(words_s), list(classes_s)
    for s, step in enumerate(ring_schedule(d_count, block, block_tile)):
        if s:
            ring_shift(moving_w, mesh)
            ring_shift(moving_c, mesh)
        for d, subs in enumerate(step):
            for sub in subs:
                r0, r1 = sub.r0, sub.r0 + sub.rows
                c0, c1 = sub.c0, sub.c0 + sub.cols
                ca, cb = classes_s[d][r0:r1], moving_c[d][c0:c1]
                counts = counts_window_pair(
                    words_s[d][r0:r1], moving_w[d][c0:c1],
                    None if weights_s is None else weights_s[d],
                    word_chunk=wc,
                )
                i_off, j_off = fake_offsets(sub)
                if stats:
                    out = row_stats[d][r0:r1] if s == 0 else torch.empty(
                        (sub.rows, 8), dtype=torch.int32,
                        device=counts.device)
                    stats_from_counts_into(
                        counts, ca, cb, out,
                        hits[d][sub.gi0 // block_tile:,
                                sub.gj0 // block_tile:],
                        i_off=i_off, j_off=j_off, n=FAKE_N,
                        threshold=threshold, tile=block_tile,
                    )
                    if s:
                        merge_row_stats_at(row_stats[d], out, r0)
                if cap:
                    keep = survivor_mask(
                        counts, ca, cb, i_off, j_off, n=FAKE_N,
                        threshold=threshold, include_same=not cross_amr_only,
                    )
                    bufs[d] = _compact(bufs[d], keep, counts, sub,
                                       block_tile=block_tile, k=k)
                del counts
    return row_stats, hits, bufs


def _finalize_sweep(mesh: Mesh, row_stats, hits, n_pad: int,
                    block_tile: int):
    """Shard outputs → the single-chip engine format on the host:
    (row_stats int64 [N_pad, 8], tile_hits [nT, 2], (ti, tj,
    block_tile)). A block pair's hits may sit in either orientation; the
    fold adds the lower-triangle tile onto its upper-triangle twin."""
    rs = gather_to_first(row_stats, mesh).cpu().numpy().astype(np.int64)
    h = sum_to_first(hits, mesh).cpu().numpy()
    ti, tj = upper_triangle_tiles(n_pad, block_tile)
    tile_hits = h[ti, tj] + np.where((ti != tj)[:, None], h[tj, ti], 0)
    return rs, tile_hits, (ti, tj, block_tile)


def _gather_pairs(mesh: Mesh, bufs, cap: int):
    """Every shard's occupied buffer prefix, concatenated on the first
    device, sorted by (i, j) and fetched: (pairs int32 [M, 3] or None when
    the pass overflowed ``cap``, the survivor total M). One host read of
    the cursors."""
    cursors = gather_to_first([b[3].reshape(1) for b in bufs], mesh)
    counts = [int(c) for c in cursors.cpu()]
    total = sum(counts)
    if total > cap:
        return None, total
    parts = [[b[f][:c] for b, c in zip(bufs, counts)] for f in range(3)]
    arr = _sort_pairs(*(gather_to_first(p, mesh) for p in parts))
    return arr.cpu().numpy(), total


def _pairs_from_buffers(arr, m: int, cap: int,
                        expected_total: Optional[int] = None):
    """The overflow and shortfall checks of the JAX wrapper."""
    if m > cap:
        raise ValueError(
            f"sharded extraction overflow: {m} pairs > cap={cap}; "
            f"re-run with a larger cap"
        )
    if expected_total is not None and m != expected_total:
        raise ValueError(
            f"sharded extraction found {m} pairs, sweep stats promised "
            f"{expected_total} (tile_cap too small?)"
        )
    return arr


def sharded_pairwise_similarity(
    mesh: Mesh,
    words,
    classes,
    n: int,
    threshold: int,
    block_tile: int = 128,
    weights=None,
):
    """The ring sweep on a mesh: (row_stats np[N_pad, 8] int64, tile_hits
    np[nT, 2], tiles) in the single-chip engine format. ``words`` is the
    packed [N_pad, W] matrix (numpy or tensor) or staged shards
    (:func:`stage_mesh_inputs`); ``weights`` (int8 [W*32]) give the
    BLOSUM-weighted score. The statistics are K1's on every sub-step
    (the JAX package's ``stats_engine`` choices are bit-identical and not
    carried)."""
    words_s, classes_s, weights_s = _stage_inputs(
        mesh, words, classes, weights, n, block_tile)
    n_pad = _check_shards(mesh, words_s, block_tile)
    row_stats, hits, _ = _ring_pass(
        mesh, words_s, classes_s, weights_s, threshold=threshold,
        block_tile=block_tile, stats=True,
    )
    return _finalize_sweep(mesh, row_stats, hits, n_pad, block_tile)


def sharded_extract_pairs(
    mesh: Mesh,
    words,
    classes,
    n: int,
    threshold: int,
    block_tile: int = 128,
    weights=None,
    cross_amr_only: bool = True,
    cap: int = 1 << 20,
    tile_cap: Optional[int] = None,
    expected_total: Optional[int] = None,
):
    """Mesh-parallel exact pair extraction: the ring schedule once more,
    each device compacting its sub-steps' survivors into its own pair
    buffers (so no device ever holds the whole matrix), gathered on the
    first device and sorted by (i, j). Returns int32 [M, 3], equal to the
    single-chip extractor's list for every D.

    ``cap`` bounds the GLOBAL survivor count; more raises "overflow".
    ``tile_cap`` (the densest tile's survivors, from the sweep's tile
    hits) selects per-sub-tile ``torch.topk`` compaction at a width
    bucketed from it: a sub-tile over that width is dropped whole, and
    ``expected_total`` (the sweep's exact total) turns the shortfall into
    a raise. None appends the whole mask (what the pipeline runs)."""
    k = 0
    if tile_cap is not None:
        k = bucket_pow2(tile_cap, 128, block_tile * block_tile)
    words_s, classes_s, weights_s = _stage_inputs(
        mesh, words, classes, weights, n, block_tile)
    _, _, bufs = _ring_pass(
        mesh, words_s, classes_s, weights_s, threshold=threshold,
        block_tile=block_tile, stats=False, cap=cap, k=k,
        cross_amr_only=cross_amr_only,
    )
    arr, m = _gather_pairs(mesh, bufs, cap)
    return _pairs_from_buffers(arr, m, cap, expected_total)


def sharded_pairwise_fused(
    mesh: Mesh,
    words,
    classes,
    n: int,
    threshold: int,
    block_tile: int = 128,
    weights=None,
    cross_amr_only: bool = True,
    cap: int = 1 << 20,
    k: Optional[int] = None,
):
    """One fused pass → (row_stats, tile_hits, tiles, pairs): each
    sub-step's counts feed K1 and the compaction, so the ring runs once
    instead of twice. Statistics as :func:`sharded_pairwise_similarity`,
    pairs as :func:`sharded_extract_pairs`. When a capacity guess misses
    (a sub-tile over ``k`` survivors, or more than ``cap`` in all), the
    statistics stand and the pairs are extracted again by
    :func:`sharded_extract_pairs`, sized from this pass's exact tile hits.
    ``k`` defaults to 0 off the TPU, as in the JAX package (whole-mask
    compaction: only ``cap`` can overflow)."""
    k = 0 if k is None else min(k, block_tile * block_tile)
    words_s, classes_s, weights_s = _stage_inputs(
        mesh, words, classes, weights, n, block_tile)
    n_pad = _check_shards(mesh, words_s, block_tile)
    row_stats, hits, bufs = _ring_pass(
        mesh, words_s, classes_s, weights_s, threshold=threshold,
        block_tile=block_tile, stats=True, cap=cap, k=k,
        cross_amr_only=cross_amr_only,
    )
    row_stats, tile_hits, tiles = _finalize_sweep(
        mesh, row_stats, hits, n_pad, block_tile)
    arr, m = _gather_pairs(mesh, bufs, cap)
    del bufs
    per_tile = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        per_tile = per_tile + tile_hits[:, 1]
    total = int(per_tile.sum())
    if arr is not None and m == total:
        return row_stats, tile_hits, tiles, arr
    pairs = sharded_extract_pairs(
        mesh, words_s, classes_s, n, threshold, block_tile=block_tile,
        weights=weights, cross_amr_only=cross_amr_only,
        cap=max(1 << 18, total), tile_cap=None, expected_total=total,
    )
    return row_stats, tile_hits, tiles, pairs


def doc_freq_psum(mesh: Mesh, codes, valid, k: int):
    """Dense doc-freq for k=5 over row-sharded window codes: a bincount
    per shard (``kmers.index.doc_freq_dense_device``), summed on the first
    device. ``codes``/``valid`` are [N, L] (numpy or tensors, N divisible
    by the mesh size) or shards. Returns int32 [21^k] on the first
    device."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers.index import (
        doc_freq_dense_device,
    )

    require_flat(mesh)
    parts = [
        doc_freq_dense_device(c, v, k)
        for c, v in zip(shard_rows(mesh, codes), shard_rows(mesh, valid))
    ]
    return sum_to_first(parts, mesh)
