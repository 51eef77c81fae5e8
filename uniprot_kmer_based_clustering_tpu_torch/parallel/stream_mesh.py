"""The out-of-core sweep on a flat mesh: the stream engine over D shards.

Counterpart of the JAX package's ``parallel/stream_mesh.py``. Every mesh
layout of ``parallel/sharded.py`` keeps each shard's dense rows resident,
and the one-pass stream engine (``ops/stream.py``) runs on one device.
This module runs the stream engine's stationary-group / moving-block
schedule on every shard of a flat mesh at once, over disjoint sets of
block pairs:

* the CSR incidence lists, split per ``bs``-row block
  (``ops.stream.split_incidence_blocks``), and the classes, weights and
  bit table are staged once on every shard, each shard its own fresh
  copy (the dense matrix never exists anywhere);
* each stationary group's stack is built cooperatively: shard k
  materializes ``gpd`` blocks from its staging with the accumulating
  single-bit scatter (``ops.stream._materialize_block``; JAX's stack
  build uses a ``unique_indices=True`` scatter that two ranks of one row
  in one word would break), and :func:`parallel.mesh.all_gather` gives every
  shard the whole ``[gpd·D, bs, W]`` stack;
* the group's moving blocks are split into D contiguous segments
  balanced by step weight (:func:`_segment_bounds`: block ``jb`` costs
  ``min(g, jb − s0 + 1)`` steps); each shard runs its segment in chunks
  of ``scan_chunk`` moving blocks through ``ops.stream._step_compact_body``
  — the single-device one-pass engine's step, so K2 is the epilogue of
  every step on every shard, and the two engines cannot drift — into its
  own statistics accumulators and pair buffers;
* at the end the row statistics merge on the first shard by the lane
  rule (:func:`parallel.mesh.lane_merge_to_first`), the block hits sum
  and the cursors gather, in one fetch; each shard's live pair prefix is
  gathered to the first shard and sorted there once.

The shards are issued round by round (each shard's chunk of a round, then
the next round), with one in-flight event a shard a round and no host
synchronisation inside the loop, so shards on distinct cards overlap.
Shards that share a card queue on one stream: their time is the sum.

Integer sums and maxima are associative, so any partition gives the same
statistics, and the final (i, j) sort makes the pair list independent of
it: the result equals the single-device engine's for every D.

Across processes (a mesh over a ``torch.distributed`` world) each rank
stages, builds and sweeps only its own shards, the stack's all-gather
and the final merges cross ranks, and every rank returns the same
result; the K2 launches summed over the ranks equal the one-process
mesh's steps. A resumed run reads the same snapshot on every rank; only
the first shard's rank seeds its accumulators with it, writes the
snapshots (the ``CheckpointStore`` writes on rank 0 only, and every rank
waits for the write at each group boundary) and runs a redo, whose
pairs it broadcasts.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (
    upper_triangle_tiles,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
    _BIT,
    CSRBlockSource,
    _materialize_block,
    _resident_blocking,
    _step_compact_body,
    _to_host,
    _Window,
    auto_stream_block,
    extract_pairs_stream_grouped,
    split_incidence_blocks,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (
    Mesh,
    _fresh_copy,
    all_gather,
    barrier,
    broadcast_array,
    gather_to_first,
    lane_merge_to_first,
    mesh_layout,
    sum_to_first,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
    _fetch_sorted_pairs,
    _new_pair_buffers,
    _vcap_bucket,
    pairs_as_array,
)

#: Phase breakdown of the most recent :func:`sweep_extract_stream_mesh`
#: call: the one-pass engine's trace keys plus the mesh size ``d``, the
#: stack's blocks a shard ``gpd`` and the step balance of the partition.
last_mesh_trace: dict = {}


def _segment_bounds(weights: np.ndarray, d: int) -> np.ndarray:
    """Split a weighted sequence into ``d`` contiguous segments of
    near-equal total weight (the moving-block partition of one
    stationary group). Returns ``d+1`` monotone cut indices; segments
    may be empty when there are fewer items than devices."""
    cum = np.concatenate([[0], np.cumsum(weights, dtype=np.int64)])
    targets = cum[-1] * np.arange(1, d, dtype=np.int64) // d
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [len(weights)]])
    return np.maximum.accumulate(bounds)


@dataclasses.dataclass
class _Shard:
    """One shard's staging (fresh tensors on its device) and state."""

    device: torch.device
    rows: torch.Tensor
    ranks: torch.Tensor
    valid: torch.Tensor
    bit: torch.Tensor
    cls: list  # the classes split into bs-row blocks
    wts: Optional[torch.Tensor]
    state: tuple = ()  # (row_stats, block_hits, gbi, gbj, gbc, cursor)

    def block(self, b: int, bs: int, w: int):
        return _materialize_block(self.rows, self.ranks, self.valid,
                                  self.bit, b, bs=bs, w=w)


def _stage(mesh: Mesh, block_source: CSRBlockSource, classes, weights,
           bs: int, nbk: int):
    """The replicated staging: the per-block incidence split, once, and a
    fresh copy of it, the bit table, the classes and the weights on every
    local shard's device (None at the other ranks' shards)."""
    split = split_incidence_blocks(block_source._p, block_source._r, bs,
                                   nbk)
    host = [torch.from_numpy(a) for a in split]
    cls_h = torch.from_numpy(np.ascontiguousarray(classes))
    bit_h = torch.tensor(_BIT, dtype=torch.int32)
    w_h = (None if weights is None else torch.from_numpy(
        np.ascontiguousarray(weights, dtype=np.int8)))
    shards: list = [None] * mesh.size
    for k in mesh.local:
        dev = mesh.devices[k]
        rows, ranks, valid = (_fresh_copy(a, dev) for a in host)
        shards[k] = _Shard(
            device=dev, rows=rows, ranks=ranks, valid=valid,
            bit=_fresh_copy(bit_h, dev),
            cls=list(_fresh_copy(cls_h, dev).split(bs)),
            wts=None if w_h is None else _fresh_copy(w_h, dev),
        )
    return shards


def sweep_extract_stream_mesh(
    mesh: Mesh,
    classes: np.ndarray,
    n: int,
    threshold: int,
    *,
    block_source: CSRBlockSource,
    bs: Optional[int] = None,
    block: int = 512,
    weights: Optional[np.ndarray] = None,
    w_thresh: int = 1,
    word_chunk: Optional[int] = None,
    hbm_budget_bytes: int = 13 << 30,
    inflight: int = 4,
    cross_amr_only: bool = True,
    cap: Optional[int] = None,
    max_group: Optional[int] = None,
    scan_chunk: int = 8,
    pair_format: str = "arr3",
    checkpoint_store=None,
    checkpoint_key: Optional[str] = None,
    fail_after_groups: Optional[int] = None,
):
    """One-pass out-of-core sweep and exact pair extraction over a flat
    ``mesh`` (``parallel.make_mesh``): the sharded
    ``ops.stream.sweep_extract_stream``.

    ``hbm_budget_bytes`` is per device, and every blocking choice (``bs``,
    ``g``, ``word_chunk``, the pair capacity) is the JAX package's for the
    same inputs. ``cap`` bounds each shard's pair buffers (an explicit cap
    is honoured to 128 rows, so that the capacity miss is reachable); when
    a shard's exact survivor count exceeds it, the pair list is redone by
    ``ops.stream.extract_pairs_stream_grouped`` on the first shard's
    device. ``block_source`` supplies the host incidence lists; its own
    single-device staging is not used.

    Returns ``(row_stats int64 [N_pad', 8], tile_hits int32 [nT, 2],
    (ti, tj, block), pairs)`` with ``pairs`` int32 [M, 3], or packed int64
    [M] under ``pair_format="packed"`` when it fits (``ndim`` tells).

    **Group-boundary checkpoints** (``checkpoint_store`` plus
    ``checkpoint_key``): the single-device engine's snapshot — geometry,
    completed groups, the cumulative merged statistics — at every
    completed group. A resumed run seeds the first shard's accumulators
    with the restored statistics, skips the completed groups and
    recovers their pairs from the restored tile hits through the grouped
    extractor on the first shard's device (``redo_s`` of the trace): it
    recomputes the restored groups' block pairs that hold a hit, so where
    nearly every tile hits it costs about what those groups did, and a
    resume saves little; where hits are sparse it saves most of them. Snapshots resume across the two packages and across the
    single-device and mesh engines wherever ``(bs, g)`` agree.
    ``fail_after_groups`` is the fault-injection seam; a completed run
    removes its snapshot.
    """
    if mesh_layout(mesh) != "flat":
        raise AssertionError(
            "stream-mesh composition runs on a flat mesh (one axis); "
            f"got {mesh.axis_names}"
        )
    d = mesh.size
    rows0, w_words = block_source.n_rows, block_source.w_words
    classes = np.asarray(classes, np.int32)
    if classes.shape[0] < rows0:
        classes = np.concatenate(
            [classes, np.full(rows0 - classes.shape[0], -1, np.int32)]
        )

    if cap is None:
        cap_dev = max(1, min(int(hbm_budget_bytes // 8 // 12),
                             n * (n - 1) // 2))
        vcap = _vcap_bucket(cap_dev)
    else:
        vcap = max(128, -(-int(cap) // 128) * 128)
    slack = int(bs) ** 2 if bs else 4096 * 4096
    src_bytes = 18 * max(1, block_source._p.shape[0])
    budget = max(1 << 28,
                 hbm_budget_bytes - 3 * (vcap + slack) * 4 - src_bytes)
    if bs is None:
        bs = auto_stream_block(rows0, w_words, block, budget)
    if bs % block:
        raise ValueError("stream block must be a multiple of the tile")
    n_pad = -(-rows0 // bs) * bs
    if classes.shape[0] < n_pad:
        classes = np.concatenate(
            [classes, np.full(n_pad - classes.shape[0], -1, np.int32)]
        )
    nb = n_pad // block
    nbk = n_pad // bs

    block_bytes = bs * w_words * 4
    fixed = (
        n_pad * 8 * 4
        + nb * nb * 2 * 4
        + (2 * inflight + 1) * (block_bytes + 4 * bs * bs * 4)
        + n_pad * 4
    )
    avail = max(block_bytes, budget - fixed)
    word_chunk, g = _resident_blocking(bs, w_words, nbk, avail, word_chunk,
                                       max_group)
    if g > d:
        # a multiple of D, so the cooperative stack holds exactly g blocks
        g = (g // d) * d
    # blocks each shard builds; the stack holds gpd·D ≥ g (at least D
    # blocks even where the budget affords fewer)
    gpd = -(-g // d)

    t0 = time.perf_counter()
    shards = _stage(mesh, block_source, classes[:n_pad], weights, bs, nbk)
    stage_s = time.perf_counter() - t0

    w_crc = (
        zlib.crc32(np.ascontiguousarray(weights, np.int8).tobytes())
        if weights is not None else 0
    )
    ckpt_geo = np.array(
        [bs, g, n, n_pad, threshold, block, w_thresh, word_chunk,
         int(bool(cross_amr_only)), w_crc],
        np.int64,
    )
    ckpt_on = checkpoint_store is not None and bool(checkpoint_key)
    prior_groups: set = set()
    snap = checkpoint_store.load(checkpoint_key) if ckpt_on else None
    if snap is not None and np.array_equal(snap.get("geometry"), ckpt_geo):
        prior_groups = {int(x) for x in snap["groups_done"]}
    done_groups = set(prior_groups)
    groups_this_run = 0

    # + one [bs, bs] window of slack rows a shard for the append
    vcap_l = vcap + bs * bs
    mine = [sh for sh in shards if sh is not None]
    for sh in mine:
        sh.state = (
            torch.zeros((n_pad, 8), dtype=torch.int32, device=sh.device),
            torch.zeros((nb, nb, 2), dtype=torch.int32, device=sh.device),
        ) + _new_pair_buffers(vcap_l, sh.device)
    if prior_groups and shards[0] is not None:
        # a restored snapshot seeds the first shard's accumulators, as in
        # the single-device engine: the merges below then carry it
        shards[0].state[0].copy_(torch.from_numpy(snap["row_stats"]))
        shards[0].state[1].copy_(torch.from_numpy(snap["block_hits"]))
    del snap

    trace = {
        "stage_s": stage_s, "dispatch_s": 0.0, "drain_s": 0.0,
        "fetch_s": 0.0, "steps": 0, "uploads": 0, "launches": 0,
        "bs": int(bs), "g": int(g), "gpd": int(gpd), "nbk": int(nbk),
        "d": d, "word_chunk": int(word_chunk), "vcap": int(vcap),
        "overflow": False, "scan_chunk": int(scan_chunk),
    }
    window = _Window(mesh.home, trace)
    step_kw = dict(n=n, threshold=threshold, block=block, w_thresh=w_thresh,
                   word_chunk=word_chunk, cross_amr_only=cross_amr_only)

    def merged():
        """The shards' statistics merged on the first shard, and their
        cursors: one fetch."""
        rs_t = lane_merge_to_first([sh and sh.state[0] for sh in shards],
                                   mesh)
        bh_t = sum_to_first([sh and sh.state[1] for sh in shards], mesh)
        cur_t = gather_to_first(
            [sh and sh.state[5].reshape(1) for sh in shards], mesh)
        return _to_host(rs_t, bh_t, cur_t)

    def group_boundary(s0):
        """Settle the queues, merge and fetch the (small) cumulative
        statistics, persist them, and fire the fault-injection seam."""
        nonlocal groups_this_run
        if not ckpt_on:
            return
        window.drain(0)
        t0 = time.perf_counter()
        rs_c, bh_c, _ = merged()
        done_groups.add(s0)
        checkpoint_store.save(
            checkpoint_key,
            compressed=False,
            geometry=ckpt_geo,
            groups_done=np.array(sorted(done_groups), np.int64),
            row_stats=rs_c,
            block_hits=bh_c,
        )
        # no rank reads a snapshot before the first rank has written it
        barrier(mesh)
        trace["ckpt_s"] = trace.get("ckpt_s", 0.0) + (
            time.perf_counter() - t0
        )
        groups_this_run += 1
        if (fail_after_groups is not None
                and groups_this_run >= fail_after_groups):
            raise RuntimeError(
                f"stream-mesh checkpoint fault injection: killed after "
                f"{groups_this_run} group(s)"
            )

    # per group, each shard's contiguous moving-block segment, kept for
    # the per-shard expected survivor counts
    group_bounds: dict = {}
    dev_steps = np.zeros(d, np.int64)
    stacks = None
    for s0 in range(0, nbk, g):
        if s0 in prior_groups:
            continue
        g_here = min(g, nbk - s0)
        if stacks is not None:
            # release the previous group's stack before the next is built
            # (two would bust the budget); drain first, so no queued step
            # still reads it
            stacks = None
            window.drain(0)
        t0 = time.perf_counter()
        parts: list = [None] * d
        for k in mesh.local:
            sh = shards[k]
            parts[k] = torch.empty((gpd, bs, w_words), dtype=torch.int32,
                                   device=sh.device)
            for t in range(gpd):
                parts[k][t] = sh.block(min(s0 + k * gpd + t, nbk - 1), bs,
                                       w_words)
        stacks = all_gather(parts, mesh)
        del parts
        trace["dispatch_s"] += time.perf_counter() - t0
        trace["uploads"] += gpd * len(mine)
        trace["launches"] += 1

        jbs = np.arange(s0, nbk)
        wsched = np.minimum(g_here, jbs - s0 + 1).astype(np.int64)
        bounds = _segment_bounds(wsched, d)
        group_bounds[s0] = bounds
        seg_chunks = []
        for k in range(d):
            seg = jbs[bounds[k] : bounds[k + 1]]
            dev_steps[k] += wsched[bounds[k] : bounds[k + 1]].sum()
            seg_chunks.append([seg[i : i + scan_chunk]
                               for i in range(0, len(seg), scan_chunk)])
        rounds = max(len(c) for c in seg_chunks)
        for r in range(rounds):
            for k in mesh.local:
                sh = shards[k]
                if r >= len(seg_chunks[k]):
                    continue
                t0 = time.perf_counter()
                stack = stacks[k]
                for jb in seg_chunks[k][r].tolist():
                    if jb < s0 + g_here:
                        wb = stack[jb - s0]
                    else:
                        wb = sh.block(jb, bs, w_words)
                        trace["uploads"] += 1
                    for t in range(min(g_here, jb - s0 + 1)):
                        ib = s0 + t
                        sh.state = _step_compact_body(
                            sh.state, stack[t], wb, sh.cls[ib], sh.cls[jb],
                            sh.wts, ib * bs, jb * bs, **step_kw,
                        )
                        trace["steps"] += 1
                trace["dispatch_s"] += time.perf_counter() - t0
                window.push(device=sh.device)
            trace["launches"] += 1
            if len(window.pending) > 2 * inflight * len(mine):
                window.drain(inflight * len(mine))
        group_boundary(s0)
    del stacks
    window.drain(0)
    trace["balance"] = (float(dev_steps.min() / max(1, dev_steps.max()))
                        if trace["steps"] else 1.0)

    t0 = time.perf_counter()
    rs, bh, cursors = merged()
    trace["fetch_s"] += time.perf_counter() - t0

    ti, tj = upper_triangle_tiles(n_pad, block)
    tile_hits = bh[ti, tj]
    tiles = (ti, tj, block)
    hits = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        hits = hits + tile_hits[:, 1]
    total = int(hits.sum())

    # each shard's expected survivor count from the exact tile hits:
    # tile → block pair → owning group → the segment holding its moving
    # block. Tiles of restored groups were not compacted in this run;
    # the grouped extractor recovers them below
    nsb = bs // block
    ib_arr, jb_arr = ti // nsb, tj // nsb
    expected = np.zeros(d, np.int64)
    total_prior = 0
    prior_mask = np.zeros(len(ti), bool)
    for t in np.nonzero(hits > 0)[0]:
        ib, jb = int(ib_arr[t]), int(jb_arr[t])
        s0 = (ib // g) * g
        if s0 in prior_groups:
            total_prior += int(hits[t])
            prior_mask[t] = True
            continue
        owner = int(np.searchsorted(group_bounds[s0], jb - s0,
                                    side="right")) - 1
        expected[min(owner, d - 1)] += int(hits[t])
    if prior_groups:
        trace["groups_skipped"] = len(prior_groups)

    def grouped(tile_hits_wanted):
        """The grouped extractor on the first shard's device; across
        processes the first shard's rank runs it and broadcasts the
        pairs."""
        t0 = time.perf_counter()
        out = None
        if shards[0] is not None:
            out = extract_pairs_stream_grouped(
                None, classes, tile_hits_wanted, tiles, n=n,
                threshold=threshold, cross_amr_only=cross_amr_only,
                weights=weights, hbm_budget_bytes=hbm_budget_bytes,
                inflight=inflight, block_source=block_source, bs=bs,
                word_chunk=word_chunk, max_group=max_group,
                pair_format=pair_format, device=mesh.devices[0],
            )
        out = broadcast_array(out, mesh)
        trace["redo_s"] = trace.get("redo_s", 0.0) + (
            time.perf_counter() - t0)
        return out

    def release():
        # the shards' pair buffers go before a grouped pass allocates its own
        for sh in mine:
            sh.state = ()

    if (expected > vcap).any():
        # capacity miss: redo the pair list from the exact tile hits
        trace["overflow"] = True
        release()
        pairs = grouped(tile_hits)
    else:
        if not np.array_equal(cursors.astype(np.int64), expected):
            raise AssertionError(
                f"stream-mesh compacted {cursors.tolist()} pairs per "
                f"device, sweep stats promised {expected.tolist()}"
            )
        t0 = time.perf_counter()
        pairs = _fetch_mesh_pairs(mesh, [sh and sh.state for sh in shards],
                                  cursors, total - total_prior, pair_format,
                                  n_pad)
        trace["fetch_s"] += time.perf_counter() - t0
        release()
        trace["pair_format"] = "packed" if pairs.ndim == 1 else "arr3"
        if total_prior:
            # resume merge: the restored groups' pairs from their exact
            # tile hits, and the union in canonical order
            masked = np.zeros_like(tile_hits)
            masked[prior_mask] = tile_hits[prior_mask]
            prior_pairs = grouped(masked)
            if pairs.ndim == 1 and prior_pairs.ndim == 1:
                pairs = np.sort(np.concatenate([pairs, prior_pairs]))
            else:
                a = np.concatenate(
                    [pairs_as_array(pairs), pairs_as_array(prior_pairs)]
                )
                pairs = a[np.lexsort((a[:, 1], a[:, 0]))]
    if ckpt_on:
        checkpoint_store.remove(checkpoint_key)
    global last_mesh_trace
    last_mesh_trace = trace
    return rs.astype(np.int64), tile_hits, tiles, pairs


def _fetch_mesh_pairs(mesh: Mesh, states, cursors, total: int,
                      pair_format: str, n_rows: int) -> np.ndarray:
    """Each shard's live pair prefix ``[0, cursor_k)`` gathered to the
    first shard's device (exactly ``total`` lanes), sorted there by
    (i, j) and fetched once (``similarity.pairwise._fetch_sorted_pairs``:
    packed int64 when it fits and was asked for, else [M, 3]); across
    processes every rank gathers, sorts and fetches the same list."""
    bi, bj, bc = (
        gather_to_first([st and st[f][: int(c)]
                         for st, c in zip(states, cursors)], mesh)
        for f in (2, 3, 4)
    )
    return _fetch_sorted_pairs(bi, bj, bc, total, pair_format, n_rows)
