"""Sharded O(N²) pair sweep over a :class:`Mesh`, in the JAX package's
three layouts: the flat row ring, the 2-D (hosts × chips) ring and the
k-axis layout (``parallel.mesh.mesh_layout``).

Counterpart of the JAX package's ``parallel/sharded.py``.

**The rings.** The packed matrix is row-sharded, one block of ``block =
N_pad / D`` rows a device (host-major on a 2-D mesh). Each device keeps
its block stationary while a moving copy goes round (``ring_shift``),
and the JAX package's no-wasted-MACs schedule decides what each step
computes (:func:`ring_substeps`):

* step 0, the diagonal: tile-aligned row strips of the block against
  their column suffix (in-block upper triangle);
* steps 1..⌈(D−1)/2⌉: the whole (stationary × moving) block pair;
* for even D, the final step sees each unordered block pair on two
  devices, so the pair region is split between them (two half-block
  products each, the partner in the transposed orientation), or, where
  the half block is not a whole number of tiles, computed by the first
  device alone.

The 2-D ring (JAX ``make_ring_sweep_2d``) shifts the moving copy along
the host axis once an outer step ``sh`` in 0..H/2 and walks a copy of it
round the chip axis, inner steps ``sc`` in 0..C/2 at ``sh`` = 0 and
0..C−1 after (:func:`ring_substeps_2d`): outer step 0 is the flat ring
of each host (its even-C final step split on c < C/2), and for even H
the final outer step sees each host pair twice, so its C inner steps are
split on h < H/2.

Every pair (i<j) is counted exactly once on every mesh, and a pair is
credited to its stationary row: ``row_stats`` equals the JAX ring's row
by row, and the tile hits fold both orientations into the upper-triangle
enumeration. The JAX device loop is SPMD; here one process walks the
devices in turn, so a device-dependent choice (which half, or nothing)
is a plain branch. Both rings share one loop body (:func:`_ring_pass`);
only the schedule and the shifts differ (:func:`_ring_steps`).

Each sub-step's counts come from ``ops.bitmul.counts_window_pair``,
word-chunked so that no shard is ever unpacked whole
(:func:`ring_word_chunk`), and its statistics from K1
(``ops.stats.stats_from_counts_into``: the CUDA kernel on a CUDA tensor,
its plain version on a CPU one), once a sub-step. K1 masks pairs by
``gi < gj < n`` from the block's global offsets, which a wrapped ring
block (moving rows below the stationary ones) would fail everywhere. As
the JAX package's Pallas ring epilogue does, every ring sub-step runs K1
at fake offsets instead (:func:`fake_offsets`): ``(0, 0)`` keeps the
diagonal strips' in-block triangle, ``(0, rows)`` makes every pair of a
block pair valid, and ``n = 2^30`` lifts the bound. Rows at and past the
real ``n`` must therefore be all-zero (the pipeline pads them so, and the
staging checks it): they then add 0 to every lane and never pass a gate.
A survivor is stored at its real global indices, transposed on a wrapped
block so every pair is (min, max), into its card's pair buffers
(``ops.pairlist``) behind a cursor that stays on the device. An
appending sweep (:func:`sharded_sweep_async` given ``pairs`` from
:func:`new_sweep_pairs`, what ``extract="auto"`` runs) has K1 itself
append the survivors it reads, at the sub-step's pair origin
``(gi0, gj0)``, so extraction is one gather
(:func:`sharded_extract_pairs` with ``appended``); the second pass of
two-pass extraction, and the fused pass, mask them with the same
offsets (``ops.bitmul.survivor_mask``) and compact them
(``ops.pairlist.append_rows``).

**The k-axis layout** (JAX ``make_kaxis_sweep``) shards the packed
matrix's columns, the k-mer universe: device d holds ``[N_pad, W/D]``
words, the classes whole and the weights of its own columns, so the
bitset's device memory divides by D. Each row strip of S rows
(:func:`kaxis_strips`) is a diagonal sub-step: every device computes
the partial counts of the strip against its column suffix over its own
words (word-chunked, so no shard is ever unpacked whole), the partials
are summed on the first device (``sum_to_first``, JAX's ``psum``), and
one K1 launch takes the sum at its REAL offsets ``(r0, r0)`` and ``n``:
a strip lies on and above the diagonal, so no fake offset is needed.
JAX scans 128-row blocks against all N_pad columns (one compiled shape
on the TPU); the strips here are S rows, a multiple of 128 sized so that
the D partial strips and their sum fit :data:`KAXIS_STRIP_BYTES`, and
take only the columns ``[r0, N_pad)``: tiles wholly below the diagonal
hold no pair ``gi < gj``. Row stats (credited to the smaller index, as in
JAX) and tile hits are the same for any S. Extraction and the fused pass
compact from the same summed counts on the first device (JAX's
replicated compaction, done once).

**Across processes** (a mesh over a ``torch.distributed`` world,
``parallel.mesh``): each rank stages, multiplies and compacts only its
own shards (``Mesh.local``), the shifts and reductions cross ranks, and
the schedules do not change, so the K1 launches summed over the ranks
equal :func:`count_substeps`, :func:`count_substeps_2d` or
:func:`count_kaxis_strips`. A k-axis strip's summed counts reach every
rank, but only the first shard's rank runs K1 and the compaction on
them, as the first device does in one process. Every wrapper returns the
replicated result on every rank (JAX ``_replicate_row_stats``): the row
statistics, tile hits and pair prefixes are gathered to every rank, and
each rank sorts the same pair list. A check that reads only local shards
is agreed over the ranks, so that all raise together.

**Tracing.** Every pass counts into a :data:`last_trace` dict, and
:func:`_gather_pairs` is the span ``ukc.ring.gather`` (``utils.timing``;
``ring_shift`` is ``ukc.ring.shift``).

The JAX package builds each pass as a memoised ``make_ring_*`` /
``make_kaxis_*`` closure so that ``jit`` does not retrace; the port has
no compiled closures to keep, so those makers have no counterpart here.
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
from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
    APPEND_LANES,
    EPILOGUE_PAIR_CAP,
    append_rows,
    append_window,
    check_cursor,
    new_pair_buffers,
    sort_compact_append,
    sorted_pairs,
    tile_survivors,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (
    upper_triangle_tiles,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import (
    stats_from_counts_into,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
    _BIT,
    _materialize_block,
    split_incidence_blocks,
)
from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (
    Mesh,
    agree,
    broadcast_from_first,
    gather_to_first,
    mesh_layout,
    ring_shift,
    shard_rows,
    sum_to_first,
)
from uniprot_kmer_based_clustering_tpu_torch.utils.timing import span

#: ``n`` of every K1 launch and survivor mask of the rings (see module doc)
FAKE_N = 1 << 30

#: bytes of the two unpacked int8 operands of one sub-step, at most
RING_UNPACK_BYTES = 2 << 30

#: bytes of the D partial int32 counts strips of a k-axis step and their
#: sum, at most (the strip height S follows from it)
KAXIS_STRIP_BYTES = 2 << 30

#: Counts of the most recent sweep, extraction or fused pass on a mesh,
#: over this rank's shards, in every layout (the
#: ``similarity.pairwise.last_trace`` convention): ``stage_bytes`` (the
#: words and classes :func:`stage_mesh_inputs` or
#: :func:`stage_mesh_inputs_csr` put on the devices),
#: ``stage_pinned_bytes`` (those of ``stage_bytes`` copied to CUDA
#: devices from page-locked host words, as asynchronous DMAs),
#: ``shift_bytes``
#: (the moving words and classes of every ring shift; 0 on the k axis),
#: ``substeps`` (products: ring sub-steps, or k-axis strips, of every
#: pass), ``hit_tiles`` (tiles holding a survivor, set by
#: :func:`survivor_total`), ``pairs`` (the survivors of the last
#: gather), ``epilogue_pairs`` (the survivors K1 appended during an
#: appending sweep, summed over the cards; 0 off that route) and
#: ``second_passes`` (the runs of the schedule for extraction alone, by
#: :func:`sharded_extract_pairs`). A
#: caller that hands one :func:`new_trace` dict to its staging and its
#: passes, as ``pipeline._sharded_similarity`` does, reads the whole
#: job here. Times are the spans'.
last_trace: dict = {}


def new_trace() -> dict:
    return dict(stage_bytes=0, stage_pinned_bytes=0, shift_bytes=0,
                substeps=0, hit_tiles=0, pairs=0, epilogue_pairs=0,
                second_passes=0)


def _begin_trace(trace: Optional[dict]) -> dict:
    """``trace`` (a fresh one when None), made :data:`last_trace`."""
    global last_trace
    last_trace = trace = new_trace() if trace is None else trace
    return trace


def _nbytes(shards) -> int:
    return sum(t.nbytes for t in shards if t is not None)


@dataclasses.dataclass(frozen=True)
class SubStep:
    """One product of a ring step on one device: stationary rows
    ``[r0, r0 + rows)`` of the device's block against moving rows
    ``[c0, c0 + cols)`` of the block it holds, whose first pair sits at
    global ``(gi0, gj0)``; ``triangle`` keeps only the in-block pairs
    above the diagonal (step 0). A k-axis strip is one too: rows and
    columns global, ``triangle`` set."""

    r0: int
    rows: int
    c0: int
    cols: int
    gi0: int
    gj0: int
    triangle: bool

    @property
    def transposed(self) -> bool:
        """A wrapped block pair (moving rows below the stationary ones):
        its pairs are stored as (column, row), so every pair is
        (min, max)."""
        return self.gj0 < self.gi0


def diag_strip_bounds(nbl: int, max_strips: int = 8):
    """Tile-aligned strip bounds for the diagonal step: ~``max_strips``
    equal strips over ``nbl`` tiles (the last may be short). Returns
    [(tile_lo, tile_hi), ...]."""
    per = -(-nbl // max_strips)
    return [(r, min(nbl, r + per)) for r in range(0, nbl, per)]


def _substeps(row_base: int, moving_base: int, block: int, block_tile: int,
              *, diag: bool, first: Optional[bool],
              max_strips: int = 8) -> List[SubStep]:
    """The three sub-step shapes (the JAX ``_substeps_diag``,
    ``_substep_full`` and ``_substeps_split``): the diagonal strips; one
    full block pair (``first`` None); or a pair seen by two devices, of
    which the ``first`` covers rows [0, h) of the pair region and the
    partner rows [h, 2h) transposed, or, when h is not a whole number of
    tiles, the first device the whole block pair and the partner
    nothing."""
    if diag:
        out = []
        for t0, t1 in diag_strip_bounds(block // block_tile, max_strips):
            r0, r1 = t0 * block_tile, t1 * block_tile
            out.append(SubStep(r0, r1 - r0, r0, block - r0, row_base + r0,
                               row_base + r0, True))
        return out
    full = SubStep(0, block, 0, block, row_base, moving_base, False)
    if first is None:
        return [full]
    h = block // 2
    if h % block_tile:
        return [full] if first else []
    b1 = a2 = 0 if first else h
    return [
        SubStep(0, h, b1, h, row_base, moving_base + b1, False),
        SubStep(a2, h, h, h, row_base + a2, moving_base + h, False),
    ]


def ring_substeps(s: int, d_count: int, dev: int, block: int,
                  block_tile: int, max_strips: int = 8) -> List[SubStep]:
    """The products of flat-ring step ``s`` on device ``dev`` (the JAX
    ``_ring_substeps``): exact, disjoint coverage of the pairs for every
    D; the even-D final step is split on dev < D/2."""
    return _substeps(
        dev * block, (dev + s) % d_count * block, block, block_tile,
        diag=s == 0, first=dev < d_count // 2 if 2 * s == d_count else None,
        max_strips=max_strips,
    )


def ring_substeps_2d(sh: int, sc: int, hc: int, cc: int, h: int, c: int,
                     block: int, block_tile: int,
                     max_strips: int = 8) -> List[SubStep]:
    """The products of 2-D outer step ``sh``, inner step ``sc`` on chip c
    of host h (the JAX ``_ring_substeps_2d`` and ``_ring_gate_2d``): the
    diagonal at (0, 0); the even-C intra-host final step (sh = 0,
    2·sc = C) split on c < C/2; every inner step of the even-H final
    outer step (2·sh = H) split on h < H/2, the partner seeing the pair
    transposed at its inner step −sc mod C; else one full block pair."""
    first = None
    if sh == 0 and 2 * sc == cc:
        first = c < cc // 2
    elif 2 * sh == hc:
        first = h < hc // 2
    moving = ((h + sh) % hc * cc + (c + sc) % cc) * block
    return _substeps((h * cc + c) * block, moving, block, block_tile,
                     diag=sh == 0 and sc == 0, first=first,
                     max_strips=max_strips)


def steps_2d(hc: int, cc: int):
    """The 2-D ring's (outer, inner) steps in order."""
    return [(sh, sc) for sh in range(hc // 2 + 1)
            for sc in range(cc if sh else cc // 2 + 1)]


def ring_schedule(d_count: int, block: int, block_tile: int):
    """Every step's sub-steps, ``[step][device] -> [SubStep, ...]``."""
    return [
        [ring_substeps(s, d_count, dev, block, block_tile)
         for dev in range(d_count)]
        for s in range(d_count // 2 + 1)
    ]


def ring_schedule_2d(hc: int, cc: int, block: int, block_tile: int):
    """Every (outer, inner) step's sub-steps on an H × C mesh, in
    :func:`steps_2d` order, ``[step][shard] -> [SubStep, ...]`` with
    shard h·C + c."""
    return [
        [ring_substeps_2d(sh, sc, hc, cc, d // cc, d % cc, block,
                          block_tile)
         for d in range(hc * cc)]
        for sh, sc in steps_2d(hc, cc)
    ]


def count_substeps(d_count: int, n_pad: int, block_tile: int = 128) -> int:
    """Products of one flat-ring pass over an ``n_pad``-row matrix on
    ``d_count`` devices: the K1 launches of one sweep or fused pass."""
    sched = ring_schedule(d_count, n_pad // d_count, block_tile)
    return sum(len(subs) for step in sched for subs in step)


def count_substeps_2d(hc: int, cc: int, n_pad: int,
                      block_tile: int = 128) -> int:
    """Products of one 2-D ring pass on an H × C mesh: the K1 launches of
    one sweep or fused pass."""
    sched = ring_schedule_2d(hc, cc, n_pad // (hc * cc), block_tile)
    return sum(len(subs) for step in sched for subs in step)


def kaxis_strips(d_count: int, n_pad: int, block_tile: int = 128,
                 budget: Optional[int] = None) -> List[SubStep]:
    """The row strips of a k-axis pass over an ``n_pad``-row matrix on
    ``d_count`` devices: each S rows (the last may be short) against its
    column suffix, S the most whole tiles for which the D partial int32
    strips and their sum, at the full width N_pad, fit ``budget``
    (:data:`KAXIS_STRIP_BYTES`), at least one tile. Tall strips fill the
    card: K1 runs a warp a row, so a 128-row strip would occupy a quarter
    of the H100's 132 SMs."""
    budget = KAXIS_STRIP_BYTES if budget is None else budget
    nbl = n_pad // block_tile
    per = max(1, budget // ((d_count + 1) * n_pad * 4 * block_tile))
    out = []
    for t0 in range(0, nbl, per):
        r0, r1 = t0 * block_tile, min(nbl, t0 + per) * block_tile
        out.append(SubStep(r0, r1 - r0, r0, n_pad - r0, r0, r0, True))
    return out


def count_kaxis_strips(d_count: int, n_pad: int,
                       block_tile: int = 128) -> int:
    """K1 launches of one k-axis sweep or fused pass: one a strip."""
    return len(kaxis_strips(d_count, n_pad, block_tile))


def fake_offsets(sub: SubStep):
    """(i_off, j_off) of a ring sub-step's K1 launch and survivor mask:
    the local triangle on the diagonal, every pair valid elsewhere."""
    return 0, 0 if sub.triangle else sub.rows


def _word_chunk(rows: int, w_words: int, budget: int) -> int:
    """0 (whole) when ``rows`` unpacked int8 rows of ``w_words`` words fit
    ``budget``, else the largest divisor of ``w_words`` whose rows do (at
    least 1)."""
    per_word = rows * 32
    if w_words * per_word <= budget:
        return 0
    best = 1
    for d in range(1, w_words + 1):
        if w_words % d == 0 and d * per_word <= budget:
            best = d
    return best


def ring_word_chunk(block: int, w_words: int,
                    budget: int = RING_UNPACK_BYTES) -> int:
    """Contraction chunk of the rings' products: 0 (whole) when both
    unpacked operands of the widest sub-step (2·block rows) fit
    ``budget``, else the largest divisor of ``w_words`` that does (at
    least 1)."""
    return _word_chunk(2 * block, w_words, budget)


def _check_shards(mesh: Mesh, words_s, block_tile: int) -> int:
    """A ring's row shards: equal, and N_pad a multiple of D tiles.
    Returns N_pad."""
    d = mesh.size
    mine = [words_s[i] for i in mesh.local]
    block = mine[0].shape[0]
    n_pad = block * d
    if any(w.shape != mine[0].shape for w in mine) or (
            n_pad % (d * block_tile)):
        raise ValueError(
            f"N_pad={n_pad} must be divisible by devices×block_tile="
            f"{d * block_tile}, in equal shards"
        )
    return n_pad


def _check_kaxis_width(w_words: int, d: int) -> None:
    if w_words % d:
        raise ValueError(
            f"W={w_words} packed words must divide over {d} devices"
        )


def _check_zero_padding(mesh: Mesh, words_s, n: int) -> None:
    """Rows at and past ``n`` must be all-zero (module doc); one read of
    the padding rows of each local shard, agreed over the ranks."""
    block = words_s[mesh.local[0]].shape[0]
    bad = None
    for d in mesh.local:
        lo = max(0, n - d * block)
        if lo < block and bool(words_s[d][lo:].any()):
            bad = d
            break
    if agree(bad is not None, mesh):
        raise ValueError(
            f"rows from n={n} on must be all-zero bitsets"
            + (f" (shard {bad})" if bad is not None else "")
        )


def _as_int32(arr):
    """numpy uint32/int32 or a tensor → an int32 tensor (a view where
    possible)."""
    if torch.is_tensor(arr):
        return arr.to(torch.int32)
    arr = np.asarray(arr)
    if arr.dtype == np.uint32:
        arr = np.ascontiguousarray(arr).view(np.int32)
    return torch.from_numpy(np.require(arr, np.int32, "W"))


def _shard_cols(mesh: Mesh, t: torch.Tensor) -> list:
    """Column shard d of a ``[R, C]`` tensor (C divisible by D) on device
    d, each a contiguous copy (this rank's shards; None at the others)."""
    cw = t.shape[1] // mesh.size
    out: list = [None] * mesh.size
    for d in mesh.local:
        part = t[:, d * cw : (d + 1) * cw]
        out[d] = torch.empty(part.shape, dtype=part.dtype,
                             device=mesh.devices[d]).copy_(part)
    return out


def _replicate(mesh: Mesh, t: torch.Tensor) -> list:
    """``t`` on every device of the mesh (the first entry on the first)."""
    return broadcast_from_first(t.to(mesh.home), mesh)


def stage_mesh_inputs(mesh: Mesh, words, classes, trace=None):
    """Stage (words, classes) onto the mesh's layout ONCE, so a sweep
    followed by an extraction does not copy the matrix twice (JAX
    ``stage_mesh_inputs``). The rings (flat, and 2-D in host-major shard
    order) take row shards, shard d on device d; the k-axis layout takes
    column shards ``[N_pad, W/D]`` and the classes whole on every device.
    The words become int32 bits (from numpy uint32, or an int32 tensor),
    the classes int32. Words given as a page-locked tensor (the pipeline
    passes ``BitsetMatrix.pinned``) go to each CUDA device as an
    asynchronous DMA on that device's stream, so the devices load at
    once and the call returns before the copies end. Staged inputs (a
    list or tuple of shards each) pass through unchanged; ``trace`` (a
    :data:`last_trace` dict) gains the bytes of the shards made here, and
    of those the bytes sent from page-locked words. Returns
    ``(words_shards, classes_shards)``."""
    staged = isinstance(words, (list, tuple))
    staged_classes = isinstance(classes, (list, tuple))
    if not staged:
        words = _as_int32(words)
    if not staged_classes:
        classes = _as_int32(classes)
        if mesh_layout(mesh) == "kaxis":
            classes = _replicate(mesh, classes)
    # the rings' row shards are contiguous views of the host words, so
    # page-locked words reach each card by DMA; the k axis's column
    # shards are strided, and torch gathers them in pageable memory first
    pinned = False
    if mesh_layout(mesh) == "kaxis":
        if not staged:
            _check_kaxis_width(words.shape[1], mesh.size)
            words = _shard_cols(mesh, words)
        words_s, classes_s = list(words), list(classes)
    else:
        pinned = not staged and words.is_pinned()
        words_s = shard_rows(mesh, words)
        classes_s = shard_rows(mesh, classes)
    made = ([] if staged else words_s) + ([] if staged_classes
                                          else classes_s)
    if trace is not None:
        trace["stage_bytes"] += _nbytes(made)
        if pinned:
            trace["stage_pinned_bytes"] += _nbytes(
                t for t in words_s if t is not None and t.is_cuda)
    return words_s, classes_s


def stage_mesh_inputs_csr(mesh: Mesh, incidence_protein, incidence_rank,
                          n_pad: int, w_pad: int, classes, axis=None,
                          trace=None):
    """Stage the packed bitset by building each device's shard ON THE
    DEVICE from the sparse incidence lists: the dense host matrix is
    never copied (JAX ``stage_mesh_inputs_csr``). ``axis`` names the
    mesh's own axes (None: all of them): the rings' row shards, or
    ``("k",)`` for the k-axis column shards, split host-side by the word
    range ``(rank >> 5) // (W/D)`` of each incidence. Each shard is
    ``ops.stream``'s accumulating single-bit ``index_add_`` (two ranks of
    one protein in one word add distinct powers of two), so the bits
    equal ``pack_bitsets``' rows; the JAX k-axis staging's
    ``unique_indices=True`` scatter, where such ranks collide, is not
    copied. ``classes`` are padded to ``n_pad`` with -1. Returns
    ``(words_shards, classes_shards)`` and counts into ``trace``, as
    :func:`stage_mesh_inputs`."""
    axes = (mesh.axis_names if axis is None
            else (axis,) if isinstance(axis, str) else tuple(axis))
    if axes != mesh.axis_names:
        raise ValueError(
            f"axis {axes} is not the mesh's axes {mesh.axis_names}"
        )
    d = mesh.size
    kaxis = mesh_layout(mesh) == "kaxis"
    if kaxis:
        _check_kaxis_width(w_pad, d)
    elif n_pad % d:
        raise ValueError(f"n_pad={n_pad} does not divide over {d} devices")
    p = np.asarray(incidence_protein, np.int32)
    r = np.asarray(incidence_rank, np.int32)
    if kaxis:
        # column shards: split by rank (word range), each holding global
        # rows and shard-local ranks (split_incidence_blocks with the
        # roles of rows and ranks exchanged). Its searchsorted needs the
        # ranks ordered by shard only, so a stable sort of the 16-bit
        # shard index (a radix sort) does.
        ws = w_pad // d
        order = np.argsort(((r >> 5) // ws).astype(np.int16), kind="stable")
        ranks, rows, valid = split_incidence_blocks(r[order], p[order],
                                                    32 * ws, d)
        bs, w = n_pad, ws
    else:
        if p.shape[0] and np.any(np.diff(p) < 0):
            order = np.argsort(p, kind="stable")
            p, r = p[order], r[order]
        rows, ranks, valid = split_incidence_blocks(p, r, n_pad // d, d)
        bs, w = n_pad // d, w_pad
    words_s: list = [None] * d
    for b in mesh.local:
        dev = mesh.devices[b]
        words_s[b] = _materialize_block(
            torch.from_numpy(rows[b : b + 1]).to(dev),
            torch.from_numpy(ranks[b : b + 1]).to(dev),
            torch.from_numpy(valid[b : b + 1]).to(dev),
            torch.tensor(_BIT, dtype=torch.int32, device=dev), 0,
            bs=bs, w=w,
        )
    cls = np.full(n_pad, -1, np.int32)
    ids = np.asarray(classes, np.int32)[:n_pad]
    cls[: ids.shape[0]] = ids
    cls = torch.from_numpy(cls)
    classes_s = _replicate(mesh, cls) if kaxis else shard_rows(mesh, cls)
    if trace is not None:
        trace["stage_bytes"] += _nbytes(words_s) + _nbytes(classes_s)
    return words_s, classes_s


@dataclasses.dataclass
class _Staged:
    """What a pass runs on: the shards, the weights (None when
    unweighted; replicated on the rings, column-sharded on the k axis),
    the matrix's N_pad and the :data:`last_trace` dict its passes count
    into."""

    words: list
    classes: list
    weights: Optional[list]
    n_pad: int
    trace: dict


def _stage_inputs(mesh: Mesh, words, classes, weights, n: int,
                  block_tile: int, trace: Optional[dict]) -> _Staged:
    """Staged shards and weights, and the checks every wrapper makes;
    ``trace`` (a fresh one when None) becomes :data:`last_trace`."""
    trace = _begin_trace(trace)
    if block_tile % 32 and any(d.type == "cuda" for d in mesh.devices):
        raise ValueError(
            f"block_tile {block_tile}: on CUDA the mesh layouts take "
            f"multiples of 32 (K1's tiles; torch._int_mm needs more than "
            f"16 rows)"
        )
    words_s, classes_s = stage_mesh_inputs(mesh, words, classes, trace)
    kaxis = mesh_layout(mesh) == "kaxis"
    if kaxis:
        n_pad = words_s[mesh.local[0]].shape[0]
        if n_pad % block_tile:
            raise ValueError(
                f"N_pad={n_pad} must be divisible by block_tile="
                f"{block_tile}"
            )
    else:
        n_pad = _check_shards(mesh, words_s, block_tile)
        _check_zero_padding(mesh, words_s, n)
    weights_s = None
    if weights is not None:
        w0 = (weights if torch.is_tensor(weights)
              else torch.from_numpy(np.asarray(weights, np.int8)))
        w0 = w0.to(device=mesh.home, dtype=torch.int8)
        w_words = words_s[mesh.local[0]].shape[1] * (mesh.size if kaxis
                                                     else 1)
        if w0.shape != (w_words * 32,):
            raise ValueError("weights must be int8 [W*32]")
        if kaxis:
            parts = w0.chunk(mesh.size)
            weights_s = [parts[d].to(dev) if d in mesh.local else None
                         for d, dev in enumerate(mesh.devices)]
        else:
            weights_s = broadcast_from_first(w0, mesh)
    return _Staged(words_s, classes_s, weights_s, n_pad, trace)


def _compact(bufs, keep, counts, sub: SubStep, *, block_tile: int, k: int):
    """Append one sub-step's survivors to a shard's pair buffers (JAX
    ``_compact_step``) with ``ops.pairlist``'s sort-based append, in
    windows of at most ``append_window`` lanes. A wrapped sub-step
    (moving rows below the stationary ones) writes its pairs transposed,
    so every pair is (min, max). ``k`` > 0 selects up to ``k`` per
    ``block_tile``² sub-tile with ``torch.topk`` and drops a sub-tile with
    more survivors WHOLE, never truncated (the caller sees the shortfall
    against the exact tile hits); ``k`` = 0 appends the whole mask, in
    row windows."""
    transposed = sub.transposed
    if k > 0:
        m = keep.to(torch.int32)
        qj = keep.shape[1] // block_tile
        sub_hits = m.reshape(-1, block_tile, qj, block_tile).sum(dim=(1, 3))
        gi, gj, cnt = topk_subtile_candidates(
            m, counts, sub.gi0, sub.gj0, tile=block_tile, k=k,
        )
        if transposed:
            gi, gj = gj, gi
        hit = ((cnt >= 0) & (sub_hits.reshape(-1, 1) <= k)).reshape(-1)
        gi, gj, cnt = gi.reshape(-1), gj.reshape(-1), cnt.reshape(-1)
        for a in range(0, hit.numel(), APPEND_LANES):
            b = a + APPEND_LANES
            bufs = sort_compact_append(*bufs, hit[a:b], gi[a:b], gj[a:b],
                                       cnt[a:b])
        return bufs
    return append_rows(*bufs, keep, counts, sub.gi0, sub.gj0,
                       transposed=transposed)


def _substep_outputs(counts, ca, cb, sub: SubStep, i_off: int, j_off: int,
                     n: int, *, threshold: int, block_tile: int, row_stats,
                     hits, bufs, k: int, cross_amr_only: bool, append: bool):
    """What one sub-step's counts feed, the loop body every layout
    shares: with ``row_stats`` one K1 launch at (i_off, j_off, n) (a
    diagonal sub-step stores its rows, which it is the first to reach;
    the others merge theirs) adding its tile hits into ``hits`` at the
    sub-step's global tiles; with ``bufs`` the survivors of the same
    mask, appended by that launch itself under ``append`` (stored from
    the sub-step's pair origin ``(gi0, gj0)``, transposed on a wrapped
    block pair), else compacted into them by :func:`_compact`. Returns
    ``bufs``."""
    if row_stats is not None:
        r0, r1 = sub.r0, sub.r0 + sub.rows
        out = row_stats[r0:r1] if sub.triangle else torch.empty(
            (sub.rows, 8), dtype=torch.int32, device=counts.device)
        stats_from_counts_into(
            counts, ca, cb, out,
            hits[sub.gi0 // block_tile:, sub.gj0 // block_tile:],
            i_off=i_off, j_off=j_off, n=n, threshold=threshold,
            tile=block_tile, pairs=bufs if append else None,
            include_same=not cross_amr_only, pair_origin=(sub.gi0, sub.gj0),
            transposed=sub.transposed,
        )
        if not sub.triangle:
            merge_row_stats_at(row_stats, out, r0)
    if bufs is not None and not append:
        keep = survivor_mask(
            counts, ca, cb, i_off, j_off, n=n, threshold=threshold,
            include_same=not cross_amr_only,
        )
        bufs = _compact(bufs, keep, counts, sub, block_tile=block_tile, k=k)
    return bufs


def _shift(blocks: list, mesh: Mesh, trace: dict, axis=None) -> None:
    ring_shift(blocks, mesh, axis)
    trace["shift_bytes"] += _nbytes(blocks)


def _ring_steps(mesh: Mesh, words_s, classes_s, block: int,
                block_tile: int, trace: dict):
    """Yield each step of the mesh's ring: (the moving words and classes
    each shard holds, the sub-steps of each shard). The flat ring shifts
    its moving copy round the whole mesh a step. The 2-D ring shifts it
    along the host axis an outer step, then walks a second copy of it
    round the chip axis an inner step (JAX ``make_ring_sweep_2d``); every
    shift makes fresh buffers, so the inner copy never aliases the
    moving one it started from. ``trace`` gains the bytes shifted."""
    moving = [list(words_s), list(classes_s)]
    if mesh_layout(mesh) != "2d":
        for s, subs in enumerate(ring_schedule(mesh.size, block,
                                               block_tile)):
            if s:
                for m in moving:
                    _shift(m, mesh, trace)
            yield moving[0], moving[1], subs
        return
    h_ax, c_ax = mesh.axis_names
    hc, cc = mesh.shape[h_ax], mesh.shape[c_ax]
    inner = None
    for (sh, sc), subs in zip(steps_2d(hc, cc),
                              ring_schedule_2d(hc, cc, block, block_tile)):
        if sc == 0:
            if inner is not None:
                # the last outer step's chip-axis copy goes before the
                # host shift: emptying its lists drops the caller's
                # references too
                for m in inner:
                    m.clear()
            if sh:
                for m in moving:
                    _shift(m, mesh, trace, h_ax)
            inner = [list(m) for m in moving]
        else:
            for m in inner:
                _shift(m, mesh, trace, c_ax)
        yield inner[0], inner[1], subs


def _new_outputs(mesh: Mesh, rows: int, nb: int, *, stats: bool, cap: int,
                 window: int, owners: int):
    """The accumulators of a pass on the first ``owners`` devices (this
    rank's among them; None at the others): row_stats [rows, 8] and hits
    [nb, nb, 2] with ``stats``, pair buffers of ``cap`` plus ``window``
    slots of slack with ``cap``; None where unused."""
    devs = [dev if d in mesh.local else None
            for d, dev in enumerate(mesh.devices[:owners])]
    row_stats = hits = bufs = None
    if stats:
        row_stats = [dev and torch.empty((rows, 8), dtype=torch.int32,
                                         device=dev) for dev in devs]
        hits = [dev and torch.zeros((nb, nb, 2), dtype=torch.int32,
                                    device=dev) for dev in devs]
    if cap:
        bufs = [dev and new_pair_buffers(cap + window, dev) for dev in devs]
    return row_stats, hits, bufs


def _ring_pass(mesh: Mesh, st: _Staged, *, threshold: int,
               block_tile: int, stats: bool, cap: int = 0, k: int = 0,
               cross_amr_only: bool = True, pairs=None):
    """One pass of a ring (flat or 2-D) over staged shards. Each sub-step
    multiplies its stationary rows by the moving rows its shard holds and
    feeds :func:`_substep_outputs` at the ring's fake offsets; a rank runs
    its own shards' sub-steps. With ``pairs`` (:func:`new_sweep_pairs`)
    K1 appends into them, in place of ``cap`` buffers and compaction.
    Returns (row_stats [block, 8] per shard, hits [nb, nb, 2] per shard,
    pair buffers per shard); the unused ones are None, as are other
    ranks' shards."""
    block, w_words = st.words[mesh.local[0]].shape
    wc = ring_word_chunk(block, w_words)
    row_stats, hits, bufs = _new_outputs(
        mesh, block, st.n_pad // block_tile, stats=stats, cap=cap,
        window=append_window(block), owners=mesh.size)
    bufs = bufs if pairs is None else pairs
    for moving_w, moving_c, step in _ring_steps(mesh, st.words, st.classes,
                                                block, block_tile, st.trace):
        for d in mesh.local:
            st.trace["substeps"] += len(step[d])
            for sub in step[d]:
                r0, r1 = sub.r0, sub.r0 + sub.rows
                c0, c1 = sub.c0, sub.c0 + sub.cols
                counts = counts_window_pair(
                    st.words[d][r0:r1], moving_w[d][c0:c1],
                    None if st.weights is None else st.weights[d],
                    word_chunk=wc,
                )
                out = _substep_outputs(
                    counts, st.classes[d][r0:r1], moving_c[d][c0:c1], sub,
                    *fake_offsets(sub), FAKE_N, threshold=threshold,
                    block_tile=block_tile,
                    row_stats=None if row_stats is None else row_stats[d],
                    hits=None if hits is None else hits[d],
                    bufs=None if bufs is None else bufs[d], k=k,
                    cross_amr_only=cross_amr_only,
                    append=pairs is not None,
                )
                if bufs is not None:
                    bufs[d] = out
                del counts
    return row_stats, hits, bufs


def _kaxis_pass(mesh: Mesh, st: _Staged, *, n: int, threshold: int,
                block_tile: int, stats: bool, cap: int = 0, k: int = 0,
                cross_amr_only: bool = True, pairs=None):
    """One k-axis pass (module doc) over staged column shards: each strip's
    partial counts on every device, summed on the first
    (:func:`sum_to_first`), then :func:`_substep_outputs` at the strip's
    real offsets and ``n`` (its pair origin too). The outputs live on the
    first device only (across processes: the sum reaches every rank, and
    only the first shard's rank runs the outputs); ``pairs`` as for
    :func:`_ring_pass`. Returns ([row_stats [N_pad, 8]], [hits [nb, nb,
    2]], [pair buffers]), the unused ones None."""
    n_pad, ws = st.words[mesh.local[0]].shape
    row_stats, hits, bufs = _new_outputs(
        mesh, n_pad, n_pad // block_tile, stats=stats, cap=cap,
        window=append_window(n_pad), owners=1)
    bufs = bufs if pairs is None else pairs
    cls = st.classes[mesh.local[0]]
    first = mesh.local[0] == 0
    for sub in kaxis_strips(mesh.size, n_pad, block_tile):
        st.trace["substeps"] += 1
        r0, r1 = sub.r0, sub.r0 + sub.rows
        wc = _word_chunk(sub.rows + sub.cols, ws, RING_UNPACK_BYTES)
        parts = [
            counts_window_pair(
                w[r0:r1], w[r0:], None if st.weights is None
                else st.weights[d], word_chunk=wc)
            if d in mesh.local else None
            for d, w in enumerate(st.words)
        ]
        counts = sum_to_first(parts, mesh)
        del parts
        if not first:
            del counts
            continue
        out = _substep_outputs(
            counts, cls[r0:r1], cls[r0:], sub, r0, r0, n,
            threshold=threshold, block_tile=block_tile,
            row_stats=None if row_stats is None else row_stats[0],
            hits=None if hits is None else hits[0],
            bufs=None if bufs is None else bufs[0], k=k,
            cross_amr_only=cross_amr_only, append=pairs is not None,
        )
        if bufs is not None:
            bufs[0] = out
        del counts
    return row_stats, hits, bufs


def _pass(mesh: Mesh, st: _Staged, *, n: int, **kw):
    """One pass of the mesh's layout (the rings mask at ``FAKE_N``, the
    k-axis strips at ``n``)."""
    if mesh_layout(mesh) == "kaxis":
        return _kaxis_pass(mesh, st, n=n, **kw)
    return _ring_pass(mesh, st, **kw)


def new_sweep_pairs(mesh: Mesh) -> list:
    """Pair buffers for an appending sweep (the ``pairs`` of
    :func:`sharded_sweep_async` and the wrappers): :data:`ops.pairlist.
    EPILOGUE_PAIR_CAP` slots on each card that owns a pass's outputs
    (every ring shard; the first card on the k axis), with no slack (the
    kernel stores only below its slots); None at other ranks' cards."""
    owners = 1 if mesh_layout(mesh) == "kaxis" else mesh.size
    return _new_outputs(mesh, 0, 0, stats=False, cap=EPILOGUE_PAIR_CAP,
                        window=0, owners=owners)[2]


def _finalize_sweep(mesh: Mesh, row_stats, hits, n_pad: int,
                    block_tile: int):
    """Pass outputs → the single-chip engine format on the host:
    (row_stats int64 [N_pad, 8], tile_hits [nT, 2], (ti, tj,
    block_tile)). A ring's block pair may leave its hits in either
    orientation; the fold adds the lower-triangle tile onto its
    upper-triangle twin (the k-axis strips fill only the upper
    triangle, so there it adds 0)."""
    rs = gather_to_first(row_stats, mesh).cpu().numpy().astype(np.int64)
    h = sum_to_first(hits, mesh).cpu().numpy()
    ti, tj = upper_triangle_tiles(n_pad, block_tile)
    tile_hits = h[ti, tj] + np.where((ti != tj)[:, None], h[tj, ti], 0)
    return rs, tile_hits, (ti, tj, block_tile)


def _gather_pairs(mesh: Mesh, bufs, cap: int, trace: dict,
                  per_card: bool = False):
    """Every owner's occupied buffer prefix, concatenated on the first
    device, sorted by (i, j) and fetched: (pairs int32 [M, 3] or None when
    the survivors passed ``cap``, in all or with ``per_card`` on one
    owner, the survivor total M). One host read of the cursors. Every
    rank returns the same; ``trace["pairs"]`` becomes M."""
    with span("ring.gather"):
        cursors = gather_to_first([b and b[3].reshape(1) for b in bufs],
                                  mesh)
        counts = [int(c) for c in cursors.cpu()]
        total = trace["pairs"] = sum(counts)
        if (max(counts) if per_card else total) > cap:
            return None, total
        parts = [[b and b[f][:c] for b, c in zip(bufs, counts)]
                 for f in range(3)]
        arr = sorted_pairs(*(gather_to_first(p, mesh) for p in parts))
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


def _sweep(mesh: Mesh, layout: str, words, classes, n: int, threshold: int,
           block_tile: int, weights, trace, pairs, cross_amr_only: bool):
    if mesh_layout(mesh) != layout:
        raise ValueError(
            f"a {mesh_layout(mesh)} mesh {mesh.axis_names}: this sweep "
            f"takes the {layout} layout"
        )
    dispatch, finalize = sharded_sweep_async(
        mesh, words, classes, n, threshold, block_tile, weights, trace,
        pairs=pairs, cross_amr_only=cross_amr_only)
    return finalize(dispatch())


def survivor_total(tile_hits, cross_amr_only: bool,
                   trace: Optional[dict] = None) -> int:
    """The pairs a sweep's tile hits promise extraction (the cross-class
    lane, and the same-class one unless ``cross_amr_only``);
    ``trace["hit_tiles"]`` becomes the tiles holding any of them."""
    per_tile = tile_survivors(tile_hits, cross_amr_only)
    if trace is not None:
        trace["hit_tiles"] = int(np.count_nonzero(per_tile))
    return int(per_tile.sum())


def sharded_sweep_async(
    mesh: Mesh,
    words,
    classes,
    n: int,
    threshold: int,
    block_tile: int = 128,
    weights=None,
    trace: Optional[dict] = None,
    pairs=None,
    cross_amr_only: bool = True,
):
    """Stage and check the inputs once; return ``(dispatch, finalize)``
    for sweeps of the mesh's own layout (flat, 2-D or k-axis).

    ``dispatch()`` queues one whole sweep on the staged shards with no
    host sync and returns its handles; every call allocates its own
    outputs, so sweeps dispatched back to back pipeline on the devices.
    ``finalize(handles)`` fetches them and returns what
    :func:`sharded_pairwise_similarity` returns. The arguments are its
    (``ops.bitmul.sweep_mxu_async`` is the single-device form); every
    sweep dispatched counts into ``trace``.

    With ``pairs`` (:func:`new_sweep_pairs`) every K1 launch also
    appends its sub-step's survivors (cross-class only under
    ``cross_amr_only``, else every class) to its card's buffers there,
    which then go to :func:`sharded_extract_pairs` as ``appended``; what
    ``finalize`` returns is the same either way."""
    st = _stage_inputs(mesh, words, classes, weights, n, block_tile, trace)

    def dispatch():
        row_stats, hits, _ = _pass(mesh, st, n=n, threshold=threshold,
                                   block_tile=block_tile, stats=True,
                                   cross_amr_only=cross_amr_only,
                                   pairs=pairs)
        return row_stats, hits

    def finalize(handles):
        return _finalize_sweep(mesh, *handles, st.n_pad, block_tile)

    return dispatch, finalize


def sharded_pairwise_similarity(
    mesh: Mesh,
    words,
    classes,
    n: int,
    threshold: int,
    block_tile: int = 128,
    weights=None,
    trace: Optional[dict] = None,
    pairs=None,
    cross_amr_only: bool = True,
):
    """The flat ring sweep on a mesh: (row_stats np[N_pad, 8] int64,
    tile_hits np[nT, 2], tiles) in the single-chip engine format.
    ``words`` is the packed [N_pad, W] matrix (numpy or tensor) or staged
    shards (:func:`stage_mesh_inputs`); ``weights`` (int8 [W*32]) give
    the BLOSUM-weighted score. The statistics are K1's on every sub-step
    (the JAX package's ``stats_engine`` choices are bit-identical and not
    carried). The pass counts into ``trace`` (a :data:`last_trace` dict;
    a fresh one when None), which becomes :data:`last_trace`. With
    ``pairs`` K1 also appends the survivors there
    (:func:`sharded_sweep_async`)."""
    return _sweep(mesh, "flat", words, classes, n, threshold, block_tile,
                  weights, trace, pairs, cross_amr_only)


def sharded_pairwise_similarity_2d(
    mesh: Mesh,
    words,
    classes,
    n: int,
    threshold: int,
    block_tile: int = 128,
    weights=None,
    trace: Optional[dict] = None,
    pairs=None,
    cross_amr_only: bool = True,
):
    """The hierarchical (hosts × chips) ring sweep on a mesh of two axes
    (``parallel.make_mesh_2d``; its axis names are the host and chip
    axes): as :func:`sharded_pairwise_similarity`, N_pad a multiple of
    H × C × block_tile."""
    return _sweep(mesh, "2d", words, classes, n, threshold, block_tile,
                  weights, trace, pairs, cross_amr_only)


def sharded_pairwise_similarity_kaxis(
    mesh: Mesh,
    words,
    classes,
    n: int,
    threshold: int,
    block_tile: int = 128,
    weights=None,
    trace: Optional[dict] = None,
    pairs=None,
    cross_amr_only: bool = True,
):
    """The k-axis sweep on a mesh whose one axis is ``"k"``: the packed
    words column-sharded (W divisible by D), one K1 launch a row strip
    (module doc); output as :func:`sharded_pairwise_similarity`, with the
    row stats credited to the smaller index."""
    return _sweep(mesh, "kaxis", words, classes, n, threshold, block_tile,
                  weights, trace, pairs, cross_amr_only)


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
    trace: Optional[dict] = None,
    appended=None,
):
    """Mesh-parallel exact pair extraction on any layout, gathered on the
    first device and sorted by (i, j). Returns int32 [M, 3], equal to the
    single-chip extractor's list on every mesh.

    ``appended`` (the buffers an appending sweep appended to,
    :func:`new_sweep_pairs`; what the pipeline's ``extract="auto"``
    passes): the survivors K1 appended are gathered, sorted and fetched
    after one host read of the cursors, and nothing is recomputed. Where
    no card's cursor passed its slots but their sum differs from
    ``expected_total`` (the sweep's exact total) it raises, as
    ``ops.pairlist.check_cursor`` does: the list is never truncated.

    Without ``appended``, or when a card's cursor passed its slots: the
    second pass, the mesh's schedule once more, compacting survivors into
    pair buffers — each ring shard into its own (so no device ever holds
    the whole matrix), the k-axis strips into the first device's. ``cap``
    bounds the GLOBAL survivor count; more raises "overflow".
    ``tile_cap`` (the densest tile's survivors, from the sweep's tile
    hits) selects per-sub-tile ``torch.topk`` compaction at a width
    bucketed from it: a sub-tile over that width is dropped whole, and
    ``expected_total`` turns the shortfall into a raise. None appends the
    whole mask (what the pipeline's second pass runs). ``trace`` as for
    the sweeps; it gains ``epilogue_pairs`` (the cursors' sum) with
    ``appended``, and ``second_passes`` counts the second pass."""
    if appended is not None:
        trace = _begin_trace(trace)
        arr, m = _gather_pairs(mesh, appended, EPILOGUE_PAIR_CAP, trace,
                               per_card=True)
        trace["epilogue_pairs"] = m
        if arr is not None:
            if expected_total is not None:
                check_cursor(m, expected_total)
            return arr
    k = 0
    if tile_cap is not None:
        k = bucket_pow2(tile_cap, 128, block_tile * block_tile)
    st = _stage_inputs(mesh, words, classes, weights, n, block_tile, trace)
    st.trace["second_passes"] += 1
    _, _, bufs = _pass(
        mesh, st, n=n, threshold=threshold, block_tile=block_tile,
        stats=False, cap=cap, k=k, cross_amr_only=cross_amr_only,
    )
    arr, m = _gather_pairs(mesh, bufs, cap, st.trace)
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
    trace: Optional[dict] = None,
):
    """One fused pass on any layout → (row_stats, tile_hits, tiles,
    pairs): each sub-step's or strip's counts feed K1 and the
    compaction, so the schedule runs once instead of twice. Statistics
    as the layout's sweep, pairs as :func:`sharded_extract_pairs`. When a
    capacity guess misses (a sub-tile over ``k`` survivors, or more than
    ``cap`` in all), the statistics stand and the pairs are extracted
    again by :func:`sharded_extract_pairs`, sized from this pass's exact
    tile hits. ``k`` defaults to 0 off the TPU, as in the JAX package
    (whole-mask compaction: only ``cap`` can overflow). ``trace`` as for
    the sweeps; the second extraction counts into it too."""
    k = 0 if k is None else min(k, block_tile * block_tile)
    st = _stage_inputs(mesh, words, classes, weights, n, block_tile, trace)
    row_stats, hits, bufs = _pass(
        mesh, st, n=n, threshold=threshold, block_tile=block_tile,
        stats=True, cap=cap, k=k, cross_amr_only=cross_amr_only,
    )
    row_stats, tile_hits, tiles = _finalize_sweep(
        mesh, row_stats, hits, st.n_pad, block_tile)
    arr, m = _gather_pairs(mesh, bufs, cap, st.trace)
    del bufs
    total = survivor_total(tile_hits, cross_amr_only, st.trace)
    if arr is not None and m == total:
        return row_stats, tile_hits, tiles, arr
    pairs = sharded_extract_pairs(
        mesh, st.words, st.classes, n, threshold, block_tile=block_tile,
        weights=weights, cross_amr_only=cross_amr_only,
        cap=max(1 << 18, total), tile_cap=None, expected_total=total,
        trace=st.trace,
    )
    return row_stats, tile_hits, tiles, pairs


def doc_freq_psum(mesh: Mesh, codes, valid, k: int):
    """Dense doc-freq for k=5 over window codes row-sharded across every
    device of the mesh (any layout, as JAX's ``axis`` argument allows): a
    bincount per shard (``kmers.index.doc_freq_dense_device``), summed on
    the first device. ``codes``/``valid`` are [N, L] (numpy or tensors,
    N divisible by the mesh size) or shards. Returns int32 [21^k] on the
    first device (across processes: on every rank's home device)."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers.index import (
        doc_freq_dense_device,
    )

    parts = [
        None if c is None else doc_freq_dense_device(c, v, k)
        for c, v in zip(shard_rows(mesh, codes), shard_rows(mesh, valid))
    ]
    return sum_to_first(parts, mesh)
