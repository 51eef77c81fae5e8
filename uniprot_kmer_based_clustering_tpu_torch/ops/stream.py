"""Out-of-core streaming MXU sweep: corpora larger than the device's memory.

Counterpart of the JAX package's ``ops/stream.py``. Every in-core engine
keeps the packed ``[N_pad, W]`` bitset matrix resident on the device. This
engine keeps it in HOST memory and streams row *blocks* through the device:

* a **stationary group** of ``g`` row blocks is uploaded once and stays
  resident;
* every moving block ``j`` is uploaded once per group and swept against
  all stationary blocks ``i ≤ j`` of the group, the upper-triangle
  block-pair schedule of ``ops.bitmul._scan_sweep`` with the operands now
  explicit device tensors instead of slices of a resident matrix;
* statistics accumulate **on the device** in ``[N_pad, 8]`` / ``[nb, nb, 2]``
  buffers (one host fetch for the whole sweep). Each step runs the scan's
  epilogue, ``ops.stats.stats_from_counts_traced_into``: on a CUDA tensor
  one launch of the K2 kernel, on a CPU tensor its plain version.

Host↔device traffic ≈ ``matrix_bytes · nbk / (2·g)`` for the moving blocks
plus one pass of stationaries, the blocking trade-off of an out-of-core
matrix product. Results are bit-identical to every in-core engine.

On CUDA the blocks of a host matrix travel through a small ring of pinned
``[bs, W]`` buffers on a copy stream (:class:`_BlockFeed`), so the copy of
the next block overlaps the products of this one and no more host memory
is pinned than the ring. A step makes no host synchronisation; the host
runs at most ``inflight`` steps ahead of the device, bounded by one CUDA
event a step (:class:`_Window`). :class:`CSRBlockSource` instead carries
the sparse incidence lists to the device once and rebuilds each block
there, so the dense matrix need not exist anywhere.

Three ways to the exact pair list:

* two passes: :func:`sweep_mxu_stream`, then :func:`extract_pairs_stream`
  (row windows of the tiles that reported hits),
  :func:`extract_pairs_stream_grouped` (one more pass on the sweep's own
  schedule) or :func:`extract_pairs_stream_auto` (whichever uploads less);
* fused: ``sweep_mxu_stream(fused_k=…)`` drains each step's per-sub-tile
  top-k survivors inside the in-flight window and
  :func:`extract_pairs_stream_fused` redoes the tiles that overflowed;
* one pass: :func:`sweep_extract_stream` appends each step's survivors to
  global pair buffers on the device (``ops.pairlist``), checks
  the capacity exactly, and can checkpoint at stationary-group boundaries.

The blocking formulas (``bs``, ``g``, ``word_chunk``, the pair-buffer
capacity) are the JAX package's, and ``hbm_budget_bytes`` keeps its 13 GiB
default, so both packages block alike and a checkpoint written by one
resumes in the other.

The ``block_hits [nb, nb, 2]`` accumulator is device-resident and grows
quadratically in the corpus size (8 bytes per tile pair); the budgeting
accounts for it.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from typing import Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
    TOPK_CAP,
    bucket_pow2,
    counts_window_pair,
    survivor_mask,
    topk_subtile_candidates,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
    append_block,
    finalize_pairs,
    merge_pairs,
    new_pair_buffers,
    sort_compact_append,
    tile_survivors,
    vcap_bucket,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (
    upper_triangle_tiles,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import (
    stats_from_counts_traced_into,
)

#: Phase breakdown of the most recent :func:`sweep_mxu_stream` call: wall
#: seconds in uploads (the host's share: staging and enqueueing),
#: step dispatch, in-flight drains (the blocking waits) and the final
#: accumulator fetch, the bytes uploaded, and the resolved blocking.
last_trace: dict = {}

#: Same, for the most recent :func:`extract_pairs_stream` call.
last_extract_trace: dict = {}

#: Same, for :func:`extract_pairs_stream_grouped`: adds the block pairs
#: visited beside their total.
last_grouped_trace: dict = {}

#: Same, for :func:`sweep_extract_stream`: adds ``overflow`` (the
#: capacity-miss redo flag), ``vcap`` and the dispatch mode.
last_onepass_trace: dict = {}

# 2^b as int32 bit patterns; bit 31 is the sign bit
_BIT = [1 << b for b in range(31)] + [-(1 << 31)]


def _materialize_block(rows_a, ranks_a, valid_a, bit_table, b: int, *,
                       bs: int, w: int):
    """[bs, w] packed words (int32 bit patterns) of block ``b`` from the
    staged per-block incidence tensors ([nbk, m] each); ``bit_table`` is
    :data:`_BIT` on their device.

    Each (row, rank) adds its own power of two into word ``rank >> 5`` of
    its row. Two ranks of one row in the same word share a flat index, so
    the add accumulates (``index_add_``); distinct bits never carry, and
    the sum is the OR. Padding lanes add 0 to word 0.
    """
    rows_b, ranks_b, valid_b = rows_a[b], ranks_a[b], valid_a[b]
    flat = torch.where(
        valid_b, rows_b.to(torch.int64) * w + (ranks_b >> 5), 0
    )
    bit = bit_table[(ranks_b & 31).to(torch.int64)]
    words = torch.zeros(bs * w, dtype=torch.int32, device=rows_b.device)
    words.index_add_(0, flat, torch.where(valid_b, bit, 0))
    return words.view(bs, w)


def split_incidence_blocks(p: np.ndarray, r: np.ndarray, bs: int, nbk: int):
    """Split protein-sorted incidence lists into per-``bs``-row-block
    arrays padded to the largest block's count, the staging layout of
    :class:`CSRBlockSource`. Returns ``(rows, ranks, valid)``, each
    ``[nbk, m]`` with ``m`` rounded up to 8 lanes; ``rows`` are
    block-local."""
    offs = np.searchsorted(p, np.arange(nbk + 1) * bs)
    per = np.diff(offs)
    m = int(per.max()) if nbk else 0
    m = max(8, -(-m // 8) * 8)
    rows = np.zeros((nbk, m), np.int32)
    ranks = np.zeros((nbk, m), np.int32)
    valid = np.zeros((nbk, m), bool)
    for b in range(nbk):
        lo, hi = offs[b], offs[b + 1]
        k = hi - lo
        rows[b, :k] = p[lo:hi] - b * bs
        ranks[b, :k] = r[lo:hi]
        valid[b, :k] = True
    return rows, ranks, valid


class CSRBlockSource:
    """Packed row blocks materialized on the device from the sparse
    incidence lists: the block source that never needs the dense matrix.

    The packed bitset of a large corpus is very sparse, so the incidence
    lists are a small fraction of the dense matrix. The host-words source
    re-streams the dense matrix once per stationary group; this source
    uploads the incidence lists ONCE (:meth:`prepare`) and rebuilds each
    ``[bs, W]`` block on the device with an accumulating single-bit
    scatter (:func:`_materialize_block`). The per-block flat index space
    ``bs·W`` is small whatever the corpus size.

    Prefer it where host→device bandwidth is the bottleneck, or where the
    host cannot hold the dense matrix at all. Blocks equal the
    ``pack_bitsets`` row slices bit for bit.
    """

    def __init__(self, incidence_protein, incidence_rank, n_rows: int,
                 w_words: int):
        p = np.asarray(incidence_protein, np.int32)
        r = np.asarray(incidence_rank, np.int32)
        if p.shape[0] and np.any(np.diff(p) < 0):
            order = np.argsort(p, kind="stable")
            p, r = p[order], r[order]
        self._p, self._r = p, r
        self.n_rows = int(n_rows)
        self.w_words = int(w_words)
        self._bs = None
        self._nbk = 0
        self._device = None
        # device bytes of the staged per-block arrays (rows + ranks int32,
        # valid bool, padded to the largest block's count: charged twice
        # for skew); the stream entry points take this off their budget
        self.staging_estimate = 18 * max(1, p.shape[0])

    def prepare(self, bs: int, n_pad: Optional[int] = None,
                device="cuda") -> None:
        """Split the incidences per bs-row block and stage them on
        ``device``. ``n_pad`` extends the coverage with all-zero blocks
        (the sweep's row padding)."""
        device = resolve_device(device)
        nbk = -(-(n_pad or self.n_rows) // bs)
        if self._bs == bs and self._nbk >= nbk and self._device == device:
            return
        self._bs, self._nbk, self._device = bs, nbk, device
        rows, ranks, valid = split_incidence_blocks(self._p, self._r, bs, nbk)
        self._rows = torch.from_numpy(rows).to(device)
        self._ranks = torch.from_numpy(ranks).to(device)
        self._valid = torch.from_numpy(valid).to(device)
        self._bit = torch.tensor(_BIT, dtype=torch.int32, device=device)
        self.staging_estimate = rows.nbytes + ranks.nbytes + valid.nbytes

    def put(self, b: int):
        """Block ``b`` on the device: int32 [bs, W] (the uint32 words' bit
        patterns)."""
        return _materialize_block(
            self._rows, self._ranks, self._valid, self._bit, int(b),
            bs=self._bs, w=self.w_words,
        )


@dataclasses.dataclass
class StreamCandidates:
    """Survivor candidates drained from a fused streaming sweep.

    ``pairs`` (int32 [M, 3]) are complete for every tile whose exact hit
    count is ≤ ``k``; ``include_same`` records the candidate mask the
    sweep used (the extract side checks it, as the in-core
    ``FusedCandidates`` contract does)."""

    pairs: np.ndarray
    k: int
    include_same: bool


class _BlockFeed:
    """Row blocks ``[bs, W]`` (int32 bit patterns) on the device, from a
    host matrix or a :class:`CSRBlockSource`, with the stationary group's
    blocks kept until :meth:`end_group`.

    From a host matrix on CUDA a block is staged into one of ``slots``
    pinned buffers and copied on a copy stream; an event per slot keeps a
    slot from being rewritten before its copy has left, and the compute
    stream waits for the block it reads. The block's memory belongs to
    the copy stream's pool, so it is recorded on the compute stream and
    not reused before the steps that read it have run. On the CPU a block
    is a view of the host matrix. Rows past the matrix are zero (the
    sweep's row padding), so the matrix is never copied to pad it.
    """

    def __init__(self, words_host, block_source, bs: int, device,
                 slots: int, trace: dict):
        self.source = block_source
        self.bs = bs
        self.device = device
        self.trace = trace
        self.resident = {}
        trace.setdefault("upload_s", 0.0)
        trace.setdefault("uploads", 0)
        trace.setdefault("upload_bytes", 0)
        if block_source is not None:
            return
        self.words = words_host.view(np.int32)
        w = self.words.shape[1]
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.ring = [
                torch.empty((bs, w), dtype=torch.int32, pin_memory=True)
                for _ in range(slots)
            ]
            self.sent = [None] * slots
            self.turn = 0

    def put(self, b: int):
        """Block ``b``, uploaded (or materialized) now."""
        t0 = time.perf_counter()
        if self.source is not None:
            out = self.source.put(b)
        else:
            rows = self.words[b * self.bs : (b + 1) * self.bs]
            out = (self._upload(rows) if self.device.type == "cuda"
                   else self._view(rows))
            self.trace["upload_bytes"] += rows.nbytes
        self.trace["upload_s"] += time.perf_counter() - t0
        self.trace["uploads"] += 1
        return out

    def _view(self, rows):
        if rows.shape[0] == self.bs:
            return torch.from_numpy(rows)
        out = torch.zeros((self.bs, rows.shape[1]), dtype=torch.int32)
        out[: rows.shape[0]] = torch.from_numpy(rows)
        return out

    def _upload(self, rows):
        slot = self.turn % len(self.ring)
        self.turn += 1
        if self.sent[slot] is not None:
            self.sent[slot].synchronize()
        staged = self.ring[slot]
        host = staged.numpy()
        host[: rows.shape[0]] = rows
        host[rows.shape[0] :] = 0
        with torch.cuda.stream(self.stream):
            out = staged.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
        self.sent[slot] = copied
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(copied)
        out.record_stream(compute)
        return out

    def stationary(self, b: int):
        """Block ``b`` of the stationary group: uploaded on first use,
        then resident."""
        if b not in self.resident:
            self.resident[b] = self.put(b)
        return self.resident[b]

    def end_group(self):
        self.resident = {}


class _Window:
    """The in-flight bound: the host runs at most ``limit`` steps ahead of
    the device. Each pushed step records a CUDA event on its device's
    current stream (``device``: the step's device, default the window's
    own, never the current device: a window on a second card would
    otherwise bound the first card's stream); draining waits for the
    newest retired step's event of each device (a device runs its steps
    in launch order, so that retires every earlier one) and hands back
    the retired payloads. No copy, no stream synchronisation. On the CPU
    steps have run when they return."""

    def __init__(self, device, trace: dict):
        self.device = device
        self.cuda = device.type == "cuda"
        self.trace = trace
        self.pending = []
        trace.setdefault("drain_s", 0.0)

    def push(self, payload=None, device=None):
        device = self.device if device is None else device
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        self.pending.append((done, payload, device))

    def drain(self, limit: int):
        t0 = time.perf_counter()
        retired = []
        if len(self.pending) > limit:
            retired = self.pending[: len(self.pending) - limit]
            del self.pending[: len(self.pending) - limit]
            waited = set()
            for done, _, device in reversed(retired):
                if done is not None and device not in waited:
                    waited.add(device)
                    done.synchronize()
        self.trace["drain_s"] += time.perf_counter() - t0
        return [payload for _, payload, _ in retired if payload is not None]


def _to_host(*tensors):
    """The copies of a sweep's results to the host, as numpy arrays."""
    return tuple(t.cpu().numpy() for t in tensors)


def _groups(nbk: int, g: int, done=()):
    """(s0, g_here) of every stationary group not in ``done``."""
    for s0 in range(0, nbk, g):
        if s0 not in done:
            yield s0, min(g, nbk - s0)


def _group_steps(s0: int, g_here: int, nbk: int, need=None):
    """(jb, [ib, …]) for the moving blocks of group ``s0``: its stationary
    partners ib ≤ jb, only those ``need[ib, jb]`` marks when given; moving
    blocks with no partner are left out (they are never uploaded)."""
    for jb in range(s0, nbk):
        ibs = [ib for ib in range(s0, min(s0 + g_here, jb + 1))
               if need is None or need[ib, jb]]
        if ibs:
            yield jb, ibs


def _stream_step(row_stats, block_hits, wa, wb, ca, cb, weights, i0: int,
                 j0: int, *, n: int, threshold: int, block: int,
                 w_thresh: int, word_chunk: int = 0, fused_k: int = 0,
                 fused_same: bool = False):
    """One block pair: the counts product and its statistics, merged into
    the accumulators in place by the scan's epilogue (K2 on CUDA tensors,
    its plain version on CPU tensors). No host synchronisation.

    With ``fused_k`` > 0 also returns the step's per-sub-tile top-k
    survivor candidates, stacked int32 [3, nsub, fused_k] (row, column,
    count; count −1 in unused slots), else None. A sub-tile whose exact
    hit count exceeds ``fused_k`` is incomplete and is redone by the
    two-pass extractors.
    """
    bs = wa.shape[0]
    counts = counts_window_pair(wa, wb, weights, word_chunk=word_chunk)
    stats_from_counts_traced_into(
        counts, ca, cb, row_stats[i0 : i0 + bs],
        block_hits[i0 // block :, j0 // block :], i0, j0, n=n,
        threshold=threshold, w_thresh=w_thresh, tile=block,
    )
    if not fused_k:
        return None
    em = survivor_mask(counts, ca, cb, i0, j0, n=n, threshold=threshold,
                       include_same=fused_same)
    return torch.stack(topk_subtile_candidates(
        em.to(torch.int32), counts, i0, j0, tile=block, k=fused_k,
    ))


def _pad_rows(rows0: int, classes: np.ndarray, multiple: int):
    """Row padding so the block schedule divides evenly: the padded row
    count and the classes extended with −1 to it. Padding rows have empty
    bitsets and invalid classes, and the ``gj < n`` mask excludes them
    from every statistic. The words are not copied: the block feed
    zero-fills the rows past the matrix."""
    classes = np.asarray(classes, np.int32)
    target = -(-rows0 // multiple) * multiple
    if classes.shape[0] < target:
        classes = np.concatenate(
            [classes, np.full(target - classes.shape[0], -1, np.int32)]
        )
    return target, classes


def auto_stream_block(n_pad: int, w_words: int, block: int,
                      hbm_budget_bytes: int) -> int:
    """Stream-block row count: large blocks amortize dispatch and keep
    the contraction long, but one block must fit many times over (the
    stationary group, the in-flight moving blocks, the int32 counts
    square). Capped so the [bs, bs] counts block stays ≤ 1/16 of the
    budget, one packed [bs, W] block ≤ 1/8, and bs ≤ 4096."""
    bs = block
    while (
        bs * 2 <= 4096
        and bs * 2 <= n_pad
        and (bs * 2) * (bs * 2) * 4 <= hbm_budget_bytes // 16
        and (bs * 2) * w_words * 4 <= hbm_budget_bytes // 8
    ):
        bs *= 2
    return max(block, bs)


def _source_geometry(words_host, block_source):
    """(words_host contiguous or None, rows, words a row) of a sweep's
    block source."""
    if block_source is not None:
        return None, block_source.n_rows, block_source.w_words
    words_host = np.ascontiguousarray(words_host)
    return words_host, words_host.shape[0], words_host.shape[1]


def _resident_blocking(bs: int, w_words: int, nbk: int, avail: int,
                       word_chunk: Optional[int],
                       max_group: Optional[int]):
    """(word_chunk, g) from what the budget leaves (``avail`` bytes): the
    contraction chunk that bounds the unpacked int8 transients (8× the
    packed block each) to half of it, and the stationary group size, the
    [bs, W] blocks that fit the other half."""
    block_bytes = bs * w_words * 4
    if word_chunk is None:
        word_chunk = 0
        if 2 * bs * w_words * 32 > avail // 2:
            target = max(128, avail // 2 // (2 * bs * 32))
            base = w_words // 128
            best = 1
            for d in range(1, base + 1):
                if base % d == 0 and d * 128 <= target:
                    best = d
            word_chunk = best * 128
    resident_budget = max(block_bytes, avail // 2)
    g = int(min(nbk, max(1, resident_budget // block_bytes)))
    if max_group:
        g = max(1, min(g, int(max_group)))
    return word_chunk, g


def _device_operands(classes, weights, w_words: int, bs: int, device):
    """The class vector split into per-block device tensors and the int8
    weights (None when unweighted) on ``device``."""
    cls = torch.from_numpy(np.ascontiguousarray(classes)).to(device)
    wts = None
    if weights is not None:
        wts = torch.from_numpy(
            np.ascontiguousarray(weights, dtype=np.int8)
        ).to(device)
        if wts.shape != (w_words * 32,):
            raise ValueError("weights must be int8 [W*32]")
    return list(cls.split(bs)), wts


def _sweep_loop(feed, window, cls_dev, wts, row_stats, block_hits, *,
                nbk: int, g: int, bs: int, inflight: int, fused_k: int,
                trace: dict, on_candidates, **step_kw):
    """The stream sweep's device loop: every block pair of every group
    through :func:`_stream_step`, the in-flight window after each step.
    With ``fused_k`` each step's candidates go to pinned host memory with
    a non-blocking copy and reach ``on_candidates`` (as a numpy array)
    when the window retires the step. The only host waits are the
    window's events and the feed's slot events."""
    def retire(payloads):
        for p in payloads:
            on_candidates(p.numpy())

    for s0, g_here in _groups(nbk, g):
        for jb, ibs in _group_steps(s0, g_here, nbk):
            wb = (feed.stationary(jb) if jb < s0 + g_here
                  else feed.put(jb))
            for ib in ibs:
                t0 = time.perf_counter()
                ys = _stream_step(
                    row_stats, block_hits, feed.stationary(ib), wb,
                    cls_dev[ib], cls_dev[jb], wts, ib * bs, jb * bs,
                    fused_k=fused_k, **step_kw,
                )
                if ys is not None and ys.is_cuda:
                    host = torch.empty(ys.shape, dtype=ys.dtype,
                                       pin_memory=True)
                    ys = host.copy_(ys, non_blocking=True)
                trace["dispatch_s"] += time.perf_counter() - t0
                trace["steps"] += 1
                window.push(ys)
                retire(window.drain(inflight))
        feed.end_group()
    retire(window.drain(0))


def sweep_mxu_stream(
    words_host: Optional[np.ndarray],
    classes: np.ndarray,
    n: int,
    threshold: int,
    *,
    bs: Optional[int] = None,
    block: int = 512,
    weights: Optional[np.ndarray] = None,
    w_thresh: int = 1,
    word_chunk: Optional[int] = None,
    hbm_budget_bytes: int = 13 << 30,
    inflight: int = 4,
    fused_k: int = 0,
    fused_same: bool = False,
    max_group: Optional[int] = None,
    block_source: Optional[CSRBlockSource] = None,
    device="cuda",
):
    """Full upper-triangle sweep with the packed matrix in HOST memory
    (``words_host`` uint32 [rows, W], numpy), on ``device`` ("cuda", "cpu"
    or a torch.device; CUDA without a GPU raises).

    ``bs`` plays ``strip``'s role: rows per streamed block (None: sized
    from the budget by :func:`auto_stream_block`). ``max_group`` caps the
    stationary-group size below the budget's choice, the seam for the
    multi-group schedule that real budgets force only beyond the device's
    memory. ``block_source`` (a :class:`CSRBlockSource`) materializes the
    row blocks on the device from the incidence lists; ``words_host`` may
    then be None. ``hbm_budget_bytes`` keeps the JAX package's default,
    sized for a 16 GB device, so both packages block alike.

    Returns ``(row_stats int64 [N_pad', 8], tile_hits int32 [nT, 2],
    (ti, tj, block))`` as numpy arrays; ``N_pad'`` may exceed the matrix's
    rows (padded to a ``bs`` multiple; padding rows carry zero stats).

    With ``fused_k`` > 0 a 4th element follows: :class:`StreamCandidates`,
    drained from each step's per-sub-tile top-k inside the in-flight
    window, so candidate buffers never pile up on the device. A sub-tile
    whose exact hit count exceeds ``fused_k`` is truncated;
    :func:`extract_pairs_stream_fused` finds those from the tile hits and
    redoes them exactly. ``fused_same`` keeps same-class survivors too.
    """
    device = resolve_device(device)
    words_host, rows0, w_words = _source_geometry(words_host, block_source)
    if bs is None:
        bs = auto_stream_block(rows0, w_words, block, hbm_budget_bytes)
    if bs % block:
        raise ValueError("stream block must be a multiple of the tile")
    n_pad, classes = _pad_rows(rows0, classes, bs)
    if block_source is not None:
        block_source.prepare(bs, n_pad, device)
    nb = n_pad // block
    nbk = n_pad // bs

    if fused_k:
        # a capacity beyond a sub-tile's area means nothing;
        # extract_pairs_stream_fused reads the clamped value back
        fused_k = min(fused_k, block * block)
    block_bytes = bs * w_words * 4
    # what stays on the device beside the blocks: the two accumulators
    # (block_hits grows quadratically in the corpus), the in-flight
    # window of moving blocks with their counts squares and candidate
    # buffers, the classes and a CSR source's staging
    nsub = (bs // block) ** 2
    fixed = (
        n_pad * 8 * 4
        + nb * nb * 2 * 4
        + (inflight + 1) * (block_bytes + bs * bs * 4 + nsub * fused_k * 12)
        + n_pad * 4
        + (block_source.staging_estimate if block_source is not None else 0)
    )
    avail = max(block_bytes, hbm_budget_bytes - fixed)
    word_chunk, g = _resident_blocking(bs, w_words, nbk, avail, word_chunk,
                                       max_group)

    trace = {
        "upload_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
        "fetch_s": 0.0, "steps": 0, "uploads": 0, "upload_bytes": 0,
        "bs": int(bs), "g": int(g), "nbk": int(nbk),
        "word_chunk": int(word_chunk),
    }
    cls_dev, wts = _device_operands(classes, weights, w_words, bs, device)
    row_stats = torch.zeros((n_pad, 8), dtype=torch.int32, device=device)
    block_hits = torch.zeros((nb, nb, 2), dtype=torch.int32, device=device)
    feed = _BlockFeed(words_host, block_source, bs, device, inflight + 1,
                      trace)
    cand_parts = []

    def keep_candidates(arr):
        m = arr[2] >= 0
        if m.any():
            cand_parts.append(np.stack(
                [arr[0][m], arr[1][m], arr[2][m]], axis=1
            ).astype(np.int32))

    _sweep_loop(
        feed, _Window(device, trace), cls_dev, wts, row_stats, block_hits,
        nbk=nbk, g=g, bs=bs, inflight=inflight, fused_k=fused_k,
        trace=trace, on_candidates=keep_candidates, n=n,
        threshold=threshold, block=block, w_thresh=w_thresh,
        word_chunk=word_chunk, fused_same=fused_same,
    )

    t0 = time.perf_counter()
    rs, bh = _to_host(row_stats, block_hits)
    trace["fetch_s"] += time.perf_counter() - t0
    global last_trace
    last_trace = trace

    ti, tj = upper_triangle_tiles(n_pad, block)
    base = (rs.astype(np.int64), bh[ti, tj], (ti, tj, block))
    if not fused_k:
        return base
    cands = StreamCandidates(
        pairs=(np.concatenate(cand_parts, axis=0) if cand_parts
               else np.zeros((0, 3), np.int32)),
        k=fused_k,
        include_same=fused_same,
    )
    return base + (cands,)


def _step_compact_body(state, wa, wb, ca, cb, weights, i0: int, j0: int, *,
                       n: int, threshold: int, block: int, w_thresh: int,
                       word_chunk: int, cross_amr_only: bool):
    """One block pair of the ONE-PASS engine: the counts product, its
    statistics merged into the accumulators (K2 on CUDA tensors) and its
    survivors appended to the global pair buffers, all in place and with
    no host synchronisation. The survivor mask is the mask the statistics
    count, so the cursor equals the sweep's exact pair total whenever the
    capacity suffices. ``state`` is (row_stats, block_hits, gbi, gbj, gbc,
    cursor); returns it updated."""
    row_stats, block_hits, gbi, gbj, gbc, cursor = state
    bs = wa.shape[0]
    counts = counts_window_pair(wa, wb, weights, word_chunk=word_chunk)
    stats_from_counts_traced_into(
        counts, ca, cb, row_stats[i0 : i0 + bs],
        block_hits[i0 // block :, j0 // block :], i0, j0, n=n,
        threshold=threshold, w_thresh=w_thresh, tile=block,
    )
    em = survivor_mask(counts, ca, cb, i0, j0, n=n, threshold=threshold,
                       include_same=not cross_amr_only)
    gbi, gbj, gbc, cursor = append_block(gbi, gbj, gbc, cursor, em, counts,
                                         i0, j0)
    return row_stats, block_hits, gbi, gbj, gbc, cursor


def _materialize_stack(feed: _BlockFeed, s0: int, g_here: int) -> None:
    """Make the stationary group's blocks resident up front (the "scan"
    dispatch builds the whole group before its first step)."""
    for t in range(g_here):
        feed.stationary(s0 + t)


def _onepass_loop(feed, window, cls_dev, wts, state, *, nbk: int, g: int,
                  bs: int, inflight: int, dispatch: str, scan_chunk: int,
                  done_groups, trace: dict, on_group_end, **step_kw):
    """The one-pass engine's device loop over the groups not in
    ``done_groups``. A probe (one event) is pushed after every step
    ("steps") or after every ``scan_chunk`` moving blocks ("scan"), and
    the window is drained down to ``inflight`` once more than twice that
    many are pending. ``on_group_end(state, s0)`` runs at each group's
    boundary. Returns the state."""
    def probe():
        trace["launches"] += 1
        window.push()
        if len(window.pending) > 2 * inflight:
            window.drain(inflight)

    for s0, g_here in _groups(nbk, g, done_groups):
        if dispatch == "scan":
            _materialize_stack(feed, s0, g_here)
        moved = 0
        for jb, ibs in _group_steps(s0, g_here, nbk):
            wb = (feed.stationary(jb) if jb < s0 + g_here
                  else feed.put(jb))
            for ib in ibs:
                t0 = time.perf_counter()
                state = _step_compact_body(
                    state, feed.stationary(ib), wb, cls_dev[ib],
                    cls_dev[jb], wts, ib * bs, jb * bs, **step_kw,
                )
                trace["dispatch_s"] += time.perf_counter() - t0
                trace["steps"] += 1
                if dispatch == "steps":
                    probe()
            moved += 1
            if dispatch == "scan" and moved % scan_chunk == 0:
                probe()
        if dispatch == "scan" and moved % scan_chunk:
            probe()
        feed.end_group()
        on_group_end(state, s0)
    return state


def sweep_extract_stream(
    words_host: Optional[np.ndarray],
    classes: np.ndarray,
    n: int,
    threshold: int,
    *,
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
    block_source: Optional[CSRBlockSource] = None,
    pair_format: str = "arr3",
    dispatch: str = "auto",
    scan_chunk: int = 8,
    checkpoint_store=None,
    checkpoint_key: Optional[str] = None,
    fail_after_groups: Optional[int] = None,
    device="cuda",
):
    """ONE-PASS out-of-core sweep **and** exact pair extraction.

    Each step appends its survivors to global pair buffers on the device
    (``ops.pairlist.append_block``): statistics and the pair list come out
    of one streamed pass, and the host fetches one device-sorted array at
    the end. With ``block_source`` the row blocks are materialized on the
    device from the incidence lists and ``words_host`` may be None.

    ``cap`` bounds the pair buffers (default: an eighth of the budget,
    bucketed; an explicit cap is honoured to 128 rows, so that the
    capacity miss is reachable). Capacity is verified exactly: the sweep's
    own over-threshold total must fit, and the cursor must equal it; on a
    miss the pair list is redone by :func:`extract_pairs_stream_grouped`
    from the exact tile hits (one more pass), so the result is the same in
    every regime.

    ``pair_format="packed"`` fetches the pair list in the packed int64
    layout (``ops.pairlist.unpack_pairs`` decodes it) when row
    indices and counts fit the pack, else [M, 3]; callers tell them apart
    by ``ndim``.

    ``dispatch``: "steps" probes the in-flight window after every block
    pair; "scan" (the "auto" choice with a CSR block source, and only
    possible with one) builds the whole stationary group first and probes
    once per ``scan_chunk`` moving blocks. Both run the same steps in the
    same order.

    Returns ``(row_stats int64 [N_pad', 8], tile_hits int32 [nT, 2],
    (ti, tj, block), pairs int32 [M, 3] or packed int64 [M])``.

    **Group-boundary checkpointing** (``checkpoint_store``, a
    ``utils.checkpoint.CheckpointStore``, plus ``checkpoint_key``): at
    every completed stationary group the statistics accumulators and the
    list of completed groups persist; a rerun with the same store, key
    and geometry skips the completed groups. The pair buffers are not
    snapshotted: the completed groups' pairs are recovered exactly from
    the checkpointed tile hits through
    :func:`extract_pairs_stream_grouped` restricted to their tiles, a
    partial extra pass paid only after a real interruption. A snapshot of
    another geometry (bs, g, threshold, the weights' crc32, …) is ignored,
    and a completed run removes its snapshot. The snapshot's arrays are
    the JAX package's, so either package resumes the other's.
    ``fail_after_groups`` is the fault-injection seam: raise after that
    many groups completed in this run.
    """
    device = resolve_device(device)
    words_host, rows0, w_words = _source_geometry(words_host, block_source)
    if cap is None:
        # an eighth of the budget, never more than the pair space itself
        cap = max(1, min(int(hbm_budget_bytes // 8 // 12), n * (n - 1) // 2))
        vcap = vcap_bucket(int(cap))
    else:
        vcap = max(128, -(-int(cap) // 128) * 128)
    # the buffers AND the append's slack window come off the budget before
    # the blocks are sized (bs² when the caller fixed bs, else
    # auto_stream_block's cap of 4096)
    slack = int(bs) ** 2 if bs else 4096 * 4096
    src_bytes = (
        block_source.staging_estimate if block_source is not None else 0
    )
    budget = max(1 << 28, hbm_budget_bytes - 3 * (vcap + slack) * 4 - src_bytes)
    if bs is None:
        bs = auto_stream_block(rows0, w_words, block, budget)
    if bs % block:
        raise ValueError("stream block must be a multiple of the tile")
    n_pad, classes = _pad_rows(rows0, classes, bs)
    if block_source is not None:
        block_source.prepare(bs, n_pad, device)
    nb = n_pad // block
    nbk = n_pad // bs

    block_bytes = bs * w_words * 4
    # the drain window is 2·inflight probes: charge one distinct moving
    # block per pending step
    fixed = (
        n_pad * 8 * 4
        + nb * nb * 2 * 4
        + (2 * inflight + 1) * (block_bytes + 4 * bs * bs * 4)
        + n_pad * 4
    )
    avail = max(block_bytes, budget - fixed)
    word_chunk, g = _resident_blocking(bs, w_words, nbk, avail, word_chunk,
                                       max_group)

    if dispatch == "auto":
        dispatch = "scan" if block_source is not None else "steps"
    if dispatch not in ("scan", "steps"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if dispatch == "scan" and block_source is None:
        raise ValueError(
            "dispatch='scan' requires a CSR block_source (host-words "
            "blocks must upload between launches)"
        )

    # checkpoint restore: the accumulators of a snapshot with this very
    # geometry, and the groups it completed. The crc is of the weight
    # VALUES: resuming with other weights would merge stale accumulators
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
    row_stats = torch.zeros((n_pad, 8), dtype=torch.int32, device=device)
    block_hits = torch.zeros((nb, nb, 2), dtype=torch.int32, device=device)
    if ckpt_on:
        snap = checkpoint_store.load(checkpoint_key)
        if snap is not None and np.array_equal(snap.get("geometry"), ckpt_geo):
            prior_groups = {int(x) for x in snap["groups_done"]}
            row_stats.copy_(torch.from_numpy(snap["row_stats"]))
            block_hits.copy_(torch.from_numpy(snap["block_hits"]))
    done_groups = set(prior_groups)
    groups_this_run = 0

    trace = {
        "upload_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
        "fetch_s": 0.0, "steps": 0, "uploads": 0, "upload_bytes": 0,
        "bs": int(bs), "g": int(g), "nbk": int(nbk),
        "word_chunk": int(word_chunk), "vcap": int(vcap),
        "dispatch": dispatch, "launches": 0,
        "overflow": False,
    }
    window = _Window(device, trace)

    def group_boundary(state, s0):
        """Settle the queue, fetch the (small) accumulators, persist them,
        and fire the fault-injection seam."""
        nonlocal groups_this_run
        if not ckpt_on:
            return
        window.drain(0)
        t0 = time.perf_counter()
        rs_c, bh_c = _to_host(state[0], state[1])
        done_groups.add(s0)
        checkpoint_store.save(
            checkpoint_key,
            compressed=False,
            geometry=ckpt_geo,
            groups_done=np.array(sorted(done_groups), np.int64),
            row_stats=rs_c,
            block_hits=bh_c,
        )
        trace["ckpt_s"] = trace.get("ckpt_s", 0.0) + (
            time.perf_counter() - t0
        )
        groups_this_run += 1
        if (fail_after_groups is not None
                and groups_this_run >= fail_after_groups):
            raise RuntimeError(
                f"stream checkpoint fault injection: killed after "
                f"{groups_this_run} group(s)"
            )

    cls_dev, wts = _device_operands(classes, weights, w_words, bs, device)
    feed = _BlockFeed(words_host, block_source, bs, device, inflight + 1,
                      trace)
    # + one [bs, bs] window of slack rows for the append
    state = (row_stats, block_hits) + new_pair_buffers(vcap + bs * bs,
                                                       device)
    state = _onepass_loop(
        feed, window, cls_dev, wts, state, nbk=nbk, g=g, bs=bs,
        inflight=inflight, dispatch=dispatch, scan_chunk=scan_chunk,
        done_groups=prior_groups, trace=trace, on_group_end=group_boundary,
        n=n, threshold=threshold, block=block, w_thresh=w_thresh,
        word_chunk=word_chunk, cross_amr_only=cross_amr_only,
    )
    window.drain(0)

    row_stats, block_hits, gbi, gbj, gbc, cursor = state
    t0 = time.perf_counter()
    rs, bh, count = _to_host(row_stats, block_hits, cursor)
    trace["fetch_s"] += time.perf_counter() - t0
    ti, tj = upper_triangle_tiles(n_pad, block)
    tile_hits = bh[ti, tj]
    tiles = (ti, tj, block)
    hits_vec = tile_survivors(tile_hits, cross_amr_only)
    total = int(hits_vec.sum())

    # after a resume the cursor counts only the groups swept NOW; the
    # prior groups' survivors are known exactly from the restored tile
    # hits and come back through the grouped extractor below
    prior_mask = None
    total_prior = 0
    if prior_groups:
        nsb = bs // block
        owner = ((ti // nsb) // g) * g
        prior_mask = np.isin(
            owner, np.fromiter(prior_groups, np.int64, len(prior_groups))
        )
        total_prior = int(hits_vec[prior_mask].sum())
        trace["groups_skipped"] = len(prior_groups)
    total_now = total - total_prior

    def grouped(hits):
        # the sweep's own blocking, so a CSR source keeps its staging
        return extract_pairs_stream_grouped(
            words_host, classes, hits, tiles, n=n, threshold=threshold,
            cross_amr_only=cross_amr_only, weights=weights,
            hbm_budget_bytes=hbm_budget_bytes, inflight=inflight,
            block_source=block_source, bs=bs, word_chunk=word_chunk,
            max_group=max_group, pair_format=pair_format, device=device,
        )

    if total_now > vcap:
        # capacity miss, decided from the sweep's own exact int64 total:
        # redo the pair list from the exact tile hits (one more pass)
        trace["overflow"] = True
        pairs = grouped(tile_hits)
    else:
        t0 = time.perf_counter()
        pairs = finalize_pairs((gbi, gbj, gbc, count), total_now,
                               pair_format, n_pad)
        trace["fetch_s"] += time.perf_counter() - t0
        trace["pair_format"] = "packed" if pairs.ndim == 1 else "arr3"
        if total_prior:
            # resume merge: the checkpointed groups' pairs from their
            # exact tile hits, and the union put in canonical order
            masked = np.zeros_like(tile_hits)
            masked[prior_mask] = tile_hits[prior_mask]
            pairs = merge_pairs(pairs, grouped(masked))
    if ckpt_on:
        # completed: a stale snapshot must not hijack the next run
        p = checkpoint_store.path(checkpoint_key)
        if p and os.path.exists(p):
            os.remove(p)
    global last_onepass_trace
    last_onepass_trace = trace
    return rs.astype(np.int64), tile_hits, tiles, pairs


def extract_pairs_stream_fused(
    words_host: np.ndarray,
    classes: np.ndarray,
    tile_hits: np.ndarray,
    tiles,
    cands: StreamCandidates,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights: Optional[np.ndarray] = None,
    redo: str = "auto",
    device="cuda",
) -> np.ndarray:
    """Fused-mode pair recovery for the streaming engine.

    ``cands`` holds the sweep's drained per-sub-tile top-k survivors,
    complete for every tile whose exact hit count (from ``tile_hits``) is
    ≤ ``cands.k``; denser tiles were truncated and are redone exactly by a
    two-pass extractor on a masked ``tile_hits``: the window extractor, or
    the grouped one when the truncation is widespread (``redo`` "auto"
    decides by upload volume, :func:`_prefer_grouped`; "grouped" and
    "window" force one). Bit-identical to two-pass in every regime.
    """
    if cands.include_same != (not cross_amr_only):
        raise ValueError(
            "candidate mask/class-filter mismatch: the sweep's fused_same "
            "must equal (not cross_amr_only)"
        )
    k = cands.k
    cpairs = cands.pairs
    ti, tj, tile = tiles
    h = tile_survivors(tile_hits, cross_amr_only)
    keep = h <= k  # tiles whose candidates are complete

    parts = []
    if cpairs.shape[0]:
        # map each candidate to its tile and keep only complete tiles
        nb = int(max(ti.max(), tj.max())) + 1 if len(ti) else 1
        keep_m = np.zeros((nb, nb), bool)
        keep_m[ti[keep], tj[keep]] = True
        ci = (cpairs[:, 0] // tile).astype(np.int64)
        cj = (cpairs[:, 1] // tile).astype(np.int64)
        sel = keep_m[ci, cj]
        parts.append(cpairs[sel])
        expected = int(h[keep].sum())
        if int(sel.sum()) != expected:
            raise AssertionError(
                f"fused stream compaction found {int(sel.sum())} "
                f"survivors, sweep stats promised {expected}"
            )

    if not keep.all():
        masked = np.zeros_like(tile_hits)
        masked[~keep] = tile_hits[~keep]
        use_grouped = redo == "grouped" or (
            redo == "auto"
            and _prefer_grouped(int((~keep).sum()), tile, words_host)
        )
        redo_fn = (
            extract_pairs_stream_grouped if use_grouped
            else extract_pairs_stream
        )
        parts.append(
            redo_fn(
                words_host, classes, masked, tiles, n=n,
                threshold=threshold, cross_amr_only=cross_amr_only,
                weights=weights, device=device,
            )
        )

    if not parts:
        return np.zeros((0, 3), dtype=np.int32)
    pairs = np.concatenate(parts, axis=0)
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order]


def _tile_survivors(wins, cwins, ia: int, ja: int, weights, gi0: int,
                    gj0: int, n: int, threshold: int, cross_amr_only: bool):
    """(counts, survivor mask) of one tile recomputed from its two row
    windows."""
    counts = counts_window_pair(wins[ia], wins[ja], weights)
    mask = survivor_mask(counts, cwins[ia], cwins[ja], gi0, gj0, n=n,
                         threshold=threshold,
                         include_same=not cross_amr_only)
    return counts, mask


def _extract_stream_topk(buffers, wins, cwins, batch, weights, n: int,
                         threshold: int, *, tile: int,
                         cross_amr_only: bool, k: int):
    """Recompute a batch of hit tiles from the DISTINCT row windows
    ``wins`` (``batch`` lists (ia, ja, gi0, gj0): window indices and
    global offsets of each tile; a window shared by many tiles is uploaded
    once), select each tile's survivors with ``torch.topk`` (``k`` ≥ its
    exact hit count) and append the batch's candidates to the global
    buffers in one window of ``len(batch)·k`` lanes. Returns the updated
    buffers."""
    cand = []
    for ia, ja, gi0, gj0 in batch:
        counts, mask = _tile_survivors(wins, cwins, ia, ja, weights, gi0,
                                       gj0, n, threshold, cross_amr_only)
        cand.append(topk_subtile_candidates(
            mask.to(torch.int32), counts, gi0, gj0, tile=tile, k=k,
        ))
    bi, bj, bc = (torch.cat(part) for part in zip(*cand))
    return sort_compact_append(*buffers, bc >= 0, bi, bj, bc)


def _extract_stream_scatter(buffers, wins, cwins, batch, weights, n: int,
                            threshold: int, *, tile: int,
                            cross_amr_only: bool):
    """The ultra-dense-tile variant (hit counts past ``TOPK_CAP``, where
    a top-k of nearly the tile area is the slow way): each tile's whole
    survivor mask is appended to the global buffers, one window of
    tile² lanes a tile. Returns the updated buffers."""
    for ia, ja, gi0, gj0 in batch:
        counts, mask = _tile_survivors(wins, cwins, ia, ja, weights, gi0,
                                       gj0, n, threshold, cross_amr_only)
        buffers = append_block(*buffers, mask, counts, gi0, gj0)
    return buffers


def _prefer_grouped(n_hit_tiles: int, tile: int,
                    words_host: np.ndarray) -> bool:
    """The ONE pass-2 crossover (shared by
    :func:`extract_pairs_stream_auto` and the fused overflow redo): the
    window path re-uploads at most ``2·tile·W·4`` bytes per hit tile;
    prefer the grouped pass, roughly one more budgeted pass over the
    matrix, once that bound exceeds a full pass."""
    window_est = 2 * n_hit_tiles * tile * words_host.shape[1] * 4
    return window_est > words_host.nbytes


def _extract_block_pair(buffers, wa, wb, ca, cb, weights, i0: int, j0: int,
                        sub_mask, *, n: int, threshold: int, block: int,
                        word_chunk: int, cross_amr_only: bool):
    """One block-pair step of the grouped pass: the full [bs, bs] counts
    window recomputed at the sweep's own operand shape, its survivors
    restricted to the wanted sub-tiles (``sub_mask`` bool [bs/block,
    bs/block], on the device) and appended to the global buffers
    (``ops.pairlist.append_block``; the caller allocates one window of
    slack). No host synchronisation. Returns the updated buffers."""
    counts = counts_window_pair(wa, wb, weights, word_chunk=word_chunk)
    mask = survivor_mask(counts, ca, cb, i0, j0, n=n, threshold=threshold,
                         include_same=not cross_amr_only)
    mask &= sub_mask.repeat_interleave(block, 0).repeat_interleave(block, 1)
    return append_block(*buffers, mask, counts, i0, j0)


def extract_pairs_stream_grouped(
    words_host: Optional[np.ndarray],
    classes: np.ndarray,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights: Optional[np.ndarray] = None,
    bs: Optional[int] = None,
    hbm_budget_bytes: int = 13 << 30,
    inflight: int = 4,
    word_chunk: Optional[int] = None,
    max_group: Optional[int] = None,
    block_source: Optional[CSRBlockSource] = None,
    pair_format: str = "arr3",
    device="cuda",
) -> np.ndarray:
    """Pass-2 exact pair recovery on the SWEEP's residency schedule.

    :func:`extract_pairs_stream` re-uploads two ``[tile, W]`` row windows
    per hit tile: the least traffic when hits are sparse, but quadratic
    when nearly every tile hits. This variant reuses the stationary-group
    / moving-block schedule of :func:`sweep_mxu_stream`: one more pass
    over the matrix under the same budget, each block pair recomputed at
    the sweep's operand shape and its survivors appended on the device to
    the global pair buffers (one sorted fetch at the end). Block pairs
    that hold no hit tile are skipped on the host, and moving blocks
    nobody needs are never uploaded. Bit-identical to every other
    extraction path.
    """
    device = resolve_device(device)
    ti, tj, tile = tiles
    words_host, rows0, w_words = _source_geometry(words_host, block_source)
    tile_hits = np.asarray(tile_hits)
    hits_per_tile = tile_survivors(tile_hits, cross_amr_only)
    want = hits_per_tile > 0
    if not want.any():
        return np.zeros((0, 3), dtype=np.int32)
    total = int(hits_per_tile[want].sum())

    vcap = vcap_bucket(total)
    # the pair buffers and the append's slack window stay resident for
    # the whole pass: they come off the budget before the blocks are sized
    slack = int(bs) ** 2 if bs else 4096 * 4096
    src_bytes = (
        block_source.staging_estimate if block_source is not None else 0
    )
    budget = max(1 << 28, hbm_budget_bytes - 3 * (vcap + slack) * 4 - src_bytes)
    if bs is None:
        bs = auto_stream_block(rows0, w_words, tile, budget)
    if bs % tile:
        raise ValueError("grouped block must be a multiple of the tile")
    # the sweep's tile enumeration may cover rows beyond the matrix (its
    # own row padding): pad to the tile cover, then to this pass's block
    cover = (int(max(ti.max(), tj.max())) + 1) * tile
    n_pad, classes = _pad_rows(max(cover, rows0), classes, bs)
    if block_source is not None:
        block_source.prepare(bs, n_pad, device)
    nbk = n_pad // bs
    nsb = bs // tile

    # which bs-block pairs hold a wanted tile (the host's skip map), and
    # the wanted tiles as a device mask each step slices its part from
    nb = n_pad // tile
    want_m = np.zeros((nb, nb), bool)
    want_m[ti[want], tj[want]] = True
    need = want_m.reshape(nbk, nsb, nbk, nsb).any(axis=(1, 3))
    want_dev = torch.from_numpy(want_m).to(device)

    block_bytes = bs * w_words * 4
    fixed = (inflight + 1) * (block_bytes + 4 * bs * bs * 4) + n_pad * 4
    avail = max(block_bytes, budget - fixed)
    word_chunk, g = _resident_blocking(bs, w_words, nbk, avail, word_chunk,
                                       max_group)

    trace = {
        "upload_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
        "finalize_s": 0.0, "steps": 0, "uploads": 0, "upload_bytes": 0,
        "bs": int(bs), "g": int(g), "nbk": int(nbk),
        "word_chunk": int(word_chunk),
        "block_pairs_total": int(nbk * (nbk + 1) // 2),
    }
    cls_dev, wts = _device_operands(classes, weights, w_words, bs, device)
    feed = _BlockFeed(words_host, block_source, bs, device, inflight + 1,
                      trace)
    window = _Window(device, trace)
    # + one [bs, bs] window of slack rows for the append
    buffers = new_pair_buffers(vcap + bs * bs, device)
    for s0, g_here in _groups(nbk, g):
        for jb, ibs in _group_steps(s0, g_here, nbk, need):
            wb = (feed.stationary(jb) if jb < s0 + g_here
                  else feed.put(jb))
            for ib in ibs:
                t0 = time.perf_counter()
                buffers = _extract_block_pair(
                    buffers, feed.stationary(ib), wb, cls_dev[ib],
                    cls_dev[jb], wts, ib * bs, jb * bs,
                    want_dev[ib * nsb : (ib + 1) * nsb,
                             jb * nsb : (jb + 1) * nsb],
                    n=n, threshold=threshold, block=tile,
                    word_chunk=word_chunk, cross_amr_only=cross_amr_only,
                )
                trace["dispatch_s"] += time.perf_counter() - t0
                trace["steps"] += 1
                window.push()
                window.drain(inflight)
        feed.end_group()
    window.drain(0)
    t0 = time.perf_counter()
    out = finalize_pairs(buffers, total, pair_format, n_pad)
    trace["finalize_s"] += time.perf_counter() - t0
    global last_grouped_trace
    last_grouped_trace = trace
    return out


def extract_pairs_stream_auto(
    words_host: np.ndarray,
    classes: np.ndarray,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Dispatch by upload volume between the two out-of-core extractors:
    row windows (:func:`extract_pairs_stream`) when hits are sparse, the
    grouped pass (:func:`extract_pairs_stream_grouped`) when the windows'
    upload bound exceeds one full pass over the matrix
    (:func:`_prefer_grouped`)."""
    hit = tile_survivors(tile_hits, cross_amr_only) > 0
    fn = (
        extract_pairs_stream_grouped
        if _prefer_grouped(int(hit.sum()), tiles[2], words_host)
        else extract_pairs_stream
    )
    return fn(
        words_host, classes, tile_hits, tiles, n=n, threshold=threshold,
        cross_amr_only=cross_amr_only, weights=weights, device=device,
    )


def extract_pairs_stream(
    words_host: np.ndarray,
    classes: np.ndarray,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights: Optional[np.ndarray] = None,
    batch_budget_bytes: int = 512 << 20,
    inflight: int = 2,
    device="cuda",
) -> np.ndarray:
    """Pass-2 exact pair recovery for the streaming engine by row windows.

    Only the ``[tile, W]`` row windows of tiles that reported hits are
    (re)uploaded, the distinct windows of a batch once each; a batch holds
    as many tiles as ``batch_budget_bytes`` allows for two windows a tile
    (at most 64), and at most ``inflight``+1 batches are in flight. Tiles
    with up to ``TOPK_CAP`` hits are selected by top-k
    (:func:`_extract_stream_topk`), denser ones appended whole
    (:func:`_extract_stream_scatter`). With ``weights`` the second
    operand's window is scaled.
    """
    device = resolve_device(device)
    ti, tj, tile = tiles
    words_host = np.ascontiguousarray(words_host)
    tile_hits = np.asarray(tile_hits)
    hits_per_tile = tile_survivors(tile_hits, cross_amr_only)
    hit_tiles = np.nonzero(hits_per_tile)[0]
    if len(hit_tiles) == 0:
        return np.zeros((0, 3), dtype=np.int32)
    # the sweep's tile enumeration may cover rows beyond the matrix
    cover = (int(max(ti.max(), tj.max())) + 1) * tile
    n_pad, classes = _pad_rows(max(cover, words_host.shape[0]), classes, tile)

    w_words = words_host.shape[1]
    # the budget bounds the DISTINCT windows of a batch (at most two a
    # tile; hit tiles share block rows, so usually far fewer)
    batch = int(max(1, min(64, batch_budget_bytes // (2 * tile * w_words * 4))))
    hcounts = hits_per_tile[hit_tiles]
    sparse = hit_tiles[hcounts <= TOPK_CAP]
    dense = hit_tiles[hcounts > TOPK_CAP]
    # by hit count, so each batch's k fits its tiles tightly
    sparse = sparse[np.argsort(-hits_per_tile[sparse])]
    kmax = 0
    if len(sparse):
        kmax = bucket_pow2(hits_per_tile[sparse].max(), 512, tile * tile)

    trace = {
        "stack_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
        "finalize_s": 0.0, "batches": 0, "upload_bytes": 0,
        "hit_tiles": int(len(hit_tiles)), "batch": int(batch),
    }
    cls_dev, wts = _device_operands(classes, weights, w_words, tile, device)
    feed = _BlockFeed(words_host, None, tile, device, 4, trace)
    window = _Window(device, trace)
    total = int(hcounts.sum())
    # slack for the largest window appended: a batch's top-k candidates,
    # or one dense tile
    slack = max(batch * kmax, tile * tile if len(dense) else 0)
    buffers = new_pair_buffers(vcap_bucket(total) + slack, device)

    def stack(gsel):
        """One batch's distinct row windows on the device, and its tiles
        as (ia, ja, gi0, gj0) with ia/ja indexing those windows."""
        t0 = time.perf_counter()
        blocks = sorted({int(ti[t]) for t in gsel} | {int(tj[t]) for t in gsel})
        widx = {b: s for s, b in enumerate(blocks)}
        wins = [feed.put(b) for b in blocks]
        cwins = [cls_dev[b] for b in blocks]
        tiles_b = [(widx[int(ti[t])], widx[int(tj[t])], int(ti[t]) * tile,
                    int(tj[t]) * tile) for t in gsel]
        trace["stack_s"] += time.perf_counter() - t0
        trace["batches"] += 1
        return wins, cwins, tiles_b

    common = dict(tile=tile, cross_amr_only=cross_amr_only)
    for lo in range(0, len(sparse), batch):
        gsel = sparse[lo : lo + batch]
        k = bucket_pow2(hits_per_tile[gsel].max(), 512, tile * tile)
        wins, cwins, tiles_b = stack(gsel)
        t0 = time.perf_counter()
        buffers = _extract_stream_topk(buffers, wins, cwins, tiles_b, wts, n,
                                       threshold, k=k, **common)
        trace["dispatch_s"] += time.perf_counter() - t0
        window.push()
        window.drain(inflight)
    for lo in range(0, len(dense), batch):
        wins, cwins, tiles_b = stack(dense[lo : lo + batch])
        t0 = time.perf_counter()
        buffers = _extract_stream_scatter(buffers, wins, cwins, tiles_b, wts,
                                          n, threshold, **common)
        trace["dispatch_s"] += time.perf_counter() - t0
        window.push()
        window.drain(inflight)
    window.drain(0)
    t0 = time.perf_counter()
    out = finalize_pairs(buffers, total)
    trace["finalize_s"] += time.perf_counter() - t0
    global last_extract_trace
    last_extract_trace = trace
    return out
