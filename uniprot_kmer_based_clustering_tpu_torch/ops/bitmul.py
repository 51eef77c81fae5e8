"""MXU engine: pairwise shared-k-mer counts as int8 matrix products.

Counterpart of the JAX package's ``ops/bitmul.py``. The count matrix is
``C = B · Bᵀ`` over the {0,1} protein × k-mer incidence matrix ``B``;
products are 0/1 (or an int8 BLOSUM weight on the moving operand) and
accumulate exactly in int32 through ``torch._int_mm``. ``torch.matmul``
is not an option: on int8 it wraps on the CPU and is not implemented on
CUDA.

The packed uint32 words arrive as an int32 tensor (the same bits; see
``state.bitset_to_torch``). Two schedules, chosen by
:func:`resolve_schedule` as in the JAX package (``auto``: scan above 8
strips):

- strips: stationary strip s meets only its column suffix j ≥ s·strip,
  and each strip's counts block goes through the K1 epilogue
  (``ops.stats.stats_from_counts_into``: one launch that stores the
  strip's rows and adds its tile hits into the sweep's buffers). Asked
  for with ``append``, K1 also appends every strip's survivors to one
  set of pair buffers, so that extraction recomputes nothing.
  Without contraction chunking the bit matrix is unpacked once per sweep
  and sliced per strip.
- scan: equal [bs, bs] block pairs of the upper triangle, one Python
  loop step each (the JAX package's ``lax.scan``), with the K2 epilogue
  (``ops.stats.stats_from_counts_traced_into``: one launch that merges
  the block into the device accumulators). Each step unpacks its two row
  windows (the stationary one is reused while the row stays the same).
  Neither loop copies from the host or synchronises: ``sweep_mxu_async``
  only queues them, and its ``finalize`` (which ``sweep_mxu`` calls at
  once) ends the sweep in the copies of its two outputs (and of the pair
  cursor) to the host, as the JAX package's pair of the same names does.
  With ``fused_k`` each step also keeps its surviving pairs as
  per-sub-tile ``torch.topk`` candidates (:class:`FusedCandidates`), for
  ``similarity.pairwise.extract_pairs_fused``.

The kernels run on CUDA tensors; CPU tensors take their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import (
    EPILOGUE_PAIR_CAP,
    new_pair_buffers,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (
    upper_triangle_tiles,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import (  # noqa: F401
    merge_row_stats_at,
    pair_block_stats,
    stack_row_stats,
    stats_from_counts_into,
    stats_from_counts_traced_into,
    stats_tiles,
    survivor_mask,
)
from uniprot_kmer_based_clustering_tpu_torch.state import to_device
from uniprot_kmer_based_clustering_tpu_torch.utils.timing import span


def subtile_rows(x, bt: int):
    """[R, C] → [R//bt · C//bt, bt²]: each row is one bt² sub-tile,
    row-major over the sub-tile grid (a copy)."""
    qi, qj = x.shape[0] // bt, x.shape[1] // bt
    return (
        x.reshape(qi, bt, qj, bt).permute(0, 2, 1, 3).reshape(qi * qj, bt * bt)
    )


def topk_subtile_candidates(mask_i32, counts, i0: int, j0: int, *,
                            tile: int, k: int):
    """Per-sub-tile top-k survivor selection over one counts window at
    global offset (i0, j0).

    ``torch.topk`` of each ``tile``² sub-tile's 0/1 survivor mask picks
    up to ``k`` survivors; ``k`` must be ≥ the sub-tile's hit count for
    its list to be complete (callers check against the exact tile hits).
    Returns (gi, gj, cnt) int32 [qi·qj, k]: global row, global column and
    count; unused slots carry cnt −1. The order within a sub-tile is
    unspecified (topk's tie order); callers sort the final pair list.
    """
    qj = mask_i32.shape[1] // tile
    vals, sel = torch.topk(subtile_rows(mask_i32, tile), k, dim=1,
                           sorted=False)
    cnt = torch.where(
        vals > 0, torch.gather(subtile_rows(counts, tile), 1, sel),
        torch.full_like(vals, -1),
    )
    sub = torch.arange(sel.shape[0], device=sel.device)[:, None]
    si, sj = sub // qj, sub % qj
    row, col = sel // tile, sel % tile
    return (
        (i0 + si * tile + row).to(torch.int32),
        (j0 + sj * tile + col).to(torch.int32),
        cnt.to(torch.int32),
    )


@dataclasses.dataclass
class FusedCandidates:
    """Per-sub-tile top-k survivor candidates of the fused scan sweep,
    still on the device.

    ``bi``/``bj``/``bc`` are int32 [n_steps, nsub, k]: global row, global
    column and score of each candidate; unused slots carry score −1.
    Sub-tile s of step p covers block tile (pairs_ij[p, 0]//block +
    s//nbs, pairs_ij[p, 1]//block + s%nbs) with nbs = bs//block, the
    :func:`subtile_rows` layout. A sub-tile whose exact hit count (from
    the sweep's tile_hits) exceeds ``k`` is incomplete here and is redone
    by the two-pass extractor.
    """

    bi: torch.Tensor
    bj: torch.Tensor
    bc: torch.Tensor
    pairs_ij: np.ndarray  # int32 [n_steps, 2], the schedule
    bs: int
    block: int
    k: int
    include_same: bool


class SweepResult(NamedTuple):
    """What :func:`sweep_mxu` returns when asked to ``append``: its
    three usual outputs, the fused candidates (None unless asked for and
    kept by the scan), and the pair buffers K1 appended to — (bi, bj,
    bc, cursor), int32 slots on the device and the int64 cursor on the
    host, which counts every survivor K1 found, stored or not — or None
    off the strip schedule with K1."""

    row_stats: np.ndarray
    tile_hits: np.ndarray
    tiles: tuple
    fused: Optional[FusedCandidates]
    pairs: Optional[tuple]


def bucket_pow2(kmax: int, floor: int, cap: int) -> int:
    """The smallest power-of-two multiple of ``floor`` that is ≥ ``kmax``,
    capped at ``cap``: the top-k width of one extraction batch, as the
    JAX package buckets it."""
    k = floor
    while k < int(kmax):
        k *= 2
    return min(k, cap)


# Per-tile hit counts above this take the dense append instead of top-k
# selection in the stream window extractor (k would approach the tile
# area).
TOPK_CAP = 1 << 17


def unpack_words_to_int8(words, weights=None):
    """Packed words [R, W] (int32 or uint32 bit patterns) → int8 bit
    matrix [R, W*32].

    Bit b (LSB-first) of word w maps to column w*32+b, matching
    ``kmers.bitset.pack_bitsets``: on a little-endian device the words
    are viewed as bytes and byte k's bit c lands in column 8k+c. The
    shift writes straight into the output's bytes and the mask runs in
    place, so no transient larger than the input exists. With
    ``weights`` (int8 [W*32]) each bit column is scaled.
    """
    r, w = words.shape
    out = torch.empty((r, w * 32), dtype=torch.int8, device=words.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    byts = words.contiguous().view(torch.uint8).unsqueeze(-1)
    bits = out.view(torch.uint8).view(r, w * 4, 8)
    torch.bitwise_right_shift(byts, shifts, out=bits)
    bits.bitwise_and_(1)
    if weights is not None:
        out.mul_(weights)
    return out


def int8_gemm(a, b):
    """Exact int32 [M, N] = a · bᵀ for int8 a [M, K] and b [N, K].

    ``b.t()`` of a row-major ``b`` is the column-major second operand
    that ``torch._int_mm`` wants on CUDA."""
    return torch._int_mm(a, b.t())


def counts_window_pair(words_a, words_b, weights=None, *, word_chunk: int = 0):
    """int32 counts [S, J] of two explicit packed row blocks ``words_a``
    [S, W] and ``words_b`` [J, W] (the stream engine's operands).

    ``weights`` (int8 [W*32] or None) scale the second operand. With
    ``word_chunk`` > 0 the contraction axis runs in word chunks, so the
    unpacked int8 operands exist one chunk at a time and the partial
    products are summed in place. A block against itself, unweighted,
    is unpacked once.
    """
    same = words_b is words_a and weights is None
    w_words = words_a.shape[1]
    wc = word_chunk if 0 < word_chunk < w_words else w_words
    if w_words % wc:
        raise ValueError(f"word_chunk {wc} does not divide {w_words} words")
    counts = None
    for k0 in range(0, w_words, wc):
        a = unpack_words_to_int8(words_a[:, k0 : k0 + wc])
        b = a if same else unpack_words_to_int8(
            words_b[:, k0 : k0 + wc],
            None if weights is None else weights[k0 * 32 : (k0 + wc) * 32],
        )
        part = int8_gemm(a, b)
        # the chunk's operands go before the next chunk is unpacked, so
        # no more than one chunk's pair of them is ever allocated
        del a, b
        counts = part if counts is None else counts.add_(part)
        del part
    return counts


def counts_window(words, weights, ia: int, ja: int, *, s: int, jr: int,
                  word_chunk: int = 0):
    """int32 counts [s, jr] for the row windows (ia..ia+s) × (ja..ja+jr)
    of one packed matrix: :func:`counts_window_pair` on its two row
    slices (``weights`` scale the moving operand)."""
    return counts_window_pair(words[ia : ia + s], words[ja : ja + jr],
                              weights, word_chunk=word_chunk)


def accumulate_pair_block(row_stats, block_hits, rs, bh, i0: int, j0: int,
                          *, block: int):
    """Merge one block pair's (rs, bh) into the full accumulators at
    (i0, j0), in place (:func:`merge_row_stats_at` for the stats; hits
    add). Returns (row_stats, block_hits)."""
    merge_row_stats_at(row_stats, rs, i0)
    bi, bj = i0 // block, j0 // block
    block_hits[bi : bi + bh.shape[0], bj : bj + bh.shape[1]] += bh
    return row_stats, block_hits


def auto_strip(n_pad: int, block: int, budget_bytes: int = 2 << 30) -> int:
    """Pick the stationary strip size — the same decisions as the JAX
    package's ``auto_strip``: one full square up to 3584 rows; between
    8192 and 16384 rows the smallest block-multiple divisor giving at
    most 8 strips; otherwise the largest block-multiple divisor up to
    min(3584, the counts-block budget)."""
    if n_pad <= 3584:
        return n_pad
    cap = max(block, budget_bytes // (n_pad * 4))
    if 8192 < n_pad <= 16384:
        for mult in range(1, cap // block + 1):
            s = mult * block
            if n_pad % s == 0 and n_pad // s <= 8:
                return s
    cap = min(3584, cap)
    best = block
    for mult in range(1, cap // block + 1):
        s = mult * block
        if n_pad % s == 0:
            best = s
    return best


def resolve_schedule(n_pad: int, block: int, strip: Optional[int] = None,
                     schedule: str = "auto"):
    """The strip/scan decision :func:`sweep_mxu` makes, the JAX
    package's rule: ``auto`` takes the scan above 8 strips. Returns
    (schedule, strip, ns)."""
    if strip is None:
        strip = auto_strip(n_pad, block)
    ns = n_pad // strip
    if schedule == "auto":
        schedule = "scan" if ns > 8 else "strips"
    return schedule, strip, ns


def auto_word_chunk(n_pad: int, w_words: int, strip: int,
                    hbm_budget_bytes: int, j_rows: Optional[int] = None,
                    fused_bytes: int = 0) -> int:
    """Contraction chunk, sized as the JAX package sizes it: 0 (no
    chunking) when both unpacked operands fit what the budget leaves after
    the packed words, one counts block and the fused candidate buffers,
    else the largest 128-multiple divisor of ``w_words`` that fits.
    ``j_rows`` is the counts block's width: ``n_pad`` for the strip
    schedule (the default), ``strip`` for the scan."""
    j_rows = n_pad if j_rows is None else j_rows
    resident = n_pad * w_words * 4 + strip * j_rows * 4 + fused_bytes
    budget = max(512 << 20, hbm_budget_bytes - resident)
    if (strip + j_rows) * w_words * 32 <= budget:
        return 0
    target = max(128, budget // ((strip + j_rows) * 32))
    base = w_words // 128
    best = 1
    for d in range(1, base + 1):
        if base % d == 0 and d * 128 <= target:
            best = d
    return best * 128


def fused_capacity(fused_k: Optional[int], n_steps: int, nsub: int,
                   block: int, hbm_budget_bytes: int) -> int:
    """Per-sub-tile candidate capacity of fused extraction, the JAX
    package's rule. ``None``: the largest power of two from 512 up to
    block² whose int32 (i, j, count) buffers fit min(1.5 GiB, budget/8);
    0 when even 512 does not fit (two-pass instead). An explicit capacity
    is clamped to block²."""
    if fused_k is None:
        ys_budget = min(1536 << 20, hbm_budget_bytes // 8)
        kb = ys_budget // max(n_steps * nsub * 12, 1)
        fused_k = 0
        if kb >= min(512, block * block):
            fused_k = min(512, block * block)
            while fused_k * 2 <= kb and fused_k * 2 <= block * block:
                fused_k *= 2
    else:
        fused_k = min(fused_k, block * block)
    if n_steps * nsub * fused_k >= 1 << 31:
        raise ValueError(
            f"fused_k={fused_k} overflows the int32 candidate space "
            f"({n_steps} steps × {nsub} sub-tiles)"
        )
    return fused_k


def _scan_sweep(words, classes, weights, pairs_ij, *, bs: int, n: int,
                threshold: int, block: int, w_thresh: int, word_chunk: int,
                stats_engine: str, fused_k: int, fused_same: bool):
    """Upper-triangle block-pair sweep: one step per [bs, bs] block pair
    (i0, j0) of ``pairs_ij``, its epilogue, and the accumulation into
    device ``row_stats`` int32 [N_pad, 8] and ``block_hits`` int32
    [nb, nb, 2]; no host sync. ``stats_engine`` "pallas" runs K2,
    "xla" the plain epilogue. Returns (row_stats, block_hits, ys) with
    ys None or the (gi, gj, cnt) candidate buffers [P, nsub, fused_k]."""
    n_pad = words.shape[0]
    nb = n_pad // block
    dev = words.device
    row_stats = torch.zeros((n_pad, 8), dtype=torch.int32, device=dev)
    block_hits = torch.zeros((nb, nb, 2), dtype=torch.int32, device=dev)
    ys = None
    if fused_k:
        shape = (len(pairs_ij), (bs // block) ** 2, fused_k)
        ys = tuple(torch.empty(shape, dtype=torch.int32, device=dev)
                   for _ in range(3))
    a = a_row = None
    for p, (i0, j0) in enumerate(pairs_ij.tolist()):
        if word_chunk:
            counts = counts_window(words, weights, i0, j0, s=bs, jr=bs,
                                   word_chunk=word_chunk)
        else:
            # the step list is row-major: the stationary window is
            # unpacked once per block row
            if a_row != i0:
                a = None
                a = unpack_words_to_int8(words[i0 : i0 + bs])
                a_row = i0
            if i0 == j0 and weights is None:
                counts = int8_gemm(a, a)
            else:
                counts = int8_gemm(a, unpack_words_to_int8(
                    words[j0 : j0 + bs], weights))
        ca, cb = classes[i0 : i0 + bs], classes[j0 : j0 + bs]
        if stats_engine == "pallas":
            stats_from_counts_traced_into(
                counts, ca, cb, row_stats[i0 : i0 + bs],
                block_hits[i0 // block :, j0 // block :], i0, j0, n=n,
                threshold=threshold, w_thresh=w_thresh, tile=block,
            )
        else:
            rs, bh, _, _ = pair_block_stats(
                counts, ca, cb, i0, j0, n=n, threshold=threshold,
                block=block, w_thresh=w_thresh,
            )
            accumulate_pair_block(row_stats, block_hits, rs, bh, i0, j0,
                                  block=block)
        if fused_k:
            em = survivor_mask(counts, ca, cb, i0, j0, n=n,
                               threshold=threshold, include_same=fused_same)
            cand = topk_subtile_candidates(
                em.to(torch.int32), counts, i0, j0, tile=block, k=fused_k,
            )
            for buf, part in zip(ys, cand):
                buf[p] = part
        del counts
    return row_stats, block_hits, ys


def _strip_sweep(words, classes, weights, *, strip: int, n: int,
                 threshold: int, block: int, w_thresh: int, word_chunk: int,
                 stats_engine: str, pairs=None, pairs_same: bool = False):
    """The strip schedule: row_stats int32 [N_pad, 8] and block_hits
    int32 [nb, nb, 2] on the device. ``stats_engine`` "pallas" runs K1,
    "xla" the plain epilogue over each strip's whole suffix block. With
    ``pairs`` (K1 only) every strip's K1 appends its survivors to them,
    same-class ones too with ``pairs_same``."""
    n_pad = words.shape[0]
    nb = n_pad // block
    dev = words.device
    bits = bits_w = None
    if not word_chunk:
        bits = unpack_words_to_int8(words)
        bits_w = bits if weights is None else unpack_words_to_int8(
            words, weights
        )
    row_stats = torch.empty((n_pad, 8), dtype=torch.int32, device=dev)
    block_hits = torch.zeros((nb, nb, 2), dtype=torch.int32, device=dev)
    for i0 in range(0, n_pad, strip):
        if word_chunk:
            counts = counts_window(
                words, weights, i0, i0, s=strip, jr=n_pad - i0,
                word_chunk=word_chunk,
            )
        else:
            counts = int8_gemm(bits[i0 : i0 + strip], bits_w[i0:])
        ca, cb = classes[i0 : i0 + strip], classes[i0:]
        gb = i0 // block
        if stats_engine == "pallas":
            stats_from_counts_into(
                counts, ca, cb, row_stats[i0 : i0 + strip],
                block_hits[gb:, gb:], i_off=i0, j_off=i0, n=n,
                threshold=threshold, w_thresh=w_thresh, tile=block,
                pairs=pairs, include_same=pairs_same,
            )
        else:
            rs, bh, _, _ = pair_block_stats(
                counts, ca, cb, i0, i0, n=n, threshold=threshold,
                block=block, w_thresh=w_thresh,
            )
            block_hits[gb : gb + strip // block, gb:] = bh
            row_stats[i0 : i0 + strip] = rs
        del counts
    return row_stats, block_hits


@span("sweep.dispatch")
def sweep_mxu_async(
    words,
    classes,
    n: int,
    threshold: int,
    strip: Optional[int] = None,
    block: int = 512,
    weights=None,
    w_thresh: int = 1,
    word_chunk: Optional[int] = None,
    hbm_budget_bytes: int = 13 << 30,
    stats_engine: str = "auto",
    schedule: str = "auto",
    fused_k: Optional[int] = 0,
    fused_same: bool = False,
    append: bool = False,
):
    """Dispatch the full sweep; return ``(handles, finalize)``.

    The device work is queued on the current stream of ``words``'s
    device with no host sync (no ``.item()``, no ``nonzero``, no pageable
    copy: numpy ``classes`` and ``weights`` go up from pinned memory), and
    every call allocates its own outputs, so sweeps dispatched back to
    back pipeline on the device. ``finalize(handles)`` waits for the
    dispatching stream, copies the results to the host and returns what
    :func:`sweep_mxu` returns. The arguments are :func:`sweep_mxu`'s.
    The dispatch is the span ``ukc.sweep.dispatch``, ``finalize``
    ``ukc.sweep.finalize``.
    """
    if schedule not in ("auto", "strips", "scan"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if stats_engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown stats_engine {stats_engine!r}")
    n_pad, w_words = words.shape
    fused_requested = fused_k != 0
    schedule, strip, ns = resolve_schedule(n_pad, block, strip, schedule)
    if n_pad % strip or strip % block:
        raise ValueError(
            f"strip {strip} must divide N_pad {n_pad} and be a multiple "
            f"of block {block}"
        )
    fused_bytes = 0
    pairs_ij = None
    if schedule == "scan":
        ii, jj = np.triu_indices(ns)
        pairs_ij = (np.stack([ii, jj], axis=1) * strip).astype(np.int32)
    if schedule == "scan" and fused_requested:
        fused_k = fused_capacity(fused_k, len(pairs_ij),
                                 (strip // block) ** 2, block,
                                 hbm_budget_bytes)
        fused_bytes = len(pairs_ij) * (strip // block) ** 2 * fused_k * 12
    else:
        fused_k = 0
    if fused_k and stats_engine == "pallas":
        raise ValueError(
            "fused extraction requires stats_engine='xla' (or 'auto'); "
            "it cannot be combined with the pallas epilogue"
        )
    engine = "pallas" if stats_engine == "auto" else stats_engine
    if word_chunk is None:
        word_chunk = auto_word_chunk(
            n_pad, w_words, strip, hbm_budget_bytes,
            j_rows=strip if schedule == "scan" else n_pad,
            fused_bytes=fused_bytes,
        )
    if word_chunk >= w_words:
        word_chunk = 0
    dev = words.device
    classes = to_device(classes, torch.int32, dev)
    if weights is not None:
        weights = to_device(weights, torch.int8, dev)
        if weights.shape != (w_words * 32,):
            raise ValueError("weights must be int8 [W*32]")

    common = dict(n=n, threshold=threshold, block=block, w_thresh=w_thresh,
                  word_chunk=word_chunk, stats_engine=engine)
    cands = pairs = None
    if append and schedule == "strips" and engine == "pallas":
        pairs = new_pair_buffers(EPILOGUE_PAIR_CAP, dev)
    if schedule == "scan":
        row_stats, block_hits, ys = _scan_sweep(
            words, classes, weights, pairs_ij, bs=strip, fused_k=fused_k,
            fused_same=fused_same, **common,
        )
        if fused_k:
            cands = FusedCandidates(
                bi=ys[0], bj=ys[1], bc=ys[2], pairs_ij=pairs_ij, bs=strip,
                block=block, k=fused_k, include_same=fused_same,
            )
    else:
        row_stats, block_hits = _strip_sweep(
            words, classes, weights, strip=strip, pairs=pairs,
            pairs_same=fused_same, **common,
        )
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def finalize(handles):
        row_stats, block_hits, cands = handles
        with span("sweep.finalize"):
            if stream is not None:
                stream.synchronize()
            ti, tj = upper_triangle_tiles(n_pad, block)
            out = (
                row_stats.cpu().numpy().astype(np.int64),
                block_hits.cpu().numpy()[ti, tj],
                (ti, tj, block),
            )
            if append:
                # the cursor comes over with the statistics
                return SweepResult(*out, fused=cands, pairs=None
                                   if pairs is None
                                   else pairs[:3] + (pairs[3].cpu(),))
        return out + (cands,) if fused_requested else out

    return (row_stats, block_hits, cands), finalize


def sweep_mxu(
    words,
    classes,
    n: int,
    threshold: int,
    strip: Optional[int] = None,
    block: int = 512,
    weights=None,
    w_thresh: int = 1,
    word_chunk: Optional[int] = None,
    hbm_budget_bytes: int = 13 << 30,
    stats_engine: str = "auto",
    schedule: str = "auto",
    fused_k: Optional[int] = 0,
    fused_same: bool = False,
    append: bool = False,
):
    """Full upper-triangle sweep as int8 GEMMs + a statistics epilogue:
    :func:`sweep_mxu_async` and its ``finalize``.

    ``words`` int32 [N_pad, W] lives on the device the sweep runs on;
    ``classes`` int32 [N_pad] and ``weights`` (int8 [W*32], enabling the
    BLOSUM-weighted score) are tensors or numpy arrays. ``w_thresh`` is
    the count that counts as "present" for the pairs lanes. The HBM budget
    keeps the JAX package's default, sized for a 16 GB TPU v5e, so both
    packages pick the same word chunk and fused capacity.

    ``schedule`` "auto" follows :func:`resolve_schedule`. ``stats_engine``
    "auto" and "pallas" run the kernels (K1 on strips, K2 on the scan;
    their plain versions on CPU tensors); "xla" runs the plain epilogue.
    ``fused_k`` requests fused extraction: 0 off, None auto-sized from the
    budget, > 0 an explicit capacity. It needs the scan; explicit
    "pallas" with it raises, as in the JAX package. ``fused_same`` keeps
    same-class survivors too.

    Returns (row_stats int64 [N_pad, 8], tile_hits int32 [nT, 2], tiles
    (ti, tj, block)) as numpy arrays, in the upper-triangle tile
    enumeration every engine shares, after one device→host copy. When
    ``fused_k`` is non-0 a 4th element follows: a :class:`FusedCandidates`
    on the device, or None when the schedule resolved to strips or the
    budget holds no candidate buffers (two-pass extraction then).

    ``append`` asks K1 for the survivors (``fused_same`` gates them as
    it gates the fused candidates) and returns a :class:`SweepResult`
    instead: on the strip schedule with K1, every strip's launch appends
    them to one set of pair buffers (``ops.pairlist.new_pair_buffers``,
    ``EPILOGUE_PAIR_CAP`` slots).
    """
    handles, finalize = sweep_mxu_async(
        words, classes, n, threshold, strip=strip, block=block,
        weights=weights, w_thresh=w_thresh, word_chunk=word_chunk,
        hbm_budget_bytes=hbm_budget_bytes, stats_engine=stats_engine,
        schedule=schedule, fused_k=fused_k, fused_same=fused_same,
        append=append,
    )
    return finalize(handles)
