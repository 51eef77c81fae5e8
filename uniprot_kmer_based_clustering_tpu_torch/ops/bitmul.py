"""MXU engine: pairwise shared-k-mer counts as int8 matrix products.

Counterpart of the JAX package's ``ops/bitmul.py``. The count matrix is
``C = B · Bᵀ`` over the {0,1} protein × k-mer incidence matrix ``B``;
products are 0/1 (or an int8 BLOSUM weight on the moving operand) and
accumulate exactly in int32 through ``torch._int_mm``. ``torch.matmul``
is not an option: on int8 it wraps on the CPU and is not implemented on
CUDA.

The packed uint32 words arrive as an int32 tensor (the same bits; see
``state.bitset_to_torch``). The sweep runs the strip schedule for every
strip count: stationary strip s meets only its column suffix j ≥ s·strip,
and each strip's counts block goes through the K1 epilogue
(``ops.stats.stats_from_counts``: the CUDA kernel on the card, the plain
version on the CPU). Without contraction chunking the bit matrix is
unpacked once per sweep and sliced per strip (2.6 GB of int8 for the
10,619-protein corpus); the JAX package instead re-unpacks inside each
strip's fused program. The block-pair scan schedule is still to be
ported (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.ops.popcount import (
    upper_triangle_tiles,
)
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import (  # noqa: F401
    pair_block_stats,
    stack_row_stats,
    stats_from_counts,
    stats_tiles,
)


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


def counts_window(words, weights, ia: int, ja: int, *, s: int, jr: int,
                  word_chunk: int = 0):
    """int32 counts [s, jr] for the row windows (ia..ia+s) × (ja..ja+jr).

    ``weights`` (int8 [W*32] or None) scale the moving operand. With
    ``word_chunk`` > 0 the contraction axis runs in word chunks, so the
    unpacked int8 operands exist one chunk at a time.
    """
    w_words = words.shape[1]
    wc = word_chunk if 0 < word_chunk < w_words else w_words
    if w_words % wc:
        raise ValueError(f"word_chunk {wc} does not divide {w_words} words")
    counts = None
    for k0 in range(0, w_words, wc):
        a = unpack_words_to_int8(words[ia : ia + s, k0 : k0 + wc])
        b = unpack_words_to_int8(
            words[ja : ja + jr, k0 : k0 + wc],
            None if weights is None else weights[k0 * 32 : (k0 + wc) * 32],
        )
        part = int8_gemm(a, b)
        counts = part if counts is None else counts.add_(part)
    return counts


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
    """The JAX package's strip/scan decision, returned unchanged:
    (schedule, strip, ns). The port's sweep runs strips whatever this
    says for ``auto`` (the scan exists to bound TPU compiles)."""
    if strip is None:
        strip = auto_strip(n_pad, block)
    ns = n_pad // strip
    if schedule == "auto":
        schedule = "scan" if ns > 8 else "strips"
    return schedule, strip, ns


def auto_word_chunk(n_pad: int, w_words: int, strip: int,
                    hbm_budget_bytes: int) -> int:
    """Contraction chunk for the strip schedule, sized as the JAX package
    sizes it: 0 (no chunking) when both unpacked operands fit what the
    budget leaves after the packed words and one counts block, else the
    largest 128-multiple divisor of ``w_words`` that fits."""
    resident = n_pad * w_words * 4 + strip * n_pad * 4
    budget = max(512 << 20, hbm_budget_bytes - resident)
    if (strip + n_pad) * w_words * 32 <= budget:
        return 0
    target = max(128, budget // ((strip + n_pad) * 32))
    base = w_words // 128
    best = 1
    for d in range(1, base + 1):
        if base % d == 0 and d * 128 <= target:
            best = d
    return best * 128


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
):
    """Full upper-triangle sweep as strip-blocked int8 GEMMs + K1.

    ``words`` int32 [N_pad, W] and ``classes`` int32 [N_pad] live on the
    device the sweep runs on; ``weights`` (int8 [W*32], tensor or numpy)
    enables the BLOSUM-weighted score. ``w_thresh`` is the count that
    counts as "present" for the pairs lanes. The HBM budget keeps the JAX
    package's default, sized for a 16 GB TPU v5e. ``stats_engine``,
    ``schedule``, ``fused_k`` and ``fused_same`` keep the JAX signature;
    only the strip schedule with the K1 epilogue exists so far, and
    ``fused_same`` has no effect without ``fused_k``.

    Returns (row_stats int64 [N_pad, 8], tile_hits int32 [nT, 2], tiles
    (ti, tj, block)) as numpy arrays, in the upper-triangle tile
    enumeration every engine shares, after one device→host copy.
    """
    if fused_k != 0:
        raise NotImplementedError(
            "fused extraction runs on the scan schedule, not yet ported "
            "(ROADMAP queue 1, item 8)"
        )
    if schedule == "scan":
        raise NotImplementedError(
            "the block-pair scan schedule is not yet ported (ROADMAP "
            "queue 1, item 8); the strip schedule runs for every size"
        )
    if schedule not in ("auto", "strips"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if stats_engine not in ("auto", "pallas"):
        raise NotImplementedError(
            "the port's strips always run the K1 epilogue; the fused "
            "XLA epilogue belongs to the scan schedule (ROADMAP queue 1, "
            "item 8)"
        )
    n_pad, w_words = words.shape
    _, strip, ns = resolve_schedule(n_pad, block, strip, "strips")
    if n_pad % strip or strip % block:
        raise ValueError(
            f"strip {strip} must divide N_pad {n_pad} and be a multiple "
            f"of block {block}"
        )
    if word_chunk is None:
        word_chunk = auto_word_chunk(n_pad, w_words, strip, hbm_budget_bytes)
    dev = words.device
    classes = torch.as_tensor(classes, dtype=torch.int32, device=dev)
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=torch.int8, device=dev)
        if weights.shape != (w_words * 32,):
            raise ValueError("weights must be int8 [W*32]")

    bits = bits_w = None
    if not word_chunk:
        bits = unpack_words_to_int8(words)
        bits_w = bits if weights is None else unpack_words_to_int8(
            words, weights
        )
    strip_stats = []
    for si in range(ns):
        i0 = si * strip
        if word_chunk:
            counts = counts_window(
                words, weights, i0, i0, s=strip, jr=n_pad - i0,
                word_chunk=word_chunk,
            )
        else:
            counts = int8_gemm(bits[i0 : i0 + strip], bits_w[i0:])
        rs, th, _ = stats_from_counts(
            counts, classes[i0 : i0 + strip], classes[i0:],
            i_off=i0, j_off=i0, n=n, threshold=threshold,
            w_thresh=w_thresh, tile=block,
        )
        strip_stats.append((rs, th))
        del counts
    del bits, bits_w

    row_stats = torch.cat([rs for rs, _ in strip_stats]).cpu().numpy()
    hits = torch.cat([th for _, th in strip_stats]).cpu().numpy()
    nb = n_pad // block
    block_hits = np.zeros((nb, nb, 2), dtype=np.int32)
    off = 0
    for si in range(ns):
        i0 = si * strip
        lti, ltj = stats_tiles(strip, n_pad - i0, i0, i0, block)
        gb = i0 // block
        block_hits[gb + lti, gb + ltj] += hits[off : off + len(lti)]
        off += len(lti)
    ti, tj = upper_triangle_tiles(n_pad, block)
    return row_stats.astype(np.int64), block_hits[ti, tj], (ti, tj, block)
