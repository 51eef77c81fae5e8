"""``round_gemm_roofline.agglo``: the int8 GEMM of the agglomerative
rounds (``ops.bitmul.int8_gemm``, ``torch._int_mm``) as a percent of the
card's published int8 peak: the operations of the ``aten::_int_mm``
calls that start inside a ``ukc.agglo.argmax`` span, 2·M·N·K from their
recorded shapes, over the peak, over the device time of the kernels
those calls launched. The sweep stage's products in the same jobs are
left out. A checkout whose port has no such span reads None."""

import bisect

from _util import INT_MM

from peaks import int_mm_ops, peak

ARGMAX_SPAN = "ukc.agglo.argmax"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    w0, w1 = tr.window
    # the spans follow one another on one thread, so a call lies in the
    # last span that starts before it
    spans = sorted((o[1], o[2]) for o in tr.ops
                   if o[0] == ARGMAX_SPAN and w0 <= o[1] < w1)
    starts = [s for s, _ in spans]
    ids, ops = set(), 0
    for o in tr.ops:
        if o[0] != INT_MM or not w0 <= o[1] < w1:
            continue
        i = bisect.bisect_right(starts, o[1]) - 1
        if i >= 0 and o[1] < spans[i][1]:
            ids.add(o[3])
            ops += int_mm_ops(o[4])
    seconds = sum(end - start for _, _, start, end, op in tr._in_window()
                  if op in ids) / 1e9
    if not ops or seconds <= 0:
        return None
    return 100.0 * ops / peak(run.kind, "int8_ops_s") / seconds
