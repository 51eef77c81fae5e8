"""``gemm_roofline.sweep``: the int8 GEMM of ``ops.bitmul``
(``torch._int_mm``) as a percent of the card's published int8 peak: the
operations of every ``aten::_int_mm`` call, 2·M·N·K from its recorded
shapes, over the peak, over the device time of the kernels those calls
launched."""

from _util import INT_MM

from peaks import int_mm_ops, peak


def read(run):
    tr = run.trace
    if tr is None:
        return None
    w0, w1 = tr.window
    ops = sum(int_mm_ops(o[4]) for o in tr.ops
              if o[0] == INT_MM and w0 <= o[1] < w1)
    seconds = tr.device_seconds(launched_by=(INT_MM,))
    if not ops or seconds <= 0:
        return None
    return 100.0 * ops / peak(run.kind, "int8_ops_s") / seconds
