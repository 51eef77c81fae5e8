"""``ring_sweep_ms.ring4``: the ring sweep of a mesh sweep job (the
layout's sweep in ``parallel.sharded``: every sub-step's unpack, int8
GEMM and K1 on its card, the ring shifts, and the host reads of the
gathered row statistics and tile hits, which wait for every card), the
summed milliseconds of its ``ukc.ring.sweep`` spans on the profiler's
clock inside the window, a job."""

from _spans import span_seconds
from _util import per_job_ms


def read(run):
    seconds = span_seconds(run, "ukc.ring.sweep")
    return None if seconds is None else per_job_ms(run, seconds)
