"""``stage_ms.ring4``: the staging of a mesh sweep job
(``parallel.sharded.stage_mesh_inputs``: each card's row shard of the
page-locked words and the classes enqueued as asynchronous copies, all
the cards at once; the copies end inside the ring sweep's span), the
summed milliseconds of its ``ukc.ring.stage`` spans on the profiler's
clock inside the window, a job."""

from _spans import span_seconds
from _util import per_job_ms


def read(run):
    seconds = span_seconds(run, "ukc.ring.stage")
    return None if seconds is None else per_job_ms(run, seconds)
