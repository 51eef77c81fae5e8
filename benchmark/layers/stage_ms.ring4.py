"""``stage_ms.ring4``: the staging of a mesh sweep job
(``parallel.sharded.stage_mesh_inputs``: the packed words and the
classes copied to the cards, shard by shard), the summed milliseconds of
its ``ukc.ring.stage`` spans on the profiler's clock inside the window,
a job."""

from _spans import span_seconds
from _util import per_job_ms


def read(run):
    seconds = span_seconds(run, "ukc.ring.stage")
    return None if seconds is None else per_job_ms(run, seconds)
