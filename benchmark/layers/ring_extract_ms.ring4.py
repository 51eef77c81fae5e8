"""``ring_extract_ms.ring4``: the mesh-parallel extraction of a mesh
sweep job (``parallel.sharded.sharded_extract_pairs``: the schedule once
more, each sub-step's survivors compacted into its card's buffers, the
ring shifts, the pairs gathered on the first card, sorted and fetched),
the summed milliseconds of its ``ukc.ring.extract`` spans on the
profiler's clock inside the window, a job."""

from _spans import span_seconds
from _util import per_job_ms


def read(run):
    seconds = span_seconds(run, "ukc.ring.extract")
    return None if seconds is None else per_job_ms(run, seconds)
