"""``extract_ms.sweep``: the two-pass extraction of a sweep job
(``similarity.pairwise.extract_pairs``: the plan, the window unpack, the
hit tiles' products and ``nonzero`` compactions, the fetch), the summed
milliseconds of its ``ukc.pairwise.extract`` spans on the profiler's
clock inside the window, a job."""

from _spans import span_seconds
from _util import per_job_ms


def read(run):
    seconds = span_seconds(run, "ukc.pairwise.extract")
    return None if seconds is None else per_job_ms(run, seconds)
