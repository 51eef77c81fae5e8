"""``extract_ms.sweep``: the extraction of a sweep job
(``similarity.pairwise.extract_pairs``: on the strip schedule the plan
and one sort and fetch of the survivors that K1 appended; the second
pass over the hit tiles only under ``two_pass``, on the scan or past the
pair buffer's slots), the summed milliseconds of its
``ukc.pairwise.extract`` spans on the profiler's clock inside the
window, a job."""

from _spans import span_seconds
from _util import per_job_ms


def read(run):
    seconds = span_seconds(run, "ukc.pairwise.extract")
    return None if seconds is None else per_job_ms(run, seconds)
