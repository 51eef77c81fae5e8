"""``devindex_sort_ms.k7dev``: the global sort of the device index build
(``kmers.index_device``: the sort of every deduplicated window slot,
``unique_consecutive`` and the ranks written back through the
permutation), the summed milliseconds of its ``ukc.index.device.sort``
spans inside the window, a job. A checkout whose port has no such span
reads None."""

from _spans import span_seconds
from _util import per_job_ms


def read(run):
    seconds = span_seconds(run, "ukc.index.device.sort")
    if seconds is None:
        return None
    return per_job_ms(run, seconds)
