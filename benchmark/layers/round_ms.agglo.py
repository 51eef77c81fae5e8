"""``round_ms.agglo``: one round of agglomerative clustering
(``models.agglomerative``: the unpack, the int8 product, the masked
argmax, the fetch and the host's merge), the summed milliseconds of the
``ukc.agglo.round`` spans on the profiler's clock inside the window over
the window's rounds (jobs × ``last_trace["rounds"]``, every job runs the
same rounds). A checkout whose port has no such span or count reads
None."""

from _agglo import agglo_counts
from _spans import span_seconds


def read(run):
    seconds = span_seconds(run, "ukc.agglo.round")
    counts = agglo_counts()
    if seconds is None or counts is None or not counts["rounds"] \
            or not run.jobs:
        return None
    return seconds / (run.jobs * counts["rounds"]) * 1e3
