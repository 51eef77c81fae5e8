"""``upload_gbps.sweep``: the rate of the sweep stage's upload to the
card (``state.bitset_to_torch`` and the classes): the bytes a job sends
(``similarity.pairwise.last_trace``'s ``upload_bytes``) times the jobs,
over the device seconds of the window's host-to-device copies, in GB/s."""

from _spans import pairwise_counts


def read(run):
    counts = pairwise_counts()
    if counts is None or run.trace is None or not run.jobs:
        return None
    seconds = run.trace.device_seconds(name_has=("Memcpy HtoD",))
    if seconds <= 0:
        return None
    return counts["upload_bytes"] * run.jobs / seconds / 1e9
