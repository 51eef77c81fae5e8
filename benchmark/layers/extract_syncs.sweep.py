"""``extract_syncs.sweep``: the host waits of a sweep job's extraction
(a ``nonzero`` a product of hit tiles, a boolean-mask compaction on the
fused path, and the final fetch), ``similarity.pairwise.last_trace``'s
``extract_syncs`` of the window's last job."""

from _spans import pairwise_counts


def read(run):
    counts = pairwise_counts()
    if counts is None or not run.jobs:
        return None
    return float(counts["extract_syncs"])
