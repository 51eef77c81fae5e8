"""``index_s.job``: the k-mer index stage of a pipeline job
(``kmers.index.build_index``: the radix build and the unique codes'
owners), the summed seconds of its ``ukc.stage.index`` spans on the
profiler's clock inside the window, a job."""

from _spans import span_seconds


def read(run):
    seconds = span_seconds(run, "ukc.stage.index")
    if seconds is None or not run.jobs:
        return None
    return seconds / run.jobs
