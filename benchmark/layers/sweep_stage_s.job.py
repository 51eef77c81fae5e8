"""``sweep_stage_s.job``: the sweep stage of a pipeline job
(``similarity.pairwise``: upload, sweep, extraction), its ``StageTimers``
seconds, a job."""

from _util import per_job_stage


def read(run):
    return per_job_stage(run, ("sweep",))
