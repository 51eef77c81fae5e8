"""``cluster_s.job``: the connected components of a pipeline job (the
host union-find of ``models.components``), its ``StageTimers`` seconds,
a job."""

from _util import per_job_stage


def read(run):
    return per_job_stage(run, ("cluster",))
