"""``host_stages_s.job``: the host stages of a pipeline job (FASTA ingest,
k-mer encode, index, bit packing), the sum of their ``StageTimers``
seconds, a job."""

from _util import per_job_stage


def read(run):
    return per_job_stage(run, ("ingest", "encode", "index", "pack"))
