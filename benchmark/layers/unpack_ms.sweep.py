"""``unpack_ms.sweep``: device milliseconds a job of the kernels that the
ops of ``ops.bitmul.unpack_words_to_int8`` launch (the byte shift and the
mask), summed over the cards."""

from _util import UNPACK_OPS, per_job_ms


def read(run):
    if run.trace is None:
        return None
    return per_job_ms(run, run.trace.device_seconds(launched_by=UNPACK_OPS))
