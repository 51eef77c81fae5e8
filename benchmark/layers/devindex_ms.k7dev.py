"""``devindex_ms.k7dev``: the device index build of a pipeline job
(``kmers.index_device.build_device_index``: the residue matrix and its
upload, the encode, the global sort, the bit scatter and the fetch of
the codes and doc-freqs), the summed milliseconds of its
``ukc.index.device`` spans on the profiler's clock inside the window, a
job. A checkout whose port has no such span reads None."""

from _spans import span_seconds
from _util import per_job_ms


def read(run):
    seconds = span_seconds(run, "ukc.index.device")
    if seconds is None:
        return None
    return per_job_ms(run, seconds)
