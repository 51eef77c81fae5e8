"""``epilogue_roofline.sweep``: the statistics epilogue of ``ops.stats``
(``csrc/stats_epilogue.cu``: K1 on strips and ring sub-steps, K2 on the
scan's steps) as a percent of its bytes bound: the bytes one whole sweep
needs (``peaks.epilogue_needed_bytes``: the count of each pair i < j
read once, the classes and the outputs once) for each job, over the
published HBM rate, over the device time of the epilogue's kernels,
summed over the cards."""

from _util import EPILOGUE_KERNEL

from peaks import epilogue_needed_bytes, peak


def read(run):
    tr = run.trace
    if tr is None or not run.jobs:
        return None
    seconds = tr.device_seconds(name_has=(EPILOGUE_KERNEL,))
    if seconds <= 0:
        return None
    need = epilogue_needed_bytes(run.n, run.tile) * run.jobs
    return 100.0 * need / peak(run.kind, "hbm_bytes_s") / seconds
