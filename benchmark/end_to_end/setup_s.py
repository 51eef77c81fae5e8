"""``setup_s``: seconds from the start of the process to the start of the
window: the corpus, loading the program (and, on a checkout's first run,
building its kernels), the program's set-up and one warm-up job (host
clock)."""


def read(run):
    return run.setup_s
