"""``pairs_per_s``: protein pairs swept a second, n(n-1)/2 for each job
completed, over the seconds from the window's start to the end of the
last completed job (host clock)."""


def read(run):
    if not run.jobs:
        return None
    return run.n * (run.n - 1) / 2 * run.jobs / run.window_s
