"""``job_s``: seconds from the window's start to the end of the last
completed job, over the jobs completed (host clock)."""


def read(run):
    if not run.jobs:
        return None
    return run.window_s / run.jobs
