"""``device_idle.job``: percent of the traced window in which no kernel,
copy or fill ran on the card (the profiler's device timeline), in the
pipeline cell."""

from _util import idle_pct


def read(run):
    return idle_pct(run)
