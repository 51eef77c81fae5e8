"""``device_idle.agglo``: percent of the traced window in which no kernel,
copy or fill ran on the card (the profiler's device timeline), in the
agglomerative pipeline cell."""

from _util import idle_pct


def read(run):
    return idle_pct(run)
