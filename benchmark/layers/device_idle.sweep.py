"""``device_idle.sweep``: percent of the traced window in which no kernel,
copy or fill ran on a card (the profiler's device timeline), the mean of
the cards' shares, in the sweep cells."""

from _util import idle_pct


def read(run):
    return idle_pct(run)
