"""``host_idle_ms.sweep``: the card's idle time a sweep job that the
host's own Python and numpy work inside the port holds it: the idle gaps
of the traced window (``Trace.idle_gaps``) that ``Trace.label_gaps``
puts down to a ``ukc.*`` span and not to a PyTorch op, in milliseconds
a job, the mean over the cards."""

from _spans import SPAN_PREFIX, has_spans


def read(run):
    tr = run.trace
    if tr is None or not tr.cards or not run.jobs or not has_spans(run):
        return None
    idle = 0
    for card in tr.cards:
        gaps = tr.idle_gaps(card)
        idle += sum(b - a for (a, b), label in zip(gaps, tr.label_gaps(gaps))
                    if label.startswith(SPAN_PREFIX))
    return idle / len(tr.cards) / 1e9 / run.jobs * 1e3
