"""``round_gops.agglo``: the int8 operations a job's agglomerative rounds
launch, Σ 2·M·N·K over their products (``models.agglomerative
.last_trace["product_ops"]``), in billions, of the window's last job
(every job runs the same rounds). Each round's product covers every
padded row, active or not: this is the work that a round restricted to
the active rows would cut. A checkout whose port keeps no such count
reads None."""

from _agglo import agglo_counts


def read(run):
    counts = agglo_counts()
    if counts is None or not counts["product_ops"] or not run.jobs:
        return None
    return counts["product_ops"] / 1e9
