"""What the readers of the agglomerative rounds share: the counts of the
window's last clustering call (``models.agglomerative.last_trace``). A
checkout whose port keeps none reads None."""

from __future__ import annotations

import importlib

AGGLOMERATIVE = "uniprot_kmer_based_clustering_tpu_torch.models.agglomerative"


def agglo_counts() -> dict | None:
    """The counts of the last clustering call (every job of the cell
    clusters the same corpus); None before the port kept them."""
    counts = getattr(importlib.import_module(AGGLOMERATIVE), "last_trace",
                     None)
    return counts or None
