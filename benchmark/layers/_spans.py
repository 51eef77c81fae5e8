"""What the readers of the port's own spans and counters share: the
``ukc.*`` spans of ``utils.timing.span`` in the traced window, and the
counts of the last in-core sweep stage (``similarity.pairwise.last_trace``).
A checkout whose port has neither reads None."""

from __future__ import annotations

import importlib

SPAN_PREFIX = "ukc."
PAIRWISE = "uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise"


def span_seconds(run, name: str) -> float | None:
    """Seconds of the spans called ``name`` that start inside the window,
    summed; None when the trace holds none."""
    tr = run.trace
    if tr is None:
        return None
    w0, w1 = tr.window
    spans = [o[2] - o[1] for o in tr.ops if o[0] == name and w0 <= o[1] < w1]
    if not spans:
        return None
    return sum(spans) / 1e9


def has_spans(run) -> bool:
    return run.trace is not None and any(
        o[0].startswith(SPAN_PREFIX) for o in run.trace.ops)


def pairwise_counts() -> dict | None:
    """The counts of the last in-core ``pairwise_similarity`` call (every
    job of a sweep cell does the same work); None before the port kept
    them."""
    counts = getattr(importlib.import_module(PAIRWISE), "last_trace", None)
    return counts or None
