"""What the entries share: the eight parity counters of a result, in the
reference's order."""

from __future__ import annotations

import numpy as np

from reference.kmer_pairs import COUNTER_NAMES


def counters(result) -> np.ndarray:
    return np.array([getattr(result, f) for f in COUNTER_NAMES], np.int64)
