"""Row-statistic lane names and the upper-triangle tile enumeration.

Numpy copies of ``ROW_STAT_NAMES`` and ``upper_triangle_tiles`` from the
JAX package's ``ops/popcount.py`` (that module imports jax at its top).
The popcount engines themselves are still to be ported (ROADMAP queue 1,
item 6).

Row-stat lanes, per stationary protein row over all j > i:
  0 cross_weight  Σ counts where class differs
  1 cross_pairs   #pairs with counts ≥ w_thresh, class differs
  2 cross_over    #pairs with counts > threshold, class differs
  3 cross_max     max count, class differs
  4..7 the same four for class-equal pairs
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

ROW_STAT_NAMES = (
    "cross_weight",
    "cross_pairs",
    "cross_over",
    "cross_max",
    "same_weight",
    "same_pairs",
    "same_over",
    "same_max",
)


def upper_triangle_tiles(n_pad: int, tile: int) -> Tuple[np.ndarray, np.ndarray]:
    """(i_tile, j_tile) enumeration of the upper triangle, row-major so
    that all tiles sharing a stationary i are consecutive."""
    nt = n_pad // tile
    i, j = np.triu_indices(nt)
    return i.astype(np.int32), j.astype(np.int32)
