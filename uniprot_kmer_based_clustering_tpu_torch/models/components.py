"""Connected-component clustering over the thresholded pair graph.

A copy of the host union-find of the JAX package's
``models/components.py`` (that module imports jax at its top). The
device label propagation ``connected_components_device`` is still to be
ported (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import numpy as np


def connected_components(n: int, pairs: np.ndarray) -> np.ndarray:
    """Host union-find. ``pairs`` is int [M, >=2] of (i, j, ...) edges.

    Returns int32 [n] labels where each component's label is its smallest
    member index — deterministic regardless of edge order.
    """
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, j in np.asarray(pairs)[:, :2]:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            if ri < rj:
                parent[rj] = ri
            else:
                parent[ri] = rj
    return np.array([find(i) for i in range(n)], dtype=np.int32)
