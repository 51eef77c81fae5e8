"""Connected-component clustering over the thresholded pair graph.

The port's counterpart of the JAX package's ``models/components.py``:
the host union-find (what the pipeline runs on one device), the device
min-label propagation ``connected_components_device`` (a library entry,
for large pair lists) and ``connected_components_sharded`` (what the
pipeline runs on a mesh). Each labels a component by its smallest member
index, whatever the edge order.
"""

from __future__ import annotations

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device


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


def _propagate_labels(pairs_i, pairs_j, n: int):
    """Min-label propagation with pointer halving over int64 edge tensors
    on one device: (labels int64 [n], rounds). A round scatters the
    smaller label of each edge's ends into both ends
    (``scatter_reduce`` "amin", the JAX ``.at[].min``), then halves
    pointers (label[i] ← label[label[i]]); it repeats until a round
    changes nothing, one scalar read a round. Labels only fall and stay
    node indices of the same component, so the fixpoint is each
    component's minimum."""
    labels = torch.arange(n, dtype=torch.int64, device=pairs_i.device)
    rounds = 0
    while True:
        rounds += 1
        m = torch.minimum(labels[pairs_i], labels[pairs_j])
        new = labels.scatter_reduce(0, pairs_i, m, "amin", include_self=True)
        new = new.scatter_reduce(0, pairs_j, m, "amin", include_self=True)
        new = new[new]
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels, rounds


def connected_components_device(pairs_i, pairs_j, *, n: int, device="cuda"):
    """Device min-label propagation (the JAX package's
    ``connected_components_device``) on ``device``.

    ``pairs_i``/``pairs_j`` are the edge ends (numpy arrays or tensors);
    padding edges are self-edges (i = j), which change nothing. Returns
    int32 numpy [n] labels equal to :func:`connected_components`'.
    """
    device = resolve_device(device)
    pi = torch.as_tensor(pairs_i).to(device=device, dtype=torch.int64)
    pj = torch.as_tensor(pairs_j).to(device=device, dtype=torch.int64)
    labels, _ = _propagate_labels(pi, pj, n)
    return labels.to(torch.int32).cpu().numpy()


def connected_components_sharded(mesh, pairs, n: int):
    """Min-label propagation over edges sharded across ``mesh`` (the JAX
    package's ``connected_components_sharded``).

    The edge list is split evenly over the mesh's devices (padding edges
    are self-edges of node 0); the [n] labels are replicated. A round
    scatters each shard's edge minima into its copy of the labels
    (``scatter_reduce`` "amin", i then j), merges the copies by an
    elementwise minimum on the first device (JAX's ``pmin``), then halves
    pointers; one scalar read a round tests the fixpoint. Min-reductions
    are order-free, so the labels equal the host union-find's for every
    device count. The edges shard over every device of the mesh; across
    processes each rank scatters its own shards' edges, the minimum and
    the labels' broadcast cross ranks, and every rank returns the same
    labels. Returns int32 numpy [n]."""
    from uniprot_kmer_based_clustering_tpu_torch.parallel.mesh import (
        broadcast_from_first,
        min_to_first,
        shard_rows,
    )

    d = mesh.size
    edges = np.asarray(pairs)[:, :2].astype(np.int64)
    m_pad = max(d, -(-edges.shape[0] // d) * d)
    padded = np.zeros((m_pad, 2), dtype=np.int64)
    padded[: edges.shape[0]] = edges
    shards = shard_rows(mesh, padded)
    labels = torch.arange(n, dtype=torch.int64, device=mesh.home)
    while True:
        parts = []
        for lab, e in zip(broadcast_from_first(labels, mesh), shards):
            if e is None:
                parts.append(None)
                continue
            pi, pj = e[:, 0], e[:, 1]
            m = torch.minimum(lab[pi], lab[pj])
            new = lab.scatter_reduce(0, pi, m, "amin", include_self=True)
            parts.append(new.scatter_reduce(0, pj, m, "amin",
                                            include_self=True))
        new = min_to_first(parts, mesh)
        new = new[new]
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels.to(torch.int32).cpu().numpy()
