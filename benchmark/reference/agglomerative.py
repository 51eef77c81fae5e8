"""The plain reference of agglomerative clustering: numpy and scipy only.

It answers what ``kmer_pairs`` answers (the pair list and the eight
parity counters, which it takes from that module) and, for a run that
clusters, the clusters that batched mutual merges of intersection
signatures make, and the merges themselves:

1. each protein starts as a cluster whose signature is the set of its
   repeated k-mers (those two proteins or more hold), the rows of
   ``kmer_pairs.kmer_incidences``;
2. each round, every active cluster i finds, among the other active
   clusters, the largest count of k-mers that both signatures hold, ties
   going to the lowest index;
3. the pairs that are each other's best, with a count of ``min_shared``
   or more, merge: the lower index wins, its signature becomes the
   intersection of the two, and the loser goes inactive; a round's
   merges are recorded by ascending winner, as (winner, loser, shared);
4. the rounds stop after one with no merge, or after ``max_rounds``.

Each cluster is labelled by its smallest member, which is its winner.

Departures from the upstream's tree (``src/tree.rs:179-265``,
``Node::balance``), as the program documents them too: the upstream
inserts proteins one at a time and merges, within each node, the two
children whose c-bitarray intersections overlap most, so its tree
depends on the insertion order; here every cluster takes part in every
round, and all mutual best pairs of a round merge at once, so the
result depends on no order but the proteins' indices, which break ties.
The upstream's gate is "shares any k-mer", ``min_shared`` 1.

The counts are exact. The first round is one ``S·Sᵀ`` of the sparse
signature matrix in row blocks, as ``kmer_pairs`` computes its counts;
a later round recomputes only the rows whose best it may have moved:
the winners, whose signatures shrank, and the rows whose best was a
winner or a loser. Every other row keeps its best, since a merge only
shrinks a signature and so lowers no count but the winner's and the
loser's. ``count_dtype`` narrows every count before it is read, as an
accumulator of that width would hold it (saturating): the control.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from reference import kmer_pairs


def merges_wrong(got, want: np.ndarray) -> int:
    """Rows of the dendrogram that differ from the reference's at the
    same place, plus the rows that one has and the other lacks: 0 only
    for the same merges in the same order."""
    got = np.asarray(got)
    if got.ndim != 2 or got.shape[1] != 3:
        return len(want) + int(got.size)
    m = min(len(got), len(want))
    differ = (got[:m].astype(np.int64) != want[:m]).any(axis=1)
    return int(np.count_nonzero(differ)) + abs(len(got) - len(want))


# the numbers this reference adds to the comparison: name -> (the key of
# the answer it reads, the function that counts what differs); limit 0
CHECKS = {"merges_wrong": ("merges", merges_wrong)}


def _best_rows(s, st, rows, count_dtype):
    """(best count, best column) of each of ``rows`` of ``S·Sᵀ`` with
    the diagonal left out, ties to the lowest column; (0, -1) for a row
    that shares no k-mer with another."""
    n = s.shape[0]
    c = (s[rows] @ st).tocsr()
    v = c.data.astype(np.int64)
    if count_dtype is not None:
        v = np.minimum(v, np.iinfo(count_dtype).max)
    col = c.indices.astype(np.int64)
    per_row = np.diff(c.indptr)
    v[col == np.repeat(rows, per_row)] = 0
    # the largest count first, then the lowest column: one key to take
    # the largest of; a key under n + 1 is a count of 0
    key = v * (n + 1) + (n - col)
    best = np.zeros(len(rows), np.int64)
    nonempty = per_row > 0
    if nonempty.any():
        best[nonempty] = np.maximum.reduceat(key, c.indptr[:-1][nonempty])
    count = best // (n + 1)
    return count, np.where(count > 0, n - best % (n + 1), -1)


def _best(s, rows, pool, block: int, count_dtype):
    st = s.T.tocsr()
    parts = list(pool.map(
        lambda r0: _best_rows(s, st, rows[r0 : r0 + block], count_dtype),
        range(0, len(rows), block)))
    if not parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def cluster(seq_buf, offsets, *, k: int, min_shared: int = 1,
            max_rounds: int = 10_000, count_dtype=None, block: int = 512):
    """(labels int64 [n], merges int64 [M, 3], rounds) of the batched
    mutual merges of the proteins' k-mer signatures."""
    import scipy.sparse as sp

    if min_shared < 1:
        raise ValueError(f"min_shared must be 1 or more, got {min_shared}")
    n = len(offsets) - 1
    protein, column, n_cols = kmer_pairs.kmer_incidences(seq_buf, offsets, k)
    s = sp.csr_matrix((np.ones(len(protein), np.int32), (protein, column)),
                      shape=(n, n_cols))
    idx = np.arange(n)
    active = np.ones(n, bool)
    merges = []
    rounds = 0
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        best_c, best_j = _best(s, idx, pool, block, count_dtype)
        while rounds < max_rounds:
            rounds += 1
            partner = np.maximum(best_j, 0)
            mutual = (active & (best_c >= min_shared) & (best_j > idx)
                      & (best_j[partner] == idx))
            winners = idx[mutual]
            if not len(winners):
                break
            losers = best_j[winners]
            merges.append(np.stack([winners, losers, best_c[winners]], 1))
            touched = np.zeros(n, bool)
            touched[winners] = touched[losers] = True
            active[losers] = False
            # the winners' rows become the intersections, the losers'
            # rows empty; every other row stays as it was
            kept = s.tocoo()
            keep = ~touched[kept.row]
            both = s[winners].multiply(s[losers]).tocoo()
            rows = np.concatenate([kept.row[keep], winners[both.row]])
            cols = np.concatenate([kept.col[keep], both.col])
            s = sp.csr_matrix((np.ones(len(rows), np.int32), (rows, cols)),
                              shape=(n, n_cols))
            redo = active & ((best_j >= 0) & touched[partner] | mutual)
            best_c[losers], best_j[losers] = 0, -1
            rows = idx[redo]
            best_c[rows], best_j[rows] = _best(s, rows, pool, block,
                                               count_dtype)
    merges = (np.concatenate(merges) if merges
              else np.zeros((0, 3), np.int64)).astype(np.int64)
    parent = np.arange(n)
    parent[merges[:, 1]] = merges[:, 0]
    while True:  # the winner is below the loser: jump to each root
        up = parent[parent]
        if np.array_equal(up, parent):
            break
        parent = up
    return parent.astype(np.int64), merges, rounds


def answer(seq_buf, offsets, classes, *, pipeline: dict, with_clusters: bool,
           count_dtype=None) -> dict:
    """The reference's answer for one corpus under the configuration's
    ``pipeline`` block: ``counters`` and ``pairs`` as ``kmer_pairs``
    gives them and, with ``with_clusters``, ``labels`` (int64 [n], each
    cluster labelled by its smallest member) and ``merges`` (int64
    [M, 3], (winner, loser, shared) in the order they merged)."""
    if with_clusters and pipeline.get("cluster") != "agglomerative":
        raise ValueError("this reference answers cluster='agglomerative', "
                         f"not {pipeline.get('cluster')!r}")
    out = kmer_pairs.answer(
        seq_buf, offsets, classes, k=pipeline["k"],
        threshold=pipeline["threshold"],
        cross_amr_only=pipeline["cross_amr_only"], with_components=False,
        count_dtype=count_dtype)
    if with_clusters:
        out["labels"], out["merges"], _ = cluster(
            seq_buf, offsets, k=pipeline["k"],
            min_shared=pipeline.get("min_shared", 1),
            count_dtype=count_dtype)
    return out
