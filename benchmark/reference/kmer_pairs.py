"""The plain reference of the clustering: numpy and scipy only.

It rebuilds everything from the residues the benchmark generated, and
takes nothing the program made:

1. every overlapping k-mer of every protein, coded big-endian in base 21
   over the upstream's alphabet ``CSTAGPDEQNHRKMILVWYF*`` (any other byte
   codes as ``*``, index 20);
2. the distinct (protein, k-mer) incidences, the document frequency of
   each k-mer, and the k-mers held by two proteins or more;
3. the count of each pair i < j, the number of repeated k-mers both hold,
   as ``triu(B·Bᵀ, 1)`` of the sparse incidence matrix, in row blocks;
4. the eight parity counters (Σ count, pairs with a count, pairs over the
   threshold, largest count; cross-class, then same-class), the pair list
   (count over the threshold, and cross-class unless the gate is off)
   sorted by (i, j), and the connected components of the pairs, each
   labelled by its smallest member.

``count_dtype`` narrows the counts before anything reads them, as an
accumulator of that width would hold them (saturating): it gives the
control that the comparison has to fail.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ALPHABET = b"CSTAGPDEQNHRKMILVWYF*"
COUNTER_NAMES = ("cross_weight", "cross_pairs", "cross_over", "cross_max",
                 "same_weight", "same_pairs", "same_over", "same_max")


def kmer_incidences(seq_buf, offsets, k: int):
    """(protein int64 [nnz], column int64 [nnz], repeated k-mers): the
    distinct incidences of each protein with the k-mers that two proteins
    or more hold, columns numbered in ascending code order."""
    lut = np.full(256, len(ALPHABET) - 1, np.int64)
    lut[np.frombuffer(ALPHABET, np.uint8)] = np.arange(len(ALPHABET))
    idx = lut[np.asarray(seq_buf, np.uint8)]
    offsets = np.asarray(offsets, np.int64)
    n = len(offsets) - 1
    windows = np.maximum(np.diff(offsets) - k + 1, 0)
    first = np.repeat(offsets[:-1], windows)
    within = np.arange(int(windows.sum())) - np.repeat(
        np.cumsum(windows) - windows, windows)
    start = first + within
    code = np.zeros(len(start), np.int64)
    for j in range(k):
        code = code * 21 + idx[start + j]
    protein = np.repeat(np.arange(n, dtype=np.int64), windows)
    universe = 21 ** k
    key = np.unique(protein * universe + code)
    protein, code = key // universe, key % universe
    if universe <= 1 << 26:
        repeated = np.bincount(code, minlength=universe) >= 2
        keep = repeated[code]
        column = (np.cumsum(repeated) - 1)[code[keep]]
        return protein[keep], column, int(repeated.sum())
    codes, doc_freq = np.unique(code, return_counts=True)
    repeated = codes[doc_freq >= 2]
    keep = np.isin(code, repeated)
    return protein[keep], np.searchsorted(repeated, code[keep]), len(repeated)


def _row_block(b, bt, classes, r0: int, rows: int, threshold: int,
               cross_amr_only: bool, count_dtype):
    """The counters and the kept pairs of rows r0 .. r0 + rows of
    ``triu(B·Bᵀ, 1)``."""
    import scipy.sparse as sp

    c = sp.triu(b[r0 : r0 + rows] @ bt, k=1 + r0).tocoo()
    i, j = c.row.astype(np.int64) + r0, c.col.astype(np.int64)
    v = c.data.astype(np.int64)
    if count_dtype is not None:
        top = np.iinfo(count_dtype).max
        v = np.minimum(v, top).astype(count_dtype).astype(np.int64)
    cross = classes[i] != classes[j]
    counters = np.zeros(8, np.int64)
    for lane, part in ((0, v[cross]), (4, v[~cross])):
        counters[lane] = part.sum()
        counters[lane + 1] = (part >= 1).sum()
        counters[lane + 2] = (part > threshold).sum()
        counters[lane + 3] = part.max() if len(part) else 0
    keep = v > threshold
    if cross_amr_only:
        keep &= cross
    return counters, np.stack([i[keep], j[keep], v[keep]], axis=1)


def components(n: int, pairs) -> np.ndarray:
    """Connected components of the pair graph, each labelled by its
    smallest member (int64 [n])."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    g = sp.csr_matrix((np.ones(len(pairs), np.int8),
                       (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    smallest = np.full(comp.max() + 1 if n else 0, n, np.int64)
    np.minimum.at(smallest, comp, np.arange(n))
    return smallest[comp]


def answer(seq_buf, offsets, classes, *, k: int, threshold: int,
           cross_amr_only: bool, with_components: bool,
           count_dtype=None, block: int = 512) -> dict:
    """The reference's answer for one corpus: ``counters`` (int64 [8], in
    ``COUNTER_NAMES`` order), ``pairs`` (int64 [M, 3] sorted by (i, j))
    and, with ``with_components``, ``labels`` (int64 [n]). The row blocks
    of the product run on a thread each core (scipy's product and numpy's
    reductions let go of the interpreter lock)."""
    import scipy.sparse as sp

    classes = np.asarray(classes)
    n = len(classes)
    protein, column, n_cols = kmer_incidences(seq_buf, offsets, k)
    b = sp.csr_matrix((np.ones(len(protein), np.int32), (protein, column)),
                      shape=(n, n_cols))
    bt = b.T.tocsr()
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        parts = list(pool.map(
            lambda r0: _row_block(b, bt, classes, r0, block, threshold,
                                  cross_amr_only, count_dtype),
            range(0, n, block)))
    counters = np.zeros(8, np.int64)
    for part, _ in parts:
        counters[[0, 1, 2, 4, 5, 6]] += part[[0, 1, 2, 4, 5, 6]]
        counters[[3, 7]] = np.maximum(counters[[3, 7]], part[[3, 7]])
    pairs = (np.concatenate([p for _, p in parts]) if parts
             else np.zeros((0, 3), np.int64))
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    out = {"counters": counters, "pairs": pairs}
    if with_components:
        out["labels"] = components(n, pairs)
    return out
