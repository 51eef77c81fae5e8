"""Hierarchical k-mer cluster tree — revival of the reference's dead
``src/tree.rs`` (536 LoC, commented out of the build at src/main.rs:15 but
named as BASELINE configs #2/#4).

Semantics reproduced exactly (1-thread insertion order = file order):

  * every node keeps ``u`` = union and ``c`` = intersection of its
    descendants' k-mer presence bitsets (src/tree.rs:52-59);
  * ``Tree::add_protein`` wraps the protein in a leaf and calls
    ``Node::add_child`` on the root (src/tree.rs:531-536);
  * ``add_child`` on a leaf clones it into a child and becomes internal,
    adopting the new child (or, if the new child is internal, its children
    — flattening, src/tree.rs:316-324); on an internal node it updates
    u/c, adopts, and — iff the pre-update ``u`` intersected the child's
    ``u`` (src/tree.rs:331-333,379-384) — rebalances;
  * ``balance`` scans all children pairs (i asc, j < i asc) for the pair
    with the maximum ``|c_i ∩ c_j|`` (first strict max wins) and, when
    max > min over pairs, merges: the child with FEWER children adopts the
    other (ties → the earlier child adopts), recursively re-entering
    ``add_child`` (src/tree.rs:179-240).

Adaptation: bitsets are packed uint64 rows (the same
rank-hash bit space as the pairwise sweep; 5-mer and 7-mer alike, the
``kmer_size`` plumbing of src/tree.rs:85-106 collapsing into which index
built the bitset). Intersection sizes are hardware popcounts (the native
fused ``ukc_and_popcnt_rows`` kernel, ``np.bitwise_count`` as fallback);
each node caches its children's pairwise
c-similarity matrix incrementally, so an insertion costs O(M·W) instead
of the reference's O(M²·W) rescan.

The port's own copy of the JAX package's ``models/tree.py``: a host
module, over the port's binding of the same native kernel.
"""

from __future__ import annotations

import functools
import sys
from typing import List, Optional

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import BitsetMatrix

_UNRESOLVED = object()
_native_rows = _UNRESOLVED  # fused AND+popcount kernel, lazily bound


def _native_rows_fn():
    """Native ukc_and_popcnt_rows, bound once (None → numpy fallback).
    Tests force the fallback by setting ``tree._native_rows = None``."""
    global _native_rows
    if _native_rows is _UNRESOLVED:
        from uniprot_kmer_based_clustering_tpu_torch.io import native

        _native_rows = native.and_popcnt_rows_fn()
    return _native_rows


@functools.lru_cache(maxsize=1)
def _tril_pairs(m: int):
    # maxsize=1: _balance sees consecutive m values as the tree grows, so
    # one slot gives the same hit rate; a deeper cache would pin up to 64
    # O(m²) index pairs (~32 MB each at m≈2000) for no benefit
    ii, jj = np.tril_indices(m, k=-1)
    return ii, jj


class _Node:
    __slots__ = (
        "children", "u", "c", "protein",
        "_sims", "_sbuf", "_cmat", "_rows", "_free",
    )

    def __init__(self, u, c, protein: Optional[int], children=None):
        self.children: List[_Node] = children if children is not None else []
        self.u = u
        self.c = c
        self.protein = protein
        self._sims: Optional[np.ndarray] = None  # children c-sim cache
        self._sbuf: Optional[np.ndarray] = None  # its capacity buffer
        # Pooled children-c matrix backing the cache: capacity-doubling
        # [cap, W] array + slot-per-child list, so every cache event is
        # one batched AND+popcount over the pool prefix (native fused
        # kernel when built, np.bitwise_count otherwise) instead of M
        # Python-level per-pair popcounts and an O(M·W) re-stack — the
        # tree-build hot loop.
        self._cmat: Optional[np.ndarray] = None
        self._rows: Optional[List[int]] = None
        self._free: Optional[List[int]] = None

    # -- similarity cache maintenance ------------------------------------
    def _pool_reset(self):
        m = len(self.children)
        cap = max(8, 2 * m)
        self._cmat = np.zeros((cap,) + self.c.shape, dtype=self.c.dtype)
        for i, ch in enumerate(self.children):
            self._cmat[i] = ch.c
        self._rows = list(range(m))
        self._free = list(range(cap - 1, m - 1, -1))

    def _pool_append(self, child: "_Node"):
        if not self._free:
            cap = self._cmat.shape[0]
            grown = np.zeros((2 * cap,) + self._cmat.shape[1:],
                             dtype=self._cmat.dtype)
            grown[:cap] = self._cmat
            self._cmat = grown
            self._free = list(range(2 * cap - 1, cap - 1, -1))
        slot = self._free.pop()
        self._cmat[slot] = child.c
        self._rows.append(slot)

    def _pool_sims_vs(self, cvec: np.ndarray, upto: Optional[int] = None):
        """|c_i ∩ cvec| for children [0, upto) — one vector popcount over
        the contiguous pool prefix (free slots computed then discarded,
        ≤2× overcompute; a nonzero-row gather was tried and loses — most
        root children are singletons with dense c, and the fancy-index
        copy doubles memory traffic). All-zero query vectors (adopters
        whose intersection collapsed) skip the scan entirely."""
        rows = self._rows if upto is None else self._rows[:upto]
        out = np.zeros(len(rows), dtype=np.int64)
        if not rows or not np.any(cvec):
            return out
        ridx = np.asarray(rows, dtype=np.intp)
        hi = int(ridx.max()) + 1
        fn = _native_rows_fn()
        # the native kernel's ABI is C-contiguous uint64 rows (ctypes
        # ndpointer would raise mid-insertion otherwise); other layouts
        # (e.g. a caller passing raw uint32 BitsetMatrix rows) keep the
        # numpy path, which handles any unsigned dtype
        if (
            fn is not None
            and self._cmat.dtype == np.uint64
            and cvec.dtype == np.uint64
            and self._cmat.flags.c_contiguous
            and cvec.flags.c_contiguous
        ):
            counts = np.empty(hi, dtype=np.int64)
            fn(self._cmat, hi, cvec, counts)
        else:
            counts = np.bitwise_count(self._cmat[:hi] & cvec).sum(
                axis=1, dtype=np.int64
            )
        return counts[ridx]

    def _sim_matrix(self) -> np.ndarray:
        m = len(self.children)
        if self._sims is None or self._sims.shape[0] != m:
            self._pool_reset()
            cap = max(8, 2 * m)
            self._sbuf = np.zeros((cap, cap), dtype=np.int64)
            s = self._sbuf[:m, :m]
            for i in range(1, m):
                row = self._pool_sims_vs(self.children[i].c, upto=i)
                s[i, :i] = row
                s[:i, i] = row
            self._sims = s
        return self._sims

    def _sims_append(self, child: "_Node"):
        # capacity-doubling buffer + view, like the _cmat pool: a fresh
        # (m+1)² alloc+copy per insertion is O(m²) in the hot loop
        if self._sims is None:
            return
        m = self._sims.shape[0]
        if m + 1 > self._sbuf.shape[0]:
            grown = np.zeros((2 * self._sbuf.shape[0],) * 2, np.int64)
            grown[:m, :m] = self._sims
            self._sbuf = grown
        buf = self._sbuf
        if m:
            row = self._pool_sims_vs(child.c)
            buf[m, :m] = row
            buf[:m, m] = row
        buf[m, m] = 0  # fresh-alloc semantics: the (unused) diagonal is 0
        self._sims = buf[: m + 1, : m + 1]
        self._pool_append(child)

    def _sims_remove(self, idx: int):
        if self._sims is None:
            return
        # in-place forward shifts (numpy buffers overlapping basic-slice
        # assignments) — two tail copies instead of np.delete's two full
        # matrix copies
        m = self._sims.shape[0]
        buf = self._sbuf
        buf[idx : m - 1, :m] = buf[idx + 1 : m, :m]
        buf[:m - 1, idx : m - 1] = buf[: m - 1, idx + 1 : m]
        self._sims = buf[: m - 1, : m - 1]
        self._free.append(self._rows.pop(idx))

    def _sims_refresh(self, idx: int):
        if self._sims is None:
            return
        self._cmat[self._rows[idx]] = self.children[idx].c
        row = self._pool_sims_vs(self.children[idx].c)
        row[idx] = self._sims[idx, idx]
        self._sims[idx, :] = row
        self._sims[:, idx] = row


def _add_child(curr: _Node, child: _Node) -> None:
    if not curr.children:
        # Leaf case (src/tree.rs:273-325): clone self into a child node,
        # become internal, adopt `child` (or its children if internal).
        cloned = _Node(curr.u, curr.c, curr.protein)
        curr.protein = None
        curr.u = curr.u | child.u
        curr.c = curr.c & child.c
        curr.children = [cloned] + (
            child.children if child.children else [child]
        )
        curr._sims = None
        return

    # Internal case (src/tree.rs:327-385): the balance trigger uses the
    # PRE-update union.
    had_common = bool(np.any(curr.u & child.u))
    curr.u = curr.u | child.u
    curr.c = curr.c & child.c
    curr.children.append(child)
    curr._sims_append(child)
    if had_common:
        _balance(curr)


def _balance(curr: _Node) -> None:
    m = len(curr.children)
    if m < 2:
        return
    sims = curr._sim_matrix()
    # iteration order i ascending from 1, j ascending < i; strict ">" for
    # max and strict "<" for min (src/tree.rs:183-216). np.argmax returns
    # the first occurrence in that same order, preserving tie semantics.
    ii, jj = _tril_pairs(m)
    vals = sims[ii, jj]
    k = int(np.argmax(vals))
    max_val = int(vals[k])
    max_i, max_j = int(ii[k]), int(jj[k])
    min_val = int(vals.min())
    if max_val <= min_val or max_val <= 0:
        return

    child_one = curr.children[max_i]
    child_two = curr.children[max_j]
    if len(child_one.children) < len(child_two.children):
        adopter, adopted, remove_idx = child_one, child_two, max_j
    else:
        adopter, adopted, remove_idx = child_two, child_one, max_i
    del curr.children[remove_idx]
    curr._sims_remove(remove_idx)
    _add_child(adopter, adopted)
    # the adopter's c shrank — refresh its cached similarities
    curr._sims_refresh(curr.children.index(adopter))


class ClusterTree:
    """Incremental agglomerative tree over packed k-mer bitsets."""

    def __init__(self, first_protein: int, first_row: np.ndarray):
        row = np.ascontiguousarray(first_row)
        self.root = _Node(row, row, first_protein)
        self.n_inserted = 1

    def add_protein(self, protein: int, row: np.ndarray) -> None:
        row = np.ascontiguousarray(row)
        leaf = _Node(row, row, protein)
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000 + 10 * self.n_inserted))
        try:
            _add_child(self.root, leaf)
        finally:
            sys.setrecursionlimit(old_limit)
        self.n_inserted += 1

    def labels(self, n: int) -> np.ndarray:
        """Cluster label per protein: proteins under the same root child
        share a label (the subtree's minimum protein index — canonical)."""
        labels = np.full(n, -1, dtype=np.int32)

        def collect(node: _Node, out: List[int]):
            stack = [node]
            while stack:
                nd = stack.pop()
                if nd.protein is not None:
                    out.append(nd.protein)
                stack.extend(nd.children)

        if self.root.protein is not None:  # single-leaf tree
            labels[self.root.protein] = self.root.protein
            return labels
        for child in self.root.children:
            members: List[int] = []
            collect(child, members)
            if members:
                labels[np.asarray(members)] = min(members)
        return labels

    def depth(self) -> int:
        # iterative: chain-shaped trees exceed Python's default recursion
        # limit (add_protein raises the limit for its own recursion;
        # depth() must not depend on that)
        best = 0
        stack = [(self.root, 1)]
        while stack:
            node, d = stack.pop()
            if not node.children:
                best = max(best, d)
            else:
                stack.extend((c, d + 1) for c in node.children)
        return best


def build_tree(bitset: BitsetMatrix, n: int, order=None) -> ClusterTree:
    """Insert proteins in `order` (default: file order — the reference's
    1-thread semantics, SURVEY.md §3.2)."""
    words64 = np.ascontiguousarray(bitset.words[:n]).view(np.uint64)
    order = range(n) if order is None else order
    it = iter(order)
    first = next(it)
    tree = ClusterTree(int(first), words64[first])
    for i in it:
        tree.add_protein(int(i), words64[int(i)])
    return tree


def cluster_tree_labels(bitset: BitsetMatrix, n: int) -> np.ndarray:
    return build_tree(bitset, n).labels(n)
