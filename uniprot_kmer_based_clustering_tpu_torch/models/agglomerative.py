"""Batched agglomerative clustering — the port of the JAX package's
``models/agglomerative.py``.

The reference's ``src/tree.rs`` inserts proteins one at a time and
greedily merges the two children whose **c-bitarray intersections**
(the AND of all members' k-mer bitsets) overlap the most
(``Node::balance``, src/tree.rs:179-240), a sequential,
insertion-order-dependent procedure (revived exactly in
``models/tree.py``). This module keeps the same similarity notion —
shared k-mers between cluster intersection signatures — in batched
rounds on the device:

  * every cluster keeps a packed **intersection signature** (the
    c-bitarray) as one row of an ``[N_pad, W]`` int32 words tensor;
  * each round computes ALL pairwise signature intersection counts in
    one int8 product (``ops.bitmul``'s unpack and ``torch._int_mm``, the
    sweep's machinery), or strip by strip past the plan's budget;
  * every **mutual-argmax** pair with count ≥ min_shared merges (ties
    break to the lowest index, ``torch.argmax``'s first maximum, so the
    result is deterministic and insertion-order free);
  * merged signatures are the AND of the two parents; rounds repeat
    until no pair clears the gate.

Returns both a flat partition and the dendrogram (one merge edge per
round entry), the hierarchical structure the reference's tree encodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
    counts_window_pair,
    int8_gemm,
    unpack_words_to_int8,
)
from uniprot_kmer_based_clustering_tpu_torch.state import bitset_to_torch


def _best_of(counts, ok):
    """First-max argmax of each row of ``counts`` with ``~ok`` set to −1
    (in place), and the best count: (best_j int64, best_c int32)."""
    counts.masked_fill_(~ok, -1)
    best_j = torch.argmax(counts, dim=1)
    return best_j, torch.gather(counts, 1, best_j[:, None])[:, 0]


def _round_argmax(sigs, active):
    """Per-row best mutual-merge candidate over active signature rows.

    Returns (best_j int64 [N], best_count int32 [N]) with inactive rows
    and the diagonal masked out. One [N, K]·[N, K]ᵀ int8 product.
    """
    a = unpack_words_to_int8(sigs)
    counts = int8_gemm(a, a)
    del a
    iota = torch.arange(counts.shape[0], device=sigs.device)
    # an iota compare, not an eye: no [N, N] constant is built
    ok = active[None, :] & active[:, None] & (iota[:, None] != iota[None, :])
    return _best_of(counts, ok)


def _round_argmax_strip(sigs, active, i0: int, *, strip: int,
                        word_chunk: int):
    """One row strip of the round's argmax, the path past the one-shot
    plan's budget: the counts of ``strip`` rows against all of them
    through ``ops.bitmul.counts_window_pair`` (word-chunked), so the
    transients stay bounded by ``strip`` and ``word_chunk``. The counts
    are the same integer sums as :func:`_round_argmax`'s, so the argmax
    and its ties are too."""
    counts = counts_window_pair(sigs[i0 : i0 + strip], sigs,
                                word_chunk=word_chunk)
    iota = torch.arange(sigs.shape[0], device=sigs.device)
    gi = i0 + torch.arange(strip, device=sigs.device)
    ok = (active[None, :] & active[i0 : i0 + strip, None]
          & (gi[:, None] != iota[None, :]))
    return _best_of(counts, ok)


def _round_argmax_any(sigs, active, plan):
    """Round argmax through the path ``plan`` selected (see
    :func:`_argmax_plan`): the one-shot product, or the strips written
    into one device pair of outputs. Fetched in one copy as numpy
    (best_j int32 [N_pad], best_c int32 [N_pad])."""
    if plan is None:
        bj, bc = _round_argmax(sigs, active)
    else:
        strip, word_chunk = plan
        n_pad = sigs.shape[0]
        bj = torch.empty(n_pad, dtype=torch.int64, device=sigs.device)
        bc = torch.empty(n_pad, dtype=torch.int32, device=sigs.device)
        for i0 in range(0, n_pad, strip):
            # the final strip re-covers the tail from n_pad − strip (its
            # rows are written again with the same values)
            ic = min(i0, max(0, n_pad - strip))
            bj[ic : ic + strip], bc[ic : ic + strip] = _round_argmax_strip(
                sigs, active, ic, strip=strip, word_chunk=word_chunk)
    both = torch.stack([bj.to(torch.int32), bc]).cpu().numpy()
    return both[0], both[1]


def _argmax_plan(n_pad: int, w: int, hbm_budget_bytes: int):
    """None (the one-shot product fits) or (strip, word_chunk) for the
    strip path, the JAX package's rule. The one-shot round builds the
    [N_pad, K] int8 unpack and the [N_pad, N_pad] counts; past half the
    budget it strips, so the transients of one strip (a strip·K unpack
    chunk and strip·N_pad counts) stay a small share of the budget."""
    if n_pad * w * 32 + n_pad * n_pad * 4 <= hbm_budget_bytes // 2:
        return None
    strip = min(512, n_pad)
    while (
        strip * 2 * n_pad * 4 <= hbm_budget_bytes // 8
        and strip * 2 < n_pad
    ):
        strip *= 2
    word_chunk = 0
    if 2 * n_pad * w * 32 > hbm_budget_bytes // 2:
        target = max(128, hbm_budget_bytes // 2 // (2 * n_pad * 32))
        base = w // 128
        best = 1
        for d in range(1, base + 1):
            if base % d == 0 and d * 128 <= target:
                best = d
        word_chunk = best * 128
    return strip, word_chunk


def _merge_signatures(sigs, partner, is_winner, is_loser):
    """Winners absorb their partner (AND), losers zero out: full-width
    [N_pad] masks, as in the JAX package."""
    merged = sigs & sigs[partner]
    sigs = torch.where(is_winner[:, None], merged, sigs)
    return torch.where(is_loser[:, None], 0, sigs)


@dataclass
class AgglomerativeResult:
    labels: np.ndarray        # [n] cluster label (minimum member index)
    merges: np.ndarray        # [M, 3] (winner, loser, shared_count) in order
    rounds: int


def agglomerative_cluster(
    bitset, n: int, min_shared: int = 1, max_rounds: int = 10_000,
    hbm_budget_bytes: int = 13 << 30, device="cuda",
) -> AgglomerativeResult:
    """Cluster ``n`` proteins by iterative mutual-argmax signature merges,
    each round's argmax on ``device`` and its bookkeeping on the host
    (a union-find for the labels).

    ``bitset``: a BitsetMatrix (or any object with ``.words`` uint32
    [N_pad, W]). ``min_shared``: minimum shared k-mers between the two
    cluster intersection signatures for a merge (the analogue of
    balance()'s "shares any k-mer" gate at 1). Past the budget the
    argmax runs in row strips with a chunked unpack
    (:func:`_argmax_plan`); the merge sequence is the same. The budget
    keeps the JAX package's default, so both packages take one plan.
    """
    device = resolve_device(device)
    n_pad, w = np.asarray(bitset.words).shape
    plan = _argmax_plan(n_pad, w, hbm_budget_bytes)
    sigs = bitset_to_torch(bitset, device)
    active_np = np.zeros(n_pad, bool)
    active_np[:n] = True
    parent = np.arange(n_pad, dtype=np.int64)  # union-find for labels

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def up(a):
        return torch.from_numpy(a).to(device)

    merges: List[Tuple[int, int, int]] = []
    rounds = 0
    while rounds < max_rounds:
        rounds += 1
        best_j, best_c = _round_argmax_any(sigs, up(active_np), plan)
        # mutual argmax pairs over the gate; i < j canonical
        i_idx = np.arange(n_pad)
        mutual = (
            active_np
            & (best_c >= min_shared)
            & (best_j[best_j] == i_idx)
            & (i_idx < best_j)
        )
        winners = i_idx[mutual]
        losers = best_j[mutual]
        if winners.size == 0:
            break
        partner = np.arange(n_pad, dtype=np.int64)
        partner[winners] = losers
        is_winner = np.zeros(n_pad, bool)
        is_winner[winners] = True
        is_loser = np.zeros(n_pad, bool)
        is_loser[losers] = True
        sigs = _merge_signatures(sigs, up(partner), up(is_winner),
                                 up(is_loser))
        for wi, lo, c in zip(winners, losers, best_c[winners]):
            merges.append((int(wi), int(lo), int(c)))
            parent[find(int(lo))] = find(int(wi))
        active_np[losers] = False

    labels = np.full(n, -1, np.int32)
    roots: dict = {}
    for i in range(n):
        r = find(i)
        if r not in roots:
            roots[r] = i  # first member = minimum index (ascending scan)
        labels[i] = roots[r]
    return AgglomerativeResult(
        labels=labels,
        merges=np.asarray(merges, np.int64).reshape(-1, 3),
        rounds=rounds,
    )


def agglomerative_cluster_device(
    bitset, n: int, min_shared: int = 1, max_rounds: int = 10_000,
    device="cuda",
) -> AgglomerativeResult:
    """Agglomerative clustering with the whole state on ``device``: the
    rounds loop in Python, and each reads one scalar back (its merge
    count). Output equal to :func:`agglomerative_cluster`'s.

    Winner = the lower index of each mutual pair, so a cluster's
    representative is its minimum member; labels resolve by pointer
    jumping on the device, with no host union-find. Merges are written
    in the JAX order: a cumulative sum over the mutual mask. Scatters
    of rows that do not merge go to one spare slot past N_pad (the JAX
    ``mode="drop"``).
    """
    device = resolve_device(device)
    sigs = bitset_to_torch(bitset, device)
    n_pad = sigs.shape[0]
    iota = torch.arange(n_pad, device=device)
    active = torch.zeros(n_pad + 1, dtype=torch.bool, device=device)
    active[:n] = True
    parent = torch.arange(n_pad + 1, device=device)
    merges = torch.zeros((n_pad + 1, 3), dtype=torch.int32, device=device)
    mcount = 0
    rounds = 0
    while rounds < max_rounds:
        rounds += 1
        act = active[:n_pad]
        best_j, best_c = _round_argmax(sigs, act)
        m = (act & (best_c >= min_shared) & (best_j[best_j] == iota)
             & (iota < best_j))
        sigs = torch.where(m[:, None], sigs & sigs[best_j], sigs)
        loser = torch.where(m, best_j, n_pad)
        active[loser] = False
        parent[loser] = iota
        pos = torch.where(m, mcount + torch.cumsum(m, 0) - 1, n_pad)
        merges[pos] = torch.stack([iota, best_j, best_c], dim=1).to(
            torch.int32)
        nmerge = int(m.sum())
        mcount += nmerge
        if nmerge == 0:
            break
    parent = parent[:n_pad]
    while True:
        jumped = parent[parent]
        if not bool((jumped != parent).any()):
            break
        parent = jumped
    return AgglomerativeResult(
        labels=parent[:n].to(torch.int32).cpu().numpy(),
        merges=merges[:mcount].cpu().numpy().astype(np.int64),
        rounds=rounds,
    )
