"""Batched Smith-Waterman scoring on a torch device (Gotoh affine gaps,
BLOSUM62).

The reference shells out to diamond per pair (src/graph/mod.rs:266-293).
Here a whole pair batch aligns at once, as in the JAX package's
``align/sw_device.py``:

  * pairs are padded into [B, Lq] / [B, Ls] residue-index matrices;
  * a Python loop walks the query rows; each row is a few int32 tensor
    operations over [B, Ls] lanes (gathers, adds, maxes, selects);
  * the horizontal-gap recurrence E[j] = max(E[j-1]−1, H'[j-1]−open),
    sequential along the row, is linearised to one ``torch.cummax``:
    E[j] = cummax(H'[k] + k) − open − (j−1), so the row stays
    data-parallel;
  * the scan returns each pair's best score and END coordinates. START
    coordinates come from a second pass over the reversed sequences (the
    reverse alignment's end is the forward alignment's start), so no
    [Lq, Ls] matrix is ever built: device memory per pair is O(Ls).

Ties follow the JAX scan exactly: a row's best column is the first
maximum (``torch.argmax``'s documented rule, as ``jnp.argmax``), and a
later row replaces the best cell only when strictly greater.
"""

from __future__ import annotations

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.align.sw_host import (
    GAP_EXTEND,
    GAP_OPEN,
)
from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.utils.blosum import blosum62_matrix

_NEG = -(10**6)


def _sw_scan(q_idx, q_len, s_idx, s_len, matrix):
    """(scores, q_end, s_end), each int32 [B] on the inputs' device;
    ends 1-based. ``q_idx`` [B, Lq] and ``s_idx`` [B, Ls] are int64
    residue indices, ``q_len``/``s_len`` int32 [B], ``matrix`` int32
    [21, 21]. Queues its work and reads nothing back."""
    b, lq = q_idx.shape
    ls = s_idx.shape[1]
    dev = q_idx.device
    jcol = torch.arange(ls, dtype=torch.int32, device=dev)
    s_valid = jcol[None, :] < s_len[:, None]
    # open + max(j − 1, 0): the E term's offset for column j
    e_off = GAP_OPEN + torch.clamp(jcol - 1, min=0)
    zero_col = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    neg_col = torch.full((b, 1), _NEG, dtype=torch.int32, device=dev)
    h = torch.zeros((b, ls), dtype=torch.int32, device=dev)
    f = torch.full((b, ls), _NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(b, dtype=torch.int32, device=dev)
    best_i = torch.zeros_like(best)
    best_j = torch.zeros_like(best)
    for i in range(lq):
        valid = s_valid & (q_len > i)[:, None]
        sub = torch.where(valid, matrix[q_idx[:, i : i + 1], s_idx], _NEG)
        f_cur = torch.maximum(h - GAP_OPEN, f - GAP_EXTEND)
        diag = torch.cat([zero_col, h[:, :-1]], dim=1) + sub
        h_nf = torch.clamp(torch.maximum(diag, f_cur), min=0)
        run = torch.cummax(h_nf + jcol, dim=1).values
        e = torch.cat([neg_col, run[:, :-1]], dim=1) - e_off
        # zero the padding so F/E never propagate out of the valid
        # [q_len, s_len] region
        h = torch.where(valid, torch.maximum(h_nf, e), 0)
        f = torch.where(valid, f_cur, _NEG)
        row_best = h.amax(dim=1)
        row_arg = torch.argmax(h, dim=1).to(torch.int32)
        better = row_best > best
        best = torch.where(better, row_best, best)
        best_i = torch.where(better, i + 1, best_i)
        best_j = torch.where(better, row_arg + 1, best_j)
    return best, best_i, best_j


def _inputs(q_idx, q_len, s_idx, s_len, device):
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    return (up(q_idx, torch.int64), up(q_len, torch.int32),
            up(s_idx, torch.int64), up(s_len, torch.int32))


def _matrix(device):
    return torch.from_numpy(blosum62_matrix().astype(np.int32)).to(device)


def sw_scores_device(q_idx, q_len, s_idx, s_len, device="cuda"):
    """Batched local-alignment scores and 1-based end coordinates, as
    int32 numpy arrays (score, q_end, s_end).

    ``q_idx`` [B, Lq] / ``s_idx`` [B, Ls]: residue indices (0..20),
    padded arbitrarily past ``q_len``/``s_len`` (padding is masked).
    """
    device = resolve_device(device)
    out = _sw_scan(*_inputs(q_idx, q_len, s_idx, s_len, device),
                   _matrix(device))
    return tuple(torch.stack(out).cpu().numpy())


def _reverse_rows(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    out = np.zeros_like(mat)
    for r in range(mat.shape[0]):
        L = int(lens[r])
        out[r, :L] = mat[r, :L][::-1]
    return out


def sw_ends_and_starts_device(q_idx, q_len, s_idx, s_len, device="cuda"):
    """(score, q_start, q_end, s_start, s_end), all [B], 1-based.

    Two passes: the forward one gives the ends; the same scan over the
    reversed sequences gives the starts (start = len + 1 − reverse end).
    With several co-optimal alignments the two passes may bound
    different ones (the scores still agree, asserted); the output
    fields therefore come from the host traceback, which is consistent
    by construction. Both passes are queued before the six arrays come
    back in one copy.
    """
    device = resolve_device(device)
    q_idx = np.asarray(q_idx)
    s_idx = np.asarray(s_idx)
    q_len = np.asarray(q_len, np.int64)
    s_len = np.asarray(s_len, np.int64)
    matrix = _matrix(device)
    fwd = _sw_scan(*_inputs(q_idx, q_len, s_idx, s_len, device), matrix)
    bwd = _sw_scan(
        *_inputs(_reverse_rows(q_idx, q_len), q_len,
                 _reverse_rows(s_idx, s_len), s_len, device),
        matrix,
    )
    score, q_end, s_end, score_r, q_end_r, s_end_r = (
        torch.stack(fwd + bwd).cpu().numpy()
    )
    assert (score_r == score).all(), "forward/reverse score mismatch"
    q_start = q_len + 1 - q_end_r.astype(np.int64)
    s_start = s_len + 1 - s_end_r.astype(np.int64)
    return score, q_start, q_end, s_start, s_end
