"""Host Smith-Waterman (Gotoh affine-gap) local alignment with traceback.

The reference delegates alignment to the external ``diamond blastp``
binary (src/graph/mod.rs:266-293). This module is the exact-DP oracle
for the framework's own aligner: :mod:`align.sw_device` scores every
pair batched on the torch device; the host traceback here recovers the
outfmt-6 fields (coordinates, length, pident) for the pairs that reach
the output. The port's own copy of the JAX package's
``align/sw_host.py``.

Scoring matches blastp defaults: BLOSUM62, gap existence 11,
gap extension 1 (a gap of length g costs 11 + g).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.utils.blosum import blosum62_matrix

GAP_OPEN = 12  # cost of a gap of length 1 (existence 11 + extension 1)
GAP_EXTEND = 1
# Karlin-Altschul parameters for gapped BLOSUM62 with 11/1 (BLAST's
# published values); bitscore = (λ·S − ln K) / ln 2.
KA_LAMBDA = 0.267
KA_K = 0.041

_NEG = np.int32(-(10**6))


@dataclass
class LocalAlignment:
    score: int
    q_start: int  # 1-based, inclusive — blastp outfmt-6 convention
    q_end: int
    s_start: int
    s_end: int
    length: int  # alignment columns (matches + mismatches + gaps)
    identities: int
    gaps: int

    @property
    def pident(self) -> float:
        return 100.0 * self.identities / self.length if self.length else 0.0

    def bitscore(self) -> float:
        return (KA_LAMBDA * self.score - np.log(KA_K)) / np.log(2.0)

    def evalue(self, m: int, n: int) -> float:
        """Pairwise Karlin-Altschul E = m·n·2^(−bitscore) (search space =
        the two sequence lengths; diamond uses database-wide effective
        lengths, so absolute values differ — documented in align/diamond
        parity notes)."""
        return float(m) * float(n) * 2.0 ** (-self.bitscore())


def sw_align_host(
    q: np.ndarray, s: np.ndarray, matrix: Optional[np.ndarray] = None
) -> LocalAlignment:
    """Optimal local alignment of residue-index arrays q, s (int, 0..20).

    Row-vectorized numpy DP: O(len(q)) python steps over [len(s)] lanes.
    Tie-breaking is fixed (diagonal > vertical > horizontal; the FIRST
    best cell in row-major order wins — np.argmax's first-occurrence
    semantics, matched by the device kernel's strict ">" update) so
    results are deterministic.
    """
    if matrix is None:
        matrix = blosum62_matrix()
    matrix = matrix.astype(np.int32)
    lq, ls = len(q), len(s)
    # H/E/F tables kept fully for traceback: [lq+1, ls+1]
    h = np.zeros((lq + 1, ls + 1), np.int32)
    e = np.full((lq + 1, ls + 1), _NEG, np.int32)  # gap in q (horizontal)
    f = np.full((lq + 1, ls + 1), _NEG, np.int32)  # gap in s (vertical)
    s_arr = np.asarray(s, np.int64)
    for i in range(1, lq + 1):
        sub = matrix[int(q[i - 1])][s_arr]  # [ls]
        f[i, 1:] = np.maximum(h[i - 1, 1:] - GAP_OPEN, f[i - 1, 1:] - GAP_EXTEND)
        diag = h[i - 1, :-1] + sub
        h_nf = np.maximum(0, np.maximum(diag, f[i, 1:]))  # no E yet
        # E row recurrence linearized: E[j] = max_{k<j}(H'[k] − open − (j−1−k))
        #                                   = cummax(H'[k] + k) − open − (j−1)
        idx = np.arange(ls)
        run = np.maximum.accumulate(h_nf + idx)
        e_row = np.full(ls, _NEG, np.int32)
        e_row[1:] = run[:-1] - GAP_OPEN - idx[1:] + 1
        e[i, 1:] = e_row
        h[i, 1:] = np.maximum(h_nf, e_row)
    # best cell: np.argmax = FIRST occurrence in row-major order (the
    # device kernel's strict-">" update keeps the same cell)
    flat = int(np.argmax(h))
    best_i, best_j = divmod(flat, ls + 1)
    score = int(h[best_i, best_j])
    if score == 0:
        return LocalAlignment(0, 0, 0, 0, 0, 0, 0, 0)

    # traceback
    i, j = best_i, best_j
    length = identities = gaps = 0
    state = "H"
    while i > 0 and j > 0 and h[i, j] > 0:
        if state == "H":
            sub = int(matrix[int(q[i - 1]), int(s[j - 1])])
            if h[i, j] == h[i - 1, j - 1] + sub:
                length += 1
                identities += int(q[i - 1] == s[j - 1])
                i -= 1
                j -= 1
                continue
            if h[i, j] == f[i, j]:
                state = "F"
                continue
            if h[i, j] == e[i, j]:
                state = "E"
                continue
            break  # h == 0 start
        if state == "F":  # vertical: consumes q
            length += 1
            gaps += 1
            opened = f[i, j] == h[i - 1, j] - GAP_OPEN
            i -= 1
            if opened:
                state = "H"
            # else stay in F (extension)
            continue
        # state == "E": horizontal, consumes s
        length += 1
        gaps += 1
        opened = e[i, j] == h[i, j - 1] - GAP_OPEN
        j -= 1
        if opened:
            state = "H"
        continue
    return LocalAlignment(
        score=score,
        q_start=i + 1,
        q_end=best_i,
        s_start=j + 1,
        s_end=best_j,
        length=length,
        identities=identities,
        gaps=gaps,
    )
