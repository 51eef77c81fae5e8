"""Recover the shared k-mer lists of surviving pairs.

The reference's merged edge (``KmerEdgeGroup``, src/graph/edge.rs:87-112)
carries the concatenated k-mer ids shared by its protein pair; the Debug
dump prints them decoded (src/graph/edge.rs:158-175 via
``five_mer_back_to_amino_acid``). The sweep only needs the counts, so the
ids are recovered here on the host, for the pairs being written.

The port's own copy of the JAX package's ``similarity/kmers_of_pairs.py``.
A device-built index carries no incidence lists; its bitset words are
fetched to host uint32 by the pipeline, so that branch runs on numpy too.
"""

from __future__ import annotations

from typing import List

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import decode_kmer
from uniprot_kmer_based_clustering_tpu_torch.kmers.index import KmerIndex


def shared_kmer_ranks(
    index: KmerIndex, pairs: np.ndarray, bitset=None
) -> List[np.ndarray]:
    """For each (i, j, …) pair row, the sorted rank-hash ids shared by
    proteins i and j.

    With a device-built index (no host incidence lists) pass the
    BitsetMatrix; ranks are recovered by unpacking the two rows.
    """
    if not index.has_incidences:
        if bitset is None:
            raise ValueError(
                "device-built index has no incidence lists; pass the bitset"
            )
        out = []
        for row in np.asarray(pairs):
            i, j = int(row[0]), int(row[1])
            both = np.unpackbits(
                (bitset.words[i] & bitset.words[j]).view(np.uint8),
                bitorder="little",
            )
            out.append(np.nonzero(both[: index.n_repeated])[0])
        return out

    # incidences are sorted by (protein, rank), the KmerIndex layout
    ip = index.incidence_protein
    ir = index.incidence_rank
    pr = np.asarray(pairs)
    # the CSR covers every queried protein, not just the last one with
    # incidences (a trailing protein with no repeated k-mers would
    # otherwise read past the searchsorted array)
    n = int(ip[-1]) + 1 if len(ip) else 0
    if pr.size:
        n = max(n, int(pr[:, :2].max()) + 1)
    starts = np.searchsorted(ip, np.arange(n + 1))

    def ranks_of(p: int) -> np.ndarray:
        return ir[starts[p] : starts[p + 1]]

    out = []
    for row in pr:
        i, j = int(row[0]), int(row[1])
        out.append(np.intersect1d(ranks_of(i), ranks_of(j)))
    return out


def shared_kmer_strings(
    index: KmerIndex, pairs: np.ndarray, bitset=None
) -> List[List[str]]:
    """Decoded amino-acid strings of each pair's shared k-mers (the
    reference's Debug-dump representation)."""
    out = []
    for ranks in shared_kmer_ranks(index, pairs, bitset):
        codes = index.repeated_codes[ranks]
        out.append([decode_kmer(int(c), index.k) for c in codes])
    return out


def protein_kmer_strings(
    index: KmerIndex, bitset, rows=None
) -> List[List[str]]:
    """Decoded repeated-k-mer strings per protein — the reference's
    protein Debug representation (src/protein.rs:65-74 prints each
    protein's k-mers via ``five_mer_back_to_amino_acid``; after the
    re-hash those are exactly the repeated k-mers). Reads the packed
    rows, so a packless run's ``VirtualBitsetMatrix`` raises."""
    if rows is None:
        rows = range(bitset.n)
    out = []
    for i in rows:
        ranks = np.nonzero(bitset.row_bits(int(i)))[0]
        codes = index.repeated_codes[ranks]
        out.append([decode_kmer(int(c), index.k) for c in codes])
    return out
