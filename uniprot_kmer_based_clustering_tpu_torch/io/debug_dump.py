"""The reference's stdout graph dump, in its exact text format.

The reference's last act is ``println!("Graph right now:\\n{graph_ref:#?}")``
(src/main.rs:235) — Rust's pretty Debug of the whole graph:

* ``Graph`` with fields ``Kmers`` (every merged edge as ``Kmer Group
  { kmer: [..ids..], size: 2 }``, src/graph/edge.rs:158-175) and
  ``Proteins`` (every vertex as ``Protein { key, size }`` where size is
  its surviving-edge degree, src/graph/vertex.rs:159-166).
* Rust ``{:#?}`` text rules: 4-space indent per level, one field/element
  per line, trailing commas, ``[]`` for empty lists.

The port's own copy of the JAX package's ``io/debug_dump.py``, with its
two documented divergences from a reference run: k-mer ids are the
dense rank hashes (boomphf's BBHash ids cannot be reproduced without
that crate), and edges are ordered by their owning slot — ascending
minimum shared rank, then (i, j) in file order (src/graph/vertex.rs:59-140,
src/graph/mod.rs:393-412). The graph at dump time holds every merged
cross-AMR pair, so the reference-equivalent dump is a ``--threshold 0``
run.
"""

from __future__ import annotations

from typing import IO

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.similarity.kmers_of_pairs import (
    shared_kmer_ranks,
)


def write_rust_debug_dump(
    out: IO[str],
    index,
    pairs: np.ndarray,
    n: int,
    bitset=None,
    header: bool = True,
) -> None:
    """Stream the dump for ``pairs`` (int [M, ≥2] rows) over ``n``
    proteins."""
    pairs = np.asarray(pairs)
    ranks = shared_kmer_ranks(index, pairs, bitset)
    # reference edge order: ascending owning slot = (min shared k-mer id,
    # then (i, j) lexicographic in the k-mer's visit order)
    if len(pairs):
        owner = np.array(
            [int(r[0]) if len(r) else -1 for r in ranks], np.int64
        )
        order = np.lexsort((pairs[:, 1], pairs[:, 0], owner))
    else:
        order = np.arange(0)
    degree = np.zeros(n, np.int64)
    if len(pairs):
        degree += np.bincount(pairs[:, 0], minlength=n)[:n]
        degree += np.bincount(pairs[:, 1], minlength=n)[:n]

    if header:
        out.write("Graph right now:\n")
    out.write("Graph {\n")
    if len(order) == 0:
        out.write("    Kmers: [],\n")
    else:
        out.write("    Kmers: [\n")
        for e in order:
            out.write("        Kmer Group {\n")
            ids = ranks[e]
            if len(ids) == 0:
                out.write("            kmer: [],\n")
            else:
                out.write("            kmer: [\n")
                for k in ids:
                    out.write(f"                {int(k)},\n")
                out.write("            ],\n")
            out.write("            size: 2,\n")
            out.write("        },\n")
        out.write("    ],\n")
    if n == 0:
        out.write("    Proteins: [],\n")
    else:
        out.write("    Proteins: [\n")
        for p in range(n):
            out.write("        Protein {\n")
            out.write(f"            key: {p},\n")
            out.write(f"            size: {int(degree[p])},\n")
            out.write("        },\n")
        out.write("    ],\n")
    out.write("}\n")


def rust_debug_dump_to_path(
    path: str, index, pairs, n: int, bitset=None
) -> str:
    with open(path, "w") as f:
        write_rust_debug_dump(f, index, pairs, n, bitset=bitset)
    return path
