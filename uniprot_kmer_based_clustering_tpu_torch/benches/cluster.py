"""Clustering-at-scale benchmark of the port.

    python -m uniprot_kmer_based_clustering_tpu_torch.benches.cluster

The port's ``bench_cluster.py``: three stages on the synthetic corpus
(``common.synth_proteins``), each timed and gated.

1. **Connected components** at ``UKC_CLUSTER_COMPONENTS_N`` (100,000; 0
   skips): the bitset packed on the device with 3,584-row padding, one
   ``sweep_mxu`` (at 30k and beyond the block-pair scan, K2 once a step;
   the line's ``kernels`` are this sweep's K1 and K2 launches),
   ``extract_pairs`` and the sampled pair oracle
   (``benches.scale.oracle_gate``); then, with the matrix freed, the host
   union-find and ``connected_components_sharded`` on a one-device mesh
   (one warm call, then the best of 2). Gate: the two label arrays are
   equal.
2. **Agglomerative** at ``UKC_CLUSTER_AGG_N`` (default
   ``UKC_CLUSTER_N``, 30,000; ``UKC_CLUSTER_AGG=0`` skips), after a
   reference gate (``UKC_CLUSTER_GOLDEN=0`` skips it): with
   ``UKC_BENCH_FASTA`` naming a file, that file's clustering must give
   ``bench_cluster.py``'s golden 123 clusters / 10,496 merges / 62
   rounds; otherwise ``synth_proteins(2000)``'s merges, labels and rounds
   must equal the independent scipy transcription
   (``common.scipy_agglomerative``). At scale the structural gate holds
   (``benches.engines.structural_gate``) and the line names the argmax
   plan of the 13 GiB budget.
3. **Tree** at ``UKC_CLUSTER_N`` (``UKC_CLUSTER_TREE=0`` skips): host
   packing, ``build_tree``, min-member labels covering every protein.

``value`` = components proteins / device label-propagation seconds.
The device is ``UKC_BENCH_DEVICE`` (``cuda``); without a card the bench
prints its failure line and exits 1. Prints ONE JSON line (metric
``cluster_scale``) and mirrors it to ``BENCH_torch_cluster_r<NN>.json``
when ``UKC_BENCH_ROUND`` is set.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.benches import common
from uniprot_kmer_based_clustering_tpu_torch.benches.common import (
    BenchFailure,
    synth_proteins,
)
from uniprot_kmer_based_clustering_tpu_torch.benches.engines import (
    structural_gate,
)
from uniprot_kmer_based_clustering_tpu_torch.benches.scale import oracle_gate

METRIC = "cluster_scale"
UNIT = "proteins/s"
ROWS = 7 * 512  # the scale benches' row padding (one 3,584-row strip)
AGG_REFERENCE_N = 2000  # the synthetic reference gate's corpus
AGG_BUDGET = 13 << 30  # agglomerative_cluster's default budget
# bench_cluster.py's gate: the bundled file's (clusters, merges, rounds)
GOLDEN_AGG = (123, 10_496, 62)


def _synth_index(n: int, kk: int = 5):
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
    )

    seq_buf, offsets, classes = synth_proteins(n)
    codes, koff = encode_kmers(seq_buf, offsets, kk)
    return build_index(codes, koff, kk), classes


def _clusters(labels) -> tuple:
    """(clusters, largest, singletons) of a label array."""
    _, counts = np.unique(labels, return_counts=True)
    return (int(counts.shape[0]), int(counts.max()),
            int((counts == 1).sum()))


def components_stage(n: int, dev) -> tuple:
    """Sweep → pair graph → both component paths, timed and gated:
    (fields, the sweep's kernel launches, the pairs, the labels)."""
    import torch

    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        pack_bitsets_device,
    )
    from uniprot_kmer_based_clustering_tpu_torch.models.components import (
        connected_components,
        connected_components_sharded,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import sweep_mxu
    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        extract_pairs,
    )
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        classes_to_torch,
    )

    thr = common.THRESHOLD
    t0 = time.perf_counter()
    idx, classes = _synth_index(n)
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    bitset = pack_bitsets_device(
        idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
        row_multiple=ROWS, device=dev,
    )
    cls = classes_to_torch(classes, bitset.n_pad, dev)
    before = common.kernel_launches()
    _, th, tl = sweep_mxu(bitset.words, cls, n, thr)
    kernels = common.launches_since(before)
    pairs = extract_pairs(bitset.words, cls, th, tl, n=n, threshold=thr)
    t_pairs = time.perf_counter() - t0
    n_checked = oracle_gate(idx, classes, pairs, n, thr)

    # free the matrix before the label propagation claims the card
    del bitset, cls
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    labels_host = connected_components(n, pairs)
    t_host = time.perf_counter() - t0

    mesh = make_mesh(1, device=dev)
    connected_components_sharded(mesh, pairs, n)  # warm
    t_dev = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        labels_dev = connected_components_sharded(mesh, pairs, n)
        t_dev = min(t_dev, time.perf_counter() - t0)
    if not np.array_equal(labels_dev, labels_host):
        raise BenchFailure("sharded component labels != host union-find")
    clusters, largest, singletons = _clusters(labels_host)
    return {
        "components_n": n,
        "components_pairs": int(len(pairs)),
        "components_host_unionfind_seconds": round(t_host, 3),
        "components_device_pmin_seconds": round(t_dev, 6),
        "components_clusters": clusters,
        "components_largest": largest,
        "components_singletons": singletons,
        "components_index_seconds": round(t_index, 3),
        "components_sweep_extract_seconds": round(t_pairs, 3),
        "components_oracle_checked": n_checked,
        "components_parity": (
            "device label propagation == host union-find (exact); pair "
            "list CPU-oracle-gated"
        ),
    }, kernels, pairs, labels_host


def agg_reference_gate(dev) -> dict:
    """The agglomerative reference: the ``UKC_BENCH_FASTA`` file against
    the golden constants, or ``synth_proteins(2000)`` against the scipy
    transcription (merges, labels and rounds)."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers import pack_bitsets
    from uniprot_kmer_based_clustering_tpu_torch.models.agglomerative import (
        agglomerative_cluster,
    )

    path = os.environ.get("UKC_BENCH_FASTA")
    if path and os.path.exists(path):
        from uniprot_kmer_based_clustering_tpu_torch.config import (
            PipelineConfig,
        )
        from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
            run_pipeline,
        )

        res = run_pipeline(path, PipelineConfig(cluster="none"),
                           stop_after="pack", device=dev)
        t0 = time.perf_counter()
        agg = agglomerative_cluster(res.bitset, res.table.n, device=dev)
        dt = time.perf_counter() - t0
        got = (_clusters(agg.labels)[0], int(agg.merges.shape[0]),
               agg.rounds)
        if got != GOLDEN_AGG:
            raise BenchFailure(f"agglomerative golden FAILED: {got} != "
                               f"{GOLDEN_AGG}")
        return {"agg_bundled_seconds": round(dt, 3),
                "agg_bundled_golden": "123 clusters / 10496 merges / 62 "
                                      "rounds"}
    n = AGG_REFERENCE_N
    idx, _ = _synth_index(n)
    bitset = pack_bitsets(idx.incidence_protein, idx.incidence_rank, n,
                          idx.n_repeated, row_multiple=512)
    t0 = time.perf_counter()
    agg = agglomerative_cluster(bitset, n, device=dev)
    dt = time.perf_counter() - t0
    labels, merges, rounds = common.scipy_agglomerative(idx, n)
    if not (np.array_equal(agg.merges, merges)
            and np.array_equal(agg.labels, labels) and agg.rounds == rounds):
        raise BenchFailure(
            f"agglomerative reference FAILED at {n}: {len(agg.merges)} "
            f"merges in {agg.rounds} rounds != the scipy transcription's "
            f"{len(merges)} in {rounds}")
    return {
        "agg_reference_seconds": round(dt, 3),
        "agg_reference_gate": (
            f"synth_proteins({n}): merges, labels and rounds == the scipy "
            f"transcription ({len(merges)} merges, {rounds} rounds)"),
    }


def agg_mode(n_pad: int, w: int) -> str:
    """The argmax plan of the 13 GiB budget, as ``bench_cluster.py``
    reports it."""
    from uniprot_kmer_based_clustering_tpu_torch.models.agglomerative import (
        _argmax_plan,
    )

    plan = _argmax_plan(n_pad, w, AGG_BUDGET)
    if plan is None:
        return "one-shot matmul"
    return f"strip argmax (strip={plan[0]}, word_chunk={plan[1]})"


def agglomerative_stage(n: int, dev, reference: bool = True) -> tuple:
    """The reference gate (unless ``reference`` is false), then the
    rounds at ``n``: (fields, result)."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers import pack_bitsets
    from uniprot_kmer_based_clustering_tpu_torch.models.agglomerative import (
        agglomerative_cluster,
    )

    gate = agg_reference_gate(dev) if reference else {}
    idx, _ = _synth_index(n)
    # the rounds take host words (agglomerative_cluster uploads them)
    bitset = pack_bitsets(idx.incidence_protein, idx.incidence_rank, n,
                          idx.n_repeated, row_multiple=ROWS)
    t0 = time.perf_counter()
    agg = agglomerative_cluster(bitset, n, hbm_budget_bytes=AGG_BUDGET,
                                device=dev)
    dt = time.perf_counter() - t0
    why = structural_gate(agg, n)
    if why is not None:
        raise BenchFailure(f"agglomerative structural gate FAILED: {why}")
    clusters, largest, _ = _clusters(agg.labels)
    return {
        **gate,
        "agg_n": n,
        "agg_repeated_kmers": idx.n_repeated,
        "agg_seconds": round(dt, 3),
        "agg_rounds": agg.rounds,
        "agg_merges": int(agg.merges.shape[0]),
        "agg_clusters": clusters,
        "agg_largest": largest,
        "agg_mode": agg_mode(bitset.n_pad, bitset.w_pad),
        "agg_gates": (
            ("reference exact + " if gate else "")
            + "structural (losers unique, labels == union-find closure "
            "of merges)"
        ),
    }, agg


def tree_gate(labels) -> None:
    """Every protein labelled, each label its cluster's minimum member."""
    if not (labels >= 0).all():
        raise BenchFailure("tree gate FAILED: a protein has no label")
    for lbl in np.unique(labels):
        if np.nonzero(labels == lbl)[0].min() != lbl:
            raise BenchFailure(f"tree gate FAILED: label {lbl} is not its "
                               f"cluster's minimum member")


def tree_stage(n: int) -> tuple:
    """``build_tree`` at ``n``, gated: (fields, labels)."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers import pack_bitsets
    from uniprot_kmer_based_clustering_tpu_torch.models.tree import (
        build_tree,
    )

    idx, _ = _synth_index(n)
    # the tree's rows are host numpy (uint64 views): pack on the host
    bitset = pack_bitsets(idx.incidence_protein, idx.incidence_rank, n,
                          idx.n_repeated, row_multiple=8)
    t0 = time.perf_counter()
    tree = build_tree(bitset, n)
    dt = time.perf_counter() - t0
    labels = tree.labels(n)
    tree_gate(labels)
    clusters, largest, _ = _clusters(labels)
    return {
        "tree_n": n,
        "tree_seconds": round(dt, 3),
        "tree_clusters": clusters,
        "tree_largest": largest,
        "tree_depth": tree.depth(),
        "tree_root_children": len(tree.root.children),
        "tree_gates": "min-member canonical labels; full coverage",
    }, labels


def measure() -> dict:
    dev = common.bench_device()
    n_comp = int(os.environ.get("UKC_CLUSTER_COMPONENTS_N", "100000"))
    n_tree = int(os.environ.get("UKC_CLUSTER_N", "30000"))
    n_agg = int(os.environ.get("UKC_CLUSTER_AGG_N", n_tree))
    rec = {"metric": METRIC, "unit": UNIT}
    kernels = {k: 0 for k in common.kernel_launches()}
    if n_comp:
        fields, kernels, _, _ = components_stage(n_comp, dev)
        rec.update(fields)
    if os.environ.get("UKC_CLUSTER_AGG", "1") != "0":
        golden = os.environ.get("UKC_CLUSTER_GOLDEN", "1") != "0"
        rec.update(agglomerative_stage(n_agg, dev, golden)[0])
    if os.environ.get("UKC_CLUSTER_TREE", "1") != "0":
        rec.update(tree_stage(n_tree)[0])
    # the headline: proteins clustered per second by the production mode
    # (components at the largest N) through the device path
    rec["value"] = (round(n_comp / rec["components_device_pmin_seconds"], 1)
                    if n_comp else 0.0)
    rec.update(kernels=kernels, **common.device_fields(dev))
    from uniprot_kmer_based_clustering_tpu_torch.utils.artifact import (
        write_bench_artifact,
    )

    write_bench_artifact("torch_cluster", rec)
    return rec


def main() -> int:
    return common.run_bench(METRIC, UNIT, measure)


if __name__ == "__main__":
    sys.exit(main())
