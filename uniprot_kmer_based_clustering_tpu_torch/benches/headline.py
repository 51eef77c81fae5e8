"""Headline benchmark of the port: pairwise-similarity pairs/s on one card.

    python -m uniprot_kmer_based_clustering_tpu_torch.benches.headline
    python -m uniprot_kmer_based_clustering_tpu_torch.cli bench [fasta]

The port's ``bench.py``, step for step: pack the corpus with 512-row
padding, run one sweep (``ops.bitmul.sweep_mxu``) and gate it, time the
best of ``UKC_BENCH_REPS`` (5) synchronous sweeps, then twice dispatch
``reps`` sweeps back to back (``sweep_mxu_async``) and finalize once
(the steady state; the re-run must equal the gated statistics), then the
scipy CPU baseline and the C++ host engine's rate.

Corpus and gate: ``UKC_BENCH_FASTA`` when that file exists, gated on
``bench.py``'s golden counters of the bundled dataset; otherwise
``synth_proteins(UKC_BENCH_N, seed=0)`` (10,619 proteins by default),
gated on the scipy oracle's counters from the same run. The device is
``UKC_BENCH_DEVICE`` (``cuda``); without a card the bench prints its
failure line and exits 1.

Prints ONE JSON line: ``{"metric": "pairwise_similarity", "value":
<pairs/s>, "unit": "pairs/s/chip", "vs_baseline": ..., ...}`` with
bench.py's keys plus ``dataset``, ``counters``, ``power_limit_w`` and
``kernels`` (the K1 and K2 launches of one warm sweep).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.benches import common

METRIC = "pairwise_similarity"
UNIT = "pairs/s/chip"
N_DEFAULT = 10_619
# bench.py's gate: the bundled uniprot_arg.fasta's counters (BASELINE.md)
GOLDEN = {
    "edges_after_amr_filter": 5_300_233,
    "pairs_after_merge": 4_350_628,
    "pairs_over_threshold": 465,
    "max_shared_kmers": 567,
}


def _baseline_fields(value: float, baseline_s, n_pairs: float) -> dict:
    if baseline_s is None:
        return {"vs_baseline": 0.0, "baseline_unavailable": "scipy missing"}
    baseline = n_pairs / baseline_s
    return {
        "vs_baseline": round(value / baseline, 2),
        "cpu_baseline_pairs_per_s": round(baseline, 1),
        "cpu_baseline_seconds": round(baseline_s, 4),
    }


def _native_rate(idx, classes, n: int, n_pairs: float):
    """The C++ host engine's pairs/s (best of 2), or None where the
    runtime is not built; reported beside the baseline, never as it."""
    from uniprot_kmer_based_clustering_tpu_torch.io import native

    if not native.available():
        return None
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out = native.sparse_sweep(
            idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
            classes, common.THRESHOLD,
        )
        if out is None:
            return None
        best = min(best, time.perf_counter() - t0)
    return round(n_pairs / best, 1)


def measure() -> dict:
    dev = common.bench_device()
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import (
        sweep_mxu,
        sweep_mxu_async,
    )
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    corpus = common.load_corpus(N_DEFAULT)
    n, thr = corpus.n, common.THRESHOLD
    codes, koff = encode_kmers(corpus.seq_buf, corpus.offsets, 5)
    idx = build_index(codes, koff, 5)
    bitset = pack_bitsets(idx.incidence_protein, idx.incidence_rank, n,
                          idx.n_repeated, row_multiple=512)
    words = bitset_to_torch(bitset, dev)
    classes = classes_to_torch(corpus.classes, bitset.n_pad, dev)
    n_pairs = n * (n - 1) / 2.0

    if corpus.fasta is not None:
        want, parity = GOLDEN, "golden-exact"
    else:
        want, _ = common.index_oracle(idx, corpus.classes, n, thr)
        parity = "oracle-exact"

    # warm-up and quality gate: a fast wrong sweep scores zero
    row_stats = sweep_mxu(words, classes, n, thr)[0]
    got = common.counters_of(row_stats)
    if got != want:
        raise common.BenchFailure(
            f"parity FAILED: {got} != {parity.split('-')[0]} {want}")

    # one synchronous sweep's latency, best of reps; the first one's
    # kernel launches are the line's `kernels`
    reps = int(os.environ.get("UKC_BENCH_REPS", "5"))
    times, kernels = [], None
    for _ in range(reps):
        before = common.kernel_launches()
        t0 = time.perf_counter()
        sweep_mxu(words, classes, n, thr)
        times.append(time.perf_counter() - t0)
        if kernels is None:
            kernels = common.launches_since(before)
    latency = min(times)

    # steady state: reps sweeps dispatched back to back, fetched once;
    # best of two loops, each re-checked against the gated statistics
    steady = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(reps):
            handles, finalize = sweep_mxu_async(words, classes, n, thr)
        rs2 = finalize(handles)[0]
        steady = min(steady, (time.perf_counter() - t0) / reps)
        if not np.array_equal(rs2, row_stats):
            raise common.BenchFailure(
                "steady-state rerun diverged from the gated run")
    value = n_pairs / steady

    baseline_s = common.cpu_baseline(idx, corpus.classes, n)
    native_rate = _native_rate(idx, corpus.classes, n, n_pairs)
    return {
        "metric": METRIC,
        "value": round(value, 1),
        "unit": UNIT,
        **_baseline_fields(value, baseline_s, n_pairs),
        "sweep_seconds": round(steady, 6),
        "sync_latency_seconds": round(latency, 6),
        "cpu_native_engine_pairs_per_s": native_rate,
        "parity": parity,
        "counters": got,
        "dataset": corpus.label,
        "n_proteins": n,
        "kernels": kernels,
        **common.device_fields(dev),
    }


def main() -> int:
    return common.run_bench(METRIC, UNIT, measure)


if __name__ == "__main__":
    sys.exit(main())
