"""All-engine gate of the port in ONE recorded pass.

    python -m uniprot_kmer_based_clustering_tpu_torch.benches.engines

The port's ``bench_engines.py``: every sweep engine (MXU two-pass and
fused, popcount, xla, the stream engine's four modes, the C++ host
engine), the out-of-core sweep on a one-device mesh, K1 against the
plain epilogue, the k=7 and BLOSUM62-weighted configurations, grouped
out-of-core extraction and agglomerative clustering, each timed and
gated on the same corpus. Engines must agree exactly: pair list equal to
pair list, not just counters.

Corpus and gates: ``UKC_BENCH_FASTA`` when that file exists (the bundled
``uniprot_arg.fasta`` is gated on ``bench_engines.py``'s golden
constants), else ``synth_proteins(UKC_BENCH_N, seed=0)`` (10,619 by
default), gated on references computed in the run: the scipy oracle's
counters and pair list (``B·diag(w)·Bᵀ`` for the weighted row, the k=7
index for the k=7 row) and, for agglomerative clustering,
``bench_cluster.py``'s structural gate. Every engine's pairs must equal
the reference pair list.

``UKC_ENGINES_ON_CPU=1`` runs on the CPU (the kernels' plain versions)
and, as the JAX script does there, skips the K1 row and the k=7,
weighted, grouped and agglomerative rows; a skipped row leaves the
denominator. Otherwise the device is ``UKC_BENCH_DEVICE`` (``cuda``).

Prints ONE JSON line ``{"metric": "engine_parity", "value": <#rows
exact>, "unit": "engines", "vs_baseline": <value/total>,
"engines_total": ..., "engines": {name: {"cold_s", "warm_s",
"parity"}}, ...}`` and, from a run on the card, mirrors it to
``BENCH_torch_engines_r<NN>.json`` when ``UKC_BENCH_ROUND`` is set.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

import numpy as np

from uniprot_kmer_based_clustering_tpu_torch.benches import common

METRIC = "engine_parity"
UNIT = "engines"
N_DEFAULT = 10_619
# bench_engines.py's golden constants of the bundled uniprot_arg.fasta
GOLDEN = {
    "edges_after_amr_filter": 5_300_233,
    "pairs_after_merge": 4_350_628,
    "pairs_over_threshold": 465,
    "max_shared_kmers": 567,
}
GOLDEN_K7 = {
    "edges_after_amr_filter": 99_250,
    "pairs_after_merge": 22_732,
    "pairs_over_threshold": 463,
    "max_shared_kmers": 565,
}
GOLDEN_WEIGHTED = {
    "edges_after_amr_filter": 124_363_524,
    "pairs_after_merge": 4_350_628,
    "pairs_over_threshold": 465,
    "max_shared_kmers": 14_781,
}
GOLDEN_CLUSTERS = 123

# (name, config overrides), bench_engines.py's list
ENGINES = [
    ("mxu_two_pass", dict(engine="mxu", extract="two_pass")),
    ("mxu_fused", dict(engine="mxu", extract="fused")),
    ("popcount_pallas", dict(engine="popcount")),
    ("xla", dict(engine="xla")),
    ("stream_two_pass", dict(engine="stream", extract="two_pass")),
    ("stream_fused", dict(engine="stream", extract="fused")),
    ("stream_onepass", dict(engine="stream", extract="onepass")),
    ("stream_onepass_csr", dict(
        engine="stream", extract="onepass", stream_source="csr",
    )),
    ("native_cpp", dict(engine="native")),
]
EXTRA_GATES = ("mxu_7mer", "mxu_weighted", "stream_grouped_extract",
               "agglomerative")


@dataclasses.dataclass
class Run:
    """The inputs every row shares: the corpus, its k=5 host index and
    packed bitset, and the reference it is gated on (golden constants of
    the bundled file, or the oracle's counters; the oracle's pair
    list)."""

    dev: object
    corpus: common.Corpus
    idx: object
    bitset: object
    golden: bool
    want: dict
    ref_pairs: np.ndarray

    @property
    def n(self) -> int:
        return self.corpus.n

    @property
    def classes(self) -> np.ndarray:
        return self.corpus.classes

    def padded_classes(self) -> np.ndarray:
        cls = np.full(self.bitset.n_pad, -1, np.int32)
        cls[: self.n] = self.classes
        return cls

    @property
    def exact(self) -> str:
        return "golden-exact" if self.golden else "oracle-exact"


def prepare(dev, corpus: common.Corpus) -> Run:
    """Index, pack and gate reference of ``corpus`` for a run on
    ``dev``."""
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )

    codes, koff = encode_kmers(corpus.seq_buf, corpus.offsets, 5)
    idx = build_index(codes, koff, 5)
    bitset = pack_bitsets(idx.incidence_protein, idx.incidence_rank,
                          corpus.n, idx.n_repeated, row_multiple=512)
    golden = bool(corpus.fasta) and os.path.realpath(
        corpus.fasta).endswith("uniprot_arg.fasta")
    counters, pairs = common.index_oracle(idx, corpus.classes, corpus.n)
    return Run(dev, corpus, idx, bitset, golden,
               GOLDEN if golden else counters, pairs)


def _timed(fn):
    """One cold call and the best of two warm ones: (first result, last
    result, record)."""
    t0 = time.perf_counter()
    res = fn()
    rec = {"cold_s": round(time.perf_counter() - t0, 4)}
    warm = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        res2 = fn()
        warm = min(warm, time.perf_counter() - t0)
    rec["warm_s"] = round(warm, 4)
    return res, res2, rec


def _gate(run: Run, rec: dict, res, res2) -> bool:
    """An engine row's gate: counters equal the reference, pairs equal
    the reference pair list, the warm re-run equal to the first."""
    got = res.parity_counters()
    ok = got == run.want and np.array_equal(res.pairs, res2.pairs)
    pairs_eq = np.array_equal(res.pairs, run.ref_pairs)
    rec["parity"] = (
        run.exact if (ok and pairs_eq)
        else f"MISMATCH: counters={got} pairs_eq={pairs_eq}"
    )
    return ok and pairs_eq


def _trace(trace: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in dict(trace or {}).items()}


def engine_row(run: Run, name: str, over: dict):
    """One entry of ENGINES through ``pairwise_similarity``: (rec, ok)."""
    from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.ops import (
        stream as stream_mod,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        pairwise_similarity,
    )

    config = PipelineConfig(**over)
    res, res2, rec = _timed(lambda: pairwise_similarity(
        run.bitset, run.classes, config, index=run.idx, device=run.dev))
    if name.startswith("stream"):
        # the phase breakdown of the last warm pass
        rec["sweep_trace"] = _trace(
            stream_mod.last_onepass_trace if "onepass" in name
            else stream_mod.last_trace)
        if name == "stream_two_pass":
            rec["extract_trace"] = _trace(stream_mod.last_extract_trace)
    return rec, _gate(run, rec, res, res2)


def stream_mesh_row(run: Run):
    """The out-of-core sweep on a one-device flat mesh (the card the run
    holds): (rec, ok)."""
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        CSRBlockSource,
    )
    from uniprot_kmer_based_clustering_tpu_torch.parallel import make_mesh
    from uniprot_kmer_based_clustering_tpu_torch.parallel.stream_mesh import (
        sweep_extract_stream_mesh,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        PairwiseResult,
    )

    mesh1 = make_mesh(devices=[run.dev])

    def _run_mesh():
        src = CSRBlockSource(
            run.idx.incidence_protein, run.idx.incidence_rank,
            run.bitset.n_pad, run.bitset.w_pad,
        )
        rs, _th, _tl, pr = sweep_extract_stream_mesh(
            mesh1, run.classes, run.n, common.THRESHOLD, block_source=src,
        )
        return PairwiseResult.from_row_stats(rs, pr, cross_amr_only=True)

    res, res2, rec = _timed(_run_mesh)
    return rec, _gate(run, rec, res, res2)


def stats_rows(run: Run):
    """K1 (``stats_engine="pallas"``) against the plain epilogue
    (``"xla"``) over one whole ``sweep_mxu``: identical row statistics
    and tile hits, and on the card K1 launched by the first and not by
    the second.
    Returns ({"stats_pallas": rec, "stats_xla": rec}, ok)."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import stats
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import sweep_mxu
    from uniprot_kmer_based_clustering_tpu_torch.state import (
        bitset_to_torch,
        classes_to_torch,
    )

    words = bitset_to_torch(run.bitset, run.dev)
    classes = classes_to_torch(run.classes, run.bitset.n_pad, run.dev)
    out, recs = {}, {}
    for eng in ("pallas", "xla"):
        before = stats.stats_from_counts_into.launches
        t0 = time.perf_counter()
        rs, th, _ = sweep_mxu(words, classes, run.n, common.THRESHOLD,
                              stats_engine=eng)
        recs[f"stats_{eng}"] = {
            "cold_s": round(time.perf_counter() - t0, 4),
            "k1_launches": stats.stats_from_counts_into.launches - before,
        }
        out[eng] = (rs, th)
    same = all(np.array_equal(a, b)
               for a, b in zip(out["pallas"], out["xla"]))
    # on a CPU tensor both are plain versions and nothing launches
    k1 = run.dev.type != "cuda" or (
        recs["stats_pallas"]["k1_launches"] > 0
        and recs["stats_xla"]["k1_launches"] == 0)
    for rec in recs.values():
        rec["parity"] = ("identical" if same and k1
                         else f"MISMATCH: equal={same} k1_ran={k1}")
    return recs, same and k1


def k7_row(run: Run):
    """The 7-mer configuration on the MXU engine against GOLDEN_K7 (the
    bundled file) or the scipy oracle over the k=7 index: (rec, ok)."""
    from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        pairwise_similarity,
    )

    c = run.corpus
    t0 = time.perf_counter()
    codes7, koff7 = encode_kmers(c.seq_buf, c.offsets, 7)
    idx7 = build_index(codes7, koff7, 7)
    bitset7 = pack_bitsets(idx7.incidence_protein, idx7.incidence_rank,
                           run.n, idx7.n_repeated, row_multiple=512)
    res7 = pairwise_similarity(bitset7, run.classes,
                               PipelineConfig(k=7, engine="mxu"),
                               index=idx7, device=run.dev)
    rec = {"cold_s": round(time.perf_counter() - t0, 4)}
    got = res7.parity_counters()
    if run.golden:
        want, pairs_ok = GOLDEN_K7, (
            res7.pairs.shape[0] == GOLDEN_K7["pairs_over_threshold"])
    else:
        want, ref = common.index_oracle(idx7, run.classes, run.n)
        pairs_ok = np.array_equal(res7.pairs, ref)
    ok = got == want and pairs_ok
    rec["parity"] = run.exact if ok else (
        f"MISMATCH: {got} pairs_ok={pairs_ok}")
    return rec, ok


def weighted_row(run: Run):
    """The BLOSUM62-weighted configuration against GOLDEN_WEIGHTED (the
    bundled file) or the scipy oracle of ``B·diag(w)·Bᵀ`` at the weighted
    threshold: (rec, ok)."""
    from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
        pairwise_similarity,
    )
    from uniprot_kmer_based_clustering_tpu_torch.utils.blosum import (
        rank_weights_int8,
    )

    config = PipelineConfig(weighting="blosum62")
    t0 = time.perf_counter()
    wts = rank_weights_int8(run.idx.repeated_codes, 5,
                            run.bitset.w_pad * 32)
    resw = pairwise_similarity(run.bitset, run.classes, config,
                               weights=wts, index=run.idx, device=run.dev)
    rec = {"cold_s": round(time.perf_counter() - t0, 4)}
    got = resw.parity_counters()
    if run.golden:
        want, pairs_ok = GOLDEN_WEIGHTED, (
            resw.pairs.shape[0] == GOLDEN_WEIGHTED["pairs_over_threshold"])
    else:
        want, ref = common.index_oracle(
            run.idx, run.classes, run.n,
            threshold=config.effective_weighted_threshold(wts),
            weights=wts[: run.idx.n_repeated])
        pairs_ok = np.array_equal(resw.pairs, ref)
    ok = got == want and pairs_ok
    rec["parity"] = run.exact if ok else (
        f"MISMATCH: {got} pairs_ok={pairs_ok}")
    return rec, ok


def grouped_row(run: Run):
    """Grouped out-of-core extraction (``extract_pairs_stream_grouped``)
    forced multi-group (bs 1,024 under a 1 GiB budget) after a stream
    sweep at the same bs: its pairs equal the reference list. (rec,
    ok)."""
    from uniprot_kmer_based_clustering_tpu_torch.ops import (
        stream as stream_mod,
    )
    from uniprot_kmer_based_clustering_tpu_torch.ops.stream import (
        extract_pairs_stream_grouped,
        sweep_mxu_stream,
    )

    cls_pad = run.padded_classes()
    _, th_g, tl_g = sweep_mxu_stream(
        run.bitset.words, cls_pad, n=run.n, threshold=common.THRESHOLD,
        bs=1024, block=512, device=run.dev,
    )
    t0 = time.perf_counter()
    pairs_g = extract_pairs_stream_grouped(
        run.bitset.words, cls_pad, th_g, tl_g, n=run.n,
        threshold=common.THRESHOLD, bs=1024, hbm_budget_bytes=1 << 30,
        device=run.dev,
    )
    rec = {"cold_s": round(time.perf_counter() - t0, 4),
           "trace": _trace(stream_mod.last_grouped_trace)}
    ok = np.array_equal(pairs_g, run.ref_pairs)
    rec["parity"] = run.exact if ok else "MISMATCH vs reference pairs"
    return rec, ok


def structural_gate(agg, n: int) -> Optional[str]:
    """``bench_cluster.py``'s invariants of any correct merge sequence:
    every winner is below its loser, the losers are unique, and the
    labels are the union-find closure of the merge list with min-member
    representatives. Returns None, or what failed."""
    m = np.asarray(agg.merges)
    if not (m[:, 0] < m[:, 1]).all():
        return "a winner is not below its loser"
    losers = m[:, 1]
    if np.unique(losers).shape[0] != losers.shape[0]:
        return "a loser merged twice"
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for w, lo, _c in m:
        parent[find(int(lo))] = find(int(w))
    roots = {}
    for i in range(n):
        roots.setdefault(find(i), i)
    expect = np.array([roots[find(i)] for i in range(n)], np.int32)
    if not np.array_equal(agg.labels, expect):
        return "labels != the union-find of the merges"
    return None


def agglomerative_row(run: Run):
    """``agglomerative_cluster``: 123 clusters and N − clusters merges on
    the bundled file, else the structural gate. (rec, ok)."""
    from uniprot_kmer_based_clustering_tpu_torch.models.agglomerative import (
        agglomerative_cluster,
    )

    t0 = time.perf_counter()
    agg = agglomerative_cluster(run.bitset, run.n, device=run.dev)
    rec = {"cold_s": round(time.perf_counter() - t0, 4)}
    n_clusters = int(len(np.unique(agg.labels)))
    n_merges = int(agg.merges.shape[0])
    rec.update(clusters=n_clusters, dendrogram_rows=n_merges,
               rounds=int(agg.rounds))
    why = None
    if n_merges != run.n - n_clusters:
        why = "merges != N - clusters"
    elif run.golden and n_clusters != GOLDEN_CLUSTERS:
        why = f"clusters {n_clusters} != {GOLDEN_CLUSTERS}"
    elif not run.golden:
        why = structural_gate(agg, run.n)
    rec["parity"] = (
        ("golden-exact" if run.golden else "structural-exact")
        if why is None
        else f"MISMATCH: clusters={n_clusters} merges={n_merges}: {why}"
    )
    return rec, why is None


EXTRA_ROWS = dict(zip(EXTRA_GATES, (k7_row, weighted_row, grouped_row,
                                    agglomerative_row)))


def _error(e: Exception) -> dict:
    return {"parity": f"ERROR: {type(e).__name__}: {e}"}


def measure(on_cpu: bool) -> dict:
    from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
    from uniprot_kmer_based_clustering_tpu_torch.io import native

    dev = resolve_device("cpu") if on_cpu else common.bench_device()
    run = prepare(dev, common.load_corpus(N_DEFAULT))
    engines = {}
    exact = 0
    skipped = 0  # rows not run: out of the denominator
    # a broken engine must not hide the other rows' evidence, so each
    # row's exception becomes its record
    for name, over in ENGINES:
        if name == "native_cpp" and not native.available():
            engines[name] = {"parity": "skipped (native lib not built)"}
            skipped += 1
            continue
        try:
            engines[name], ok = engine_row(run, name, over)
        except Exception as e:  # noqa: BLE001
            engines[name], ok = _error(e), False
        exact += int(ok)

    try:
        engines["stream_mesh_d1"], ok = stream_mesh_row(run)
    except Exception as e:  # noqa: BLE001
        engines["stream_mesh_d1"], ok = _error(e), False
    exact += int(ok)

    if on_cpu:
        engines["stats_pallas_vs_xla"] = {
            "parity": "skipped (hardware-only check)"}
        skipped += 1
    else:
        try:
            recs, ok = stats_rows(run)
            engines.update(recs)
        except Exception as e:  # noqa: BLE001
            engines["stats_pallas_vs_xla"], ok = _error(e), False
        exact += int(ok)

    for name, row in EXTRA_ROWS.items():
        if on_cpu:
            engines[name] = {"parity": "skipped (hardware-only gate)"}
            skipped += 1
            continue
        try:
            engines[name], ok = row(run)
        except Exception as e:  # noqa: BLE001
            engines[name], ok = _error(e), False
        exact += int(ok)

    total = len(ENGINES) + 1 + 1 + len(EXTRA_GATES) - skipped
    return {
        "metric": METRIC,
        "value": float(exact),
        "unit": UNIT,
        "vs_baseline": round(exact / total, 3),
        "engines_total": total,
        "engines_skipped": skipped,
        "pairs_over_threshold": int(run.ref_pairs.shape[0]),
        "engines": engines,
        "dataset": run.corpus.label,
        "n_proteins": run.n,
        **common.device_fields(dev),
    }


def _write(line: dict) -> None:
    from uniprot_kmer_based_clustering_tpu_torch.utils.artifact import (
        write_bench_artifact,
    )

    write_bench_artifact("torch_engines", line)


def main() -> int:
    on_cpu = os.environ.get("UKC_ENGINES_ON_CPU") == "1"

    def _measure():
        line = measure(on_cpu)
        if not on_cpu:
            # the artifact is evidence from the card; a CPU run never
            # overwrites it
            _write(line)
        return line

    return common.run_bench(METRIC, UNIT, _measure,
                            on_fail=None if on_cpu else _write)


if __name__ == "__main__":
    sys.exit(main())
