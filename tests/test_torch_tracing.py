"""The port's spans and counters (``utils.timing.span``,
``similarity.pairwise.last_trace``, ``models.agglomerative.last_trace``)
on the CPU at 300 proteins: under ``torch.profiler`` the pipeline, the
sweep stage and the agglomerative rounds emit their ``ukc.*`` spans with
the parents the call tree gives them; with no profiler no
``record_function`` is entered; the counts are what the inputs give; and
``StageTimers`` keeps its API and its seconds.
"""

import time

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.kmers import index as kindex
from uniprot_kmer_based_clustering_tpu_torch.models import (
    agglomerative as tagg,
)
from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
    blosum_weights,
    run_pipeline,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise as tpw
from uniprot_kmer_based_clustering_tpu_torch.utils import timing

N = 300
STRIPS = dict(engine="mxu", tile=16, strip=64, threshold=2)
# strip 16: 19 strips of the 304 padded rows, so the scan, which fused
# extraction needs
FUSED = dict(engine="mxu", tile=16, strip=16, threshold=2, extract="fused")

# the nearest enclosing ukc.* span of each span, as the call tree nests
# them; None is the caller. Under extract="two_pass" extraction unpacks
# and recomputes the hit tiles; under the default, on the strip
# schedule, it only plans and fetches what K1 appended.
STAGES = ["ingest", "encode", "index", "pack", "sweep", "cluster"]
PAIRWISE_PARENTS = {
    "ukc.pairwise.upload": None,
    "ukc.pairwise.sweep": None,
    "ukc.sweep.dispatch": "ukc.pairwise.sweep",
    "ukc.sweep.finalize": "ukc.pairwise.sweep",
    "ukc.pairwise.extract": None,
    "ukc.extract.plan": "ukc.pairwise.extract",
    "ukc.extract.unpack": "ukc.pairwise.extract",
    "ukc.extract.products": "ukc.pairwise.extract",
    "ukc.extract.fetch": "ukc.pairwise.extract",
    "ukc.pairwise.result": None,
}
APPENDED_PARENTS = {
    k: v for k, v in PAIRWISE_PARENTS.items()
    if k not in ("ukc.extract.unpack", "ukc.extract.products")
}


def _pipeline_parents(pairwise):
    return {
        **{f"ukc.stage.{s}": None for s in STAGES},
        "ukc.index.build": "ukc.stage.index",
        "ukc.index.owners": "ukc.stage.index",
        **{k: v or "ukc.stage.sweep" for k, v in pairwise.items()},
    }


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """bench_scale's template-mutation corpus, 300 proteins, headers in
    the reference's format."""
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(N, seed=3)
    path = tmp_path_factory.mktemp("tracing") / "synth.fasta"
    with open(path, "w") as f:
        for i in range(N):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    return str(path)


@pytest.fixture(scope="module")
def packed(fasta):
    """The pipeline up to the packed matrix, on the strip schedule's
    padding."""
    return run_pipeline(fasta, PipelineConfig(**STRIPS), stop_after="pack",
                        device="cpu")


def _spans(prof):
    """(name, parent) of every ukc.* span of the trace, in start order:
    the parent is the innermost ukc.* span that encloses it."""
    ev = sorted(
        ((e.name(), e.start_ns(), e.end_ns())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith(timing.SPAN_PREFIX)),
        key=lambda e: (e[1], -e[2]),
    )
    out, stack = [], []
    for name, start, end in ev:
        while stack and stack[-1][2] < end:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, start, end))
    return out


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _pairwise(packed, config, weights=None):
    return tpw.pairwise_similarity(
        packed.bitset, packed.table.amr_class_ids, config, weights=weights,
        index=packed.index, device="cpu",
    )


@pytest.mark.parametrize("what,extract", [
    pytest.param("pairwise", "auto", id="pairwise"),
    pytest.param("pipeline", "auto", id="pipeline"),
    pytest.param("pairwise", "two_pass", id="pairwise-two_pass"),
    pytest.param("pipeline", "two_pass", id="pipeline-two_pass"),
])
def test_the_spans_nest_as_the_call_tree(fasta, packed, what, extract):
    config = PipelineConfig(**STRIPS, extract=extract)
    pairwise = PAIRWISE_PARENTS if extract == "two_pass" else APPENDED_PARENTS
    if what == "pairwise":
        _, spans = _profiled(lambda: _pairwise(packed, config))
        want = pairwise
    else:
        _, spans = _profiled(lambda: run_pipeline(fasta, config,
                                                  device="cpu"))
        want = _pipeline_parents(pairwise)
    assert dict(spans) == want
    # each span once: one window, one unpack, one span around the
    # products' loop (two-pass); one plan and one fetch (appended)
    names = [s for s, _ in spans]
    assert len(names) == len(want)
    if what == "pipeline":
        assert [s for s in names if s.startswith("ukc.stage.")] == [
            f"ukc.stage.{s}" for s in STAGES]


@pytest.mark.parametrize("engine", ["numpy", "auto"])
def test_the_index_spans_on_either_build(packed, engine):
    from uniprot_kmer_based_clustering_tpu_torch.kmers.encode import (
        encode_kmers,
    )

    table = packed.table
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    index, spans = _profiled(lambda: kindex.build_index(codes, koff, 5,
                                                        engine=engine))
    assert spans == [("ukc.index.build", None), ("ukc.index.owners", None)]
    assert np.array_equal(index.unique_owner, packed.index.unique_owner)


def test_no_record_function_without_a_profiler(fasta, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    config = PipelineConfig(**STRIPS)
    r = run_pipeline(fasta, config, device="cpu")
    assert len(r.pairwise.pairs) and list(r.timings) == STAGES
    with pytest.raises(AssertionError, match="no profiler"):
        _profiled(lambda: run_pipeline(fasta, config, device="cpu"))


@pytest.mark.parametrize("weighting,extract", [
    pytest.param("none", "two_pass", id="none"),
    pytest.param("blosum62", "two_pass", id="blosum62"),
    pytest.param("none", "auto", id="none-appended"),
    pytest.param("blosum62", "auto", id="blosum62-appended"),
])
def test_the_two_pass_counts_are_the_inputs(packed, weighting, extract):
    """Two-pass: a product a run of hit tiles, its survivors appended on
    the device, and the one fetch. The default on the strip schedule: no
    product, the one fetch, and every pair appended by K1."""
    config = PipelineConfig(**STRIPS, weighting=weighting, extract=extract)
    bitset = packed.bitset
    weights = blosum_weights(packed.index, config, bitset)
    r = _pairwise(packed, config, weights)
    t = tpw.last_trace

    n_pad, w_pad = bitset.n_pad, bitset.w_pad
    upload = n_pad * w_pad * 4 + n_pad * 4
    if weights is not None:
        upload += w_pad * 32
    assert t["upload_bytes"] == upload

    # the sweep's hit tiles, as extraction reads them
    classes = np.full(n_pad, -1, np.int32)
    classes[: bitset.n] = packed.table.amr_class_ids
    threshold = (config.effective_weighted_threshold(weights)
                 if weights is not None else config.threshold)
    _, tile_hits, (ti, tj, _) = tpw.sweep_mxu(
        torch.from_numpy(bitset.words.view(np.int32)), classes, n=bitset.n,
        threshold=threshold, strip=config.strip, block=config.tile,
        weights=None if weights is None else torch.from_numpy(weights),
    )
    hit = np.nonzero(tile_hits[:, 0] > 0)[0]
    runs = list(tpw._tile_runs(ti[hit], tj[hit]))
    assert 0 < len(runs) < len(hit)
    if extract == "two_pass":
        assert t == {"upload_bytes": upload, "pinned_bytes": 0,
                     "hit_tiles": len(hit),
                     "extract_products": len(runs),
                     "extract_syncs": 1, "epilogue_pairs": 0,
                     "pairs": len(r.pairs)}
    else:
        assert t == {"upload_bytes": upload, "pinned_bytes": 0,
                     "hit_tiles": len(hit),
                     "extract_products": 0, "extract_syncs": 1,
                     "epilogue_pairs": len(r.pairs), "pairs": len(r.pairs)}
    assert len(r.pairs) == int(tile_hits[:, 0].sum())


def test_the_fused_counts_are_the_inputs(fasta):
    pre = run_pipeline(fasta, PipelineConfig(**FUSED), stop_after="pack",
                       device="cpu")
    r = _pairwise(pre, PipelineConfig(**FUSED))
    t = tpw.last_trace
    n_pad, w_pad = pre.bitset.n_pad, pre.bitset.w_pad
    ns = n_pad // FUSED["strip"]
    # the keep mask: a bool per (block pair of the scan, sub-tile)
    keep = ns * (ns + 1) // 2 * (FUSED["strip"] // FUSED["tile"]) ** 2
    assert t["upload_bytes"] == n_pad * w_pad * 4 + n_pad * 4 + keep
    # no sub-tile overflows the capacity: three compactions and the fetch
    assert t["extract_products"] == 0 and t["extract_syncs"] == 4
    assert t["pairs"] == len(r.pairs) > 0 and t["hit_tiles"] > 0


def test_last_trace_is_replaced_by_each_call(packed):
    _pairwise(packed, PipelineConfig(**STRIPS))
    first = tpw.last_trace
    _pairwise(packed, PipelineConfig(**{**STRIPS, "threshold": 10**6}))
    assert tpw.last_trace is not first
    assert tpw.last_trace["pairs"] == tpw.last_trace["hit_tiles"] == 0
    assert tpw.last_trace["extract_syncs"] == 0


@pytest.mark.parametrize("profiled", [False, True])
def test_stage_timers_keep_their_api_and_seconds(profiled, capsys):
    timers = timing.StageTimers(echo=True)

    def work():
        with timers.stage("a"):
            time.sleep(0.02)
        with timers.stage("b"):
            pass
        with timers.stage("a"):
            time.sleep(0.01)

    if profiled:
        _, spans = _profiled(work)
        assert spans == [("ukc.stage.a", None), ("ukc.stage.b", None),
                         ("ukc.stage.a", None)]
    else:
        work()
    got = timers.as_dict()
    assert list(got) == ["a", "b"]
    assert 0.03 <= got["a"] < 1.0 and 0 <= got["b"] < got["a"]
    assert got is not timers.seconds and got == timers.seconds
    assert capsys.readouterr().err.count("[stage] a:") == 2


# the agglomerative rounds: the host loop on its one-shot plan and on
# the strip plan (a 1 MiB budget), and the loop with its state on the
# device
AGGLO_LOOPS = [
    pytest.param("host", 13 << 30, id="host"),
    pytest.param("host", 1 << 20, id="host-strips"),
    pytest.param("device", None, id="device"),
]
AGGLO_PARENTS = {
    "ukc.agglo.round": None,
    "ukc.agglo.argmax": "ukc.agglo.round",
    "ukc.agglo.fetch": "ukc.agglo.round",
    "ukc.agglo.merge": "ukc.agglo.round",
}


def _agglo(packed, loop, budget, **kw):
    b = packed.bitset
    if loop == "device":
        return tagg.agglomerative_cluster_device(b, b.n, device="cpu", **kw)
    return tagg.agglomerative_cluster(b, b.n, hbm_budget_bytes=budget,
                                      device="cpu", **kw)


def _agglo_plan(packed, loop, budget):
    b = packed.bitset
    return None if loop == "device" else tagg._argmax_plan(b.n_pad, b.w_pad,
                                                           budget)


@pytest.mark.parametrize("loop,budget", AGGLO_LOOPS)
def test_the_agglomerative_spans_nest_as_the_rounds(packed, loop, budget):
    plain = _agglo(packed, loop, budget)
    r, spans = _profiled(lambda: _agglo(packed, loop, budget))
    agglo = [(s, p) for s, p in spans if s.startswith("ukc.agglo.")]
    assert dict(agglo) == AGGLO_PARENTS
    names = [s for s, _ in agglo]
    plan = _agglo_plan(packed, loop, budget)
    strips = 1 if plan is None else -(-packed.bitset.n_pad // plan[0])
    assert r.rounds > 2
    assert names.count("ukc.agglo.round") == r.rounds
    assert names.count("ukc.agglo.argmax") == r.rounds * strips
    assert names.count("ukc.agglo.fetch") == r.rounds
    assert names.count("ukc.agglo.merge") == r.rounds
    # the profiler changes nothing of the result
    assert r.rounds == plain.rounds
    assert r.merges.tobytes() == plain.merges.tobytes()
    assert r.labels.tobytes() == plain.labels.tobytes()


@pytest.mark.parametrize("loop,budget", AGGLO_LOOPS)
def test_the_agglomerative_counts_are_the_inputs(packed, loop, budget):
    b = packed.bitset
    n_pad, w, n = b.n_pad, b.w_pad, b.n
    k = 32 * w
    one_round = _agglo(packed, loop, budget, max_rounds=1)
    _agglo(packed, loop, budget, max_rounds=2)
    two_rounds = tagg.last_trace
    r = _agglo(packed, loop, budget)
    t = tagg.last_trace
    assert t is not two_rounds  # each call starts its own counts
    assert t["rounds"] == r.rounds and t["merges"] == len(r.merges)
    plan = _agglo_plan(packed, loop, budget)
    if plan is None:
        assert t["plan"] == "one_shot" and t["products"] == r.rounds
        assert t["product_ops"] == r.rounds * 2 * n_pad**2 * k
    else:
        strip, chunk = plan
        strips, chunks = -(-n_pad // strip), w // chunk
        assert t["plan"] == "strip" and chunks > 1
        assert t["products"] == r.rounds * strips * chunks
        assert t["product_ops"] == r.rounds * strips * 2 * strip * n_pad * k
    # a merge retires one row: the first round takes all n, the second
    # those the first left
    assert two_rounds["active_rows"] == n + (n - len(one_round.merges))
    assert n + (r.rounds - 1) * (n - len(r.merges)) < t["active_rows"] \
        < r.rounds * n
    words = n_pad * w * 4
    if loop == "host":
        # one fetch a round (best_j, best_c as int32); the active mask
        # once; a merging round's partner (int64) and two bool masks
        assert t["syncs"] == r.rounds
        assert t["host_bytes"] == (words + n_pad + r.rounds * 8 * n_pad
                                   + (r.rounds - 1) * 10 * n_pad)
    else:
        # a round's merge count; each pointer-jumping step's test; the
        # labels and the merges (int32) at the end
        jumps = t["syncs"] - r.rounds - 2
        assert jumps >= 1
        assert t["host_bytes"] == (words + 8 * r.rounds + jumps + 4 * n
                                   + 12 * len(r.merges))


def test_the_host_loop_reads_the_device_once_a_round(packed, monkeypatch):
    """The counters read nothing of the device: the round's one fetch is
    the host loop's only read."""
    calls = {"cpu": 0}
    real_cpu = torch.Tensor.cpu

    def counted_cpu(self, *a, **k):
        calls["cpu"] += 1
        return real_cpu(self, *a, **k)

    def refuse(*a, **k):
        raise AssertionError("a device read beside the round's fetch")

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    for name in ("item", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    r = _agglo(packed, "host", 13 << 30)
    assert calls["cpu"] == r.rounds == tagg.last_trace["syncs"]
