"""The port's spans and counters (``utils.timing.span``,
``similarity.pairwise.last_trace``) on the CPU at 300 proteins: under
``torch.profiler`` the pipeline and the sweep stage emit their ``ukc.*``
spans with the parents the call tree gives them; with no profiler no
``record_function`` is entered; the counts are what the inputs give; and
``StageTimers`` keeps its API and its seconds.
"""

import time

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.kmers import index as kindex
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
# them; None is the caller
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
PIPELINE_PARENTS = {
    **{f"ukc.stage.{s}": None for s in STAGES},
    "ukc.index.build": "ukc.stage.index",
    "ukc.index.owners": "ukc.stage.index",
    **{k: v or "ukc.stage.sweep" for k, v in PAIRWISE_PARENTS.items()},
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


@pytest.mark.parametrize("what", ["pairwise", "pipeline"])
def test_the_spans_nest_as_the_call_tree(fasta, packed, what):
    config = PipelineConfig(**STRIPS)
    if what == "pairwise":
        _, spans = _profiled(lambda: _pairwise(packed, config))
        want = PAIRWISE_PARENTS
    else:
        _, spans = _profiled(lambda: run_pipeline(fasta, config,
                                                  device="cpu"))
        want = PIPELINE_PARENTS
    assert dict(spans) == want
    # one window: one unpack, one span around the products' loop
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


@pytest.mark.parametrize("weighting", ["none", "blosum62"])
def test_the_two_pass_counts_are_the_inputs(packed, weighting):
    config = PipelineConfig(**STRIPS, weighting=weighting)
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
    assert t == {"upload_bytes": upload, "hit_tiles": len(hit),
                 "extract_products": len(runs),
                 "extract_syncs": len(runs) + 1, "pairs": len(r.pairs)}


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
