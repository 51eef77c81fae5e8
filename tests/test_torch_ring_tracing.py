"""The mesh layer's spans and counters (``ukc.ring.*``,
``parallel.sharded.last_trace``) on four CPU shards, at 300 proteins of
the benchmark's corpus generator (``benchmark/corpus.py``): the mesh's
answer equals the single-device sweep stage and the benchmark's plain
reference (``benchmark/reference/kmer_pairs.py``) exactly; under
``torch.profiler`` the mesh path emits its ``ukc.ring.*`` spans with
the parents the call tree gives them, and no other path or unprofiled
call does; and the counts are their closed forms, on the flat ring, the
2-D ring and the k-axis layout.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh
from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded as tsh
from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
    _sharded_similarity,
    run_pipeline,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise import (
    pairwise_similarity,
)
from uniprot_kmer_based_clustering_tpu_torch.utils import timing

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
SEED = 2**31 + 19
# the benchmark's configuration at 300 proteins (its tests' cut): the
# classes in the same proportions and one family of two classes, so
# that cross-class pairs pass the threshold; tile 1,024 pads the rows to
# 1,024, so a four-shard ring's blocks are 256 rows and its final step
# is split
SMALL = {"n": 300,
         "class_sizes": [112, 100, 24, 24, 17, 11, 6, 5, 1],
         "fixed_families": [{"classes": [7, 2], "members": [2, 8],
                             "length": 300}],
         "proteins_per_family": 6}
TILE = 1024
LAYOUTS = ["flat", "2d", "kaxis"]


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_corpus = _load("bench_corpus", "corpus.py")
kmer_pairs = _load("bench_kmer_pairs", "reference", "kmer_pairs.py")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(pipeline config, the packed corpus, the reference's answer)."""
    with open(os.path.join(BENCH, "configs", "arg_k5_n10619.json")) as f:
        bench = json.load(f)
    spec = {**bench["corpus"], **SMALL}
    seq_buf, offsets, classes = bench_corpus.synth_proteins(spec, SEED)
    fasta = str(tmp_path_factory.mktemp("ring") / "corpus.fasta")
    bench_corpus.write_fasta(fasta, seq_buf, offsets, classes)
    p = bench["pipeline"]
    config = PipelineConfig(**{**p, "engine": "mxu", "tile": TILE})
    pre = run_pipeline(fasta, config, stop_after="pack", device="cpu")
    ref = kmer_pairs.answer(seq_buf, offsets, classes, k=p["k"],
                            threshold=p["threshold"],
                            cross_amr_only=p["cross_amr_only"],
                            with_components=False)
    return config, pre, ref


def _mesh(layout):
    if layout == "2d":
        return tmesh.make_mesh_2d(2, 2, device="cpu")
    return tmesh.make_mesh(4, axis="k" if layout == "kaxis" else "p",
                           device="cpu")


def _on_mesh(job, layout, **config):
    base, pre, _ = job
    cfg = dataclasses.replace(base, **config)
    return _sharded_similarity(pre.bitset, pre.table, cfg, _mesh(layout),
                               index=pre.index)


def _counters(r):
    return np.array([getattr(r, f) for f in kmer_pairs.COUNTER_NAMES],
                    np.int64)


def _spans(fn):
    """(the result, (name, parent) of every ukc.* span in start order: the
    parent is the innermost ukc.* span that encloses it)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ev = sorted(
        ((e.name(), e.start_ns(), e.end_ns())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith(timing.SPAN_PREFIX)),
        key=lambda e: (e[1], -e[2]),
    )
    spans, stack = [], []
    for name, start, end in ev:
        while stack and stack[-1][2] < end:
            stack.pop()
        spans.append((name, stack[-1][0] if stack else None))
        stack.append((name, start, end))
    return out, spans


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_mesh_equals_one_device_and_the_reference(job, layout):
    config, pre, ref = job
    r = _on_mesh(job, layout)
    one = pairwise_similarity(pre.bitset, pre.table.amr_class_ids, config,
                              index=pre.index, device="cpu")
    assert len(ref["pairs"]) > 0
    np.testing.assert_array_equal(r.pairs, ref["pairs"])
    np.testing.assert_array_equal(r.pairs, one.pairs)
    np.testing.assert_array_equal(_counters(r), ref["counters"])
    np.testing.assert_array_equal(_counters(one), ref["counters"])


def _shifts(parent, n):
    return [("ukc.ring.shift", parent)] * n


@pytest.mark.parametrize("extract", ["auto", "two_pass", "fused"])
def test_the_ring_spans_nest_as_the_call_tree(job, extract):
    _, spans = _spans(lambda: _on_mesh(job, "flat", extract=extract))
    # D = 4: three ring steps, so two shifts of the words and two of the
    # classes a pass; auto's extraction is the gather of what K1 appended
    # during the sweep, two_pass's a second pass
    if extract == "fused":
        want = ([("ukc.ring.stage", None), ("ukc.ring.fused", None)]
                + _shifts("ukc.ring.fused", 4)
                + [("ukc.ring.gather", "ukc.ring.fused")])
    elif extract == "auto":
        want = ([("ukc.ring.stage", None), ("ukc.ring.sweep", None)]
                + _shifts("ukc.ring.sweep", 4)
                + [("ukc.ring.extract", None),
                   ("ukc.ring.gather", "ukc.ring.extract")])
    else:
        want = ([("ukc.ring.stage", None), ("ukc.ring.sweep", None)]
                + _shifts("ukc.ring.sweep", 4)
                + [("ukc.ring.extract", None)]
                + _shifts("ukc.ring.extract", 4)
                + [("ukc.ring.gather", "ukc.ring.extract")])
    assert spans == want


def test_the_ring_spans_appear_nowhere_else(job, monkeypatch):
    config, pre, _ = job
    _, spans = _spans(lambda: pairwise_similarity(
        pre.bitset, pre.table.amr_class_ids, config, index=pre.index,
        device="cpu"))
    assert spans and not [s for s, _ in spans if s.startswith("ukc.ring.")]

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for layout in LAYOUTS:
        assert len(_on_mesh(job, layout).pairs)


def _steps(layout, mesh):
    """Ring steps a pass: the shifts are one fewer; the k axis has none."""
    if layout == "flat":
        return mesh.size // 2 + 1
    if layout == "2d":
        return len(tsh.steps_2d(mesh.shape["h"], mesh.shape["c"]))
    return 1


def _substeps(layout, mesh, n_pad):
    if layout == "flat":
        return tsh.count_substeps(mesh.size, n_pad)
    if layout == "2d":
        return tsh.count_substeps_2d(mesh.shape["h"], mesh.shape["c"], n_pad)
    return tsh.count_kaxis_strips(mesh.size, n_pad)


@pytest.mark.parametrize("extract", ["auto", "two_pass", "fused"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_last_trace_is_its_closed_forms(job, layout, extract):
    _, pre, ref = job
    r = _on_mesh(job, layout, extract=extract)
    t = tsh.last_trace
    mesh = _mesh(layout)
    n_pad, w_pad = pre.bitset.n_pad, pre.bitset.w_pad
    assert n_pad == TILE == tmesh.pad_for_mesh(n_pad, 4, 128)
    words, classes = n_pad * w_pad * 4, n_pad * 4
    # auto takes K1's appends: one pass, as fused
    passes = 2 if extract == "two_pass" else 1
    # the k axis holds the classes whole on every shard
    staged = words + classes * (4 if layout == "kaxis" else 1)
    # every shift moves all four shards' words and classes
    shifted = passes * (_steps(layout, mesh) - 1) * (words + classes)
    tiles = {(i // 128, j // 128) for i, j, _ in ref["pairs"]}
    assert t == {"stage_bytes": staged, "stage_pinned_bytes": 0,
                 "shift_bytes": shifted,
                 "substeps": passes * _substeps(layout, mesh, n_pad),
                 "hit_tiles": len(tiles), "pairs": len(r.pairs),
                 "epilogue_pairs": len(r.pairs) if extract == "auto" else 0,
                 "second_passes": passes - 1}
    assert len(tiles) > 1


def test_last_trace_is_replaced_by_each_call(job):
    _, pre, _ = job
    _on_mesh(job, "flat")
    first = tsh.last_trace
    mesh = _mesh("flat")
    classes = np.full(pre.bitset.n_pad, -1, np.int32)
    classes[: pre.bitset.n] = pre.table.amr_class_ids
    tsh.sharded_pairwise_similarity(mesh, pre.bitset.words, classes,
                                    pre.bitset.n, 10)
    t = tsh.last_trace
    assert t is not first and first["pairs"] > 0
    # a sweep alone: the staging, one pass, no extraction
    n_pad, w_pad = pre.bitset.n_pad, pre.bitset.w_pad
    assert t == {"stage_bytes": n_pad * w_pad * 4 + n_pad * 4,
                 "stage_pinned_bytes": 0,
                 "shift_bytes": 2 * (n_pad * w_pad * 4 + n_pad * 4),
                 "substeps": tsh.count_substeps(4, n_pad),
                 "hit_tiles": 0, "pairs": 0, "epilogue_pairs": 0,
                 "second_passes": 0}
