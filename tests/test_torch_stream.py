"""The port's out-of-core stream engine (ops/stream.py) against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX stream
functions and the port's (``device="cpu"``: the plain epilogue in place
of the K2 kernel). Each JAX oracle is built once per module; where a case
only varies the blocking, the result already pinned to JAX is the oracle.

Tolerance: exact equality (``row_stats``, ``tile_hits``, tile lists, int32
``(i, j, count)`` rows in (i, j) order, packed int64 lists, file bytes).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu import cluster_fasta as jcluster_fasta
from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.ops import stream as js
from uniprot_kmer_based_clustering_tpu.similarity import pairwise as jpw
from uniprot_kmer_based_clustering_tpu.utils import checkpoint as jckpt
from uniprot_kmer_based_clustering_tpu_torch import cluster_fasta
from uniprot_kmer_based_clustering_tpu_torch import pipeline as tpl
from uniprot_kmer_based_clustering_tpu_torch import similarity as tsim
from uniprot_kmer_based_clustering_tpu_torch.kmers import bitset as tbitset
from uniprot_kmer_based_clustering_tpu_torch.ops import stream as ts
from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise as tpw
from uniprot_kmer_based_clustering_tpu_torch.utils import checkpoint as tckpt

THR = 3
BASE = dict(threshold=THR, tile=16, word_block=128)
STAT_FIELDS = ("cross_weight", "cross_pairs", "cross_over", "cross_max",
               "same_weight", "same_pairs", "same_over", "same_max")


def _random_bitset(seed, n=150, k=1200, dens=0.06, row_multiple=16):
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(rng.random((n, k)) < dens)
    rows, cols = rows.astype(np.int32), cols.astype(np.int32)
    bs = pack_bitsets(rows, cols, n, k, row_multiple=row_multiple,
                      word_multiple=128)
    return bs, rng.integers(0, 3, n).astype(np.int32), rows, cols


class Problem:
    """150 random proteins over 1200 k-mers (160 × 128 words at tile 16),
    with the JAX oracles of the module, each computed on first use."""

    def __init__(self):
        self.bs, self.classes, self.rows, self.cols = _random_bitset(7)
        self.cls = np.full(self.bs.n_pad, -1, np.int32)
        self.cls[: self.bs.n] = self.classes
        self.weights = np.random.default_rng(3).integers(
            1, 12, self.bs.w_pad * 32).astype(np.int8)
        self._cache = {}

    def jax(self, **kw):
        """The JAX package's pairwise_similarity for a config, cached."""
        key = json.dumps(kw, sort_keys=True)
        if key not in self._cache:
            weighted = kw.get("weighting") == "blosum62"
            self._cache[key] = jpw.pairwise_similarity(
                self.bs, self.classes, PipelineConfig(**BASE | kw),
                weights=self.weights if weighted else None,
            )
        return self._cache[key]

    def torch(self, **kw):
        weighted = kw.get("weighting") == "blosum62"
        return tpw.pairwise_similarity(
            self.bs, self.classes, PipelineConfig(**BASE | kw),
            weights=self.weights if weighted else None, device="cpu",
        )

    def jax_sweep(self, threshold=THR):
        """(tile_hits, tiles) of the JAX stream sweep at bs 32, cached."""
        key = f"sweep{threshold}"
        if key not in self._cache:
            self._cache[key] = js.sweep_mxu_stream(
                self.bs.words, self.cls, n=self.bs.n, threshold=threshold,
                bs=32, block=16)[1:]
        return self._cache[key]


@pytest.fixture(scope="module")
def problem():
    return Problem()


def _check_same(a, b):
    for f in STAT_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    assert a.pairs.dtype == np.int32
    assert np.array_equal(a.pairs, b.pairs)


def _same_sweep(got, want):
    assert got[0].dtype == np.int64
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert got[1].dtype == np.int32
    assert np.array_equal(got[1], np.asarray(want[1]))
    assert got[2][2] == want[2][2]
    assert np.array_equal(got[2][0], want[2][0])
    assert np.array_equal(got[2][1], want[2][1])


# -- the engine through pairwise_similarity ---------------------------------

@pytest.mark.parametrize("strip", [None, 16, 32, 48, 160])
def test_stream_engine_and_blocking_invariance(problem, strip):
    """The stream engine equals the JAX reference for every stream-block
    size: the budget's own, one that pads beyond the packed matrix (160 =
    one block) and one that does not divide the padded rows (48)."""
    ref = problem.jax(engine="xla")
    assert len(ref.pairs) > 1000
    got = problem.torch(engine="stream", strip=strip)
    _check_same(got, ref)
    if strip in (None, 32):
        _check_same(got, problem.jax(engine="stream", strip=strip))


@pytest.mark.parametrize("kw", [
    dict(cross_amr_only=False),
    dict(weighting="blosum62", weighted_threshold=THR * 6),
    dict(cross_amr_only=False, weighting="blosum62",
         weighted_threshold=THR * 6),
], ids=["all-pairs", "weighted", "all-pairs-weighted"])
@pytest.mark.parametrize("extract", ["two_pass", "fused", "onepass"])
def test_stream_gates_and_weights(problem, kw, extract):
    """cross_amr_only=False and int8 column weights ride every extraction
    mode; a weighted run stays on the stream engine."""
    ref = problem.jax(engine="mxu", strip=32, **kw)
    assert len(ref.pairs) > 0
    _check_same(problem.torch(engine="stream", strip=32, extract=extract,
                              **kw), ref)


def test_weighted_run_stays_on_the_stream_engine(problem, monkeypatch):
    called = []
    real = ts.sweep_mxu_stream

    def spy(*a, **k):
        called.append(k["weights"] is not None)
        return real(*a, **k)

    monkeypatch.setattr(ts, "sweep_mxu_stream", spy)
    problem.torch(engine="stream", strip=32, weighting="blosum62",
                  weighted_threshold=THR * 6)
    assert called == [True]


@pytest.mark.parametrize("kw,jax_too", [
    (dict(extract="fused", strip=32), True),
    (dict(extract="fused", extract_k=4096, strip=32), False),
    (dict(extract="onepass", strip=32), True),
    (dict(extract="onepass", strip=32, extract_k=8), False),
], ids=["fused", "fused-k-over-tile-area", "onepass", "onepass-cap-8"])
def test_stream_extract_modes_via_config(problem, kw, jax_too):
    """extract='fused' (a capacity past the tile area is clamped, on both
    sides of the keep/redo split) and extract='onepass' (extract_k is the
    pair-buffer capacity: 8 forces the capacity-miss redo) through the
    production dispatch."""
    got = problem.torch(engine="stream", **kw)
    _check_same(got, problem.jax(engine="xla"))
    if jax_too:
        _check_same(got, problem.jax(engine="stream", **kw))


def test_stream_fused_overflow_redo_via_config(problem):
    """A capacity below the densest tile's hit count (threshold 0) forces
    the truncation-detect and two-pass-redo path."""
    ref = problem.jax(engine="xla", threshold=0)
    got = problem.torch(engine="stream", extract="fused", extract_k=8,
                        strip=32, threshold=0)
    _check_same(got, ref)


def test_onepass_requires_stream_engine(problem):
    with pytest.raises(ValueError, match="stream") as terr:
        problem.torch(engine="mxu", extract="onepass")
    with pytest.raises(ValueError, match="stream") as jerr:
        problem.jax(engine="mxu", extract="onepass")
    assert str(terr.value) == str(jerr.value)


def test_stream_empty_result():
    bs, classes, _, _ = _random_bitset(1, n=40, k=300, dens=0.03)
    r = tpw.pairwise_similarity(
        bs, classes, PipelineConfig(threshold=10**6, tile=16,
                                    engine="stream"), device="cpu")
    assert r.pairs.shape == (0, 3) and r.pairs.dtype == np.int32


@pytest.mark.parametrize("n,k,dens,n_cls,thr", [
    (1, 40, 0.2, 1, 0),
    (2, 40, 0.0, 3, 1),
    (17, 130, 0.3, 1, 0),
    (33, 513, 0.08, 4, 2),
    (64, 64, 0.5, 2, 5),
])
@pytest.mark.parametrize("extract", ["auto", "onepass"])
def test_stream_fuzz_parity(n, k, dens, n_cls, thr, extract):
    """Degenerate shapes (one protein, no incidence, one class at
    threshold 0, a dense bitset), both gates: the stream engine equals the
    port's in-core MXU engine, which the JAX package pins."""
    rng = np.random.default_rng(11 + n)
    rows, cols = np.nonzero(rng.random((n, k)) < dens)
    bs = tbitset.pack_bitsets(rows.astype(np.int32), cols.astype(np.int32),
                              n, k, row_multiple=8, word_multiple=128)
    classes = rng.integers(0, n_cls, n).astype(np.int32)
    for cross_only in (True, False):
        kw = dict(threshold=thr, tile=8, cross_amr_only=cross_only)
        ref = tpw.pairwise_similarity(
            bs, classes, PipelineConfig(engine="mxu", **kw), device="cpu")
        got = tpw.pairwise_similarity(
            bs, classes, PipelineConfig(engine="stream", strip=16,
                                        extract=extract, **kw),
            device="cpu")
        _check_same(got, ref)


# -- the sweep and its blocking ----------------------------------------------

SWEEPS = {
    "bs32": dict(bs=32),
    "auto-bs": dict(),
    "small-group-budget": dict(bs=16, hbm_budget_bytes=1 << 14, inflight=1),
    "max-group-1": dict(bs=64, max_group=1),
    "word-chunk-64": dict(bs=32, word_chunk=64),
    "budget-1MiB": dict(bs=32, hbm_budget_bytes=1 << 20, inflight=1),
}


@pytest.mark.parametrize("name,weighted", [
    *((name, False) for name in SWEEPS),
    ("bs32", True), ("max-group-1", True), ("word-chunk-64", True),
])
def test_sweep_matches_jax_sweep(problem, name, weighted):
    """sweep_mxu_stream gives the JAX sweep's row_stats, tile_hits and
    tile list, chooses the same (bs, g, word_chunk) and takes the same
    steps and uploads: single- and multi-group, contraction-chunked,
    weighted (w_thresh 5) and unweighted."""
    kw = dict(SWEEPS[name], n=problem.bs.n, block=16,
              threshold=THR * 6 if weighted else THR)
    if weighted:
        kw.update(weights=problem.weights, w_thresh=5)
    want = js.sweep_mxu_stream(problem.bs.words, problem.cls, **kw)
    jtrace = dict(js.last_trace)
    got = ts.sweep_mxu_stream(problem.bs.words, problem.cls, device="cpu",
                              **kw)
    _same_sweep(got, want)
    for key in ("bs", "g", "nbk", "word_chunk", "steps", "uploads"):
        assert ts.last_trace[key] == jtrace[key], key
    if name == "small-group-budget":
        assert ts.last_trace["g"] == 1 and ts.last_trace["uploads"] == 55
    if name == "word-chunk-64":
        assert ts.last_trace["word_chunk"] == 64 < problem.bs.w_pad


def test_sweep_pads_short_classes_and_rows(problem):
    """Classes of length n (not N_pad) and a block that pads the rows
    beyond the matrix: padding rows carry zero stats and class −1."""
    want = js.sweep_mxu_stream(problem.bs.words, problem.classes,
                               n=problem.bs.n, threshold=THR, bs=64,
                               block=16)
    got = ts.sweep_mxu_stream(problem.bs.words, problem.classes,
                              n=problem.bs.n, threshold=THR, bs=64, block=16,
                              device="cpu")
    _same_sweep(got, want)
    assert got[0].shape[0] == 192 > problem.bs.n_pad
    assert not got[0][problem.bs.n:].any()


@pytest.mark.parametrize("args", [
    (160, 128, 16, 13 << 30), (32256, 28416, 512, 13 << 30),
    (32256, 28416, 512, 2 << 30), (10752, 7680, 512, 13 << 30),
    (100352, 49152, 512, 13 << 30), (512, 128, 512, 1 << 20),
    (4096, 128, 128, 1 << 24),
])
def test_auto_stream_block_is_the_jax_packages(args):
    assert ts.auto_stream_block(*args) == js.auto_stream_block(*args)


def test_stream_block_must_be_a_tile_multiple(problem):
    with pytest.raises(ValueError, match="multiple of the tile"):
        ts.sweep_mxu_stream(problem.bs.words, problem.cls, n=problem.bs.n,
                            threshold=THR, bs=24, block=16, device="cpu")


# -- fused --------------------------------------------------------------------

def test_fused_candidates_match_jax(problem):
    """With a capacity that holds every sub-tile the drained candidates
    are the JAX sweep's, as a set (the order within a sub-tile is
    top-k's), and the extractor returns the pair list from them alone."""
    kw = dict(n=problem.bs.n, threshold=THR, bs=32, block=16, fused_k=256)
    *want, jc = js.sweep_mxu_stream(problem.bs.words, problem.cls, **kw)
    *got, tc = ts.sweep_mxu_stream(problem.bs.words, problem.cls,
                                   device="cpu", **kw)
    _same_sweep(got, want)
    assert (tc.k, tc.include_same) == (jc.k, jc.include_same) == (256, False)

    def canon(p):
        return p[np.lexsort((p[:, 1], p[:, 0]))]

    assert tc.pairs.dtype == np.int32 and len(tc.pairs) > 0
    assert np.array_equal(canon(tc.pairs), canon(jc.pairs))
    pairs = ts.extract_pairs_stream_fused(
        problem.bs.words, problem.cls, got[1], got[2], tc, n=problem.bs.n,
        threshold=THR, device="cpu")
    assert np.array_equal(pairs, problem.jax(engine="xla").pairs)


@pytest.mark.parametrize("redo", ["auto", "grouped", "window"])
def test_fused_overflow_redo_routes(problem, redo):
    """Threshold 0 with capacity 8 truncates nearly every tile: the redo
    by row windows and by the grouped pass both restore the exact list,
    and equal the JAX extractor fed the JAX sweep."""
    ref = problem.jax(engine="xla", threshold=0)
    rs, th, tiles, cands = ts.sweep_mxu_stream(
        problem.bs.words, problem.cls, n=problem.bs.n, threshold=0, bs=32,
        block=16, fused_k=8, device="cpu")
    assert (th[:, 0] > 8).sum() > 10
    got = ts.extract_pairs_stream_fused(
        problem.bs.words, problem.cls, th, tiles, cands, n=problem.bs.n,
        threshold=0, redo=redo, device="cpu")
    assert np.array_equal(got, ref.pairs)


def test_fused_checks_mask_and_total(problem):
    rs, th, tiles, cands = ts.sweep_mxu_stream(
        problem.bs.words, problem.cls, n=problem.bs.n, threshold=THR, bs=32,
        block=16, fused_k=256, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        ts.extract_pairs_stream_fused(
            problem.bs.words, problem.cls, th, tiles, cands, n=problem.bs.n,
            threshold=THR, cross_amr_only=False, device="cpu")
    short = dataclasses.replace(cands, pairs=cands.pairs[1:])
    with pytest.raises(AssertionError, match="promised"):
        ts.extract_pairs_stream_fused(
            problem.bs.words, problem.cls, th, tiles, short, n=problem.bs.n,
            threshold=THR, device="cpu")


# -- the two-pass extractors --------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(bs=16), dict(bs=48), dict(bs=160), dict(bs=None),
    dict(bs=16, hbm_budget_bytes=1 << 20, inflight=1),
    dict(bs=32, word_chunk=64), dict(bs=64, max_group=1),
    dict(bs=32, pair_format="packed"),
], ids=["bs16", "bs48", "bs160", "auto-bs", "tiny-budget", "word-chunk-64",
        "max-group-1", "packed"])
def test_grouped_extractor(problem, kw):
    """The grouped (sweep-schedule) extractor on the JAX sweep's tile
    hits equals the reference pair list for every blocking: a block that
    does not divide the padded rows, one block, the budget's choice, one
    block a group, the word-chunked operands, and the packed format."""
    th, tiles = problem.jax_sweep()
    got = ts.extract_pairs_stream_grouped(
        problem.bs.words, problem.cls, th, tiles, n=problem.bs.n,
        threshold=THR, device="cpu", **kw)
    assert np.array_equal(tsim.pairs_as_array(got),
                          problem.jax(engine="xla").pairs)
    assert got.ndim == (1 if "pair_format" in kw else 2)


def test_grouped_masked_subset_matches_jax(problem):
    """tile_hits restricted to a subset of hit tiles (the fused redo's
    contract): exactly that subset's pairs, as the JAX extractor returns
    them."""
    th, tiles = problem.jax_sweep()
    th = np.asarray(th)
    hit = np.nonzero(th[:, 0] > 0)[0]
    sel = np.random.default_rng(2).choice(hit, size=len(hit) // 3,
                                          replace=False)
    masked = np.zeros_like(th)
    masked[sel] = th[sel]
    kw = dict(n=problem.bs.n, threshold=THR, bs=32)
    want = js.extract_pairs_stream_grouped(problem.bs.words, problem.cls,
                                           masked, tiles, **kw)
    got = ts.extract_pairs_stream_grouped(problem.bs.words, problem.cls,
                                          masked, tiles, device="cpu", **kw)
    assert 0 < len(got) < len(problem.jax(engine="xla").pairs)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert ts.last_grouped_trace["steps"] < \
        ts.last_grouped_trace["block_pairs_total"]


def test_grouped_empty(problem):
    th, tiles = problem.jax_sweep()
    got = ts.extract_pairs_stream_grouped(
        problem.bs.words, problem.cls, np.zeros_like(np.asarray(th)), tiles,
        n=problem.bs.n, threshold=THR, device="cpu")
    assert got.shape == (0, 3) and got.dtype == np.int32


def test_grouped_checks_total(problem):
    th, tiles = problem.jax_sweep()
    th = np.asarray(th).copy()
    th[np.nonzero(th[:, 0])[0][0], 0] += 1
    with pytest.raises(AssertionError, match="promised"):
        ts.extract_pairs_stream_grouped(
            problem.bs.words, problem.cls, th, tiles, n=problem.bs.n,
            threshold=THR, bs=32, device="cpu")


@pytest.mark.parametrize("cross_only,weighted", [
    (True, False), (False, False), (True, True), (False, True)])
def test_window_and_grouped_extractors_match_jax(problem, cross_only,
                                                 weighted):
    """Both two-pass extractors against the JAX window extractor, fed the
    same sweep outputs, for both gates, weighted and unweighted."""
    wts = problem.weights if weighted else None
    thr = THR * 4
    rs, th, tiles = ts.sweep_mxu_stream(
        problem.bs.words, problem.cls, n=problem.bs.n, threshold=thr, bs=32,
        block=16, weights=wts, device="cpu")
    kw = dict(n=problem.bs.n, threshold=thr, cross_amr_only=cross_only,
              weights=wts)
    want = js.extract_pairs_stream(problem.bs.words, problem.cls, th, tiles,
                                   **kw)
    assert len(want) > 0
    win = ts.extract_pairs_stream(problem.bs.words, problem.cls, th, tiles,
                                  device="cpu", **kw)
    grp = ts.extract_pairs_stream_grouped(problem.bs.words, problem.cls, th,
                                          tiles, bs=32, device="cpu", **kw)
    assert np.array_equal(win, want) and np.array_equal(grp, want)


def test_window_extractor_dense_path(problem, monkeypatch):
    """Tiles past TOPK_CAP hits are appended whole: with the crossover
    shrunk to 1 every hit tile takes that path, at threshold 0."""
    ref = problem.jax(engine="xla", threshold=0)
    th, tiles = problem.jax_sweep(threshold=0)
    monkeypatch.setattr(ts, "TOPK_CAP", 1)
    got = ts.extract_pairs_stream(problem.bs.words, problem.cls, th, tiles,
                                  n=problem.bs.n, threshold=0, device="cpu")
    assert np.array_equal(got, ref.pairs)


def test_window_extractor_small_batches(problem):
    """A batch budget of one tile: every batch uploads its own windows,
    more batches than the in-flight window holds."""
    th, tiles = problem.jax_sweep()
    got = ts.extract_pairs_stream(
        problem.bs.words, problem.cls, th, tiles, n=problem.bs.n,
        threshold=THR, batch_budget_bytes=1, inflight=1, device="cpu")
    assert np.array_equal(got, problem.jax(engine="xla").pairs)
    assert ts.last_extract_trace["batch"] == 1
    assert ts.last_extract_trace["batches"] == \
        ts.last_extract_trace["hit_tiles"] > 3


def test_extract_auto_takes_the_cheaper_route(problem, monkeypatch):
    th, tiles = problem.jax_sweep()
    args = (problem.bs.words, problem.cls, th, tiles)
    kw = dict(n=problem.bs.n, threshold=THR)
    want = js.extract_pairs_stream_auto(*args, **kw)
    assert np.array_equal(ts.extract_pairs_stream_auto(*args, device="cpu",
                                                       **kw), want)
    n_hit = int((np.asarray(th)[:, 0] > 0).sum())
    for mod in (ts, js):
        assert mod._prefer_grouped(n_hit, 16, problem.bs.words) is True
        assert mod._prefer_grouped(4, 16, problem.bs.words) is False
    took = []
    monkeypatch.setattr(ts, "extract_pairs_stream",
                        lambda *a, **k: took.append("window"))
    sparse = np.zeros_like(np.asarray(th))
    sparse[np.nonzero(np.asarray(th)[:, 0])[0][:2]] = 1
    ts.extract_pairs_stream_auto(problem.bs.words, problem.cls, sparse,
                                 tiles, device="cpu", **kw)
    assert took == ["window"]


# -- one pass -------------------------------------------------------------------

@pytest.mark.parametrize("obs", [16, 48, None])
def test_onepass_matches_jax(problem, obs):
    """Stats AND pairs from a single streamed pass equal the JAX one-pass
    engine's, with the same capacity and blocking in the trace."""
    kw = dict(n=problem.bs.n, threshold=THR, bs=obs, block=16)
    want = js.sweep_extract_stream(problem.bs.words, problem.cls, **kw)
    jtrace = dict(js.last_onepass_trace)
    got = ts.sweep_extract_stream(problem.bs.words, problem.cls,
                                  device="cpu", **kw)
    _same_sweep(got, want)
    assert got[3].dtype == np.int32 and np.array_equal(got[3], want[3])
    assert np.array_equal(got[3], problem.jax(engine="xla").pairs)
    for key in ("bs", "g", "nbk", "word_chunk", "vcap", "steps", "uploads",
                "dispatch", "launches", "overflow", "pair_format"):
        assert ts.last_onepass_trace[key] == jtrace[key], key


def test_onepass_packed_pairs(problem):
    """pair_format="packed": the int64 list decodes to the canonical
    matrix, is sorted, equals the JAX package's packed list, and the
    helpers agree across packages."""
    kw = dict(n=problem.bs.n, threshold=THR, bs=32, block=16,
              pair_format="packed")
    want = js.sweep_extract_stream(problem.bs.words, problem.cls, **kw)[3]
    pairs = ts.sweep_extract_stream(problem.bs.words, problem.cls,
                                    device="cpu", **kw)[3]
    ref = problem.jax(engine="xla").pairs
    assert pairs.ndim == 1 and pairs.dtype == np.int64
    assert np.array_equal(pairs, want)
    assert np.array_equal(tsim.unpack_pairs(pairs), ref)
    assert tsim.unpack_pairs(pairs).dtype == np.int32
    assert np.array_equal(tsim.pairs_as_array(pairs), ref)
    assert tsim.pairs_as_array(ref) is ref
    assert np.all(np.diff(pairs) > 0)
    i, j, c = (int(v) for v in ref[len(ref) // 2])
    assert tsim.packed_key(i, j) == jpw.packed_key(i, j)
    p = int(np.searchsorted(pairs, tsim.packed_key(i, j)))
    assert tsim.packed_pair(pairs[p]) == jpw.packed_pair(pairs[p]) == (i, j, c)
    assert ts.last_onepass_trace["pair_format"] == "packed"


@pytest.mark.parametrize("pair_format", ["arr3", "packed"])
@pytest.mark.parametrize("cap", [8, 128])
def test_onepass_capacity_miss_redo(problem, pair_format, cap):
    """A capacity below the survivor count is detected from the sweep's
    exact total and the list redone by the grouped pass, never truncated;
    an explicit cap is honoured to 128 rows."""
    ref = problem.jax(engine="xla").pairs
    assert len(ref) > 128
    got = ts.sweep_extract_stream(
        problem.bs.words, problem.cls, n=problem.bs.n, threshold=THR, bs=32,
        block=16, cap=cap, pair_format=pair_format, device="cpu")[3]
    assert ts.last_onepass_trace["overflow"] is True
    assert ts.last_onepass_trace["vcap"] == 128
    assert got.ndim == (1 if pair_format == "packed" else 2)
    assert np.array_equal(tsim.pairs_as_array(got), ref)


def test_onepass_explicit_cap_granularity(problem):
    ref = problem.jax(engine="xla").pairs
    cap = len(ref) + 1
    got = ts.sweep_extract_stream(
        problem.bs.words, problem.cls, n=problem.bs.n, threshold=THR, bs=32,
        block=16, cap=cap, device="cpu")[3]
    assert ts.last_onepass_trace["vcap"] == -(-cap // 128) * 128
    assert ts.last_onepass_trace["overflow"] is False
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("cross_only,weighted,kw", [
    (False, False, {}),
    (True, True, {}),
    (True, False, dict(hbm_budget_bytes=1 << 20, inflight=1)),
], ids=["all-pairs", "weighted", "starved-budget"])
def test_onepass_gates_weights_and_budget(problem, cross_only, weighted, kw):
    wts = problem.weights if weighted else None
    kw = dict(kw, n=problem.bs.n, threshold=THR * 4, bs=32, block=16,
              weights=wts, cross_amr_only=cross_only)
    want = js.sweep_extract_stream(problem.bs.words, problem.cls, **kw)
    got = ts.sweep_extract_stream(problem.bs.words, problem.cls,
                                  device="cpu", **kw)
    _same_sweep(got, want)
    assert len(want[3]) > 0 and np.array_equal(got[3], want[3])
    assert ts.last_onepass_trace["g"] == js.last_onepass_trace["g"]


def test_onepass_multigroup_equals_single_group(problem):
    kw = dict(n=problem.bs.n, threshold=THR, bs=64, block=16, device="cpu")
    one = ts.sweep_extract_stream(problem.bs.words, problem.classes, **kw)
    many = ts.sweep_extract_stream(problem.bs.words, problem.classes,
                                   max_group=1, **kw)
    assert (ts.last_onepass_trace["g"], ts.last_onepass_trace["nbk"]) == (1, 3)
    _same_sweep(many, one)
    assert np.array_equal(many[3], one[3])
    assert np.array_equal(one[3], problem.jax(engine="xla").pairs)


def test_onepass_scan_dispatch_equals_steps(problem):
    """dispatch="scan" (a CSR source's "auto") and "steps" run the same
    steps: equal outputs for every chunk size, group size, capacity and
    pair format; "scan" probes less often; without a CSR source it is a
    contract error, with the JAX package's message."""
    src = ts.CSRBlockSource(problem.rows, problem.cols, problem.bs.n_pad,
                            problem.bs.w_pad)
    kw = dict(n=problem.bs.n, threshold=THR, bs=32, block=16,
              block_source=src, device="cpu")
    steps = ts.sweep_extract_stream(None, problem.classes, dispatch="steps",
                                    **kw)
    assert ts.last_onepass_trace["dispatch"] == "steps"
    assert ts.last_onepass_trace["launches"] == 15
    assert np.array_equal(steps[3], problem.jax(engine="xla").pairs)
    ts.sweep_extract_stream(None, problem.classes, **kw)
    assert ts.last_onepass_trace["dispatch"] == "scan"
    for chunk, mg in ((1, 1), (3, 2), (8, None), (64, None)):
        got = ts.sweep_extract_stream(None, problem.classes, dispatch="scan",
                                      scan_chunk=chunk, max_group=mg, **kw)
        tr = ts.last_onepass_trace
        assert tr["dispatch"] == "scan" and tr["launches"] <= tr["steps"]
        if chunk >= 8:
            assert tr["launches"] == 1 < tr["steps"] == 15
        _same_sweep(got, steps)
        assert np.array_equal(got[3], steps[3]), (chunk, mg)
    over = ts.sweep_extract_stream(None, problem.classes, dispatch="scan",
                                   cap=8, **kw)
    assert ts.last_onepass_trace["overflow"] is True
    assert np.array_equal(over[3], steps[3])
    packed = ts.sweep_extract_stream(None, problem.classes, dispatch="scan",
                                     pair_format="packed", **kw)[3]
    assert packed.ndim == 1
    assert np.array_equal(tsim.unpack_pairs(packed), steps[3])


def test_scan_dispatch_needs_a_block_source(problem):
    kw = dict(n=problem.bs.n, threshold=THR, bs=32, block=16,
              dispatch="scan")
    with pytest.raises(ValueError, match="scan") as terr:
        ts.sweep_extract_stream(problem.bs.words, problem.classes,
                                device="cpu", **kw)
    with pytest.raises(ValueError, match="scan") as jerr:
        js.sweep_extract_stream(problem.bs.words, problem.classes, **kw)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unknown dispatch"):
        ts.sweep_extract_stream(problem.bs.words, problem.classes,
                                device="cpu", **dict(kw, dispatch="chunks"))


# -- the pair buffers -------------------------------------------------------------

def _t(values):
    return torch.from_numpy(np.asarray(values, np.int32))


def test_packed_fetch_count_fallback():
    """A stored count ≥ 2^16 cannot pack: the fetch falls back to the
    [M, 3] format (never corrupts), as the JAX package's does."""
    bi, bj = _t([3, 1]), _t([5, 2])
    got = tpw._fetch_sorted_pairs(bi, bj, _t([1 << 16, 7]), 2, "packed",
                                  n_rows=10)
    assert got.ndim == 2 and got.dtype == np.int32
    assert np.array_equal(got, [[1, 2, 7], [3, 5, 1 << 16]])
    got = tpw._fetch_sorted_pairs(bi, bj, _t([(1 << 16) - 1, 7]), 2,
                                  "packed", n_rows=10)
    assert got.ndim == 1 and got.dtype == np.int64
    assert np.array_equal(tpw.unpack_pairs(got),
                          [[1, 2, 7], [3, 5, (1 << 16) - 1]])
    assert np.array_equal(jpw.unpack_pairs(got), tpw.unpack_pairs(got))


def test_packed_fetch_row_limit():
    """Row indices ≥ 2^23 would set the int64 sign bit at the i field:
    the pack refuses such corpora by their row bound and stays exact right
    up to it."""
    assert tpw._PACK_ROW_LIMIT == jpw._PACK_ROW_LIMIT == 1 << 23
    hi = tpw._PACK_ROW_LIMIT - 2
    bi, bj, bc = _t([hi, 1]), _t([hi + 1, 2]), _t([9, 7])
    got = tpw._fetch_sorted_pairs(bi, bj, bc, 2, "packed",
                                  n_rows=tpw._PACK_ROW_LIMIT)
    assert got.ndim == 2
    got = tpw._fetch_sorted_pairs(bi, bj, bc, 2, "packed",
                                  n_rows=tpw._PACK_ROW_LIMIT - 1)
    assert got.ndim == 1 and np.all(got > 0)
    assert np.array_equal(tpw.unpack_pairs(got),
                          [[1, 2, 7], [hi, hi + 1, 9]])
    assert tpw.packed_pair(tpw.packed_key(hi, hi + 1) | 9) == (hi, hi + 1, 9)


@pytest.mark.parametrize("total,space", [
    (0, None), (1, None), (16384, None), (16385, None), ((1 << 17) - 1, None),
    (1 << 17, None), (5_000_000, None), (70000, 50000), (0, 0)])
def test_vcap_bucket_is_the_jax_packages(total, space):
    assert tpw._vcap_bucket(total, space) == jpw._vcap_bucket(total, space)


def test_finalize_pairs_checks_the_cursor():
    gbi, gbj, gbc, cursor = tpw._new_pair_buffers(8, "cpu")
    assert cursor.dtype == torch.int64 and int(cursor) == 0
    assert (gbi == tpw._IMAX).all() and (gbc == -1).all()
    gbi[:2], gbj[:2], gbc[:2] = _t([4, 1]), _t([9, 3]), _t([5, 6])
    got = tpw._finalize_pairs((gbi, gbj, gbc, cursor + 2), 2)
    assert np.array_equal(got, [[1, 3, 6], [4, 9, 5]])
    with pytest.raises(AssertionError, match="promised 3"):
        tpw._finalize_pairs((gbi, gbj, gbc, cursor + 2), 3)
    assert tpw._finalize_pairs((gbi, gbj, gbc, cursor + 2), 2, "packed",
                               n_rows=16).ndim == 1
    assert tpw._finalize_pairs((gbi, gbj, gbc, cursor + 2), 2,
                               "packed").ndim == 2


def test_sort_compact_append_contract():
    """Survivors land contiguously at the cursor, the tail is sentinels,
    repeated appends chain, and a full window at cursor = vcap lands in
    the slack without touching valid rows: the JAX function's contract,
    fed the same windows."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    window, vcap = 64, 128
    tb = tpw._new_pair_buffers(vcap + window, "cpu")
    jb = jpw._new_pair_buffers(vcap + window)
    for _ in range(3):
        keep = rng.random((8, 8)) < 0.4
        gi, gj, c = (rng.integers(lo, 1000, (8, 8)).astype(np.int32)
                     for lo in (0, 0, 1))
        tb = ts.sort_compact_append(*tb, torch.from_numpy(keep), _t(gi),
                                    _t(gj), _t(c))
        jb = js.sort_compact_append(*jb, jnp.asarray(keep), jnp.asarray(gi),
                                    jnp.asarray(gj), jnp.asarray(c))
    n_kept = int(tb[3])
    assert n_kept == int(jb[3]) > 0

    def rows(bufs, k):
        return sorted(zip(*(np.asarray(b)[:k].tolist() for b in bufs[:3])))

    assert rows(tb, n_kept) == rows(jb, n_kept)
    for t, j in zip(tb[:3], jb[:3]):
        assert np.array_equal(t.numpy()[n_kept:], np.asarray(j)[n_kept:])
    assert (tb[0].numpy()[n_kept:] == tpw._IMAX).all()
    assert (tb[2].numpy()[n_kept:] == -1).all()

    # zero survivors: cursor and buffers unchanged
    before = [b.clone() for b in tb[:3]]
    zero = torch.zeros((8, 8), dtype=torch.int32)
    tb2 = ts.sort_compact_append(*tb, zero.bool(), zero, zero, zero)
    assert int(tb2[3]) == n_kept
    assert all(torch.equal(a, b) for a, b in zip(tb2[:3], before))

    # a full window at cursor = vcap lands in the slack
    gbi, gbj, gbc, cur = tpw._new_pair_buffers(vcap + window, "cpu")
    full = torch.ones((8, 8), dtype=torch.int32)
    gbi, gbj, gbc, cur = ts.sort_compact_append(
        gbi, gbj, gbc, cur + vcap, full.bool(), full * 7, full * 9, full * 3)
    assert int(cur) == vcap + window
    assert (gbi[vcap:] == 7).all() and (gbc[vcap:] == 3).all()
    assert (gbi[:vcap] == tpw._IMAX).all()


def test_sort_compact_append_past_the_buffers():
    """In a run that overflows the cursor walks past the buffers: the
    writes go to the last slot (no index error), earlier rows stay, and
    the cursor keeps the exact count."""
    gbi, gbj, gbc, cur = tpw._new_pair_buffers(16, "cpu")
    full = torch.ones((4, 4), dtype=torch.int32)
    for k in range(3):
        gbi, gbj, gbc, cur = ts.sort_compact_append(
            gbi, gbj, gbc, cur, full.bool(), full * (k + 1), full, full)
    assert int(cur) == 48
    assert (gbi[:15] == 1).all()


# -- the CSR block source ---------------------------------------------------------

def test_csr_blocks_match_pack_bitsets():
    """Device-materialized blocks equal the packed matrix's row slices bit
    for bit: two ranks of one protein in the same word (the add must
    accumulate), a rank ≡ 31 (mod 32) (the int32 sign bit), ragged and
    all-zero padding blocks; and equal the JAX source's blocks."""
    rng = np.random.default_rng(11)
    n, k = 150, 1200
    rows, cols = np.nonzero(rng.random((n, k)) < 0.06)
    extra = np.array([[0, 0], [0, 1], [0, 31], [0, 63], [5, 95], [5, 64],
                      [149, 1199], [149, 1183]])
    pairs = np.unique(np.concatenate(
        [np.stack([rows, cols], axis=1), extra]), axis=0)
    rows, cols = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    bs = tbitset.pack_bitsets(rows, cols, n, k, row_multiple=16,
                              word_multiple=128)
    assert bs.words[0, 0] & 0x80000003 == 0x80000003
    src = ts.CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad)
    jsrc = js.CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad)
    src.prepare(64, n_pad=192, device="cpu")
    jsrc.prepare(64, n_pad=192)
    assert src.staging_estimate == jsrc.staging_estimate
    for b in range(3):
        got = src.put(b)
        assert got.dtype == torch.int32 and tuple(got.shape) == (64, bs.w_pad)
        want = np.zeros((64, bs.w_pad), np.uint32)
        chunk = bs.words[b * 64 : (b + 1) * 64]
        want[: chunk.shape[0]] = chunk
        assert np.array_equal(got.numpy().view(np.uint32), want), b
        assert np.array_equal(np.asarray(jsrc.put(b)), want), b
    # unsorted incidence lists are sorted by protein first
    perm = rng.permutation(len(rows))
    shuffled = ts.CSRBlockSource(rows[perm], cols[perm], bs.n_pad, bs.w_pad)
    shuffled.prepare(32, device="cpu")
    assert np.array_equal(shuffled.put(2).numpy().view(np.uint32),
                          bs.words[64:96])


def test_split_incidence_blocks_is_the_jax_packages(problem):
    order = np.argsort(problem.rows, kind="stable")
    p, r = problem.rows[order], problem.cols[order]
    for bs_rows, nbk in ((64, 3), (16, 12), (160, 1)):
        for a, b in zip(ts.split_incidence_blocks(p, r, bs_rows, nbk),
                        js.split_incidence_blocks(p, r, bs_rows, nbk)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_source_equals_host_source(problem, weighted):
    """Every stream entry point gives the same result from either block
    source, weighted too, and equals the JAX package's CSR-sourced run;
    the capacity miss redoes through the grouped extractor from the
    source."""
    wts = problem.weights if weighted else None
    thr = THR * 6 if weighted else THR
    kw = dict(n=problem.bs.n, threshold=thr, bs=64, block=16, weights=wts)
    src = ts.CSRBlockSource(problem.rows, problem.cols, problem.bs.n_pad,
                            problem.bs.w_pad)
    jsrc = js.CSRBlockSource(problem.rows, problem.cols, problem.bs.n_pad,
                             problem.bs.w_pad)
    host = ts.sweep_mxu_stream(problem.bs.words, problem.classes,
                               device="cpu", **kw)
    csr = ts.sweep_mxu_stream(None, problem.classes, block_source=src,
                              device="cpu", **kw)
    _same_sweep(csr, host)
    assert ts.last_trace["upload_bytes"] == 0
    want = js.sweep_extract_stream(None, problem.classes, block_source=jsrc,
                                   max_group=1, **kw)
    jtrace = dict(js.last_onepass_trace)
    one = ts.sweep_extract_stream(None, problem.classes, block_source=src,
                                  max_group=1, device="cpu", **kw)
    _same_sweep(one, want)
    _same_sweep(one, host)
    assert len(want[3]) > 128 and np.array_equal(one[3], want[3])
    for key in ("bs", "g", "word_chunk", "vcap", "steps", "uploads",
                "dispatch", "launches"):
        assert ts.last_onepass_trace[key] == jtrace[key], key
    over = ts.sweep_extract_stream(None, problem.classes, block_source=src,
                                   cap=128, device="cpu", **kw)
    assert ts.last_onepass_trace["overflow"] is True
    assert np.array_equal(over[3], want[3])
    grouped = ts.extract_pairs_stream_grouped(
        None, problem.classes, host[1], host[2], n=problem.bs.n,
        threshold=thr, weights=wts, block_source=src, device="cpu")
    assert np.array_equal(grouped, want[3])


class _Index:
    """The three members of a KmerIndex that the csr path reads."""

    has_incidences = True

    def __init__(self, rows, cols):
        self.incidence_protein, self.incidence_rank = rows, cols


def test_csr_via_config(problem):
    """stream_source='csr' through the production dispatch equals the
    host-words stream engine; the gates raise as the JAX package's."""
    idx = _Index(problem.rows, problem.cols)
    cfg = PipelineConfig(engine="stream", extract="onepass",
                         stream_source="csr", **BASE)
    got = tpw.pairwise_similarity(problem.bs, problem.classes, cfg,
                                  index=idx, device="cpu")
    _check_same(got, problem.jax(engine="xla"))
    _check_same(got, jpw.pairwise_similarity(problem.bs, problem.classes,
                                             cfg, index=idx))
    cfg = PipelineConfig(engine="stream", stream_source="csr", **BASE)
    with pytest.raises(ValueError, match="incidence") as terr:
        tpw.pairwise_similarity(problem.bs, problem.classes, cfg,
                                device="cpu")
    with pytest.raises(ValueError, match="incidence") as jerr:
        jpw.pairwise_similarity(problem.bs, problem.classes, cfg)
    assert str(terr.value) == str(jerr.value)


# -- checkpoints: kill and resume -------------------------------------------------

CKPT = dict(bs=16, block=16, max_group=1)


def _stores(tmp_path):
    return {"jax": (js, jckpt.CheckpointStore(str(tmp_path)), {}),
            "torch": (ts, tckpt.CheckpointStore(str(tmp_path)),
                      dict(device="cpu"))}


@pytest.mark.parametrize("writer,reader", [
    ("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
@pytest.mark.parametrize("mode", ["plain", "weighted-packed"])
def test_kill_and_resume_across_packages(problem, tmp_path, writer, reader,
                                         mode):
    """One package sweeps two stationary groups and is killed
    (fail_after_groups); the other resumes from its snapshot with its own
    CheckpointStore, skips the completed groups and returns the
    uninterrupted run's stats, tile hits and pair list; the completed run
    removes the snapshot."""
    kw = dict(CKPT, n=problem.bs.n, threshold=THR)
    if mode == "weighted-packed":
        kw.update(weights=problem.weights, threshold=THR * 6,
                  pair_format="packed")
    want = ts.sweep_extract_stream(problem.bs.words, problem.cls,
                                   device="cpu", **kw)
    assert len(want[3]) > 0
    stores = _stores(tmp_path)
    wmod, wstore, wkw = stores[writer]
    with pytest.raises(RuntimeError, match="fault injection"):
        wmod.sweep_extract_stream(
            problem.bs.words, problem.cls, checkpoint_store=wstore,
            checkpoint_key="stream-test", fail_after_groups=2, **kw, **wkw)
    rmod, rstore, rkw = stores[reader]
    snap = rstore.load("stream-test")
    assert snap is not None and list(snap["groups_done"]) == [0, 1]
    assert set(snap) == {"geometry", "groups_done", "row_stats",
                         "block_hits"}
    got = rmod.sweep_extract_stream(
        problem.bs.words, problem.cls, checkpoint_store=rstore,
        checkpoint_key="stream-test", **kw, **rkw)
    assert rmod.last_onepass_trace["groups_skipped"] == 2
    _same_sweep(got, want)
    assert got[3].dtype == want[3].dtype and np.array_equal(got[3], want[3])
    assert rstore.load("stream-test") is None
    assert os.listdir(tmp_path) == []


def test_snapshot_is_the_jax_packages(problem, tmp_path):
    """The two packages write the same snapshot for the same interrupted
    run: names, dtypes and values, the geometry with the weights' crc32."""
    kw = dict(CKPT, n=problem.bs.n, threshold=THR * 6,
              weights=problem.weights, checkpoint_key="k",
              fail_after_groups=3)
    snaps = []
    for name in ("jax", "torch"):
        mod, store, extra = _stores(tmp_path / name)[name]
        with pytest.raises(RuntimeError, match="killed after 3"):
            mod.sweep_extract_stream(problem.bs.words, problem.cls,
                                     checkpoint_store=store, **kw, **extra)
        snaps.append(store.load("k"))
    assert set(snaps[0]) == set(snaps[1])
    for key in snaps[0]:
        assert snaps[0][key].dtype == snaps[1][key].dtype, key
        assert np.array_equal(snaps[0][key], snaps[1][key]), key
    assert snaps[1]["geometry"][-1] != 0


def test_resume_ignores_another_geometry_and_other_weights(problem, tmp_path):
    store = tckpt.CheckpointStore(str(tmp_path))
    kw = dict(CKPT, n=problem.bs.n, threshold=THR, device="cpu",
              checkpoint_store=store, checkpoint_key="k")
    want = ts.sweep_extract_stream(problem.bs.words, problem.cls,
                                   **dict(kw, checkpoint_store=None))
    for change in (dict(bs=32), dict(weights=problem.weights),
                   dict(threshold=THR + 1)):
        with pytest.raises(RuntimeError, match="fault injection"):
            ts.sweep_extract_stream(problem.bs.words, problem.cls,
                                    fail_after_groups=1, **kw)
        assert store.load("k") is not None
        other = dict(kw, **change)
        got = ts.sweep_extract_stream(problem.bs.words, problem.cls, **other)
        assert "groups_skipped" not in ts.last_onepass_trace
        fresh = ts.sweep_extract_stream(
            problem.bs.words, problem.cls,
            **dict(other, checkpoint_store=None))
        _same_sweep(got, fresh)
        assert np.array_equal(got[3], fresh[3])
        assert store.load("k") is None
    assert np.array_equal(
        ts.sweep_extract_stream(problem.bs.words, problem.cls, **kw)[3],
        want[3])


def test_resume_through_the_csr_source(problem, tmp_path):
    store = tckpt.CheckpointStore(str(tmp_path))
    src = ts.CSRBlockSource(problem.rows, problem.cols, problem.bs.n_pad,
                            problem.bs.w_pad)
    kw = dict(CKPT, n=problem.bs.n, threshold=THR, block_source=src,
              device="cpu")
    want = ts.sweep_extract_stream(None, problem.cls, **kw)
    with pytest.raises(RuntimeError, match="fault injection"):
        ts.sweep_extract_stream(None, problem.cls, checkpoint_store=store,
                                checkpoint_key="k", fail_after_groups=4, **kw)
    got = ts.sweep_extract_stream(None, problem.cls, checkpoint_store=store,
                                  checkpoint_key="k", **kw)
    assert ts.last_onepass_trace["groups_skipped"] == 4
    _same_sweep(got, want)
    assert np.array_equal(got[3], want[3])
    assert np.array_equal(got[3], problem.jax(engine="xla").pairs)


# -- pipeline and CLI ------------------------------------------------------------

def _cli_outputs(out):
    with open(os.path.join(out, "stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(out, "pairs.tsv"), "rb") as f:
        pairs = f.read()
    with open(os.path.join(out, "clusters.tsv"), "rb") as f:
        clusters = f.read()
    return stats, pairs, clusters


@pytest.mark.parametrize("extra", [
    [],
    ["--stream-source", "csr"],
    ["--extract", "onepass", "--all-pairs", "--threshold", "3"],
    ["--extract", "fused", "--extract-k", "4"],
    ["--weighting", "blosum62", "--stream-source", "csr"],
], ids=["two-pass", "csr", "onepass-all-pairs", "fused-k4", "csr-weighted"])
def test_cli_stream_matches_jax_cli(toy_fasta, tmp_path, extra):
    """`cli run --engine stream` with each of its flags writes the JAX
    CLI's pairs.tsv and clusters.tsv bytes and parity counters."""
    from uniprot_kmer_based_clustering_tpu.cli import main as jmain
    from uniprot_kmer_based_clustering_tpu_torch.cli import main as tmain

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jmain(["run", toy_fasta, "--cpu", "--engine", "stream", "--out",
                  jout, *extra]) == 0
    assert tmain(["run", toy_fasta, "--device", "cpu", "--engine", "stream",
                  "--out", tout, *extra]) == 0
    js_, jp, jc = _cli_outputs(jout)
    ts_, tp, tc = _cli_outputs(tout)
    assert tp == jp and tc == jc
    assert ts_["parity"] == js_["parity"] and ts_["clusters"] == js_["clusters"]
    assert ts_["parity"]["pairs_over_threshold"] > 0
    assert ts_["config"]["stream_source"] == js_["config"]["stream_source"]


@pytest.fixture(scope="module")
def synth_fasta(tmp_path_factory):
    """bench_scale's template-mutation corpus, 400 proteins."""
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(400, seed=5)
    path = tmp_path_factory.mktemp("synth") / "synth.fasta"
    with open(path, "w") as f:
        for i in range(400):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    return str(path)


@pytest.fixture(scope="module")
def synth_ref(synth_fasta):
    return jcluster_fasta(synth_fasta, engine="stream", tile=64, strip=128)


@pytest.mark.parametrize("kw", [
    dict(), dict(extract="fused"), dict(extract="onepass"),
    dict(stream_source="csr"),
], ids=["two-pass", "fused", "onepass", "packless-csr"])
def test_pipeline_stream_on_a_synthetic_corpus(synth_fasta, synth_ref, kw):
    """400 synth_proteins, tile 64, 4 stream blocks of 128 rows: every
    stream mode of run_pipeline equals the JAX pipeline on the stream
    engine; the csr run never builds the dense matrix."""
    got = cluster_fasta(synth_fasta, device="cpu", engine="stream", tile=64,
                        strip=128, **kw)
    assert got.parity_report() == synth_ref.parity_report()
    assert got.parity_report()["pairs_over_threshold"] > 100
    assert np.array_equal(got.pairwise.pairs, synth_ref.pairwise.pairs)
    assert np.array_equal(got.cluster_labels, synth_ref.cluster_labels)
    assert list(got.timings) == ["ingest", "encode", "index", "pack",
                                 "sweep", "cluster"]
    virtual = isinstance(got.bitset, tbitset.VirtualBitsetMatrix)
    assert virtual == (kw.get("stream_source") == "csr")
    assert (got.bitset.n_pad, got.bitset.w_pad) == (
        synth_ref.bitset.n_pad, synth_ref.bitset.w_pad)


def test_packless_bitset_raises_on_the_dense_path(toy_fasta):
    """The packless run's bitset carries the geometry only: the JAX
    package's VirtualBitsetMatrix dimensions, and any touch of the words
    raises."""
    from uniprot_kmer_based_clustering_tpu.kmers.bitset import (
        VirtualBitsetMatrix as JVirtual,
    )

    got = cluster_fasta(toy_fasta, device="cpu", engine="stream",
                        stream_source="csr", threshold=3, tile=16)
    ref = cluster_fasta(toy_fasta, device="cpu", engine="mxu", threshold=3,
                        tile=16)
    assert isinstance(got.bitset, tbitset.VirtualBitsetMatrix)
    assert np.array_equal(got.pairwise.pairs, ref.pairwise.pairs)
    assert got.parity_report() == ref.parity_report()
    for n, bits, rm in ((60, 700, 16), (1, 1, 512), (10619, 231253, 3584)):
        t = tbitset.VirtualBitsetMatrix.make(n, bits, row_multiple=rm)
        j = JVirtual.make(n, bits, row_multiple=rm)
        assert (t.n, t.n_bits, t.n_pad, t.w_pad) == (j.n, j.n_bits, j.n_pad,
                                                     j.w_pad)
    with pytest.raises(RuntimeError, match="never materialized"):
        got.bitset.words.shape
    with pytest.raises(RuntimeError, match="never materialized"):
        got.bitset.words[0]
    with pytest.raises(RuntimeError, match="never materialized"):
        got.bitset.row_bits(0)


def test_stream_run_without_checkpoint_dir_writes_no_snapshot(
        toy_fasta, monkeypatch):
    """With no checkpoint directory the one-pass sweep is handed no store:
    no boundary fetch, no save, nothing to remove."""
    seen = []
    real = ts.sweep_extract_stream

    def spy(*a, **k):
        seen.append((k["checkpoint_store"], k["checkpoint_key"]))
        return real(*a, **k)

    monkeypatch.setattr(ts, "sweep_extract_stream", spy)
    cluster_fasta(toy_fasta, device="cpu", engine="stream",
                  extract="onepass", threshold=3, tile=16)
    assert seen == [(None, None)]
    assert "ckpt_s" not in ts.last_onepass_trace


def test_stream_run_with_checkpoint_dir_keeps_progress(toy_fasta, tmp_path,
                                                       monkeypatch):
    """With a checkpoint directory the progress goes under the JAX
    pipeline's sub-key of the pairs artifact; a killed run leaves it, the
    rerun resumes from it and removes it, and the JAX pipeline then
    resumes from the finished artifact."""
    cfg = PipelineConfig(engine="stream", extract="onepass", threshold=3,
                         tile=16, strip=16)
    real = ts.sweep_extract_stream
    monkeypatch.setattr(
        ts, "sweep_extract_stream",
        lambda *a, **k: real(*a, max_group=1, fail_after_groups=2, **k))
    with pytest.raises(RuntimeError, match="fault injection"):
        tpl.run_pipeline(toy_fasta, cfg, checkpoint_dir=str(tmp_path),
                         device="cpu")
    fingerprint = tpl._fasta_fingerprint(toy_fasta)
    progress = cfg.cache_key("pairs", fingerprint) + "-stream-progress.npz"
    assert progress in os.listdir(tmp_path)
    monkeypatch.setattr(ts, "sweep_extract_stream",
                        lambda *a, **k: real(*a, max_group=1, **k))
    got = tpl.run_pipeline(toy_fasta, cfg, checkpoint_dir=str(tmp_path),
                           device="cpu")
    assert ts.last_onepass_trace["groups_skipped"] == 2
    assert progress not in os.listdir(tmp_path)
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline as jrun

    again = jrun(toy_fasta, cfg, checkpoint_dir=str(tmp_path))
    assert "sweep" not in again.timings
    assert np.array_equal(again.pairwise.pairs, got.pairwise.pairs)
    ref = tpl.run_pipeline(toy_fasta, dataclasses.replace(cfg, engine="mxu",
                                                          extract="auto",
                                                          strip=None),
                           device="cpu")
    assert np.array_equal(got.pairwise.pairs, ref.pairwise.pairs)
    assert len(ref.pairwise.pairs) > 0
