"""Parity of the port's pairwise stage (similarity/pairwise.py) with the
JAX package's ``pairwise_similarity`` on the toy FASTA: the mxu engine
(strip and scan schedules, two-pass and fused extraction) and the
popcount engines.

Tolerance: exact equality of the (i, j, count) pair list in (i, j) order
and of every PairwiseResult field.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.io.fasta import read_fasta
from uniprot_kmer_based_clustering_tpu.kmers import (
    build_index,
    encode_kmers,
    pack_bitsets,
)
from uniprot_kmer_based_clustering_tpu.similarity import pairwise as jpw
from uniprot_kmer_based_clustering_tpu.utils.blosum import rank_weights_int8
from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul as tbm
from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise as tpw

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def toy(toy_fasta):
    """Index + bitset of the toy FASTA at 64 rows: tile 16, strip 32 give
    2 strips and 10 upper-triangle tiles."""
    table = read_fasta(toy_fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    index = build_index(codes, koff, 5)
    bitset = pack_bitsets(
        index.incidence_protein, index.incidence_rank, table.n,
        index.n_repeated, row_multiple=32,
    )
    weights = rank_weights_int8(index.repeated_codes, 5, bitset.w_pad * 32)
    return table, index, bitset, weights


CASES = [
    dict(threshold=10, cross_amr_only=True),
    dict(threshold=10, cross_amr_only=False),
    dict(threshold=0, cross_amr_only=True),
    dict(threshold=0, cross_amr_only=False),
    dict(threshold=10, cross_amr_only=True, weighting="blosum62"),
    dict(threshold=10, cross_amr_only=False, weighting="blosum62"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_pairwise_mxu_matches_jax(toy, case):
    table, _, bitset, weights = toy
    cfg = PipelineConfig(engine="mxu", tile=16, strip=32, **case)
    w = weights if cfg.weighting == "blosum62" else None
    want = jpw.pairwise_similarity(bitset, table.amr_class_ids, cfg,
                                   weights=w)
    got = tpw.pairwise_similarity(bitset, table.amr_class_ids, cfg,
                                  weights=w, device=CPU)
    assert got.pairs.dtype == np.int32 and got.pairs.shape[1] == 3
    assert len(got.pairs) > 0
    assert np.array_equal(want.pairs, got.pairs)
    for f in dataclasses.fields(want):
        if f.name != "pairs":
            assert getattr(want, f.name) == getattr(got, f.name), f.name
    assert want.parity_counters() == got.parity_counters()


def test_extract_pairs_matches_jax_and_checks_total(toy):
    """Pass 2 alone, fed the same sweep outputs; an overstated hit count
    must raise instead of returning a short list."""
    table, _, bitset, _ = toy
    classes = np.full(bitset.n_pad, -1, np.int32)
    classes[: table.n] = table.amr_class_ids
    words = torch.from_numpy(bitset.words.view(np.int32))
    from uniprot_kmer_based_clustering_tpu_torch.ops.bitmul import sweep_mxu

    _, th, tiles = sweep_mxu(words, torch.from_numpy(classes), table.n, 4,
                             strip=32, block=16)
    want = jpw.extract_pairs(bitset.words, classes, th, tiles, table.n, 4)
    got = tpw.extract_pairs(words, classes, th, tiles, table.n, 4)
    assert len(got) > 0
    assert np.array_equal(want, got)
    # length-n classes are padded like the JAX extractor's
    got_n = tpw.extract_pairs(words, table.amr_class_ids, th, tiles,
                              table.n, 4)
    assert np.array_equal(want, got_n)
    # every other hit tile dropped: the runs of adjacent hit tiles break
    # up, and only the kept tiles' pairs come back
    gaps = th.copy()
    gaps[np.nonzero(gaps[:, 0])[0][::2]] = 0
    want_g = jpw.extract_pairs(bitset.words, classes, gaps, tiles, table.n, 4)
    got_g = tpw.extract_pairs(words, classes, gaps, tiles, table.n, 4)
    assert 0 < len(got_g) < len(got)
    assert np.array_equal(want_g, got_g)
    bad = th.copy()
    bad[np.argmax(bad[:, 0]), 0] += 1
    with pytest.raises(AssertionError, match="promised"):
        tpw.extract_pairs(words, classes, bad, tiles, table.n, 4)


def test_auto_engine_on_cpu_matches_mxu(toy):
    """auto on the CPU takes the native C++ sweep when built, as the JAX
    package does; it must agree with the mxu engine bit for bit, weighted
    too (through the sparse sweep)."""
    table, index, bitset, weights = toy
    for w, wt in ((None, "none"), (weights, "blosum62")):
        base = dict(tile=16, strip=32, threshold=4, weighting=wt)
        auto = tpw.pairwise_similarity(
            bitset, table.amr_class_ids, PipelineConfig(**base),
            weights=w, index=index, device=CPU,
        )
        mxu = tpw.pairwise_similarity(
            bitset, table.amr_class_ids,
            PipelineConfig(engine="mxu", **base), weights=w, device=CPU,
        )
        assert len(mxu.pairs) > 0
        assert np.array_equal(auto.pairs, mxu.pairs)
        for f in dataclasses.fields(mxu):
            if f.name != "pairs":
                assert getattr(auto, f.name) == getattr(mxu, f.name), f.name


@pytest.mark.parametrize("engine", ["popcount", "xla"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_pairwise_popcount_engines_match_jax(toy, engine, case):
    """The popcount engines (the plain sweep on the CPU, at config.tile)
    against the JAX package's; weighted runs move to mxu in both."""
    table, _, bitset, weights = toy
    cfg = PipelineConfig(engine=engine, tile=16, **case)
    w = weights if cfg.weighting == "blosum62" else None
    want = jpw.pairwise_similarity(bitset, table.amr_class_ids, cfg,
                                   weights=w)
    got = tpw.pairwise_similarity(bitset, table.amr_class_ids, cfg,
                                  weights=w, device=CPU)
    assert len(got.pairs) > 0
    assert np.array_equal(want.pairs, got.pairs)
    for f in dataclasses.fields(want):
        if f.name != "pairs":
            assert getattr(want, f.name) == getattr(got, f.name), f.name


@pytest.fixture(scope="module")
def toy_scan(toy_fasta):
    """The toy FASTA packed to 160 rows: tile 16 and strip 16 give 10
    strips, so the schedule resolves to the scan and fused extraction
    runs."""
    table = read_fasta(toy_fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    index = build_index(codes, koff, 5)
    bitset = pack_bitsets(
        index.incidence_protein, index.incidence_rank, table.n,
        index.n_repeated, row_multiple=160,
    )
    return table, bitset


@pytest.mark.parametrize("extract_k", [0, 2])
@pytest.mark.parametrize("case", CASES[:4], ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_pairwise_fused_matches_jax(toy_scan, case, extract_k):
    """extract='fused' on the scan schedule, auto-sized and with a
    capacity of 2 (overflow redo), against the JAX package."""
    table, bitset = toy_scan
    cfg = PipelineConfig(engine="mxu", tile=16, strip=16, extract="fused",
                         extract_k=extract_k, **case)
    assert tbm.resolve_schedule(bitset.n_pad, 16, 16) == ("scan", 16, 10)
    want = jpw.pairwise_similarity(bitset, table.amr_class_ids, cfg)
    got = tpw.pairwise_similarity(bitset, table.amr_class_ids, cfg,
                                  device=CPU)
    assert len(got.pairs) > 0
    assert np.array_equal(want.pairs, got.pairs)
    assert want.parity_counters() == got.parity_counters()


def test_auto_schedule_resolves_to_scan_above_eight_strips():
    """An auto config with ns > 8 (tile 16, strip 32 over 320 rows) runs
    the scan in both packages, with K2's plain version on the CPU; the
    fused and two-pass lists agree."""
    rng = np.random.default_rng(21)
    n, k = 300, 900
    rows, cols = np.nonzero(rng.random((n, k)) < 0.08)
    bs = pack_bitsets(rows.astype(np.int32), cols.astype(np.int32), n, k,
                      row_multiple=32, word_multiple=128)
    classes = rng.integers(0, 3, n).astype(np.int32)
    assert tbm.resolve_schedule(bs.n_pad, 16, 32) == ("scan", 32, 10)
    base = dict(threshold=3, tile=16, strip=32, engine="mxu")
    want = jpw.pairwise_similarity(bs, classes, PipelineConfig(**base))
    for extract in ("two_pass", "fused"):
        got = tpw.pairwise_similarity(
            bs, classes, PipelineConfig(extract=extract, **base), device=CPU
        )
        assert len(got.pairs) > 0
        assert np.array_equal(want.pairs, got.pairs)
        assert want.parity_counters() == got.parity_counters()


def _dense_problem(seed=5, n_pad=128, w=8, n=120):
    """tests/test_fused_extract.py's near-identical rows: every tile
    reports hits."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, size=w, dtype=np.uint32)
    words = np.tile(base, (n_pad, 1))
    flip = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words ^= np.where(rng.random((n_pad, w)) < 0.05, flip, 0).astype(np.uint32)
    words[n:] = 0
    classes = rng.integers(0, 3, size=n_pad).astype(np.int32)
    classes[n:] = -1
    return words, classes


@pytest.mark.parametrize("seed,fused_k,same", [
    (5, 256, False),    # k = block²: no sub-tile can overflow
    (5, 96, False),     # some sub-tiles overflow and are redone
    (9, 8, True),       # same-class pairs too, mostly redone
    (3, 100000, False), # clamped to block²
])
def test_fused_extraction_matches_jax(seed, fused_k, same):
    """The fused scan sweep (strip 32, block 16) and extract_pairs_fused
    against the JAX pair and against the port's two-pass list. The final
    list is sorted by (i, j) whatever torch.topk's tie order."""
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
        sweep_mxu as jsweep,
    )

    words, classes = _dense_problem(seed)
    kw = dict(strip=32, block=16, schedule="scan", fused_k=fused_k,
              fused_same=same)
    rs_j, th_j, tiles_j, c_j = jsweep(jnp.asarray(words),
                                      jnp.asarray(classes), 120, 40, **kw)
    want = jpw.extract_pairs_fused(jnp.asarray(words), classes, th_j,
                                   tiles_j, c_j, n=120, threshold=40,
                                   cross_amr_only=not same)
    t_words = torch.from_numpy(words.view(np.int32))
    rs_t, th_t, tiles_t, c_t = tbm.sweep_mxu(
        t_words, torch.from_numpy(classes), 120, 40, **kw
    )
    assert c_t.k == c_j.k == min(fused_k, 256)
    assert c_t.bc.shape == (10, 4, c_t.k)  # 4 strips → 10 steps
    assert np.array_equal(rs_j, rs_t) and np.array_equal(th_j, th_t)
    hits = th_t[:, 0] + (th_t[:, 1] if same else 0)
    if fused_k == 96:
        assert (hits > 96).any() and ((hits > 0) & (hits <= 96)).any()
    got = tpw.extract_pairs_fused(t_words, classes, th_t, tiles_t, c_t,
                                  n=120, threshold=40,
                                  cross_amr_only=not same)
    two_pass = tpw.extract_pairs(t_words, classes, th_t, tiles_t, n=120,
                                 threshold=40, cross_amr_only=not same)
    assert len(got) > 0
    assert np.array_equal(want, got)
    assert np.array_equal(two_pass, got)
    key = got[:, 0].astype(np.int64) * 128 + got[:, 1]
    assert (np.diff(key) > 0).all()
    with pytest.raises(ValueError, match="other gate"):
        tpw.extract_pairs_fused(t_words, classes, th_t, tiles_t, c_t,
                                n=120, threshold=40, cross_amr_only=same)


@pytest.mark.parametrize("same", [False, True])
def test_fused_plain_epilogue_matches_kernel_route(same):
    """Explicit stats_engine='xla' with fused extraction gives the same
    statistics, candidates and final pair list as 'auto' (K2's route)."""
    words, classes = _dense_problem(7)
    t_words = torch.from_numpy(words.view(np.int32))
    kw = dict(strip=32, block=16, schedule="scan", fused_k=96,
              fused_same=same)
    runs = [tbm.sweep_mxu(t_words, torch.from_numpy(classes), 120, 40,
                          stats_engine=engine, **kw)
            for engine in ("auto", "xla")]
    (rs_a, th_a, _, c_a), (rs_x, th_x, tiles, c_x) = runs
    assert np.array_equal(rs_a, rs_x) and np.array_equal(th_a, th_x)
    for name in ("bi", "bj", "bc"):
        assert torch.equal(getattr(c_a, name), getattr(c_x, name))
    got = tpw.extract_pairs_fused(t_words, classes, th_x, tiles, c_x,
                                  n=120, threshold=40,
                                  cross_amr_only=not same)
    want = tpw.extract_pairs(t_words, classes, th_x, tiles, n=120,
                             threshold=40, cross_amr_only=not same)
    assert len(got) > 0 and np.array_equal(want, got)


def test_fused_compaction_checks_total():
    """A candidate lost from the buffers must raise, not shorten the
    list."""
    words, classes = _dense_problem()
    t_words = torch.from_numpy(words.view(np.int32))
    _, th, tiles, cands = tbm.sweep_mxu(
        t_words, torch.from_numpy(classes), 120, 40, strip=32, block=16,
        schedule="scan", fused_k=256,
    )
    cands.bc[0, 1, :] = -1
    with pytest.raises(AssertionError, match="promised"):
        tpw.extract_pairs_fused(t_words, classes, th, tiles, cands, n=120,
                                threshold=40)


def test_extract_pairs_in_windows_matches_whole(toy, monkeypatch):
    """Unpacking the bit matrix in row windows (forced small here, as at
    the 30,000-protein scale) gives the same pair list, weighted too."""
    table, _, bitset, weights = toy
    classes = np.full(bitset.n_pad, -1, np.int32)
    classes[: table.n] = table.amr_class_ids
    words = torch.from_numpy(bitset.words.view(np.int32))
    for w in (None, weights):
        _, th, tiles = tbm.sweep_mxu(words, torch.from_numpy(classes),
                                     table.n, 2, strip=32, block=16,
                                     weights=w)
        whole = tpw.extract_pairs(words, classes, th, tiles, table.n, 2,
                                  cross_amr_only=False, weights=w)
        monkeypatch.setattr(tpw, "_UNPACK_WINDOW_BYTES",
                            16 * bitset.w_pad * 32)
        assert tpw._window_rows(bitset.n_pad, 16, bitset.w_pad * 32) == 16
        windowed = tpw.extract_pairs(words, classes, th, tiles, table.n, 2,
                                     cross_amr_only=False, weights=w)
        monkeypatch.undo()
        assert len(whole) > 0
        assert np.array_equal(whole, windowed)


@pytest.mark.parametrize("knob,raises,match", [
    (dict(engine="stream", tile=16), None, None),
    (dict(engine="mxu", extract="onepass"), ValueError,
     "stream-engine mode"),
    (dict(engine="mxu", tile=16, strip=32, index_engine="device"), None,
     None),
])
def test_unported_knobs_raise(toy, knob, raises, match):
    """Knobs refused until they were ported now run and give the JAX
    result (the stream engine; a config naming the device index build,
    whose bitset the sweep takes like any other); the one-pass mode on any
    other engine raises the JAX package's ValueError. Every case names
    its engine: "auto" resolves on the CPU by whether the JAX package's
    native library loaded, which the port cannot follow."""
    table, _, bitset, _ = toy
    cfg = PipelineConfig(**knob)
    if raises is None:
        want = jpw.pairwise_similarity(bitset, table.amr_class_ids, cfg)
        got = tpw.pairwise_similarity(bitset, table.amr_class_ids, cfg,
                                      device=CPU)
        assert len(got.pairs) > 0 and np.array_equal(got.pairs, want.pairs)
        return
    with pytest.raises(raises, match=match) as err:
        tpw.pairwise_similarity(bitset, table.amr_class_ids, cfg, device=CPU)
    if raises is ValueError:
        with pytest.raises(ValueError) as jerr:
            jpw.pairwise_similarity(bitset, table.amr_class_ids, cfg)
        assert str(err.value) == str(jerr.value)
