"""Extraction from the survivors the K1 epilogue appends on the strip
schedule (``ops.stats.stats_from_counts_into(pairs=)``,
``sweep_mxu(append=True)``, ``similarity.pairwise.extract_pairs(
appended=)``), on the CPU at 300 proteins: 5 strips of 64
rows, tile 16.

The route's ``PairwiseResult`` equals ``extract="two_pass"``'s and the
JAX package's, pair for pair and counter for counter, within the
buffers' capacity and beyond it (two-pass then); K1 appends on the
strip schedule and on every mesh layout's sweep (once a sub-step or
strip; ``tests/test_torch_sharded.py`` holds that route), and no other
path asks it for survivors: the scan, the plain epilogue, the popcount
engines and the stream engine run K1 and K2 without the append.

Tolerance: exact equality of the (i, j, count) pair list in (i, j) order
and of every PairwiseResult field.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.config import (
    PipelineConfig as JaxConfig,
)
from uniprot_kmer_based_clustering_tpu.io.fasta import read_fasta
from uniprot_kmer_based_clustering_tpu.kmers import (
    build_index,
    encode_kmers,
    pack_bitsets,
)
from uniprot_kmer_based_clustering_tpu.similarity import pairwise as jpw
from uniprot_kmer_based_clustering_tpu.utils.blosum import rank_weights_int8
from uniprot_kmer_based_clustering_tpu_torch.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.ops import bitmul as tbm
from uniprot_kmer_based_clustering_tpu_torch.ops import stats
from uniprot_kmer_based_clustering_tpu_torch.ops.pairlist import pairs_as_array
from uniprot_kmer_based_clustering_tpu_torch.parallel import mesh as tmesh
from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded as tsh
from uniprot_kmer_based_clustering_tpu_torch.pipeline import (
    _sharded_similarity,
)
from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise as tpw

N = 300
STRIPS = dict(engine="mxu", tile=16, strip=64, threshold=2)
N_STRIPS = 5  # 320 padded rows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """bench_scale's template-mutation corpus, packed by the JAX package
    on 64-row padding: (table, index, bitset, BLOSUM weights)."""
    from bench_scale import synth_proteins

    seq_buf, offsets, classes = synth_proteins(N, seed=3)
    path = tmp_path_factory.mktemp("epilogue") / "synth.fasta"
    with open(path, "w") as f:
        for i in range(N):
            seq = seq_buf[offsets[i] : offsets[i + 1]].tobytes().decode()
            f.write(f">S{i:05d}|FEATURES|UNIPROT|c{classes[i]}|g{i}\n{seq}\n")
    table = read_fasta(str(path))
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    index = build_index(codes, koff, 5)
    bitset = pack_bitsets(
        index.incidence_protein, index.incidence_rank, table.n,
        index.n_repeated, row_multiple=64,
    )
    assert bitset.n_pad == N_STRIPS * STRIPS["strip"]
    weights = rank_weights_int8(index.repeated_codes, 5, bitset.w_pad * 32)
    return table, index, bitset, weights


@pytest.fixture
def appends(monkeypatch):
    """The global row offsets of the blocks whose survivors were
    appended: on CPU tensors K1's plain version appends through
    ``ops.stats.append_survivors_reference``, whichever path calls it."""
    calls = []
    real = stats.append_survivors_reference

    def counted(*args, **kw):
        calls.append(kw["i_off"])
        return real(*args, **kw)

    monkeypatch.setattr(stats, "append_survivors_reference", counted)
    return calls


_JAX = {}


def _jax(corpus, weighting, gate):
    """The JAX package's answer, once a (weighting, gate)."""
    key = (weighting, gate)
    if key not in _JAX:
        table, _, bitset, weights = corpus
        cfg = JaxConfig(**STRIPS, weighting=weighting, cross_amr_only=gate)
        _JAX[key] = jpw.pairwise_similarity(
            bitset, table.amr_class_ids, cfg,
            weights=weights if weighting == "blosum62" else None,
        )
    return _JAX[key]


def _port(corpus, weighting, gate, extract):
    table, _, bitset, weights = corpus
    cfg = PipelineConfig(**STRIPS, weighting=weighting, cross_amr_only=gate,
                         extract=extract)
    r = tpw.pairwise_similarity(
        bitset, table.amr_class_ids, cfg,
        weights=weights if weighting == "blosum62" else None, device="cpu",
    )
    return r, dict(tpw.last_trace)


def _assert_same(got, want):
    assert np.array_equal(got.pairs, want.pairs)
    for f in dataclasses.fields(want):
        if f.name != "pairs":
            assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("route", ["auto", "fused", "overflow"])
@pytest.mark.parametrize("gate", [True, False], ids=["cross", "all"])
@pytest.mark.parametrize("weighting", ["none", "blosum62"])
def test_epilogue_route_matches_two_pass_and_jax(corpus, monkeypatch,
                                                 appends, weighting, gate,
                                                 route):
    """``auto`` and ``fused`` on the strip schedule take K1's survivors:
    no product, one fetch, every pair appended. With the capacity below
    the survivors (``overflow``) the cursor still counts them all, and
    two-pass recomputes the hit tiles; the answer is the same."""
    want = _jax(corpus, weighting, gate)
    two, two_trace = _port(corpus, weighting, gate, "two_pass")
    assert two_trace["epilogue_pairs"] == 0 and not appends
    assert two_trace["extract_products"] > 0
    m = len(two.pairs)
    assert m > 2
    if route == "overflow":
        monkeypatch.setattr(tbm, "EPILOGUE_PAIR_CAP", m // 2)
    got, trace = _port(corpus, weighting, gate,
                       "fused" if route == "fused" else "auto")
    assert appends == [s * STRIPS["strip"] for s in range(N_STRIPS)]
    _assert_same(got, want)
    _assert_same(two, want)
    assert trace["epilogue_pairs"] == m == trace["pairs"]
    assert trace["hit_tiles"] == two_trace["hit_tiles"] > 0
    if route == "overflow":
        assert m > tbm.EPILOGUE_PAIR_CAP
        assert trace["extract_products"] == two_trace["extract_products"]
        assert trace["extract_syncs"] == two_trace["extract_syncs"]
    else:
        assert trace["extract_products"] == 0
        assert trace["extract_syncs"] == 1


def _strip_pairs(corpus, **kw):
    """The strip sweep asked for survivors, then their extraction."""
    table, _, bitset, _ = corpus
    words = torch.from_numpy(bitset.words.view(np.int32))
    classes = np.full(bitset.n_pad, -1, np.int32)
    classes[: bitset.n] = table.amr_class_ids
    out = tbm.sweep_mxu(words, classes, bitset.n, STRIPS["threshold"],
                        strip=STRIPS["strip"], block=STRIPS["tile"],
                        append=True, **kw)
    assert out.fused is None
    if out.pairs is None:
        return None
    return tpw.extract_pairs(words, classes, out.tile_hits, out.tiles,
                             bitset.n, STRIPS["threshold"],
                             appended=out.pairs)


# the mesh's rows: 320 padded to four 128-row tiles
MESH_N_PAD = tmesh.pad_for_mesh(N_STRIPS * STRIPS["strip"], 4, 128)
PATHS = {
    # path: K1 launches that append (the strip schedule and the mesh
    # sweeps append; every other path appends nothing)
    "strips": N_STRIPS,
    "word_chunk": N_STRIPS,
    "two_pass": 0,
    "plain_epilogue": 0,
    "scan": 0,
    "popcount": 0,
    "xla": 0,
    "stream": 0,
    # one a sub-step or strip of the mesh's sweep
    "flat": tsh.count_substeps(4, MESH_N_PAD),
    "2d": tsh.count_substeps_2d(2, 2, MESH_N_PAD),
    "kaxis": tsh.count_kaxis_strips(4, MESH_N_PAD),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_only_the_strip_schedule_appends(corpus, appends, path):
    """K1 appends on the single card's strip schedule (contraction chunks
    too, which end in K1) and on every mesh layout's sweep, once a strip,
    sub-step or k-axis strip, and on no other path of the single card:
    ``appends`` records every block whose survivors were appended. Each
    path gives the strip route's pairs. (The name is older than the
    mesh's appends.)"""
    table, index, bitset, _ = corpus
    want = _port(corpus, "none", True, "auto")[0].pairs
    del appends[:]
    if path in ("strips", "word_chunk", "plain_epilogue"):
        kw = dict(word_chunk=bitset.w_pad // 2 if path == "word_chunk"
                  else 0,
                  stats_engine="xla" if path == "plain_epilogue" else "auto")
        got = _strip_pairs(corpus, **kw)
        if path == "plain_epilogue":
            assert got is None
            got = want
    elif path in ("flat", "2d", "kaxis"):
        mesh = (tmesh.make_mesh_2d(2, 2, device="cpu") if path == "2d"
                else tmesh.make_mesh(4, axis="k" if path == "kaxis" else "p",
                                     device="cpu"))
        got = _sharded_similarity(bitset, table, PipelineConfig(**STRIPS),
                                  mesh, index=index).pairs
    else:
        cfg = dict(STRIPS)
        if path == "two_pass":
            cfg["extract"] = "two_pass"
        elif path == "scan":
            cfg["strip"] = 16  # 20 strips: above 8, the scan
        else:
            cfg["engine"] = path
        got = tpw.pairwise_similarity(bitset, table.amr_class_ids,
                                      PipelineConfig(**cfg), index=index,
                                      device="cpu").pairs
        if path != "stream":  # the stream engine keeps its own trace
            assert tpw.last_trace["epilogue_pairs"] == 0
    assert len(appends) == PATHS[path]
    assert len(want) > 0
    assert np.array_equal(pairs_as_array(np.asarray(got)), want)
