"""Parity of the port's pairwise stage (similarity/pairwise.py) with the
JAX package's ``pairwise_similarity(engine="mxu")`` on the toy FASTA.

Tolerance: exact equality of the (i, j, count) pair list in (i, j) order
and of every PairwiseResult field.
"""

import dataclasses

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


@pytest.mark.parametrize("knob,item", [
    (dict(engine="popcount"), "item 6"),
    (dict(engine="xla"), "item 6"),
    (dict(engine="stream"), "item 9"),
    (dict(extract="fused"), "item 8"),
    (dict(index_engine="device"), "item 11"),
])
def test_unported_knobs_raise(toy, knob, item):
    table, _, bitset, _ = toy
    with pytest.raises(NotImplementedError, match=item):
        tpw.pairwise_similarity(
            bitset, table.amr_class_ids, PipelineConfig(**knob), device=CPU
        )
