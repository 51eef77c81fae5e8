"""The port's clustering-at-scale bench (``benches/cluster.py``,
``bench_cluster.py``'s counterpart) on the CPU against the JAX package.

Each stage of the bench runs on the CPU (``UKC_BENCH_DEVICE=cpu``) over
``synth_proteins(n, seed=0)`` at a few hundred proteins; its pairs,
component labels, merges, labels, rounds and tree labels are held to the
JAX functions on the same seeded corpus (the sweep's engine pinned to
``mxu``, the JAX tree on its numpy path) and to the scipy transcription
of the agglomerative rounds. Tolerance 0. Torch runs on one thread and
each result is computed once.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig as JConfig
from uniprot_kmer_based_clustering_tpu.kmers import build_index as jbuild_index
from uniprot_kmer_based_clustering_tpu.kmers import encode_kmers as jencode
from uniprot_kmer_based_clustering_tpu.kmers import pack_bitsets as jpack
from uniprot_kmer_based_clustering_tpu.models import agglomerative as jagg
from uniprot_kmer_based_clustering_tpu.models import components as jcomp
from uniprot_kmer_based_clustering_tpu.models import tree as jtree
from uniprot_kmer_based_clustering_tpu.similarity import pairwise as jpw
from uniprot_kmer_based_clustering_tpu_torch.benches import (
    cluster,
    common,
    engines,
)
from uniprot_kmer_based_clustering_tpu_torch.models import agglomerative

KNOBS = ("UKC_BENCH_", "UKC_CLUSTER_")
CPU = torch.device("cpu")
N_AGG = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def bench_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(KNOBS):
            monkeypatch.delenv(k)
    monkeypatch.setenv("UKC_BENCH_DEVICE", "cpu")
    return monkeypatch


def _line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@functools.lru_cache(maxsize=None)
def _jax_state(n: int, row_multiple: int = 512):
    seq_buf, offsets, classes = common.synth_proteins(n, seed=0)
    codes, koff = jencode(seq_buf, offsets, 5)
    idx = jbuild_index(codes, koff, 5)
    bs = jpack(idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
               row_multiple=row_multiple)
    return idx, bs, classes


@functools.lru_cache(maxsize=None)
def _components(n: int):
    return cluster.components_stage(n, CPU)


@pytest.mark.parametrize("n", [300, 500])
def test_components_match_jax(n):
    """The stage's pair list = the JAX sweep and extraction's (engine
    mxu), its labels = JAX ``connected_components`` of those pairs."""
    fields, kernels, pairs, labels = _components(n)
    _, bs, classes = _jax_state(n)
    want = jpw.pairwise_similarity(bs, classes, JConfig(engine="mxu")).pairs
    assert np.array_equal(pairs, want)
    want_labels = jcomp.connected_components(n, np.asarray(want))
    assert np.array_equal(labels, want_labels)
    _, counts = np.unique(want_labels, return_counts=True)
    assert (fields["components_pairs"], fields["components_clusters"],
            fields["components_largest"],
            fields["components_singletons"]) == (
        len(want), len(counts), int(counts.max()), int((counts == 1).sum()))
    assert fields["components_oracle_checked"] > 0
    assert kernels == {"K1": 0, "K2": 0}  # the plain epilogue on the CPU


@functools.lru_cache(maxsize=None)
def _agglomerative():
    return cluster.agglomerative_stage(N_AGG, CPU, reference=False)


def test_agglomerative_matches_jax_and_the_scipy_transcription():
    fields, agg = _agglomerative()
    idx, bs, _ = _jax_state(N_AGG)
    want = jagg.agglomerative_cluster(bs, N_AGG)
    assert np.array_equal(agg.merges, want.merges)
    assert np.array_equal(agg.labels, want.labels)
    assert agg.rounds == want.rounds
    labels, merges, rounds = common.scipy_agglomerative(idx, N_AGG)
    assert np.array_equal(merges, want.merges)
    assert np.array_equal(labels, want.labels) and rounds == want.rounds
    assert (fields["agg_rounds"], fields["agg_merges"],
            fields["agg_clusters"]) == (
        want.rounds, len(want.merges), len(np.unique(want.labels)))
    assert fields["agg_mode"] == "one-shot matmul"
    assert "agg_reference_gate" not in fields


def test_reference_gate_holds_at_a_small_corpus(monkeypatch):
    monkeypatch.setattr(cluster, "AGG_REFERENCE_N", 150)
    got = cluster.agg_reference_gate(CPU)
    assert got["agg_reference_gate"].startswith(
        "synth_proteins(150): merges, labels and rounds == the scipy")


def test_reference_gate_catches_a_different_transcription(monkeypatch):
    monkeypatch.setattr(cluster, "AGG_REFERENCE_N", 150)
    real = common.scipy_agglomerative

    def one_round_more(index, n, min_shared=1):
        labels, merges, rounds = real(index, n, min_shared)
        return labels, merges, rounds + 1

    monkeypatch.setattr(common, "scipy_agglomerative", one_round_more)
    with pytest.raises(common.BenchFailure, match="agglomerative reference"):
        cluster.agg_reference_gate(CPU)


def test_tree_matches_jax(monkeypatch):
    """The stage's labels, depth and root width = the JAX tree's (numpy
    path) on the same host-packed rows."""
    monkeypatch.setattr(jtree, "_native_rows", None)
    fields, labels = cluster.tree_stage(N_AGG)
    _, bs, _ = _jax_state(N_AGG, 8)
    want = jtree.build_tree(bs, N_AGG)
    assert np.array_equal(labels, want.labels(N_AGG))
    assert fields["tree_depth"] == want.depth()
    assert fields["tree_root_children"] == len(want.root.children)
    assert fields["tree_clusters"] == len(np.unique(labels))


def test_structural_gate_is_the_engines_bench_s():
    assert cluster.structural_gate is engines.structural_gate


def test_agglomerative_stage_rejects_a_loser_merged_twice(monkeypatch):
    def twice(bitset, n, **kw):
        merges = np.array([[0, 2, 5], [1, 2, 4]], np.int64)
        labels = np.arange(n, dtype=np.int32)
        labels[2] = 0
        return agglomerative.AgglomerativeResult(labels, merges, 1)

    monkeypatch.setattr(agglomerative, "agglomerative_cluster", twice)
    with pytest.raises(common.BenchFailure, match="a loser merged twice"):
        cluster.agglomerative_stage(40, CPU, reference=False)


@pytest.mark.parametrize("n_pad, w", [(512, 128), (10_752, 7_680),
                                      (32_256, 28_416), (100_352, 65_536)],
                         ids=["small", "10619", "30k", "100k"])
def test_agg_mode_is_jax_s_argmax_plan(n_pad, w):
    plan = jagg._argmax_plan(n_pad, w, 13 << 30)
    want = ("one-shot matmul" if plan is None else
            f"strip argmax (strip={plan[0]}, word_chunk={plan[1]})")
    assert cluster.agg_mode(n_pad, w) == want


@pytest.mark.parametrize("labels, why", [
    (np.array([0, 0, -1, 3], np.int32), "has no label"),
    (np.array([1, 1, 2, 3], np.int32), "minimum member"),
], ids=["uncovered", "not-min"])
def test_tree_gate_rejects_bad_labels(labels, why):
    cluster.tree_gate(np.array([0, 0, 2, 0], np.int32))
    with pytest.raises(common.BenchFailure, match=why):
        cluster.tree_gate(labels)


def test_cluster_bench_on_the_cpu(bench_env, capsys, monkeypatch):
    """Every stage, the reference gate at 150 proteins; the line carries
    the JAX script's keys plus the port's."""
    monkeypatch.setattr(cluster, "AGG_REFERENCE_N", 150)
    bench_env.setenv("UKC_CLUSTER_COMPONENTS_N", "300")
    bench_env.setenv("UKC_CLUSTER_N", "200")
    bench_env.setenv("UKC_CLUSTER_AGG_N", "150")
    assert cluster.main() == 0
    line = _line(capsys)
    assert line["metric"] == "cluster_scale" and line["unit"] == "proteins/s"
    assert line["value"] == round(
        300 / line["components_device_pmin_seconds"], 1)
    fields = _components(300)[0]
    assert line["components_pairs"] == fields["components_pairs"]
    assert (line["agg_n"], line["tree_n"]) == (150, 200)
    assert line["agg_gates"].startswith("reference exact + structural")
    assert line["kernels"] == {"K1": 0, "K2": 0}
    assert line["device"] == "cpu" and line["power_limit_w"] is None


def test_cluster_without_cuda_fails_instead_of_running_on_the_cpu(
        bench_env, capsys, monkeypatch):
    bench_env.setenv("UKC_BENCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cluster.main() == 1
    line = _line(capsys)
    assert line["value"] == 0.0 and line["metric"] == cluster.METRIC
    assert "no CUDA GPU" in line["error"]


def test_cluster_artifact_is_named_torch_cluster(bench_env, capsys,
                                                 monkeypatch):
    from uniprot_kmer_based_clustering_tpu_torch.utils import artifact

    names = []
    monkeypatch.setattr(artifact, "write_bench_artifact",
                        lambda name, line, repo_dir=None: names.append(name))
    for stage in ("COMPONENTS_N", "AGG", "TREE"):
        bench_env.setenv(f"UKC_CLUSTER_{stage}", "0")
    assert cluster.main() == 0
    assert _line(capsys)["value"] == 0.0
    assert names == ["torch_cluster"]
