"""A configuration names its plain reference, and the agglomerative one.

The agglomerative reference (``reference/agglomerative.py``) against
merges by Python sets at a tiny size with ties, and against the port's
``agglomerative_cluster`` (one-shot and strip plans) and
``agglomerative_cluster_device`` on the CPU; a configuration naming it
runs ``correct`` through the harness, and fails each planted fault and
the int8 control; no file of ``reference/`` imports the port. A
configuration that names no reference keeps ``kmer_pairs``'s answer and
its cache path, and the checks come from the reference's answer."""

from __future__ import annotations

import ast
import collections
import copy
import hashlib
import importlib
import json
import os
import shutil
import tempfile

import numpy as np
import pytest
from conftest import BENCH, harness, run_cpu, small_config, spec

import compare
import control
import corpus

PIPELINE = "uniprot_kmer_based_clustering_tpu_torch.pipeline"
CELLS = [w["name"] for w in spec()["workloads"]]
agg = harness.load_module("reference", "agglomerative")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU rounds on one thread: the tests run in several
    processes at once."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def agg_config(**pipeline) -> dict:
    """``arg10k.job``'s configuration at 300 proteins, clustering
    agglomeratively and naming the agglomerative reference."""
    config = small_config("arg10k.job", **{"cluster": "agglomerative",
                                           "min_shared": 1, **pipeline})
    config.update(name="arg_k5_n300_agglomerative", reference="agglomerative")
    return config


def _tiny_corpus(seed: int):
    """40 proteins: 30 of the generator's and copies of the first 10, so
    that signatures tie."""
    spec_ = small_config("arg10k.sweep")["corpus"]
    spec_.update(n=30, class_sizes=[15, 10, 5], proteins_per_family=4,
                 fixed_families=[{"classes": [0, 1], "members": [2, 3],
                                  "length": 40}],
                 length_median=40, length_min=20, length_max=60,
                 substitutions_per_residue=0.05)
    seq_buf, offsets, _ = corpus.synth_proteins(spec_, seed)
    seqs = [seq_buf[offsets[p] : offsets[p + 1]] for p in range(30)]
    seqs += seqs[:10]
    off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    return np.concatenate(seqs), off


def _merge_by_sets(seq_buf, offsets, k: int, min_shared: int):
    """The rounds by Python sets and loops: (labels, merges, rounds)."""
    n = len(offsets) - 1
    kmers = []
    for p in range(n):
        s = seq_buf[offsets[p] : offsets[p + 1]].tobytes()
        kmers.append({s[i : i + k] for i in range(len(s) - k + 1)})
    df = collections.Counter(x for ks in kmers for x in ks)
    sig = [{x for x in ks if df[x] >= 2} for ks in kmers]
    active, parent, merges, rounds = set(range(n)), list(range(n)), [], 0
    while True:
        rounds += 1
        best = {}
        for i in active:
            best[i] = (-1, -1)
            for j in sorted(active - {i}):
                if len(sig[i] & sig[j]) > best[i][0]:
                    best[i] = (len(sig[i] & sig[j]), j)
        now = [(i, best[i][1], best[i][0]) for i in sorted(active)
               if best[i][0] >= min_shared and best[i][1] > i
               and best[best[i][1]][1] == i]
        if not now:
            break
        for i, j, c in now:
            sig[i] &= sig[j]
            active.discard(j)
            parent[j] = i
            merges.append((i, j, c))
    labels = []
    for p in range(n):
        while parent[p] != p:
            p = parent[p]
        labels.append(p)
    return labels, merges, rounds


@pytest.mark.parametrize("min_shared", [1, 3])
@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_the_reference_merges_what_python_sets_merge(seed, min_shared):
    seq_buf, offsets = _tiny_corpus(seed)
    labels, merges, rounds = _merge_by_sets(seq_buf, offsets, 5, min_shared)
    got = agg.cluster(seq_buf, offsets, k=5, min_shared=min_shared)
    assert len(merges) >= 10  # the copies merge at least
    np.testing.assert_array_equal(got[0], labels)
    np.testing.assert_array_equal(got[1], np.array(merges).reshape(-1, 3))
    assert got[1].dtype == np.int64 and got[2] == rounds


def _port_bitset(config: dict, seed: int, tmp_path):
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
    from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline

    seq_buf, offsets, classes = corpus.synth_proteins(config["corpus"], seed)
    fasta = str(tmp_path / "corpus.fasta")
    corpus.write_fasta(fasta, seq_buf, offsets, classes)
    pre = run_pipeline(fasta, PipelineConfig(**config["pipeline"]),
                       stop_after="pack", device="cpu")
    return seq_buf, offsets, pre.bitset


@pytest.mark.parametrize("plan", ["one-shot", "strips"])
@pytest.mark.parametrize("min_shared", [1, 3])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_the_reference_equals_the_port_on_the_cpu(seed, min_shared, plan,
                                                  tmp_path):
    from uniprot_kmer_based_clustering_tpu_torch.models import (
        agglomerative as port,
    )

    config = agg_config(min_shared=min_shared)
    seq_buf, offsets, bitset = _port_bitset(config, seed, tmp_path)
    n = len(offsets) - 1
    budget = {"one-shot": 13 << 30, "strips": 1 << 20}[plan]
    assert (port._argmax_plan(bitset.n_pad, bitset.w_pad, budget) is None) \
        == (plan == "one-shot")
    labels, merges, rounds = agg.cluster(seq_buf, offsets, k=5,
                                         min_shared=min_shared)
    assert len(merges) > n // 2
    for got in (port.agglomerative_cluster(bitset, n, min_shared=min_shared,
                                           hbm_budget_bytes=budget,
                                           device="cpu"),
                port.agglomerative_cluster_device(
                    bitset, n, min_shared=min_shared, device="cpu")):
        np.testing.assert_array_equal(got.labels, labels)
        np.testing.assert_array_equal(got.merges, merges)
        assert got.rounds == rounds


def test_a_configuration_naming_the_reference_runs_correct():
    result, info, checks = run_cpu("arg10k.job", config=agg_config())
    assert result["correct"], (checks, info["failures"])
    assert list(checks) == ["jobs_failed", "pair_rows_wrong",
                            "counters_wrong", "labels_wrong", "merges_wrong"]
    assert all(c == {"value": 0, "limit": 0} for c in checks.values())


def _one_merge_row_changed(monkeypatch):
    mod = importlib.import_module(PIPELINE)
    real = mod.agglomerative_cluster

    def altered(*a, **k):
        r = real(*a, **k)
        r.merges = r.merges.copy()
        r.merges[len(r.merges) // 2, 2] += 1
        return r

    monkeypatch.setattr(mod, "agglomerative_cluster", altered)
    return {"merges_wrong": 1, "labels_wrong": 0}


def _one_label_changed(monkeypatch):
    mod = importlib.import_module(PIPELINE)
    real = mod.agglomerative_cluster

    def altered(*a, **k):
        r = real(*a, **k)
        r.labels = r.labels.copy()
        loser = int(r.merges[0, 1])
        r.labels[loser] = loser  # out of its cluster, on its own
        return r

    monkeypatch.setattr(mod, "agglomerative_cluster", altered)
    return {"merges_wrong": 0, "labels_wrong": 1}


def _components_handed_over(monkeypatch):
    from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig

    monkeypatch.setattr(harness, "pipeline_config", lambda config: (
        PipelineConfig(**dict(config["pipeline"], cluster="components"))))
    return {}


@pytest.mark.parametrize("fault", [_one_merge_row_changed, _one_label_changed,
                                   _components_handed_over])
def test_a_fault_in_the_clustering_is_not_correct(fault, monkeypatch):
    want = fault(monkeypatch)
    result, _, checks = run_cpu("arg10k.job", config=agg_config())
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]
    assert checks["pair_rows_wrong"]["value"] == 0
    assert checks["counters_wrong"]["value"] == 0
    for name, value in want.items():
        assert checks[name]["value"] == value, name
    if not want:  # a partition with no dendrogram
        assert checks["labels_wrong"]["value"] > 0
        assert checks["merges_wrong"]["value"] > 100


def test_the_int8_control_is_not_correct():
    _, _, traffic = harness.cell_parts(spec(), "arg10k.job")
    checks, ok = control.control_checks(agg_config(), traffic, 2**31 + 3)
    assert not ok
    assert set(checks) == {"jobs_failed", "pair_rows_wrong", "counters_wrong",
                           "labels_wrong", "merges_wrong"}
    assert checks["merges_wrong"]["value"] > 0


def test_no_reference_imports_the_port():
    folder = os.path.join(BENCH, "reference")
    names = sorted(f for f in os.listdir(folder) if f.endswith(".py"))
    assert {"kmer_pairs.py", "agglomerative.py"} <= set(names)
    for f in names:
        path = os.path.join(folder, f)
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            found = []
            if isinstance(node, ast.Import):
                found = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                found = [node.module]
            for name in found:
                assert name.split(".")[0] not in (
                    harness.PORT, *harness.FORBIDDEN_MODULES), (path, name)


def _old_cache_path(config, traffic, seed):
    """The cache path as the harness made it before a configuration could
    name its reference."""
    h = hashlib.sha256(json.dumps([config, traffic["entry"] == "pipeline"],
                                  sort_keys=True).encode())
    for src in ("corpus.py", os.path.join("reference", "kmer_pairs.py")):
        with open(os.path.join(BENCH, src), "rb") as f:
            h.update(f.read())
    return os.path.join(harness.CACHE_DIR,
                        f"{config['name']}.{seed}.{h.hexdigest()[:16]}.npz")


@pytest.mark.parametrize("workload", CELLS)
def test_a_configuration_without_the_key_keeps_its_answer_and_cache(workload):
    s = spec()
    _, config, traffic = harness.cell_parts(s, workload)
    assert "reference" not in config
    for seed in (1, 2**31 + 3):
        assert harness.reference_cache_path(config, traffic, seed) == \
            _old_cache_path(config, traffic, seed)
    small = small_config(workload)
    seq_buf, offsets, classes = corpus.synth_proteins(small["corpus"], 5)
    p = small["pipeline"]
    want = agg.kmer_pairs.answer(
        seq_buf, offsets, classes, k=p["k"], threshold=p["threshold"],
        cross_amr_only=p["cross_amr_only"],
        with_components=traffic["entry"] == "pipeline")
    for _ in range(2):  # computed, then read from the cache
        got = harness.reference_answer(small, traffic, 5, seq_buf, offsets,
                                       classes)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
    assert os.path.exists(_old_cache_path(small, traffic, 5))
    checks, _ = compare.judge([want], 0, want, getattr(
        harness.reference_of(config, traffic)[0], "CHECKS", {}))
    assert list(checks) == ["jobs_failed", "pair_rows_wrong",
                            "counters_wrong"] + (
        ["labels_wrong"] if traffic["entry"] == "pipeline" else [])


def test_a_named_reference_digests_every_reference_file(monkeypatch):
    _, config, traffic = harness.cell_parts(spec(), "arg10k.job")
    named = dict(copy.deepcopy(config), reference="agglomerative")
    copied = tempfile.mkdtemp()
    try:
        shutil.copy(os.path.join(BENCH, "corpus.py"), copied)
        shutil.copytree(os.path.join(BENCH, "reference"),
                        os.path.join(copied, "reference"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        monkeypatch.setattr(harness, "HERE", copied)
        before = [harness.reference_cache_path(c, traffic, 1)
                  for c in (config, named)]
        assert before[0] != before[1]
        with open(os.path.join(copied, "reference", "zz_new.py"), "w") as f:
            f.write("# a further reference\n")
        after = [harness.reference_cache_path(c, traffic, 1)
                 for c in (config, named)]
        assert after[0] == before[0] and after[1] != before[1]
        with open(os.path.join(copied, "reference", "kmer_pairs.py"),
                  "a") as f:
            f.write("# changed\n")
        again = [harness.reference_cache_path(c, traffic, 1)
                 for c in (config, named)]
        assert again[0] != after[0] and again[1] != after[1]
    finally:
        shutil.rmtree(copied)


def test_the_answer_decides_the_checks():
    ref = {"pairs": np.zeros((0, 3), np.int64),
           "counters": np.zeros(8, np.int64),
           "merges": np.array([[0, 1, 5]], np.int64)}
    right = dict(ref)
    checks, wrong = compare.judge([right], 0, ref, agg.CHECKS)
    assert list(checks) == ["jobs_failed", "pair_rows_wrong",
                            "counters_wrong", "merges_wrong"]
    assert wrong == 0 and compare.passes(checks)
    checks, wrong = compare.judge([{k: ref[k] for k in ("pairs", "counters")}],
                                  0, ref, agg.CHECKS)
    assert wrong == 1 and checks["merges_wrong"]["value"] == 1
    checks, _ = compare.judge([right], 0, {k: ref[k] for k in ref
                                           if k != "merges"}, agg.CHECKS)
    assert "merges_wrong" not in checks
