"""The port's agglomerative clustering against the benchmark's plain
reference (``benchmark/reference/agglomerative.py``: numpy and scipy,
nothing of either package), loaded by its path as the benchmark's
harness loads it, on seeded synthetic corpora of the benchmark's
generator at 200–600 proteins, on the CPU.

Each path of the port: the host loop on its one-shot plan and on the
strip plan (a 1 MiB budget), the loop with its state on the device, and
``run_pipeline(..., cluster="agglomerative")``, which ``cli run
--cluster agglomerative`` calls; at ``min_shared`` 1 (the upstream's
gate) and 3. The pipeline runs with its knobs pinned (``engine="mxu"``,
tile 16, strip 32), as the card runs it.

Tolerance: exact equality of the merges row for row, the labels and the
rounds (for the pipeline, the rounds its call counted,
``models.agglomerative.last_trace``).
"""

import functools
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from uniprot_kmer_based_clustering_tpu_torch import PipelineConfig
from uniprot_kmer_based_clustering_tpu_torch.models import agglomerative
from uniprot_kmer_based_clustering_tpu_torch.pipeline import run_pipeline

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.insert(0, BENCH)

import corpus  # noqa: E402

PINNED = dict(engine="mxu", tile=16, strip=32, threshold=10,
              cross_amr_only=True, cluster="agglomerative")
SEEDS = {2**31 + 11: 200, 2**31 + 12: 400, 2**31 + 13: 600}
PATHS = ("one_shot", "strip", "device", "pipeline")
STRIP_BUDGET = 1 << 20


def _reference():
    """``reference/agglomerative.py`` as a module, from its path."""
    path = os.path.join(BENCH, "reference", "agglomerative.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_reference_agglomerative", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REFERENCE = _reference()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The CPU rounds on one thread: the tests run in several processes
    at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spec(n: int) -> dict:
    """The cell's corpus cut to ``n`` proteins: its classes in proportion
    and one family of two classes."""
    with open(os.path.join(BENCH, "configs",
                           "arg_k5_n10619_agglo.json")) as f:
        spec = json.load(f)["corpus"]
    sizes = [round(n * s / spec["n"]) for s in spec["class_sizes"][:9]]
    sizes[0] += n - sum(sizes)
    spec.update(n=n, class_sizes=sizes, proteins_per_family=6,
                fixed_families=[{"classes": [7, 2], "members": [2, 8],
                                 "length": 300}])
    return spec


@functools.lru_cache(maxsize=None)
def _corpus(seed: int, tmp: str):
    """(fasta path, seq_buf, offsets, the packed pipeline) of ``seed``."""
    seq_buf, offsets, classes = corpus.synth_proteins(_spec(SEEDS[seed]),
                                                      seed)
    fasta = os.path.join(tmp, f"corpus{seed}.fasta")
    corpus.write_fasta(fasta, seq_buf, offsets, classes)
    pre = run_pipeline(fasta, PipelineConfig(**PINNED), stop_after="pack",
                       device="cpu")
    return fasta, seq_buf, offsets, pre


@functools.lru_cache(maxsize=None)
def _want(seed: int, min_shared: int, tmp: str):
    _, seq_buf, offsets, _ = _corpus(seed, tmp)
    return REFERENCE.cluster(seq_buf, offsets, k=5, min_shared=min_shared)


def _port(path: str, seed: int, min_shared: int, tmp: str):
    """(labels, merges, rounds) of the port's ``path``."""
    fasta, _, _, pre = _corpus(seed, tmp)
    bitset, n = pre.bitset, pre.table.n
    if path == "pipeline":
        r = run_pipeline(fasta, PipelineConfig(**PINNED,
                                               min_shared=min_shared),
                         device="cpu")
        return (r.cluster_labels, r.dendrogram,
                agglomerative.last_trace["rounds"])
    if path == "device":
        r = agglomerative.agglomerative_cluster_device(
            bitset, n, min_shared=min_shared, device="cpu")
    else:
        budget = STRIP_BUDGET if path == "strip" else 13 << 30
        plan = agglomerative._argmax_plan(bitset.n_pad, bitset.w_pad, budget)
        assert (plan is None) == (path == "one_shot")
        r = agglomerative.agglomerative_cluster(
            bitset, n, min_shared=min_shared, hbm_budget_bytes=budget,
            device="cpu")
    return r.labels, r.merges, r.rounds


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("agglomerative_reference"))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("min_shared", [1, 3])
@pytest.mark.parametrize("seed", list(SEEDS))
def test_the_port_merges_what_the_reference_merges(seed, min_shared, path,
                                                   tmp):
    labels, merges, rounds = _want(seed, min_shared, tmp)
    got_labels, got_merges, got_rounds = _port(path, seed, min_shared, tmp)
    assert len(merges) > SEEDS[seed] // 2
    np.testing.assert_array_equal(got_merges, merges)
    np.testing.assert_array_equal(got_labels, labels)
    assert got_rounds == rounds
