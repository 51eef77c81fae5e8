"""The comparison that decides ``correct`` fails its control (the
reference with its counts held in int8) and each fault planted in the
timed path, at a size a test run can hold."""

from __future__ import annotations

import numpy as np
import pytest
from conftest import harness, run_cpu, small_config

import control

PAIRWISE = "uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise"


@pytest.mark.parametrize("workload", ["arg10k.sweep", "arg10k.job"])
def test_the_int8_control_is_not_correct(workload):
    config = small_config(workload)
    _, _, traffic = harness.cell_parts(harness.load_json(
        harness.ROOT, "BENCHMARK.json"), workload)
    checks, ok = control.control_checks(config, traffic, 2**31 + 3)
    assert not ok
    assert checks["pair_rows_wrong"]["value"] > 0


def _alter_one_count(monkeypatch):
    import importlib

    mod = importlib.import_module(PAIRWISE)
    real = mod._sorted_pairs

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[0, 2] += 1
        return out

    monkeypatch.setattr(mod, "_sorted_pairs", altered)


def _leave_out_half(monkeypatch):
    import importlib

    mod = importlib.import_module(PAIRWISE)
    real = mod.extract_pairs
    monkeypatch.setattr(mod, "extract_pairs",
                        lambda *a, **k: real(*a, **k)[::2])


def _union_find_returns_its_start(monkeypatch):
    from uniprot_kmer_based_clustering_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "connected_components",
                        lambda n, pairs: np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("workload,fault", [
    ("arg10k.sweep", _alter_one_count),
    ("arg10k.sweep", _leave_out_half),
    ("arg10k.job", _alter_one_count),
    ("arg10k.job", _union_find_returns_its_start),
])
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault,
                                                  monkeypatch):
    fault(monkeypatch)
    result, _, checks = run_cpu(workload)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_a_job_that_raises_counts_as_failed(monkeypatch):
    import importlib

    mod = importlib.import_module(PAIRWISE)
    real, calls = mod.extract_pairs, []

    def broken(*a, **k):
        calls.append(1)
        if len(calls) > 1:  # the warm-up job of the set-up goes through
            raise RuntimeError("planted")
        return real(*a, **k)

    monkeypatch.setattr(mod, "extract_pairs", broken)
    result, info, checks = run_cpu("arg10k.sweep")
    assert result["correct"] is False
    assert checks["jobs_failed"]["value"] > 0
    assert "planted" in info["failures"][0]
