"""The agglomerative deployment's cell, ``arg10k.agglo``: it is found by
name like every cell and names the agglomerative reference, its
comparison fails the int8 control, a traced run on the CPU reads its
span and counter metrics, its readers read a hand-built trace right and
a port without the spans and counters as None, and they read again on
the CPU what they read on the card (``record_agglo_trace.py``)."""

from __future__ import annotations

import importlib
import json
import os

import pytest
from conftest import BENCH, PORT_COUNTERS, harness, run_cpu, small_config, spec

import control
import tracing

AGGLOMERATIVE = "uniprot_kmer_based_clustering_tpu_torch.models.agglomerative"
CELL = "arg10k.agglo"
SPAN = "round_ms.agglo"
ROOFLINE = "round_gemm_roofline.agglo"
GOPS = "round_gops.agglo"
IDLE = "device_idle.agglo"
FIXTURE = os.path.join(BENCH, "tests", "data", f"{CELL}.trace.json")

# the rounds' counters are among those a recorded fixture keeps and the
# layer tests restore (``conftest.PORT_COUNTERS``)
PORT_COUNTERS.setdefault("agglomerative", "models.agglomerative")


def _read(name, run):
    return harness.load_module("layers", name).read(run)


def test_the_cell_its_files_and_metrics_are_found():
    s = spec()
    cell, config, traffic = harness.cell_parts(s, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "job"
    assert traffic["entry"] == "pipeline"
    assert config["name"] == cell["config"] == "arg_k5_n10619_agglo"
    assert config["reference"] == "agglomerative"
    base = harness.load_json(BENCH, "configs", "arg_k5_n10619.json")
    assert config["pipeline"] == {**base["pipeline"],
                                  "cluster": "agglomerative",
                                  "min_shared": 1}
    assert config["corpus"] == base["corpus"] and config["reduced"] == []
    assert {k: config["assumed"][k] for k in base["assumed"]} == \
        base["assumed"]
    e2e = {m["name"] for m in harness.metrics_of(s, cell, "end_to_end")}
    assert e2e == {"job_s", "peak_gib", "setup_s"}
    layers = harness.metrics_of(s, cell, "per_layer")
    assert {m["name"] for m in layers} == {SPAN, ROOFLINE, GOPS, IDLE}
    for m in layers:
        assert m["workloads"] == [CELL] and m["moves"] == "job_s"
    assert harness.reference_of(config, traffic)[0].CHECKS


def test_the_int8_control_is_not_correct():
    _, _, traffic = harness.cell_parts(spec(), CELL)
    checks, ok = control.control_checks(small_config(CELL), traffic,
                                        2**31 + 3)
    assert not ok
    assert checks["merges_wrong"]["value"] > 0


def test_a_traced_cpu_run_reads_the_span_and_counter_metrics():
    result, _, checks = run_cpu(CELL, traced=True)
    assert result["correct"] and result["device"]["platform"] == "cpu"
    assert list(checks) == ["jobs_failed", "pair_rows_wrong",
                            "counters_wrong", "labels_wrong", "merges_wrong"]
    got = result["metrics"]
    # the roofline and the idle share read the card's timeline, which a
    # CPU run has not
    assert set(got) == {SPAN, GOPS}
    counts = importlib.import_module(AGGLOMERATIVE).last_trace
    assert counts["plan"] == "one_shot" and counts["rounds"] > 1
    assert counts["syncs"] == counts["rounds"]
    assert got[GOPS]["value"] == pytest.approx(counts["product_ops"] / 1e9)
    assert got[SPAN]["value"] > 0


MS = 1_000_000  # nanoseconds
N_PAD, K = 1024, 4096
GEMM = [[N_PAD, K], [K, N_PAD]]  # 2·N_PAD²·K = 8,589,934,592 operations


def _run(jobs=2):
    """Two jobs in a 0–100 ms window, each with a sweep-stage product
    outside the rounds and two 20 ms rounds whose argmax launches one
    product whose kernel takes 5 ms."""
    ops = [[tracing.WINDOW_SPAN, 0, 100 * MS, 1, [], 7]]
    device = []

    def op(name, a, b, shapes=()):
        ops.append([name, a * MS, b * MS, len(ops) + 1, list(shapes), 7])
        return len(ops)

    for j in range(jobs):
        t = 50 * j
        device.append(["gemm", 0, (t + 1) * MS, (t + 4) * MS,
                       op("aten::_int_mm", t + 1, t + 2, GEMM)])
        for r in range(2):
            t0 = t + 5 + 20 * r
            op("ukc.agglo.round", t0, t0 + 20)
            op("ukc.agglo.argmax", t0, t0 + 10)
            device.append(["gemm", 0, (t0 + 2) * MS, (t0 + 7) * MS,
                           op("aten::_int_mm", t0 + 1, t0 + 2, GEMM)])
            op("ukc.agglo.fetch", t0 + 10, t0 + 12)
            op("ukc.agglo.merge", t0 + 12, t0 + 20)
    tr = tracing.Trace(ops=ops, device=device, window=[0, 100 * MS],
                       cards=[0])
    return harness.Run(cell={"name": CELL}, config={}, traffic={},
                       kind="NVIDIA H100 80GB HBM3", n=10, tile=16,
                       jobs=jobs, window_s=0.1, job_seconds=[0.05] * jobs,
                       timings=[], setup_s=1.0, peak_bytes=0, trace=tr)


def test_the_readers_on_a_hand_built_trace(monkeypatch):
    monkeypatch.setattr(importlib.import_module(AGGLOMERATIVE), "last_trace",
                        {"rounds": 2, "product_ops": 2 * 2 * N_PAD**2 * K})
    run = _run()
    assert _read(SPAN, run) == pytest.approx(20)
    # the rounds' four products and their four 5 ms kernels; the sweep
    # stage's are not counted
    assert _read(ROOFLINE, run) == pytest.approx(
        100 * 4 * 2 * N_PAD**2 * K / 1979e12 / 0.020)
    assert _read(GOPS, run) == pytest.approx(4 * N_PAD**2 * K / 1e9)
    assert _read(IDLE, run) == pytest.approx(100 - 26)


def test_a_port_without_the_spans_and_counters_reads_none(monkeypatch):
    monkeypatch.delattr(importlib.import_module(AGGLOMERATIVE), "last_trace")
    run = _run()
    run.trace.ops = [o for o in run.trace.ops
                     if not o[0].startswith("ukc.")]
    for name in (SPAN, ROOFLINE, GOPS):
        assert _read(name, run) is None, name
    assert _read(IDLE, run) == pytest.approx(100 - 26)


def _fixture():
    with open(FIXTURE) as f:
        rec = json.load(f)
    run = dict(rec["run"])
    run["trace"] = tracing.Trace(**run["trace"])
    return harness.Run(**run), rec


def test_the_readers_read_again_what_they_read_on_the_card(monkeypatch):
    run, rec = _fixture()
    assert run.cell["name"] == CELL and run.kind.startswith("NVIDIA")
    counts = rec["last_trace"]["agglomerative"]
    monkeypatch.setattr(importlib.import_module(AGGLOMERATIVE), "last_trace",
                        counts)
    assert set(rec["metrics"]) == {SPAN, ROOFLINE, GOPS, IDLE}
    for name, want in rec["metrics"].items():
        got = _read(name, run)
        assert got == want and got > 0, name
    assert 0 < rec["metrics"][ROOFLINE] <= 100
    assert counts["plan"] == "one_shot"
    assert counts["syncs"] == counts["rounds"]
    assert rec["metrics"][GOPS] == pytest.approx(counts["product_ops"] / 1e9)


def test_a_trace_without_the_spans_reads_none(monkeypatch):
    run, rec = _fixture()
    monkeypatch.setattr(importlib.import_module(AGGLOMERATIVE), "last_trace",
                        {})
    run.trace.ops = [o for o in run.trace.ops
                     if not o[0].startswith("ukc.")]
    for name in (SPAN, ROOFLINE, GOPS):
        assert _read(name, run) is None, name
