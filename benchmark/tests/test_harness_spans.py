"""The readers of the port's spans and counters: a traced run of each cell
on the CPU reads the span and counter metrics, the two that need the
card's timeline read None there, a hand-built trace checks their
arithmetic, and a port without the spans and counters reads None."""

from __future__ import annotations

import importlib

import pytest
from conftest import harness, run_cpu, spec

import tracing

PAIRWISE = "uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise"
ON_THE_CPU = {"arg10k.job": ["index_s.job"],
              "arg10k.sweep": ["extract_ms.sweep", "extract_syncs.sweep"]}
ON_THE_CARD = ["upload_gbps.sweep", "host_idle_ms.sweep"]


def _read(name, run):
    return harness.load_module("layers", name).read(run)


@pytest.mark.parametrize("workload", sorted(ON_THE_CPU))
def test_a_traced_cpu_run_reads_the_spans_and_counters(workload):
    result, info, _ = run_cpu(workload, traced=True)
    assert result["correct"]
    got = result["metrics"]
    for name in ON_THE_CPU[workload]:
        assert isinstance(got[name]["value"], float) and got[name]["value"] > 0
    for name in ON_THE_CARD:
        assert name not in got
    if workload == "arg10k.job":
        # the same interval as the stage timer, on the profiler's clock
        assert got["index_s.job"]["value"] == pytest.approx(
            info["stage_s_mean"]["index"], rel=0.05)
    else:
        counts = importlib.import_module(PAIRWISE).last_trace
        assert got["extract_syncs.sweep"]["value"] == \
            counts["extract_products"] + 1


def test_the_new_metrics_name_files_and_cells():
    s = spec()
    names = {m["name"]: m for m in s["per_layer"]}
    for cell, metrics in ON_THE_CPU.items():
        for name in metrics:
            assert names[name]["workloads"] == [cell]
    for name in ON_THE_CARD:
        assert names[name]["workloads"] == ["arg10k.sweep"]


MS = 1_000_000  # nanoseconds


def _run(ops, device, jobs=2):
    """A run of ``jobs`` jobs whose trace holds ``ops`` (name, start, end)
    on the window's thread and ``device`` (name, start, end) on card 0,
    in milliseconds; the window is 0–100 ms."""
    tr = tracing.Trace(
        ops=[[tracing.WINDOW_SPAN, 0, 100 * MS, 1, [], 7]]
        + [[n, a * MS, b * MS, i + 2, [], 7] for i, (n, a, b) in
           enumerate(ops)],
        device=[[n, 0, a * MS, b * MS, 0] for n, a, b in device],
        window=[0, 100 * MS], cards=[0])
    return harness.Run(cell={"name": "arg10k.sweep"}, config={}, traffic={},
                       kind="NVIDIA H100 80GB HBM3", n=10, tile=16, jobs=jobs,
                       window_s=0.1, job_seconds=[0.05] * jobs, timings=[],
                       setup_s=1.0, peak_bytes=0, trace=tr)


def test_the_upload_rate_and_the_idle_time_on_a_hand_built_trace(
        monkeypatch):
    monkeypatch.setattr(importlib.import_module(PAIRWISE), "last_trace",
                        {"upload_bytes": 3_000_000, "extract_syncs": 3})
    # two jobs: the upload copies (5 + 7 ms) run under the upload span;
    # the card idles 0–2 ms (no span: the harness's loop), 10–14 ms under
    # a ukc span with no op open, 20–23 ms inside aten::nonzero, and
    # 30–100 ms under the result span of the second job
    run = _run(
        ops=[(tracing.JOB_SPAN, 2, 30), ("ukc.pairwise.upload", 2, 10),
             ("aten::copy_", 2, 10), ("ukc.pairwise.extract", 10, 30),
             ("aten::nonzero", 20, 23), (tracing.JOB_SPAN, 30, 100),
             ("ukc.pairwise.result", 30, 100)],
        device=[("Memcpy HtoD (Pageable -> Device)", 2, 7),
                ("Memcpy HtoD (Pageable -> Device)", 7, 10),
                ("kernel", 14, 20), ("kernel", 23, 30)])
    # 2 jobs x 3 MB over 8 ms of copies
    assert _read("upload_gbps.sweep", run) == pytest.approx(6e6 / 8e-3 / 1e9)
    # 4 + 70 ms under ukc spans, over 2 jobs; not 0–2 ms nor 20–23 ms
    assert _read("host_idle_ms.sweep", run) == pytest.approx(74 / 2)
    assert _read("extract_syncs.sweep", run) == 3.0
    assert _read("extract_ms.sweep", run) == pytest.approx(20 / 2)


def test_a_port_without_spans_and_counters_reads_none(monkeypatch):
    monkeypatch.delattr(importlib.import_module(PAIRWISE), "last_trace")
    run = _run(ops=[(tracing.JOB_SPAN, 0, 50), ("aten::copy_", 0, 10)],
               device=[("Memcpy HtoD (Pageable -> Device)", 0, 10)])
    for name in ON_THE_CPU["arg10k.job"] + ON_THE_CPU["arg10k.sweep"] \
            + ON_THE_CARD:
        assert _read(name, run) is None, name
