"""The four-card flat ring's cell, ``arg10k.ring4``: it is found by name
like every cell, its comparison fails the int8 control and a wrong pair
planted on one shard, a traced run on a CPU mesh reads its span
metrics, its readers read a hand-built trace right and a port without
the spans and counters as None, and they read again on the CPU what they
read on the cards (``record_trace.py``)."""

from __future__ import annotations

import importlib
import json
import os

import pytest
from conftest import BENCH, harness, run_cpu, small_config, spec

import control
import tracing

SHARDED = "uniprot_kmer_based_clustering_tpu_torch.parallel.sharded"
CELL = "arg10k.ring4"
SPANS = {"stage_ms.ring4": "ukc.ring.stage",
         "ring_sweep_ms.ring4": "ukc.ring.sweep",
         "ring_extract_ms.ring4": "ukc.ring.extract"}
PEER = "peer_gbps.ring4"
FIXTURE = os.path.join(BENCH, "tests", "data", f"{CELL}.trace.json")


def _read(name, run):
    return harness.load_module("layers", name).read(run)


def test_the_cell_its_files_and_metrics_are_found():
    s = spec()
    cell, config, traffic = harness.cell_parts(s, CELL)
    assert cell["chips"] == 4 and cell["traffic"] == "ring4"
    assert traffic["entry"] == "mesh_sweep_stage"
    assert traffic["mesh"] == {"layout": "flat", "devices": 4}
    assert config["name"] == cell["config"] == "arg_k5_n10619_ring4"
    base = harness.load_json(BENCH, "configs", "arg_k5_n10619.json")
    assert config["pipeline"] == base["pipeline"]
    assert config["corpus"] == base["corpus"] and config["reduced"] == []
    assert os.path.exists(os.path.join(BENCH, "entries",
                                       "mesh_sweep_stage.py"))
    e2e = {m["name"] for m in harness.metrics_of(s, cell, "end_to_end")}
    assert e2e == {"pairs_per_s", "peak_gib", "setup_s"}
    layers = harness.metrics_of(s, cell, "per_layer")
    assert {m["name"] for m in layers} == set(SPANS) | {PEER}
    for m in layers:
        assert m["workloads"] == [CELL] and m["moves"] == "pairs_per_s"


def test_the_int8_control_is_not_correct():
    _, _, traffic = harness.cell_parts(spec(), CELL)
    checks, ok = control.control_checks(small_config(CELL), traffic,
                                        2**31 + 3)
    assert not ok
    assert checks["pair_rows_wrong"]["value"] > 0


def test_one_wrong_pair_on_one_shard_is_not_correct(monkeypatch):
    mod = importlib.import_module(SHARDED)
    real, shards = mod._gather_pairs, []

    def altered(mesh, bufs, *a, **k):
        d = next(d for d, b in enumerate(bufs) if int(b[3]) > 0)
        bufs[d][2][0] += 1
        shards.append(d)
        return real(mesh, bufs, *a, **k)

    monkeypatch.setattr(mod, "_gather_pairs", altered)
    result, _, checks = run_cpu(CELL)
    assert shards and result["correct"] is False
    assert result["failed"] == result["attempted"]
    assert checks["pair_rows_wrong"]["value"] == 2
    assert checks["counters_wrong"]["value"] == 0


def test_a_traced_cpu_run_reads_the_span_metrics():
    result, info, _ = run_cpu(CELL, traced=True)
    assert result["correct"] and result["device"]["platform"] == "cpu"
    got = result["metrics"]
    assert set(got) == set(SPANS)  # no peer copy on the CPU
    for name in SPANS:
        assert isinstance(got[name]["value"], float) and got[name]["value"] > 0
    counts = importlib.import_module(SHARDED).last_trace
    assert counts["shift_bytes"] > 0 and counts["pairs"] > 0


MS = 1_000_000  # nanoseconds


def _run(jobs=2):
    """Two jobs on two cards: each job's staging, sweep and extraction
    spans, and its peer copies (3 + 5 ms on card 0, 2 ms on card 1), in a
    0–100 ms window."""
    ops, device = [[tracing.WINDOW_SPAN, 0, 100 * MS, 1, [], 7]], []
    for j in range(jobs):
        t = 50 * j
        for name, a, b in (("ukc.ring.stage", 0, 10),
                           ("ukc.ring.sweep", 10, 30),
                           ("ukc.ring.shift", 12, 14),
                           ("ukc.ring.extract", 30, 45)):
            ops.append([name, (t + a) * MS, (t + b) * MS, len(ops) + 1, [],
                        7])
        device += [["Memcpy PtoP (Device -> Device)", 0, (t + 12) * MS,
                    (t + 15) * MS, 0],
                   ["Memcpy PtoP (Device -> Device)", 0, (t + 31) * MS,
                    (t + 36) * MS, 0],
                   ["Memcpy PtoP (Device -> Device)", 1, (t + 12) * MS,
                    (t + 14) * MS, 0],
                   ["Memcpy HtoD (Pageable -> Device)", 1, (t + 1) * MS,
                    (t + 9) * MS, 0]]
    tr = tracing.Trace(ops=ops, device=device, window=[0, 100 * MS],
                       cards=[0, 1])
    return harness.Run(cell={"name": CELL}, config={}, traffic={},
                       kind="NVIDIA H100 80GB HBM3", n=10, tile=16,
                       jobs=jobs, window_s=0.1, job_seconds=[0.05] * jobs,
                       timings=[], setup_s=1.0, peak_bytes=0, trace=tr)


def test_the_readers_on_a_hand_built_trace(monkeypatch):
    monkeypatch.setattr(importlib.import_module(SHARDED), "last_trace",
                        {"shift_bytes": 20_000_000, "stage_bytes": 1})
    run = _run()
    assert _read("stage_ms.ring4", run) == pytest.approx(10)
    assert _read("ring_sweep_ms.ring4", run) == pytest.approx(20)
    assert _read("ring_extract_ms.ring4", run) == pytest.approx(15)
    # 2 jobs x 20 MB over 2 x (3 + 5 + 2) ms of peer copies
    assert _read(PEER, run) == pytest.approx(40e6 / 20e-3 / 1e9)


def test_a_port_without_the_spans_and_counters_reads_none(monkeypatch):
    monkeypatch.delattr(importlib.import_module(SHARDED), "last_trace")
    run = _run()
    run.trace.ops = [o for o in run.trace.ops
                     if not o[0].startswith("ukc.")]
    for name in list(SPANS) + [PEER]:
        assert _read(name, run) is None, name


def _fixture():
    with open(FIXTURE) as f:
        rec = json.load(f)
    run = dict(rec["run"])
    run["trace"] = tracing.Trace(**run["trace"])
    return harness.Run(**run), rec


def test_the_readers_read_again_what_they_read_on_the_cards(monkeypatch):
    run, rec = _fixture()
    assert run.cell["name"] == CELL and sorted(run.trace.cards) == [0, 1, 2, 3]
    monkeypatch.setattr(importlib.import_module(SHARDED), "last_trace",
                        rec["last_trace"]["sharded"])
    assert set(rec["metrics"]) == set(SPANS) | {PEER}
    for name, want in rec["metrics"].items():
        got = _read(name, run)
        assert got == want and got > 0, name
    # the peer rate's bytes are the job's shifts times the jobs
    seconds = run.trace.device_seconds(name_has=("Memcpy PtoP",))
    assert rec["metrics"][PEER] == pytest.approx(
        rec["last_trace"]["sharded"]["shift_bytes"] * run.jobs / seconds
        / 1e9)
