"""The 7-mer cell with the index built on the card, ``arg10k.k7dev``: it is
found by name like every cell, its comparison fails the int8 control, a
traced run on the CPU reads its span and counter metrics, its readers
read a hand-built trace right and a port without the spans and counters
as None, and they read again on the CPU what they read on the card
(``record_trace.py``)."""

from __future__ import annotations

import importlib
import json
import os

import pytest
from conftest import BENCH, harness, run_cpu, small_config, spec

import control
import tracing

INDEX_DEVICE = "uniprot_kmer_based_clustering_tpu_torch.kmers.index_device"
PAIRWISE = "uniprot_kmer_based_clustering_tpu_torch.similarity.pairwise"
CELL = "arg10k.k7dev"
SPANS = {"devindex_ms.k7dev": "ukc.index.device",
         "devindex_sort_ms.k7dev": "ukc.index.device.sort"}
LINK = "link_mb.k7dev"
FIXTURE = os.path.join(BENCH, "tests", "data", f"{CELL}.trace.json")


def _read(name, run):
    return harness.load_module("layers", name).read(run)


def test_the_cell_its_files_and_metrics_are_found():
    s = spec()
    cell, config, traffic = harness.cell_parts(s, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "job"
    assert traffic["entry"] == "pipeline"
    assert config["name"] == cell["config"] == "arg_k7_n10619_devindex"
    base = harness.load_json(BENCH, "configs", "arg_k5_n10619.json")
    assert config["pipeline"] == {**base["pipeline"], "k": 7,
                                  "index_engine": "device"}
    assert config["corpus"] == base["corpus"] and config["reduced"] == []
    assert config["assumed"] == base["assumed"]
    e2e = {m["name"] for m in harness.metrics_of(s, cell, "end_to_end")}
    assert e2e == {"job_s", "peak_gib", "setup_s"}
    layers = harness.metrics_of(s, cell, "per_layer")
    assert {m["name"] for m in layers} == set(SPANS) | {LINK}
    for m in layers:
        assert m["workloads"] == [CELL] and m["moves"] == "job_s"


def test_the_int8_control_is_not_correct():
    _, _, traffic = harness.cell_parts(spec(), CELL)
    checks, ok = control.control_checks(small_config(CELL), traffic,
                                        2**31 + 3)
    assert not ok
    assert checks["pair_rows_wrong"]["value"] > 0


def test_a_traced_cpu_run_reads_the_span_and_counter_metrics():
    result, info, _ = run_cpu(CELL, traced=True)
    assert result["correct"] and result["device"]["platform"] == "cpu"
    got = result["metrics"]
    assert set(got) == set(SPANS) | {LINK}
    for name in got:
        assert isinstance(got[name]["value"], float) and got[name]["value"] > 0
    # the build's spans sit inside the index stage
    assert got["devindex_sort_ms.k7dev"]["value"] < \
        got["devindex_ms.k7dev"]["value"] < \
        info["stage_s_mean"]["index"] * 1e3
    build = importlib.import_module(INDEX_DEVICE).last_trace
    sweep = importlib.import_module(PAIRWISE).last_trace
    assert build["k"] == 7 and build["syncs"] == 2
    assert 0 < build["repeated"] < build["distinct"]
    # the words are handed over on the device: the sweep copies the
    # classes alone, one int32 a padded row, and the words are W_pad
    # (a multiple of 128) int32 a padded row
    assert build["words_bytes"] % sweep["upload_bytes"] == 0
    assert build["words_bytes"] // sweep["upload_bytes"] % 128 == 0
    assert got[LINK]["value"] == pytest.approx(
        (build["host_bytes"] + sweep["upload_bytes"]) / 1e6)


MS = 1_000_000  # nanoseconds


def _run(jobs=2):
    """Two jobs, each with a 40 ms device build whose global sort takes
    15 ms, in a 0–100 ms window."""
    ops = [[tracing.WINDOW_SPAN, 0, 100 * MS, 1, [], 7]]
    for j in range(jobs):
        t = 50 * j
        for name, a, b in (("ukc.stage.index", 0, 41),
                           ("ukc.index.device", 0, 40),
                           ("ukc.index.device.residues", 0, 5),
                           ("ukc.index.device.sort", 10, 25),
                           ("ukc.stage.sweep", 41, 49)):
            ops.append([name, (t + a) * MS, (t + b) * MS, len(ops) + 1, [],
                        7])
    tr = tracing.Trace(ops=ops, device=[], window=[0, 100 * MS], cards=[0])
    return harness.Run(cell={"name": CELL}, config={}, traffic={},
                       kind="NVIDIA H100 80GB HBM3", n=10, tile=16,
                       jobs=jobs, window_s=0.1, job_seconds=[0.05] * jobs,
                       timings=[], setup_s=1.0, peak_bytes=0, trace=tr)


def test_the_readers_on_a_hand_built_trace(monkeypatch):
    monkeypatch.setattr(importlib.import_module(INDEX_DEVICE), "last_trace",
                        {"host_bytes": 20_000_000})
    monkeypatch.setattr(importlib.import_module(PAIRWISE), "last_trace",
                        {"upload_bytes": 43_008})
    run = _run()
    assert _read("devindex_ms.k7dev", run) == pytest.approx(40)
    assert _read("devindex_sort_ms.k7dev", run) == pytest.approx(15)
    assert _read(LINK, run) == pytest.approx(20.043008)


def test_a_port_without_the_spans_and_counters_reads_none(monkeypatch):
    monkeypatch.delattr(importlib.import_module(INDEX_DEVICE), "last_trace")
    run = _run()
    run.trace.ops = [o for o in run.trace.ops
                     if not o[0].startswith("ukc.")]
    for name in list(SPANS) + [LINK]:
        assert _read(name, run) is None, name


def _fixture():
    with open(FIXTURE) as f:
        rec = json.load(f)
    run = dict(rec["run"])
    run["trace"] = tracing.Trace(**run["trace"])
    return harness.Run(**run), rec


def test_the_readers_read_again_what_they_read_on_the_card(monkeypatch):
    run, rec = _fixture()
    assert run.cell["name"] == CELL and run.kind.startswith("NVIDIA")
    monkeypatch.setattr(importlib.import_module(INDEX_DEVICE), "last_trace",
                        rec["last_trace"]["index_device"])
    monkeypatch.setattr(importlib.import_module(PAIRWISE), "last_trace",
                        rec["last_trace"]["pairwise"])
    assert set(rec["metrics"]) == set(SPANS) | {LINK}
    for name, want in rec["metrics"].items():
        got = _read(name, run)
        assert got == want and got > 0, name
    # the words stayed on the card: the sweep copied the classes alone
    build = rec["last_trace"]["index_device"]
    sweep = rec["last_trace"]["pairwise"]
    assert build["words_bytes"] // sweep["upload_bytes"] % 128 == 0
    assert rec["metrics"][LINK] == pytest.approx(
        (build["host_bytes"] + sweep["upload_bytes"]) / 1e6)
