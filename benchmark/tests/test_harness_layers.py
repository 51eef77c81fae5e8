"""Each layer reader on a profiler trace recorded on the card
(``record_trace.py``), with the port's counters as the window's last job
left them there: it reads again what it read there, its shares lie in
(0, 100], and the breakdown sums what the trace holds."""

from __future__ import annotations

import glob
import importlib
import json
import os

import pytest
from conftest import BENCH, PORT_COUNTERS, harness, spec

import tracing

FIXTURES = sorted(glob.glob(os.path.join(BENCH, "tests", "data",
                                         "*.trace.json")))


def _load(path):
    with open(path) as f:
        rec = json.load(f)
    run = dict(rec["run"])
    run["trace"] = tracing.Trace(**run["trace"])
    return harness.Run(**run), rec


def test_every_cell_kind_has_a_recorded_trace():
    entries = {harness.load_json(BENCH, "traffic",
                                 f"{w['traffic']}.json")["entry"]
               for w in spec()["workloads"]}
    recorded = {_load(p)[0].traffic["entry"] for p in FIXTURES}
    assert entries <= recorded


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_each_reader_reads_again_what_it_read_on_the_card(path, monkeypatch):
    run, rec = _load(path)
    for short, mod in PORT_COUNTERS.items():
        monkeypatch.setattr(importlib.import_module(f"{harness.PORT}.{mod}"),
                            "last_trace", rec["last_trace"].get(short, {}))
    metrics = harness.metrics_of(spec(), run.cell, "per_layer")
    assert {m["name"] for m in metrics} == set(rec["metrics"])
    for m in metrics:
        got = harness.load_module("layers", m["name"]).read(run)
        assert got == rec["metrics"][m["name"]], m["name"]
        if m["unit"] == "%":
            assert 0 < got <= 100, (m["name"], got)
        else:
            assert got > 0, (m["name"], got)


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_busy_time_and_the_breakdown(path):
    run, rec = _load(path)
    tr = run.trace
    busy = sum(tr.busy_s(c) for c in tr.cards) / len(tr.cards)
    assert busy == pytest.approx(rec["busy_s"])
    assert 0 < busy <= tr.window_s == rec["window_s"]
    b = tracing.breakdown(tr)
    assert 1 <= len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"] == sorted(b["device_ops"], key=lambda x: -x[1])
    idle = sum(v for _, v in tracing.breakdown(tr, top=10**6)["idle_gaps"])
    assert idle == pytest.approx(tr.window_s - busy)


def test_a_reader_finds_nothing_in_an_empty_trace():
    run, _ = _load(FIXTURES[0])
    run.trace = tracing.Trace(ops=[], device=[], window=run.trace.window,
                              cards=run.trace.cards)
    for name in ("h2d_ms.sweep", "unpack_ms.sweep", "gemm_roofline.sweep",
                 "epilogue_roofline.sweep", "device_idle.sweep"):
        assert harness.load_module("layers", name).read(run) is None, name
