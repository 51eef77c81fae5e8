"""``BENCHMARK.json`` keeps its schema, every name in it has its file, and
a run's last line has the keys and types that its readers read."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
from conftest import BENCH, harness, run_cpu, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_the_benchmark_file_keeps_its_schema():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"][1] == "benchmark/run.py"
    assert 1 <= s["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(s)) <= 64 * 1024
    used = {w["config"] for w in s["workloads"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    fours = [w for w in s["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(s["workloads"]) // 4)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for kind in ("end_to_end", "per_layer"):
        for m in s[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            folder = "end_to_end" if kind == "end_to_end" else "layers"
            assert os.path.exists(os.path.join(BENCH, folder,
                                               f"{m['name']}.py"))
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        for cell in m["workloads"]:
            reports = harness.metrics_of(s, {"name": cell}, "end_to_end")
            assert m["moves"] in {r["name"] for r in reports}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in s["workloads"]:
        e = {m["name"] for m in harness.metrics_of(s, w, "end_to_end")}
        assert "setup_s" in e and len(e) >= 2
        assert harness.metrics_of(s, w, "per_layer")


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_the_result_keys(traced):
    result, _, checks = run_cpu("arg10k.sweep", traced=traced)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks" and result["checks"] == checks
    assert isinstance(result["correct"], bool)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if not traced:
        assert set(result["metrics"]) == {"pairs_per_s", "setup_s"}
    for c in checks.values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_without_a_card_the_run_prints_no_result_and_fails():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "arg10k.sweep",
         "--seed", str(2**32 + 1), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
