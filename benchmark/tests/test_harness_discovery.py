"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries: in a copy of the benchmark, new ones run
with no file that was there edited. So is a cell whose configuration
names its own plain reference, the agglomerative one."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, SMALL, harness


def test_a_cell_added_in_a_copy_runs_with_its_own_metric(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "data"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    spec = harness.load_json(harness.ROOT, "BENCHMARK.json")

    config = harness.load_json(BENCH, "configs", "arg_k5_n10619.json")
    config.update(name="arg_k5_n777")
    config["corpus"].update(SMALL)
    config["pipeline"]["engine"] = "mxu"
    (root / "benchmark/configs/arg_k5_n777.json").write_text(
        json.dumps(config))
    traffic = harness.load_json(BENCH, "traffic", "sweep.json")
    (root / "benchmark/traffic/sweep_again.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/layers/jobs_seen.tiny.py").write_text(
        "def read(run):\n    return float(run.jobs)\n")
    spec["configs"].append({"name": "arg_k5_n777", "source": "x",
                            "file": "benchmark/configs/arg_k5_n777.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny.sweep", "config": "arg_k5_n777",
                              "traffic": "sweep_again", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("tiny.sweep")
    spec["per_layer"].append({"name": "jobs_seen.tiny", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "x", "moves": "pairs_per_s",
                              "workloads": ["tiny.sweep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    code = f"""
import json, sys
sys.path.insert(0, {str(root / 'benchmark')!r})
import harness
harness.DEVICE = "cpu"
spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
out = []
for traced in (False, True):
    result, _, _ = harness.measure(spec, "tiny.sweep", 5, 0.2, traced)
    out.append(result)
print(json.dumps(out))
"""
    env = {**os.environ, "PYTHONPATH": harness.ROOT}
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    plain, traced = json.loads(run.stdout.splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"pairs_per_s", "setup_s"}
    assert traced["metrics"]["jobs_seen.tiny"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_an_agglomerative_cell_added_in_a_copy_is_checked_by_its_reference(
        tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "data"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    spec = harness.load_json(harness.ROOT, "BENCHMARK.json")

    config = harness.load_json(BENCH, "configs", "arg_k5_n10619.json")
    config.update(name="arg_k5_n300_agglomerative", reference="agglomerative")
    config["corpus"].update(SMALL)
    config["pipeline"].update(engine="mxu", cluster="agglomerative",
                              min_shared=1)
    (root / "benchmark/configs/arg_k5_n300_agglomerative.json").write_text(
        json.dumps(config))
    spec["configs"].append({"name": "arg_k5_n300_agglomerative",
                            "source": "x", "reduced": [], "why": "x",
                            "file": "benchmark/configs/"
                                    "arg_k5_n300_agglomerative.json"})
    spec["workloads"].append({"name": "tiny.agglomerative",
                              "config": "arg_k5_n300_agglomerative",
                              "traffic": "job", "chips": 1, "why": "x"})
    job_s = next(m for m in spec["end_to_end"] if m["name"] == "job_s")
    job_s["workloads"].append("tiny.agglomerative")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    code = f"""
import json, sys
sys.path.insert(0, {str(root / 'benchmark')!r})
import harness
harness.DEVICE = "cpu"
spec = harness.load_json(harness.ROOT, "BENCHMARK.json")
result, _, checks = harness.measure(spec, "tiny.agglomerative", 5, 0.2, False)
print(json.dumps([result, checks]))
"""
    env = {**os.environ, "PYTHONPATH": harness.ROOT}
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    result, checks = json.loads(run.stdout.splitlines()[-1])
    assert result["correct"], checks
    assert set(result["metrics"]) == {"job_s", "setup_s"}  # no peak on the CPU
    assert list(checks) == ["jobs_failed", "pair_rows_wrong",
                            "counters_wrong", "labels_wrong", "merges_wrong"]
    for p, data in before.items():
        assert p.read_bytes() == data, p
