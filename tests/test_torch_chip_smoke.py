"""chip_smoke.py's end of run: every process the run started is stopped,
and no other. The phases themselves need the card and run only there."""

import importlib.util
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _square(x):
    return x * x


@pytest.fixture
def marked_run(monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setenv(cs.RUN_TOKEN, f"{os.getpid()}.{time.time_ns()}")
    return cs


def test_stop_leftovers_stops_tracker_child_and_orphan(marked_run):
    cs = marked_run
    from multiprocessing import resource_tracker

    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        assert pool.submit(_square, 7).result() == 49
    tracker = resource_tracker._resource_tracker._pid
    child = subprocess.Popen(["sleep", "120"])
    subprocess.run(["sh", "-c", "sleep 121 & exit 0"], check=True)
    deadline = time.monotonic() + 10
    while len(cs._marked_pids()) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert child.pid in cs._marked_pids()
    cs.stop_leftovers()
    assert cs._marked_pids() == []
    assert child.poll() is not None
    assert resource_tracker._resource_tracker._pid is None
    if tracker is not None:
        with pytest.raises(ProcessLookupError):
            os.kill(tracker, 0)


def test_stop_leftovers_leaves_unmarked_processes(marked_run):
    cs = marked_run
    env = {k: v for k, v in os.environ.items() if k != cs.RUN_TOKEN}
    other = subprocess.Popen(["sleep", "120"], env=env)
    try:
        cs.stop_leftovers(wait_s=0.2)
        assert other.poll() is None
    finally:
        other.kill()
        other.wait()


@pytest.mark.parametrize("where", ["checkout_without_card", "alone"])
def test_exits_nonzero_without_a_result(where, tmp_path):
    """No card visible (``CUDA_VISIBLE_DEVICES`` empty), or a directory
    holding chip_smoke.py and nothing else of the repository."""
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


FAKE_WORKER = """
import json, os, sys, time
spec = json.loads(sys.argv[2])
time.sleep(spec.get("sleep", 0))
if spec.get("fail_rank") == int(os.environ["RANK"]):
    sys.exit(3)
print("DIST " + json.dumps({"case": spec["case"],
                            "rank": int(os.environ["RANK"]),
                            "world": int(os.environ["WORLD_SIZE"]),
                            "port": os.environ["MASTER_PORT"]}))
"""


@pytest.fixture
def fake_workers(tmp_path):
    cs = _chip_smoke()
    worker = tmp_path / "worker.py"
    worker.write_text(FAKE_WORKER)
    cs.__file__ = str(worker)
    return cs


def test_launch_ranks_runs_jobs_at_once_with_their_own_ports(fake_workers):
    cs = fake_workers
    t0 = time.perf_counter()
    out = cs._launch_ranks([({"case": "a", "sleep": 4.0}, 1),
                            ({"case": "d", "sleep": 4.0}, 3)])
    wall = time.perf_counter() - t0
    assert [[x["rank"] for x in lines] for lines, _ in out] == [[0], [0, 1, 2]]
    assert [{x["case"] for x in lines} for lines, _ in out] == [{"a"}, {"d"}]
    assert {x["world"] for x in out[1][0]} == {3}
    ports = [{x["port"] for x in lines} for lines, _ in out]
    assert all(len(p) == 1 for p in ports) and ports[0] != ports[1]
    assert all(4.0 <= w <= wall for _, w in out)
    assert wall < 7.0  # one after the other would take 8 s


def test_launch_ranks_fails_on_a_rank_that_exits_nonzero(fake_workers):
    with pytest.raises(AssertionError, match="case b: rank 1 exited 3"):
        fake_workers._launch_ranks([({"case": "a"}, 1),
                                    ({"case": "b", "fail_rank": 1}, 2)])


def test_launch_ranks_kills_every_worker_after_the_timeout(fake_workers,
                                                           monkeypatch):
    cs = fake_workers
    monkeypatch.setattr(cs, "DIST_TIMEOUT", 2)
    t0 = time.perf_counter()
    with pytest.raises(AssertionError, match=r"\['a', 'b'\]: a worker "
                                             r"outlived 2 s"):
        cs._launch_ranks([({"case": "a", "sleep": 60}, 2),
                          ({"case": "b"}, 1)])
    assert time.perf_counter() - t0 < 30


def test_dist_waves_cover_every_case_once():
    cs = _chip_smoke()
    assert sorted("".join(cs.DIST_WAVES)) == list("abcde")


def test_bench_runs_runs_every_bench_once_and_in_parallel(monkeypatch):
    cs = _chip_smoke()
    import threading

    active, peak, seen = [0], [0], []
    lock = threading.Lock()

    def fake_line(label, argv, smi, knobs=None):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            seen.append((label, argv[0], dict(knobs or {})))
        time.sleep(0.2)
        with lock:
            active[0] -= 1
        return {"label": label}

    monkeypatch.setattr(cs, "_bench_line", fake_line)
    lines = cs.bench_runs("card, 700.00 W")
    labels = ["cluster", "scale", "query", "engines", "cli bench",
              "pod flat", "pod 1x1", "pod nccl"]
    assert sorted(lines) == sorted(labels)
    assert all(lines[k] == {"label": k} for k in labels)
    assert peak[0] == cs.BENCH_PARALLEL
    knobs = {label: k for label, _, k in seen}
    assert knobs["cluster"] == {"UKC_CLUSTER_COMPONENTS_N": "30000",
                                "UKC_CLUSTER_AGG_N": "10619",
                                "UKC_CLUSTER_N": "5000"}
    assert knobs["query"] == {"UKC_QUERY_STREAM": "1"}
    assert knobs["pod nccl"]["UKC_POD_DISTRIBUTED"] == "1"
    assert knobs["pod nccl"]["WORLD_SIZE"] == "1"
