"""Shared pieces of the harness's tests: they drive the harness on the
CPU, past its look for a card, at corpora of a few hundred proteins."""

from __future__ import annotations

import contextlib
import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)

import harness  # noqa: E402

# the port's counters that readers read, by the key a recorded fixture
# keeps them under: the module (under the port) whose ``last_trace`` the
# window's last job left
PORT_COUNTERS = {"pairwise": "similarity.pairwise",
                 "sharded": "parallel.sharded",
                 "index_device": "kmers.index_device"}

# the corpus cut to 300 proteins: the classes in the same proportions
# and a family of two classes, so that cross-class pairs pass the
# threshold
SMALL = {"n": 300,
         "class_sizes": [112, 100, 24, 24, 17, 11, 6, 5, 1],
         "fixed_families": [{"classes": [7, 2], "members": [2, 8],
                             "length": 300}],
         "proteins_per_family": 6}


def small_config(workload: str, **pipeline) -> dict:
    """The cell's configuration at a few hundred proteins, on the plain
    int8 path that the card runs (``engine="mxu"``; the CPU's default
    would be the host C++ sweep)."""
    _, config, _ = harness.cell_parts(spec(), workload)
    config = copy.deepcopy(config)
    config["corpus"].update(copy.deepcopy(SMALL))
    config["pipeline"].update({"engine": "mxu", **pipeline})
    return config


def spec() -> dict:
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


@pytest.fixture(autouse=True)
def _private_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE_DIR", str(tmp_path / "reference"))


@contextlib.contextmanager
def with_config(config: dict, device: str = "cpu"):
    """The harness's run on ``device``, the CPU unless asked otherwise,
    with ``config`` in place of the cell's configuration file."""
    cell_parts = harness.cell_parts

    def small_parts(spec_, workload):
        cell, _, traffic = cell_parts(spec_, workload)
        return cell, config, traffic

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "DEVICE", device)
        mp.setattr(harness, "cell_parts", small_parts)
        yield


def run_cpu(workload: str, seed: int = 2**31 + 11, seconds: float = 0.3,
            traced: bool = False, config=None):
    """One run of ``workload`` on the CPU: (result line, info, checks)."""
    with with_config(config or small_config(workload)):
        return harness.measure(spec(), workload, seed, seconds, traced)
