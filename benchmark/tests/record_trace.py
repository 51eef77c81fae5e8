"""Record a small traced run on the card for the layer readers' tests.

    python benchmark/tests/record_trace.py <workload> <n proteins>

runs ``workload`` with its corpus cut to ``n`` proteins for a window of
a few jobs under the profiler, and writes
``benchmark/tests/data/<workload>.trace.json``: the reduced trace, what
the readers read besides it (the port's counters of the window's last
job, ``last_trace`` of each module in ``conftest.PORT_COUNTERS``), and
the value each per-layer metric of the cell read from it on the card.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from conftest import (  # noqa: E402
    BENCH, PORT_COUNTERS, harness, small_config, spec, with_config,
)

import tracing  # noqa: E402


def _gap_middles(trace: dict) -> np.ndarray:
    tr = tracing.Trace(**trace)
    return np.sort([sum(g) // 2 for c in tr.cards for g in tr.idle_gaps(c)])


def prune(run: dict) -> dict:
    """Keep of the host's events only what the readers read: the window,
    the ops that launched device work, the port's ``ukc.*`` spans, the
    ops of the window's thread that were open in the middle of an idle
    gap (so that the gaps' labels read as on the card), and the shapes of
    the GEMM calls alone; cut the kernels' template names to their first
    96 characters."""
    tr = run["trace"]
    middles = _gap_middles(tr)
    thread = next(o[5] for o in tr["ops"] if o[0] == tracing.WINDOW_SPAN)

    def open_in_a_gap(o):
        i = np.searchsorted(middles, o[1])
        return o[5] == thread and i < len(middles) and middles[i] <= o[2]

    tr["device"] = [[d[0][:96]] + d[1:] for d in tr["device"]]
    launched = {d[4] for d in tr["device"]}
    tr["ops"] = [o[:4] + [o[4] if o[0] == "aten::_int_mm" else []] + o[5:]
                 for o in tr["ops"]
                 if o[3] in launched or o[0].startswith("ukc.")
                 or o[0] in (tracing.WINDOW_SPAN, "aten::_int_mm")
                 or open_in_a_gap(o)]
    return run


def main(workload: str, n: int) -> None:
    config = small_config(workload, engine="auto")
    sizes = config["corpus"]["class_sizes"]
    sizes[0] += n - sum(sizes)
    config["corpus"]["n"] = n
    runs = []

    class KeptRun(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

    harness.Run = KeptRun
    with with_config(config, device="cuda"):
        result, _, _ = harness.measure(spec(), workload, 2**31 + 99, 0.05,
                                       True)
    run = prune(dataclasses.asdict(runs[0]))
    out = {"run": run,
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "busy_s": result["device"].get("busy_s"),
           "window_s": result["device"].get("window_s"),
           "last_trace": {
               short: dict(getattr(importlib.import_module(
                   f"{harness.PORT}.{mod}"), "last_trace"))
               for short, mod in PORT_COUNTERS.items()}}
    kept = dict(run, trace=tracing.Trace(**run["trace"]))
    again = {m: harness.load_module("layers", m).read(harness.Run(**kept))
             for m in out["metrics"]}
    if again != out["metrics"]:
        print("the pruned trace reads", again, file=sys.stderr)
    path = os.path.join(BENCH, "tests", "data", f"{workload}.trace.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(path, os.path.getsize(path), out["metrics"], run["jobs"])


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
