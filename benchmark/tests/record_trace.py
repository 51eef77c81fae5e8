"""Record a small traced run on the card for the layer readers' tests.

    python benchmark/tests/record_trace.py <workload> <n proteins>

runs ``workload`` with its corpus cut to ``n`` proteins for a window of
a few jobs under the profiler, and writes
``benchmark/tests/data/<workload>.trace.json``: the reduced trace, what
the readers read besides it, and the value each per-layer metric of the
cell read from it on the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from conftest import (  # noqa: E402
    BENCH, harness, small_config, spec, with_config,
)


def prune(run: dict) -> dict:
    """Keep of the host's events only what the readers read: the window,
    the ops that launched device work, and the shapes of the GEMM calls
    (the idle gaps' labels then name fewer ops than on the card); cut the
    kernels' template names to their first 96 characters."""
    tr = run["trace"]
    tr["device"] = [[d[0][:96]] + d[1:] for d in tr["device"]]
    launched = {d[4] for d in tr["device"]}
    tr["ops"] = [o[:4] + [o[4] if o[0] == "aten::_int_mm" else []] + o[5:]
                 for o in tr["ops"]
                 if o[3] in launched or o[0] in ("benchmark.window",
                                                 "aten::_int_mm")]
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
           "window_s": result["device"].get("window_s")}
    path = os.path.join(BENCH, "tests", "data", f"{workload}.trace.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(path, os.path.getsize(path), out["metrics"], run["jobs"])


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
