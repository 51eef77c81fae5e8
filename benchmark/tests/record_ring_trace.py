"""Record a small traced run of a mesh cell on its cards for the ring
readers' tests.

    python benchmark/tests/record_ring_trace.py <workload> <n proteins>

does what ``record_trace.py`` does, but keeps the port's ``ukc.*`` spans
among the host's events, and adds to the file the counts that the
program counters read (``parallel.sharded.last_trace`` of the window's
last job), so that the readers of spans and counters read again on the
CPU what they read on the cards.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import record_trace  # noqa: E402
from conftest import BENCH  # noqa: E402

PRUNE = record_trace.prune


def prune(run: dict) -> dict:
    """``record_trace.prune``, keeping the ``ukc.*`` spans (without
    shapes)."""
    spans = [o[:4] + [[]] + o[5:] for o in run["trace"]["ops"]
             if o[0].startswith("ukc.")]
    run = PRUNE(run)
    kept = {o[3] for o in run["trace"]["ops"]}
    run["trace"]["ops"] += [o for o in spans if o[3] not in kept]
    return run


def main(workload: str, n: int) -> None:
    from uniprot_kmer_based_clustering_tpu_torch.parallel import sharded

    record_trace.prune = prune
    record_trace.main(workload, n)
    path = os.path.join(BENCH, "tests", "data", f"{workload}.trace.json")
    with open(path) as f:
        out = json.load(f)
    out["last_trace"] = dict(sharded.last_trace)
    with open(path, "w") as f:
        json.dump(out, f)
    print(path, os.path.getsize(path), out["last_trace"])


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
