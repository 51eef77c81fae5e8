"""Record a small traced run of ``arg10k.k7dev`` on the card for its
readers' tests.

    python benchmark/tests/record_k7dev_trace.py <n proteins>

does what ``record_trace.py`` does, keeping the port's ``ukc.*`` spans
among the host's events as ``record_ring_trace.py`` does, and adds to
the file the counts that ``link_mb.k7dev`` reads, those of the window's
last job (``kmers.index_device.last_trace`` and
``similarity.pairwise.last_trace``), so that the readers read again on
the CPU what they read on the card.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import record_ring_trace  # noqa: E402
import record_trace  # noqa: E402
from conftest import BENCH  # noqa: E402

CELL = "arg10k.k7dev"


def main(n: int) -> None:
    from uniprot_kmer_based_clustering_tpu_torch.kmers import index_device
    from uniprot_kmer_based_clustering_tpu_torch.similarity import pairwise

    record_trace.prune = record_ring_trace.prune
    record_trace.main(CELL, n)
    path = os.path.join(BENCH, "tests", "data", f"{CELL}.trace.json")
    with open(path) as f:
        out = json.load(f)
    out["last_trace"] = {"index_device": dict(index_device.last_trace),
                         "pairwise": dict(pairwise.last_trace)}
    with open(path, "w") as f:
        json.dump(out, f)
    print(path, os.path.getsize(path), out["last_trace"])


if __name__ == "__main__":
    main(int(sys.argv[1]))
