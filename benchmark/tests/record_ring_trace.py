"""Record a small traced run of a mesh cell on its cards for the ring
readers' tests.

    python benchmark/tests/record_ring_trace.py <workload> <n proteins>

is ``record_trace.py`` (which keeps the port's ``ukc.*`` spans and the
counters of the window's last job, ``parallel.sharded.last_trace``
among them), run on as many cards as the cell asks for.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import record_trace  # noqa: E402

if __name__ == "__main__":
    record_trace.main(sys.argv[1], int(sys.argv[2]))
