"""Record a small traced run of ``arg10k.agglo`` on the card for its
readers' tests.

    python benchmark/tests/record_agglo_trace.py <n proteins>

is ``record_trace.py arg10k.agglo <n proteins>`` with the counts of the
agglomerative rounds (``models.agglomerative.last_trace``, kept under
``"agglomerative"``) among the port's counters that it keeps.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_harness_agglo  # noqa: E402,F401  (adds the rounds' counters)
import record_trace  # noqa: E402

if __name__ == "__main__":
    record_trace.main("arg10k.agglo", int(sys.argv[1]))
