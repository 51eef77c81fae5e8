"""Record a small traced run of ``arg10k.k7dev`` on the card for its
readers' tests.

    python benchmark/tests/record_k7dev_trace.py <n proteins>

is ``record_trace.py arg10k.k7dev <n proteins>``, which keeps the port's
``ukc.*`` spans and the counters ``link_mb.k7dev`` reads, those of the
window's last job (``kmers.index_device.last_trace`` and
``similarity.pairwise.last_trace``).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import record_trace  # noqa: E402

if __name__ == "__main__":
    record_trace.main("arg10k.k7dev", int(sys.argv[1]))
