"""Structured per-stage timing.

Replaces the reference's ad-hoc ``Instant::now()`` + eprintln pairs
(``src/main.rs:216-230``, ``src/graph/mod.rs:57-59,126-128,…``) with a
collected dict that the CLI and bench report as JSON (the port's copy of
the JAX package's ``utils/timing.py``).
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict


class StageTimers:
    def __init__(self, echo: bool = False):
        self.seconds: Dict[str, float] = {}
        self.echo = echo

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            if self.echo:
                print(f"[stage] {name}: {dt:.3f}s", file=sys.stderr)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)
