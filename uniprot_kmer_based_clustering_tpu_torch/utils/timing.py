"""Structured per-stage timing, and spans on the profiler's clock.

Replaces the reference's ad-hoc ``Instant::now()`` + eprintln pairs
(``src/main.rs:216-230``, ``src/graph/mod.rs:57-59,126-128,…``) with a
collected dict that the CLI and bench report as JSON (the port's copy of
the JAX package's ``utils/timing.py``).

:func:`span` names an interval of the port's host work inside a
``torch.profiler`` trace (``cli run --profile``, the benchmark's traced
runs): a ``record_function`` range called ``ukc.<name>``, stamped by the
same profiler that stamps the kernels and copies, so an idle gap of the
card can be put down to the span open on the host at the time. With no
profiler running a span reads one module flag and does nothing else.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "ukc."


@contextlib.contextmanager
def span(name: str):
    """The body as the profiler range ``ukc.<name>`` while a profiler
    records; otherwise nothing (no clock read, nothing on the device)."""
    if not _autograd_profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class StageTimers:
    def __init__(self, echo: bool = False):
        self.seconds: Dict[str, float] = {}
        self.echo = echo

    @contextlib.contextmanager
    def stage(self, name: str):
        """Add the body's seconds to ``name``; under a profiler the body
        is also the span ``ukc.stage.<name>``."""
        t0 = time.perf_counter()
        try:
            with span(f"stage.{name}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            if self.echo:
                print(f"[stage] {name}: {dt:.3f}s", file=sys.stderr)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)
