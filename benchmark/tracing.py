"""The traced window: what ``torch.profiler`` recorded, reduced to plain
records that the layer readers and the breakdown read.

A :class:`Trace` holds, in nanoseconds on the profiler's clock:

- ``ops``: the host's events (PyTorch ops and the benchmark's own
  ``record_function`` spans), ``[name, start, end, id, shapes, thread]``;
- ``device``: every kernel, copy and fill that ran on a card,
  ``[name, card, start, end, op id]``, where ``op id`` is the id of the
  innermost host event that launched it;
- ``window``: the start and end of the ``benchmark.window`` span;
- ``cards``: the cards the cell uses.

It is plain data, so a trace recorded on the card can be saved as JSON
and read again by the tests (``tests/record_trace.py``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

WINDOW_SPAN = "benchmark.window"
JOB_SPAN = "benchmark.job"
HOST_ONLY = "host: Python or numpy, no PyTorch op"


@dataclasses.dataclass
class Trace:
    ops: list
    device: list
    window: list
    cards: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def op_names(self) -> Dict[int, str]:
        return {o[3]: o[0] for o in self.ops}

    def device_seconds(self, launched_by=None, name_has=None,
                       card: Optional[int] = None) -> float:
        """Seconds of device work inside the window, summed over events
        (and cards): those launched by a host op named in ``launched_by``,
        or whose name holds one of ``name_has``."""
        names = self.op_names() if launched_by else {}
        total = 0
        for name, dev, start, end, op in self._in_window():
            if card is not None and dev != card:
                continue
            if launched_by and names.get(op) not in launched_by:
                continue
            if name_has and not any(s in name for s in name_has):
                continue
            total += end - start
        return total / 1e9

    def busy_s(self, card: int) -> float:
        """Seconds of the window in which anything ran on ``card``: the
        union of its events' intervals."""
        return sum(b - a for a, b in self._busy(card)) / 1e9

    def _in_window(self):
        w0, w1 = self.window
        for name, dev, start, end, op in self.device:
            if end > w0 and start < w1:
                yield name, dev, max(start, w0), min(end, w1), op

    def _busy(self, card: int) -> List[list]:
        spans = sorted([s, e] for _, d, s, e, _ in self._in_window()
                       if d == card)
        merged: List[list] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def idle_gaps(self, card: int) -> List[list]:
        """The idle intervals of ``card`` inside the window."""
        edges = [self.window[0]]
        for s, e in self._busy(card):
            edges += [s, e]
        edges.append(self.window[1])
        return [[a, b] for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def _main_thread_ops(self) -> list:
        thread = next((o[5] for o in self.ops if o[0] == WINDOW_SPAN), None)
        return sorted((o for o in self.ops if o[5] == thread),
                      key=lambda o: (o[1], -o[2]))

    def label_gaps(self, gaps: List[list]) -> List[str]:
        """What the host was doing in the middle of each gap: the innermost
        PyTorch op that was running on the thread of the window, or
        ``HOST_ONLY`` when only the benchmark's own spans were open."""
        ops = self._main_thread_ops()
        order = sorted(range(len(gaps)), key=lambda g: sum(gaps[g]))
        labels = [HOST_ONLY] * len(gaps)
        stack: list = []
        i = 0
        for g in order:
            t = sum(gaps[g]) // 2
            while i < len(ops) and ops[i][1] <= t:
                while stack and stack[-1][2] < ops[i][1]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            inner = [o for o in stack if not o[0].startswith("benchmark.")]
            if inner:
                labels[g] = inner[-1][0]
        return labels


def capture(prof, cards: list) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops, device, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, start, end = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() > 0:
                continue  # runtime calls (launches, syncs) of an op
            if name == WINDOW_SPAN:
                window = [start, end]
            ops.append([name, start, end, e.correlation_id(),
                        [list(s) for s in e.shapes()],
                        e.start_thread_id()])
        elif not e.is_user_annotation() and not name.startswith("benchmark."):
            device.append([name, e.device_index(), start, end,
                           e.linked_correlation_id()])
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    return Trace(ops=ops, device=device, window=window, cards=list(cards))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (seconds summed over the
    cards) and the idle time of the cards by what the host was doing
    (seconds a card, averaged over the cards)."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, _, start, end, _ in trace._in_window():
        by_name[name] += (end - start) / 1e9
    idle: Dict[str, float] = defaultdict(float)
    for card in trace.cards:
        gaps = trace.idle_gaps(card)
        for (a, b), label in zip(gaps, trace.label_gaps(gaps)):
            idle[label] += (b - a) / 1e9 / len(trace.cards)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_ops": ranked(by_name), "idle_gaps": ranked(idle)}
