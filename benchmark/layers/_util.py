"""What the layer readers share."""

from __future__ import annotations

import statistics

UNPACK_OPS = ("aten::bitwise_right_shift", "aten::bitwise_and_")
INT_MM = "aten::_int_mm"
EPILOGUE_KERNEL = "stats_epilogue"


def per_job_stage(run, names) -> float | None:
    """Mean over the window's jobs of the summed ``StageTimers`` seconds of
    the stages ``names``; None when no job reported them."""
    seen = [t for t in run.timings if any(n in t for n in names)]
    if not seen:
        return None
    return statistics.fmean(sum(t.get(n, 0.0) for n in names) for t in seen)


def idle_pct(run) -> float | None:
    """Percent of the traced window with nothing on the card, the mean of
    the cards' shares."""
    tr = run.trace
    if tr is None or not tr.cards or not tr.device:
        return None
    busy = statistics.fmean(tr.busy_s(c) for c in tr.cards)
    return 100.0 * (1.0 - busy / tr.window_s)


def per_job_ms(run, seconds: float) -> float | None:
    if not run.jobs or seconds <= 0:
        return None
    return seconds / run.jobs * 1e3
