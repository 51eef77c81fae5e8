"""The comparison that decides ``correct``.

Every job of the window answers the same question about the same corpus,
so each job's answer is held against the reference's: the pair list row
for row, the eight parity counters, and in a cell that clusters, the
partition. Each number compared counts what differs, so the limit of each
is 0: the configuration states exact answers.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"jobs_failed": 0, "pair_rows_wrong": 0, "counters_wrong": 0,
          "labels_wrong": 0}


def _rows(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.int64)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))).ravel()


def pair_rows_wrong(got, want: np.ndarray) -> int:
    """Rows of the symmetric difference of two (i, j, count) lists, plus
    any out of (i, j) order: 0 only for the same list in the same
    order."""
    got = np.asarray(got)
    if got.ndim != 2 or got.shape[1] != 3:
        return len(want) + int(got.size)
    if got.shape == want.shape and np.array_equal(got, want):
        return 0
    got = got.astype(np.int64)
    out_of_order = int(np.count_nonzero(
        np.diff(got[:, 0] * (1 << 32) + got[:, 1]) <= 0))
    return int(len(np.setxor1d(_rows(got), _rows(want)))) + out_of_order


def labels_wrong(got, want: np.ndarray) -> int:
    """Proteins whose component, labelled by its smallest member, differs
    from the reference's."""
    got = np.asarray(got, np.int64)
    if got.shape != want.shape or (len(got) and (
            got.min() < 0 or got.max() >= len(got))):
        return len(want)
    smallest = np.full(len(got), len(got), np.int64)
    np.minimum.at(smallest, got, np.arange(len(got)))
    return int(np.count_nonzero(smallest[got] != want))


def judge(answers: list, failed: int, ref: dict):
    """The numbers compared, each the worst over the window's jobs, with
    its limit, ``{name: {"value": v, "limit": l}}``, and the number of
    jobs whose answer was wrong. ``answers`` holds one dict a completed
    job (``pairs``, ``counters`` and, where the cell clusters,
    ``labels``); a window that completed no job fails."""
    worst = {"jobs_failed": failed if answers else max(failed, 1),
             "pair_rows_wrong": 0, "counters_wrong": 0}
    if "labels" in ref:
        worst["labels_wrong"] = 0
    wrong_jobs = 0
    for a in answers:
        got = {"pair_rows_wrong": pair_rows_wrong(a["pairs"], ref["pairs"]),
               "counters_wrong": int(np.count_nonzero(
                   np.asarray(a["counters"], np.int64) != ref["counters"]))}
        if "labels" in ref:
            got["labels_wrong"] = labels_wrong(a["labels"], ref["labels"])
        wrong_jobs += any(v > LIMITS[k] for k, v in got.items())
        for k, v in got.items():
            worst[k] = max(worst[k], v)
    return ({k: {"value": v, "limit": LIMITS[k]} for k, v in worst.items()},
            wrong_jobs)


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
