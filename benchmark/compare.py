"""The comparison that decides ``correct``.

Every job of the window answers the same question about the same corpus,
so each job's answer is held against the reference's: the pair list row
for row, the eight parity counters, in a cell that clusters the
partition, and whatever further numbers the configuration's reference
declares (its ``CHECKS``, such as the dendrogram's ``merges_wrong``).
The reference's answer decides which are compared: a number is compared
exactly when the answer holds the key it reads. Each number counts what
differs, so the limit of each is 0: the configurations state exact
answers.
"""

from __future__ import annotations

import numpy as np


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


def counters_wrong(got, want: np.ndarray) -> int:
    """Parity counters that differ from the reference's."""
    got = np.asarray(got, np.int64)
    if got.shape != want.shape:
        return len(want)
    return int(np.count_nonzero(got != want))


# name -> (the key of the answer it reads, the function that counts what
# differs); a reference module's ``CHECKS`` add to these
CHECKS = {"pair_rows_wrong": ("pairs", pair_rows_wrong),
          "counters_wrong": ("counters", counters_wrong),
          "labels_wrong": ("labels", labels_wrong)}


def judge(answers: list, failed: int, ref: dict, extra: dict = None):
    """The numbers compared, each the worst over the window's jobs, with
    its limit 0, ``{name: {"value": v, "limit": 0}}``, and the number of
    jobs whose answer was wrong. ``answers`` holds one dict a completed
    job; ``extra`` holds the reference module's ``CHECKS``. A number is
    compared where ``ref`` holds the key it reads; a job whose answer
    lacks that key counts as wrong in all of it. A window that completed
    no job fails."""
    checks = {name: c for name, c in {**CHECKS, **(extra or {})}.items()
              if c[0] in ref}
    worst = {"jobs_failed": failed if answers else max(failed, 1),
             **{name: 0 for name in checks}}
    wrong_jobs = 0
    for a in answers:
        got = {name: fn(a[key], ref[key]) if key in a
               else max(1, len(ref[key]))
               for name, (key, fn) in checks.items()}
        wrong_jobs += any(v > 0 for v in got.values())
        for k, v in got.items():
            worst[k] = max(worst[k], v)
    return ({k: {"value": v, "limit": 0} for k, v in worst.items()},
            wrong_jobs)


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
