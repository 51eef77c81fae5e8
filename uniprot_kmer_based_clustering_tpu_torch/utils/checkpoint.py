"""Stage-artifact checkpointing (save / resume).

The reference keeps all intermediate state in RAM and restarts from
scratch on any failure (SURVEY.md §5: no checkpoint/resume). Here every
stage's arrays are persisted as .npz keyed by a config hash, so
a killed run resumes from the last completed stage and downstream stages
(clustering, alignment) can be re-run without recomputing the sweep.

The port's own copy of the JAX package's ``utils/checkpoint.py``: the same
file format and keys, so a checkpoint directory written by either package
resumes in the other. The port runs one process, so every save writes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class CheckpointStore:
    def __init__(self, directory: Optional[str]):
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)

    def path(self, key: str) -> Optional[str]:
        if not self.directory:
            return None
        return os.path.join(self.directory, f"{key}.npz")

    def load(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        p = self.path(key)
        if not p or not os.path.exists(p):
            return None
        with np.load(p, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def save(self, key: str, *, compressed: bool = True, **arrays) -> None:
        """Persist ``arrays`` under ``key``. ``compressed=False`` writes a
        plain .npz, which either package loads alike: the stream engines'
        group snapshots, saved at every group boundary, take it, since
        compressing a 1 MB row-statistics snapshot costs ~0.1 s."""
        p = self.path(key)
        if not p:
            return
        tmp = p[: -len(".npz")] + f".tmp.{os.getpid()}.npz"
        (np.savez_compressed if compressed else np.savez)(tmp, **arrays)
        os.replace(tmp, p)
