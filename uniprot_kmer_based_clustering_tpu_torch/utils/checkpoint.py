"""Stage-artifact checkpointing (save / resume).

The reference keeps all intermediate state in RAM and restarts from
scratch on any failure (SURVEY.md §5: no checkpoint/resume). Here every
stage's arrays are persisted as .npz keyed by a config hash, so
a killed run resumes from the last completed stage and downstream stages
(clustering, alignment) can be re-run without recomputing the sweep.

The port's own copy of the JAX package's ``utils/checkpoint.py``: the same
file format and keys, so a checkpoint directory written by either package
resumes in the other. In a ``torch.distributed`` world of several
processes (``cli run --distributed``) the artifacts are replicated and
only rank 0 writes or removes them, as only JAX process 0 does (ranks
share the checkpoint filesystem); every rank loads.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np


def _writes() -> bool:
    """False on a rank other than 0 of a multi-process torch world. Only
    a process that made a group has ``torch.distributed`` loaded with one
    initialised, so this numpy-only module imports nothing for it."""
    dist = sys.modules.get("torch.distributed")
    return not (dist is not None and dist.is_available()
                and dist.is_initialized() and dist.get_world_size() > 1
                and dist.get_rank() != 0)


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
        if not p or not _writes():
            return
        tmp = p[: -len(".npz")] + f".tmp.{os.getpid()}.npz"
        (np.savez_compressed if compressed else np.savez)(tmp, **arrays)
        os.replace(tmp, p)

    def remove(self, key: str) -> None:
        """Delete ``key``'s artifact, if there is one (rank 0 only)."""
        p = self.path(key)
        if p and _writes() and os.path.exists(p):
            os.remove(p)
