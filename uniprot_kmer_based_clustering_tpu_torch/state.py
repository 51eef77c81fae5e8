"""Carry the shared host state onto a torch device.

This system has no weights; its device state is the packed presence
matrix, the per-protein AMR classes and the optional BLOSUM column
weights. All three are built by the host stages (numpy / C++) and cross
over here unchanged, unless the index was built on the device, whose
words stay there.
"""

from __future__ import annotations

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
    BitsetMatrix,
    DeviceBitsetMatrix,
)


def bitset_to_torch(bitset: BitsetMatrix, device) -> torch.Tensor:
    """The packed uint32 words [N_pad, W_pad] as int32 on ``device``.

    ``view(np.int32)`` reinterprets the same bits without a copy (torch's
    uint32 support is thin: ``>>`` is missing on the CPU); on the CPU the
    tensor shares the numpy buffer. A bitset built on the device
    (``DeviceBitsetMatrix``) gives its own tensor, with no copy when it
    already lies on ``device``, and never passes through the host."""
    if isinstance(bitset, DeviceBitsetMatrix):
        return bitset.device_words.to(device)
    words = np.ascontiguousarray(bitset.words).view(np.int32)
    return torch.from_numpy(words).to(device)


def classes_to_torch(class_ids, n_pad: int, device) -> torch.Tensor:
    """Per-protein class ids padded to ``n_pad`` with −1, int32."""
    ids = np.asarray(class_ids, dtype=np.int32)
    classes = np.full(n_pad, -1, dtype=np.int32)
    classes[: ids.shape[0]] = ids
    return torch.from_numpy(classes).to(device)


def weights_to_torch(weights, device) -> torch.Tensor:
    """int8 BLOSUM column weights [W_pad*32] on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(weights, dtype=np.int8)).to(
        device
    )
