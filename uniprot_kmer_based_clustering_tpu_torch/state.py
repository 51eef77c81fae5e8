"""Carry the shared host state onto a torch device.

This system has no weights; its device state is the packed presence
matrix, the per-protein AMR classes and the optional BLOSUM column
weights. All three are built by the host stages (numpy / C++) and cross
over here unchanged, unless the index was built on the device, whose
words stay there. Bound for a CUDA device they leave page-locked host
memory, so each upload is an asynchronous DMA on the current stream.
"""

from __future__ import annotations

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.kmers.bitset import (
    BitsetMatrix,
    DeviceBitsetMatrix,
    pinned_of,
)


def to_device(x, dtype, device) -> torch.Tensor:
    """``x`` (a tensor or numpy array) as a ``dtype`` tensor on
    ``device``, with no host sync: host data bound for a CUDA device is
    first copied into page-locked memory, so its upload is an
    asynchronous DMA on the current stream (a pageable copy to the card
    blocks)."""
    device = torch.device(device)
    t = torch.as_tensor(x, dtype=dtype)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def bitset_to_torch(bitset: BitsetMatrix, device) -> torch.Tensor:
    """The packed uint32 words [N_pad, W_pad] as int32 on ``device``.

    Words packed into page-locked memory (``bitset.pinned``) go to a CUDA
    device as an asynchronous DMA on the current stream: the call returns
    at once, and every later op on that stream sees the words. The copy
    reads the allocator's own tensor, never a view of it, so that the
    caching host allocator records the copy and does not hand the block
    out again while it runs. Pageable words (a CPU pack, or one above
    the pin cap) are copied as before, and the host waits for that copy.

    ``view(np.int32)`` reinterprets the same bits without a copy (torch's
    uint32 support is thin: ``>>`` is missing on the CPU); on the CPU the
    tensor shares the host buffer. A bitset built on the device
    (``DeviceBitsetMatrix``) gives its own tensor, with no copy when it
    already lies on ``device``, and never passes through the host."""
    if isinstance(bitset, DeviceBitsetMatrix):
        return bitset.device_words.to(device)
    pinned = pinned_of(bitset)
    if pinned is not None:
        return pinned.to(device, non_blocking=True)
    words = np.ascontiguousarray(bitset.words).view(np.int32)
    return torch.from_numpy(words).to(device)


def classes_to_torch(class_ids, n_pad: int, device) -> torch.Tensor:
    """Per-protein class ids padded to ``n_pad`` with −1, int32; to a
    CUDA device through page-locked memory, asynchronously."""
    ids = np.asarray(class_ids, dtype=np.int32)
    classes = np.full(n_pad, -1, dtype=np.int32)
    classes[: ids.shape[0]] = ids
    return to_device(classes, torch.int32, device)


def weights_to_torch(weights, device) -> torch.Tensor:
    """int8 BLOSUM column weights [W_pad*32] on ``device``; to a CUDA
    device through page-locked memory, asynchronously."""
    return to_device(np.ascontiguousarray(weights, dtype=np.int8),
                     torch.int8, device)
