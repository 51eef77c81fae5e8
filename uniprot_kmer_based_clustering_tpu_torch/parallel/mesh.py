"""Device meshes and the collectives the row ring needs.

Counterpart of the JAX package's ``parallel/mesh.py``. The JAX mesh is
one process driving N devices through ``shard_map``; the port keeps that
shape. A :class:`Mesh` is an ordered list of torch devices under one
axis name, each shard of a row-sharded matrix is a tensor on its own
device, and the collectives are copies:

- :func:`ring_shift` (JAX ``ppermute`` one step round the ring): shard i
  receives shard i+1 as a FRESH buffer on device i, also when both lie
  on one device, so no in-place op on a moving block can touch a
  stationary one;
- :func:`sum_to_first` (``psum``), :func:`gather_to_first`
  (``all_gather`` / the row-sharded output), :func:`min_to_first`
  (``pmin``) and :func:`broadcast_from_first` (a replicated operand):
  copies onto, or from, the first shard's device.

Every schedule of ``parallel/sharded.py`` and the sharded components move
data only through these functions, so a multi-process transport swaps
them and not the schedules.

A mesh may repeat a device: ``make_mesh(devices=["cuda:0"] * 4)`` runs
a four-shard ring on one card (each shard's launches queue on the same
stream, so its time is the sum over shards, no scaling figure), and
``make_mesh(4, device="cpu")`` four CPU shards, the stand-in for the JAX
package's virtual CPU devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device

#: The message tail of every mesh layout, flag and entry the port does
#: not carry yet.
UNPORTED = "the mesh engines (ROADMAP queue 1, item 14)"


class Mesh:
    """An ordered list of torch devices under ``axis`` (a name, or a tuple
    of names for a layout the port refuses: only the flat row ring is
    ported)."""

    def __init__(self, devices: Sequence, axis="p"):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,) if isinstance(axis, str) else tuple(axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "p", *,
              device="cuda", devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of ``device``'s type
    (all of them by default).

    On CUDA, asking for more cards than are visible raises JAX's
    ``ValueError`` ("requested N devices, only M available"): the mesh
    never falls back to fewer cards or to the CPU. ``device="cpu"`` gives
    ``n_devices`` CPU shards (1 by default). ``devices`` is an explicit
    list, which may repeat a device (several shards on one card)."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(
                f"n_devices={n_devices} but {len(devices)} devices listed"
            )
        return Mesh(devices, axis)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (n_devices or 1), axis)
    avail = torch.cuda.device_count()
    n = avail if n_devices is None else n_devices
    if n > avail:
        raise ValueError(f"requested {n} devices, only {avail} available")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def require_flat(mesh: Mesh) -> None:
    """Refuse the layouts that are not ported: two mesh axes (the 2-D
    ring) and the contraction axis ``"k"``."""
    axes = mesh.axis_names
    if len(axes) != 1 or axes == ("k",):
        raise NotImplementedError(
            f"mesh axes {axes}: only the flat row ring is "
            f"ported; the 2-D ring and the k-axis layout are {UNPORTED}"
        )


def pad_for_mesh(n: int, n_devices: int, multiple: int) -> int:
    """Smallest N_pad ≥ n divisible by n_devices·multiple (so every device
    holds the same number of whole tiles)."""
    unit = n_devices * multiple
    return -(-n // unit) * unit


def _fresh_copy(t: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """A new buffer on ``dst`` holding ``t`` (never ``t`` itself)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=dst)
    return out.copy_(t, non_blocking=True)


def shard_rows(mesh: Mesh, arr) -> list:
    """Split an ``[N, ...]`` array (numpy or tensor) into ``mesh.size``
    equal row shards, shard d on device d; a list or tuple of shards
    passes through. N must divide evenly, as JAX's row sharding needs."""
    if isinstance(arr, (list, tuple)):
        if len(arr) != mesh.size:
            raise ValueError(
                f"{len(arr)} shards for a mesh of {mesh.size} devices"
            )
        return list(arr)
    t = arr if torch.is_tensor(arr) else torch.from_numpy(
        np.require(arr, requirements="W"))
    if t.shape[0] % mesh.size:
        raise ValueError(
            f"{t.shape[0]} rows do not divide over {mesh.size} devices"
        )
    return [_fresh_copy(part, dev)
            for part, dev in zip(t.chunk(mesh.size), mesh.devices)]


def ring_shift(blocks: list, mesh: Mesh) -> list:
    """One step of the ring, in place on the list: ``blocks[i]`` becomes a
    fresh copy of ``blocks[(i + 1) % D]`` on device i (JAX's ppermute with
    perm ``[((i + 1) % D, i)]``). Each old block is dropped as soon as
    its copy exists, so at most one extra block lives at a time."""
    first = blocks[0]
    d = len(blocks)
    for i in range(d):
        blocks[i] = _fresh_copy(blocks[i + 1] if i + 1 < d else first,
                                mesh.devices[i])
    return blocks


def gather_to_first(parts: Sequence[torch.Tensor], mesh: Mesh,
                    dim: int = 0) -> torch.Tensor:
    """Concatenate the shards' tensors along ``dim`` on the first shard's
    device."""
    dst = mesh.devices[0]
    return torch.cat([p.to(dst) for p in parts], dim=dim)


def sum_to_first(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise sum of the shards' tensors on the first shard's device
    (a fresh tensor)."""
    dst = mesh.devices[0]
    out = _fresh_copy(parts[0], dst)
    for p in parts[1:]:
        out += p.to(dst)
    return out


def min_to_first(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise minimum of the shards' tensors on the first shard's
    device (a fresh tensor)."""
    dst = mesh.devices[0]
    out = _fresh_copy(parts[0], dst)
    for p in parts[1:]:
        torch.minimum(out, p.to(dst), out=out)
    return out


def broadcast_from_first(t: torch.Tensor, mesh: Mesh) -> list:
    """``t`` (on the first shard's device) replicated to every shard: the
    first shard's entry is ``t``, the others fresh copies."""
    return [t] + [_fresh_copy(t, dev) for dev in mesh.devices[1:]]
