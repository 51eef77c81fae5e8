"""Device meshes and the collectives the mesh engines need.

Counterpart of the JAX package's ``parallel/mesh.py``. The JAX mesh is
one process driving N devices through ``shard_map``; the port keeps that
shape. A :class:`Mesh` is an ordered list of torch devices under one
axis name (the flat row ring, or ``"k"``: the k-axis layout) or two
(hosts × chips, host-major: the 2-D ring); :func:`mesh_layout` names
the layout, as the JAX package's dispatch reads it from the axis names.
Each shard of a sharded matrix is a tensor on its own device, and the
collectives are copies:

- :func:`ring_shift` (JAX ``ppermute`` one step round a ring, over the
  whole mesh or along one axis of a 2-D mesh): shard i receives its
  ring successor as a FRESH buffer on device i, also when both lie on
  one device, so no in-place op on a moving block can touch a
  stationary one;
- :func:`sum_to_first` (``psum``), :func:`gather_to_first`
  (``all_gather`` / the row-sharded output), :func:`min_to_first`
  (``pmin``), :func:`lane_merge_to_first` (the row statistics' lane
  rule: lanes 3 and 7 by max, the others by sum) and
  :func:`broadcast_from_first` (a replicated operand): copies onto, or
  from, the first shard's device;
- :func:`all_gather` (``all_gather`` with a replicated result): every
  shard receives the shards' tensors concatenated in shard order, as a
  fresh tensor on its own device.

Every schedule of ``parallel/sharded.py`` and ``parallel/stream_mesh.py``
and the sharded components move data only through these functions, so a
multi-process transport swaps them and not the schedules.

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
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import merge_row_stats_at

#: The message tail of the one mesh path the port does not carry yet.
UNPORTED = "the multi-process --distributed path (ROADMAP queue 1, item 14c)"


class Mesh:
    """An ordered list of torch devices under ``axis`` (a name, or a
    tuple of two names, host-major, whose sizes ``shape`` gives)."""

    def __init__(self, devices: Sequence, axis="p",
                 shape: Optional[Sequence[int]] = None):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,) if isinstance(axis, str) else tuple(axis)
        sizes = tuple(shape) if shape is not None else (len(self.devices),)
        if (len(self.axis_names) not in (1, 2)
                or len(sizes) != len(self.axis_names)
                or int(np.prod(sizes)) != len(self.devices)):
            raise ValueError(
                f"mesh axes {self.axis_names} of sizes {sizes} do not "
                f"hold {len(self.devices)} devices"
            )
        #: axis name -> size, as JAX's ``mesh.shape``
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.shape})")


def mesh_layout(mesh: Mesh) -> str:
    """The sharding layout of ``mesh``, read from its axis names as the
    JAX package's wrappers read it: two axes → ``"2d"`` (the hierarchical
    ring), the one axis ``"k"`` → ``"kaxis"`` (bitset columns sharded),
    else ``"flat"`` (the row ring)."""
    if len(mesh.axis_names) == 2:
        return "2d"
    return "kaxis" if mesh.axis_names == ("k",) else "flat"


def _mesh_devices(n: Optional[int], device, devices: Optional[Sequence]):
    """The devices of a new mesh: ``devices`` as listed, else ``n`` (all
    visible cards when None) of ``device``'s type; CPU shards repeat the
    CPU (1 by default). Too few cards raise JAX's ``ValueError``."""
    if devices is not None:
        if n is not None and n != len(devices):
            raise ValueError(
                f"n_devices={n} but {len(devices)} devices listed"
            )
        return list(devices)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (n or 1)
    avail = torch.cuda.device_count()
    n = avail if n is None else n
    if n > avail:
        raise ValueError(f"requested {n} devices, only {avail} available")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, axis: str = "p", *,
              device="cuda", devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of ``device``'s type
    (all of them by default); ``axis="k"`` makes it a k-axis mesh.

    On CUDA, asking for more cards than are visible raises JAX's
    ``ValueError`` ("requested N devices, only M available"): the mesh
    never falls back to fewer cards or to the CPU. ``device="cpu"`` gives
    ``n_devices`` CPU shards (1 by default). ``devices`` is an explicit
    list, which may repeat a device (several shards on one card)."""
    return Mesh(_mesh_devices(n_devices, device, devices), axis)


def make_mesh_2d(n_hosts: int, n_chips: int, host_axis: str = "h",
                 chip_axis: str = "c", *, device="cuda",
                 devices: Optional[Sequence] = None) -> Mesh:
    """(hosts × chips) mesh for the 2-D ring: shard ``h * n_chips + c``
    is chip c of host h (host-major, as JAX orders ``jax.devices()``).

    The same device rules as :func:`make_mesh` over ``n_hosts * n_chips``
    devices: too few cards raise "requested N devices, only M available",
    ``device="cpu"`` gives CPU shards and ``devices`` may repeat a card.
    JAX's multi-process check (``n_chips`` equal to each process's device
    count, so the host axis is the real host boundary) belongs to the
    multi-process ``--distributed`` path, which is not ported; one
    process drives every device here."""
    need = n_hosts * n_chips
    return Mesh(_mesh_devices(need, device, devices),
                (host_axis, chip_axis), (n_hosts, n_chips))


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


def ring_sources(mesh: Mesh, axis: Optional[str] = None) -> list:
    """``src[i]``: the shard whose block shard i receives in one step of
    the ring along ``axis`` (JAX's ppermute with perm ``[((i + 1) % size,
    i)]`` on that axis), or round all shards in mesh order when ``axis``
    is None. Along ``"c"`` shard (h, c) receives (h, (c + 1) % C); along
    ``"h"`` it receives ((h + 1) % H, c)."""
    d = mesh.size
    if axis is None:
        return [(i + 1) % d for i in range(d)]
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    # the stride of ``axis`` in the host-major order, and its size
    stride = 1
    for name in reversed(mesh.axis_names):
        if name == axis:
            break
        stride *= mesh.shape[name]
    size = mesh.shape[axis]
    return [i + stride * ((i // stride + 1) % size - i // stride % size)
            for i in range(d)]


def ring_shift(blocks: list, mesh: Mesh, axis: Optional[str] = None) -> list:
    """One step of the ring (:func:`ring_sources`), in place on the list:
    ``blocks[i]`` becomes a fresh copy of ``blocks[src[i]]`` on device i.
    Each old block is dropped as soon as its copy exists, except the
    first of each ring, kept until the ring's wrap-around reads it."""
    src = ring_sources(mesh, axis)
    saved = {s: blocks[s] for i, s in enumerate(src) if s < i}
    for i, s in enumerate(src):
        blocks[i] = _fresh_copy(saved.pop(s) if s < i else blocks[s],
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


def lane_merge_to_first(parts: Sequence[torch.Tensor],
                        mesh: Mesh) -> torch.Tensor:
    """The shards' ``[R, 8]`` row statistics merged by the lane rule on
    the first shard's device (a fresh tensor): lanes 3 and 7 (the maxima)
    by elementwise max, the others by sum."""
    dst = mesh.devices[0]
    out = _fresh_copy(parts[0], dst)
    for p in parts[1:]:
        merge_row_stats_at(out, p.to(dst), 0)
    return out


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The shards' tensors concatenated along dim 0 in shard order, on
    every shard's device: entry i is a fresh tensor on device i (also
    where shards share a device), so no shard aliases another's copy."""
    return [torch.cat([p.to(dev) for p in parts]) for dev in mesh.devices]


def broadcast_from_first(t: torch.Tensor, mesh: Mesh) -> list:
    """``t`` (on the first shard's device) replicated to every shard: the
    first shard's entry is ``t``, the others fresh copies."""
    return [t] + [_fresh_copy(t, dev) for dev in mesh.devices[1:]]
