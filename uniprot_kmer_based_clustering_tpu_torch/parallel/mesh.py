"""Device meshes and the collectives the mesh engines need.

Counterpart of the JAX package's ``parallel/mesh.py``. A :class:`Mesh`
is an ordered list of torch devices (its shards) under one axis name
(the flat row ring, or ``"k"``: the k-axis layout) or two (hosts ×
chips, host-major: the 2-D ring); :func:`mesh_layout` names the layout,
as the JAX package's dispatch reads it from the axis names. Each shard
of a sharded matrix is a tensor on its own device.

**One process or several.** A mesh is built in one process (every shard
local, as the JAX package's single-controller ``shard_map``), or, after
:func:`init_distributed`, over every rank of a ``torch.distributed``
world: the JAX multi-controller model, where each process runs the same
program, owns the shards of its own devices, and every process ends with
the same replicated result. Shards are ordered rank-major, as JAX orders
``jax.devices()`` process-major; ``Mesh.ranks`` names each shard's rank
and ``Mesh.local`` this rank's shards. On a multi-process mesh a shard
list holds tensors at the local indices and None elsewhere.

The collectives are copies within a process and ``torch.distributed``
calls across processes:

- :func:`ring_shift` (JAX ``ppermute`` one step round a ring, over the
  whole mesh or along one axis of a 2-D mesh): shard i receives its
  ring successor as a FRESH buffer on device i, also when both lie on
  one device, so no in-place op on a moving block can touch a
  stationary one; a remote source comes by one ``batch_isend_irecv``
  of the whole step;
- :func:`sum_to_first` (``psum``), :func:`gather_to_first`
  (``all_gather`` / the row-sharded output), :func:`min_to_first`
  (``pmin``), :func:`lane_merge_to_first` (the row statistics' lane
  rule: lanes 3 and 7 by max, the others by sum) and
  :func:`broadcast_from_first` (a replicated operand): copies onto, or
  from, the first shard's device; across processes every rank receives
  the result on its first local device (``all_reduce`` for the sums,
  minima and lanes, one broadcast a shard for the gathers);
- :func:`all_gather` (``all_gather`` with a replicated result): every
  shard receives the shards' tensors concatenated in shard order, as a
  fresh tensor on its own device.

Every schedule of ``parallel/sharded.py`` and ``parallel/stream_mesh.py``
and the sharded components move data only through these functions, so
the multi-process transport swaps them and not the schedules. Under
NCCL, CUDA tensors go to the library as they are; under gloo a CUDA
tensor is staged explicitly through one pinned host buffer a rank
(never gloo's own CUDA path), and CPU tensors go as they are. The bytes
a rank hands to the transport and the seconds it spends there are
counted in :data:`transport_stats`.

A mesh may repeat a device: ``make_mesh(devices=["cuda:0"] * 4)`` runs
a four-shard ring on one card (each shard's launches queue on the same
stream, so its time is the sum over shards, no scaling figure), and
``make_mesh(4, device="cpu")`` four CPU shards, the stand-in for the JAX
package's virtual CPU devices. Several ranks may share one card over
gloo (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import math
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import distributed as dist

from uniprot_kmer_based_clustering_tpu_torch.device import resolve_device
from uniprot_kmer_based_clustering_tpu_torch.ops.stats import merge_row_stats_at

#: Counters of this process's transport, read and set to 0 by the caller
#: as the kernels' ``.launches`` are (:func:`reset_transport_stats`):
#: ``bytes`` this rank handed to other ranks (a point-to-point send once,
#: a broadcast once for each receiving rank, an ``all_reduce`` at the
#: ring algorithm's 2(w − 1)/w of its buffer), ``seconds`` spent in the
#: transport's calls (host clock, staging copies included) and ``calls``.
transport_stats = {"bytes": 0, "seconds": 0.0, "calls": 0}

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# the dtypes a header can name, and its most dimensions
_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
           torch.float16, torch.bfloat16, torch.float32, torch.float64,
           torch.bool)
_MAX_DIMS = 8
# row-statistics lanes merged by sum and by max (ROW_STAT_NAMES)
_SUM_LANES = [0, 1, 2, 4, 5, 6]
_MAX_LANES = [3, 7]


def reset_transport_stats() -> dict:
    """The transport counters so far (a copy); then all set to 0."""
    out = dict(transport_stats)
    transport_stats.update(bytes=0, seconds=0.0, calls=0)
    return out


def world() -> tuple:
    """(rank, world size) of the default ``torch.distributed`` group;
    (0, 1) when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None) -> None:
    """Join this process to a ``torch.distributed`` world; call it once
    in every process before :func:`make_mesh` (JAX ``init_distributed``).

    With no arguments it reads the ``torchrun`` environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``;
    ``LOCAL_RANK`` picks the card), as ``jax.distributed.initialize()``
    autodetects; with arguments it joins ``tcp://coordinator_address``
    (``host:port``) as rank ``process_id`` of ``num_processes``.

    ``backend`` None is ``"nccl"``: one rank a card, the rank's card
    (``cuda:LOCAL_RANK``, else the rank modulo the visible cards) made
    current before the group is. ``"gloo"`` serves CPU ranks (``cli run
    --device cpu``) and ranks that share a card (the mesh then stages
    CUDA tensors through host memory). A group the caller already made
    is kept as it is. A failed init raises: nothing falls back to another
    backend, and NCCL on a rank without a visible card raises."""
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if coordinator_address is None:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(
                "init_distributed() with no arguments reads the torchrun "
                f"environment; {', '.join(missing)} unset"
            )
        init = "env://"
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                "coordinator_address needs num_processes and process_id"
            )
        init = f"tcp://{coordinator_address}"
        size, rank = int(num_processes), int(process_id)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend 'nccl' needs a CUDA GPU on every rank and torch "
                "sees none; pass backend='gloo' for CPU ranks"
            )
        torch.cuda.set_device(_local_card(rank))
    dist.init_process_group(backend, init_method=init, world_size=size,
                            rank=rank)


def _local_card(rank: int) -> int:
    """The card of ``rank``: ``LOCAL_RANK``, else the rank modulo the
    visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


class Mesh:
    """An ordered list of torch devices, the shards, under ``axis`` (a
    name, or a tuple of two names, host-major, whose sizes ``shape``
    gives). ``ranks`` names the process of each shard, rank-major, and
    must span the whole ``torch.distributed`` world when it names more
    than one; None makes every shard this process's own. Only this
    rank's devices are resolved; ``local`` lists its shard indices and
    ``home`` is the device of the first."""

    def __init__(self, devices: Sequence, axis="p",
                 shape: Optional[Sequence[int]] = None,
                 ranks: Optional[Sequence[int]] = None):
        rank, size = world()
        ranks = ([rank] * len(devices) if ranks is None
                 else [int(r) for r in ranks])
        if len(ranks) != len(devices):
            raise ValueError(
                f"{len(ranks)} ranks for {len(devices)} devices"
            )
        self.devices = tuple(
            resolve_device(d) if r == rank else torch.device(d)
            for d, r in zip(devices, ranks)
        )
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
        self.ranks = tuple(ranks)
        self.rank = rank
        self.local = tuple(i for i, r in enumerate(ranks) if r == rank)
        self.multiprocess = len(set(ranks)) > 1
        if not self.local:
            raise ValueError(f"rank {rank} holds no shard of the mesh")
        if self.multiprocess and (
                list(ranks) != sorted(ranks)
                or sorted(set(ranks)) != list(range(size))):
            raise ValueError(
                f"shard ranks {ranks} must be rank-major over the world "
                f"of {size}"
            )

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """This rank's first local device: where its replicated results
        land (the first shard's device on a one-process mesh)."""
        return self.devices[self.local[0]]

    def __repr__(self) -> str:
        ranks = f", ranks={list(self.ranks)}" if self.multiprocess else ""
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.shape}{ranks})")


def mesh_layout(mesh: Mesh) -> str:
    """The sharding layout of ``mesh``, read from its axis names as the
    JAX package's wrappers read it: two axes → ``"2d"`` (the hierarchical
    ring), the one axis ``"k"`` → ``"kaxis"`` (bitset columns sharded),
    else ``"flat"`` (the row ring)."""
    if len(mesh.axis_names) == 2:
        return "2d"
    return "kaxis" if mesh.axis_names == ("k",) else "flat"


def _local_devices(n: Optional[int], device, devices: Optional[Sequence],
                   size: int = 1):
    """This process's devices of a new mesh: ``devices`` as listed, else
    ``n`` (all visible cards when None) of ``device``'s type; CPU shards
    repeat the CPU (1 by default). Too few cards raise JAX's
    ``ValueError``. In a world of ``size`` > 1 processes the default is
    this rank's card (``cuda:LOCAL_RANK`` unless ``device`` names one) or
    ``n / size`` CPU shards, and ``n`` counts the whole world."""
    if devices is not None:
        if n is not None and n != len(devices) and size == 1:
            raise ValueError(
                f"n_devices={n} but {len(devices)} devices listed"
            )
        return list(devices)
    if size == 1:
        dev = resolve_device(device)
        if dev.type == "cpu":
            return [dev] * (n or 1)
        avail = torch.cuda.device_count()
        n = avail if n is None else n
        if n > avail:
            raise ValueError(
                f"requested {n} devices, only {avail} available"
            )
        return [torch.device("cuda", i) for i in range(n)]
    dev = torch.device(device)
    if dev.type == "cpu":
        if n is not None and n % size:
            raise ValueError(
                f"{n} CPU shards do not divide over {size} ranks"
            )
        return [dev] * (n // size if n else 1)
    resolve_device(dev)  # no card: raises, never falls back to the CPU
    if dev.index is None:
        dev = torch.device("cuda", _local_card(world()[0]))
    avail = torch.cuda.device_count()
    if dev.index >= avail:
        raise ValueError(
            f"requested {dev.index + 1} devices, only {avail} available"
        )
    return [dev]


def _world_shards(local: list, need: Optional[int]):
    """(devices, ranks) of a mesh over every rank's ``local`` devices,
    rank-major, cut to the first ``need`` (one ``all_gather_object``:
    every rank calls it). Too few raise JAX's "requested N devices, only
    M available"; a rank left with no shard raises too."""
    rank, size = world()
    names: list = [None] * size
    dist.all_gather_object(names, [str(d) for d in local])
    devs = [d for per in names for d in per]
    ranks = [r for r, per in enumerate(names) for _ in per]
    need = len(devs) if need is None else need
    if need > len(devs):
        raise ValueError(
            f"requested {need} devices, only {len(devs)} available"
        )
    if len(set(ranks[:need])) < size:
        raise ValueError(
            f"requested {need} devices: the first {need} leave ranks "
            f"{sorted(set(range(size)) - set(ranks[:need]))} without a "
            f"shard, and a multi-process mesh needs one on every rank"
        )
    return [resolve_device(d) if r == rank else d
            for d, r in zip(devs[:need], ranks[:need])], ranks[:need]


def make_mesh(n_devices: Optional[int] = None, axis: str = "p", *,
              device="cuda", devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of ``device``'s type
    (all of them by default); ``axis="k"`` makes it a k-axis mesh.

    On CUDA, asking for more cards than are visible raises JAX's
    ``ValueError`` ("requested N devices, only M available"): the mesh
    never falls back to fewer cards or to the CPU. ``device="cpu"`` gives
    ``n_devices`` CPU shards (1 by default). ``devices`` is an explicit
    list, which may repeat a device (several shards on one card).

    After :func:`init_distributed` with more than one process, every
    rank calls this, and the mesh spans the world: each rank contributes
    its card (``cuda:LOCAL_RANK``, or the one ``device`` names), its
    ``devices`` list, or ``n_devices / world`` CPU shards, and the mesh
    takes the first ``n_devices`` of them rank-major (all by default)."""
    _, size = world()
    local = _local_devices(n_devices, device, devices, size)
    if size == 1:
        return Mesh(local, axis)
    devs, ranks = _world_shards(local, n_devices)
    return Mesh(devs, axis, ranks=ranks)


def make_mesh_2d(n_hosts: int, n_chips: int, host_axis: str = "h",
                 chip_axis: str = "c", *, device="cuda",
                 devices: Optional[Sequence] = None) -> Mesh:
    """(hosts × chips) mesh for the 2-D ring: shard ``h * n_chips + c``
    is chip c of host h (host-major, as JAX orders ``jax.devices()``).

    The same device rules as :func:`make_mesh` over ``n_hosts * n_chips``
    devices: too few cards raise "requested N devices, only M available",
    ``device="cpu"`` gives CPU shards and ``devices`` may repeat a card.
    Across processes (JAX's multi-process check) ``n_chips`` must equal
    each rank's device count, so that the host axis is the rank boundary:
    the chip-axis shifts stay within a rank and only the host-axis shift
    crosses ranks."""
    need = n_hosts * n_chips
    _, size = world()
    local = _local_devices(need, device, devices, size)
    if size == 1:
        return Mesh(local, (host_axis, chip_axis), (n_hosts, n_chips))
    if need > size * len(local):
        raise ValueError(
            f"requested {need} devices, only {size * len(local)} available"
        )
    if n_chips != len(local):
        # the reshape's host axis is only the rank boundary when each row
        # holds exactly one process's devices
        raise ValueError(
            f"n_chips={n_chips} must equal the per-process device count "
            f"({len(local)}) on a multi-host mesh"
        )
    devs, ranks = _world_shards(local, need)
    return Mesh(devs, (host_axis, chip_axis), (n_hosts, n_chips), ranks)


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
    equal row shards, shard d on device d (only this rank's shards; None
    at the others); a list or tuple of shards passes through. N must
    divide evenly, as JAX's row sharding needs."""
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
    parts = t.chunk(mesh.size)
    out: list = [None] * mesh.size
    for i in mesh.local:
        out[i] = _fresh_copy(parts[i], mesh.devices[i])
    return out


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


# -- the multi-process transport ---------------------------------------------

_staging: dict = {"buf": None}


def _carve(sizes: Sequence[int]) -> list:
    """uint8 views of ``sizes`` bytes each, 64-byte aligned, of this
    rank's one pinned host buffer (grown, never shrunk, when too small).
    The views are valid until the next call."""
    if not sizes:
        return []
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 64) * 64
    buf = _staging["buf"]
    if buf is None or buf.numel() < total:
        _staging["buf"] = None
        buf = _staging["buf"] = torch.empty(max(total, 64),
                                            dtype=torch.uint8,
                                            pin_memory=True)
    return [buf[o : o + n] for o, n in zip(offs, sizes)]


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor, as a flat uint8 view."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _gloo_staged(mesh: Mesh) -> bool:
    """True when CUDA tensors must be staged through host memory (gloo);
    under NCCL they go as they are, and a CPU mesh needs gloo."""
    if dist.get_backend() == "nccl":
        if mesh.home.type != "cuda":
            raise ValueError(
                "the NCCL transport moves CUDA tensors; CPU shards need "
                "init_distributed(backend='gloo')"
            )
        return False
    return True


def _account(t0: float, sent: int) -> None:
    transport_stats["bytes"] += int(sent)
    transport_stats["seconds"] += time.perf_counter() - t0
    transport_stats["calls"] += 1


def _p2p(mesh: Mesh, sends, recvs) -> list:
    """One ``batch_isend_irecv`` of a whole step: ``sends`` are
    (tensor, dst rank, tag), ``recvs`` (shape, dtype, src rank, tag,
    device). Every rank posts its sends and receives ordered by tag, so
    two messages between one pair of ranks match in order. Returns the
    received tensors, each a fresh buffer on its device."""
    t0 = time.perf_counter()
    staged = _gloo_staged(mesh)
    send_b = [_as_bytes(t) for t, _, _ in sends]
    via_host_s = [staged and t.is_cuda for t, _, _ in sends]
    via_host_r = [staged and torch.device(dev).type == "cuda"
                  for _, _, _, _, dev in recvs]
    views = iter(_carve(
        [b.numel() for b, h in zip(send_b, via_host_s) if h]
        + [_nbytes(s, dt) for (s, dt, _, _, _), h in zip(recvs, via_host_r)
           if h]))
    ops, outs = [], []
    for b, h, (_, dst, tag) in zip(send_b, via_host_s, sends):
        wire = next(views).copy_(b) if h else b
        ops.append(dist.P2POp(dist.isend, wire, dst, tag=tag))
    for h, (shape, dtype, src, tag, dev) in zip(via_host_r, recvs):
        if h:
            wire, out = next(views), None
        else:
            out = torch.empty(shape, dtype=dtype, device=dev)
            wire = _as_bytes(out)
        outs.append((out, wire, shape, dtype, dev))
        ops.append(dist.P2POp(dist.irecv, wire, src, tag=tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    got = []
    for out, wire, shape, dtype, dev in outs:
        if out is None:
            out = torch.empty(shape, dtype=dtype, device=dev)
            _as_bytes(out).copy_(wire)
        got.append(out)
    _account(t0, sum(b.numel() for b in send_b))
    return got


def _bcast(t: Optional[torch.Tensor], src: int, mesh: Mesh,
           shape=None, dtype=None) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank's home device. Receivers pass
    ``shape`` and ``dtype``, or None for both: then a header broadcast
    first tells them. Returns a fresh tensor on the receivers, ``t`` on
    its home device on the sender."""
    t0 = time.perf_counter()
    staged = _gloo_staged(mesh)
    wire_dev = torch.device("cpu") if staged else mesh.home
    mine = src == mesh.rank
    size = world()[1]
    sent = 0
    if shape is None:
        head = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64, device=wire_dev)
        if mine:
            if t.dim() > _MAX_DIMS:
                raise ValueError(f"{t.dim()} dimensions > {_MAX_DIMS}")
            head[0], head[1] = t.dim(), _DTYPES.index(t.dtype)
            head[2 : 2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
            sent += head.numel() * 8 * (size - 1)
        dist.broadcast(head, src)
        head = head.tolist()
        shape, dtype = tuple(head[2 : 2 + head[0]]), _DTYPES[head[1]]
    nb = _nbytes(shape, dtype)
    if mine:
        out = t.to(mesh.home).contiguous()
        if nb:
            b = _as_bytes(out)
            if staged and b.is_cuda:
                b = _carve([nb])[0].copy_(b)
            elif not staged:
                b = b.to(wire_dev)
            dist.broadcast(b, src)
            sent += nb * (size - 1)
    else:
        out = torch.empty(shape, dtype=dtype, device=mesh.home)
        if nb:
            via_host = staged and out.is_cuda
            b = _carve([nb])[0] if via_host else _as_bytes(out)
            dist.broadcast(b, src)
            if via_host:
                _as_bytes(out).copy_(b)
    _account(t0, sent)
    return out


def _all_reduce(t: torch.Tensor, op, mesh: Mesh) -> torch.Tensor:
    """``all_reduce`` of ``t`` (on this rank's home device) in place."""
    t0 = time.perf_counter()
    size = world()[1]
    if _gloo_staged(mesh) and t.is_cuda:
        host = _carve([t.numel() * t.element_size()])[0]
        host = host.view(t.dtype).view(t.shape).copy_(t)
        dist.all_reduce(host, op)
        t.copy_(host)
    else:
        dist.all_reduce(t, op)
    _account(t0, 2 * (size - 1) * t.numel() * t.element_size() // size)
    return t


def agree(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` holds on any rank (one small
    ``all_reduce``); ``flag`` itself on a one-process mesh. A check that
    reads only local shards goes through it, so that every rank raises
    together instead of leaving the others waiting in a collective."""
    if not mesh.multiprocess:
        return bool(flag)
    dev = torch.device("cpu") if _gloo_staged(mesh) else mesh.home
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    return bool(_all_reduce(t, dist.ReduceOp.MAX, mesh).item())


def barrier(mesh: Mesh) -> None:
    """Every rank of a multi-process mesh waits for the others."""
    if mesh.multiprocess:
        dist.barrier()


def broadcast_array(arr: Optional[np.ndarray], mesh: Mesh) -> np.ndarray:
    """A host array that only the first shard's rank computed, on every
    rank (a copy there too)."""
    if not mesh.multiprocess:
        return arr
    src = mesh.ranks[0]
    t = torch.from_numpy(np.ascontiguousarray(arr)) if src == mesh.rank \
        else None
    return _bcast(t, src, mesh).cpu().numpy().copy()


def _all_parts(parts: Sequence, mesh: Mesh) -> List[torch.Tensor]:
    """Every entry of a shard list on this rank's home device, the remote
    ones broadcast by their owners (one broadcast a shard, shard order).
    Entry i belongs to shard i's rank; the list may be shorter than the
    mesh (outputs that live on the first shards only)."""
    return [_bcast(p if mesh.ranks[i] == mesh.rank else None, mesh.ranks[i],
                   mesh)
            for i, p in enumerate(parts)]


def _reduce(parts: Sequence, mesh: Mesh, merge, op) -> torch.Tensor:
    """``parts`` folded by ``merge(out, part)`` into a fresh tensor on the
    first shard's device, or across ranks on every rank's home device by
    ``op`` (``all_reduce``; when some rank owns none of the entries, their
    owners broadcast them instead)."""
    if not mesh.multiprocess:
        dst = mesh.devices[0]
        out = _fresh_copy(parts[0], dst)
        for p in parts[1:]:
            merge(out, p.to(dst))
        return out
    if set(mesh.ranks[: len(parts)]) != set(mesh.ranks):
        full = _all_parts(parts, mesh)
        out = full[0].clone()
        for p in full[1:]:
            merge(out, p)
        return out
    mine = [p for i, p in enumerate(parts) if mesh.ranks[i] == mesh.rank]
    out = _fresh_copy(mine[0], mesh.home)
    for p in mine[1:]:
        merge(out, p.to(mesh.home))
    return op(out)


def ring_shift(blocks: list, mesh: Mesh, axis: Optional[str] = None) -> list:
    """One step of the ring (:func:`ring_sources`), in place on the list:
    ``blocks[i]`` becomes a fresh copy of ``blocks[src[i]]`` on device i.
    Each old block is dropped as soon as its copy exists, except the
    first of each ring, kept until the ring's wrap-around reads it. On a
    multi-process mesh this rank's shards take local sources by a device
    copy and remote ones from one ``batch_isend_irecv`` (the blocks of a
    ring all have one shape, so a receiver allocates the buffer)."""
    src = ring_sources(mesh, axis)
    if not mesh.multiprocess:
        saved = {s: blocks[s] for i, s in enumerate(src) if s < i}
        for i, s in enumerate(src):
            blocks[i] = _fresh_copy(saved.pop(s) if s < i else blocks[s],
                                    mesh.devices[i])
        return blocks
    me, ranks = mesh.rank, mesh.ranks
    new = {i: _fresh_copy(blocks[src[i]], mesh.devices[i])
           for i in mesh.local if ranks[src[i]] == me}
    sends = [(blocks[s], ranks[i], i) for i, s in enumerate(src)
             if ranks[s] == me and ranks[i] != me]
    recvs = [(i, (blocks[i].shape, blocks[i].dtype, ranks[src[i]], i,
                  mesh.devices[i]))
             for i in mesh.local if ranks[src[i]] != me]
    got = _p2p(mesh, sends, [r for _, r in recvs])
    new.update((i, t) for (i, _), t in zip(recvs, got))
    for i, t in new.items():
        blocks[i] = t
    return blocks


def gather_to_first(parts: Sequence[torch.Tensor], mesh: Mesh,
                    dim: int = 0) -> torch.Tensor:
    """Concatenate the shards' tensors along ``dim`` on the first shard's
    device (on a multi-process mesh: on every rank's home device; the
    shards' lengths may differ)."""
    if not mesh.multiprocess:
        dst = mesh.devices[0]
        return torch.cat([p.to(dst) for p in parts], dim=dim)
    return torch.cat(_all_parts(parts, mesh), dim=dim)


def sum_to_first(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise sum of the shards' tensors on the first shard's device
    (a fresh tensor; every rank's home device across processes)."""
    return _reduce(parts, mesh, lambda out, p: out.add_(p),
                   lambda t: _all_reduce(t, dist.ReduceOp.SUM, mesh))


def min_to_first(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Elementwise minimum of the shards' tensors on the first shard's
    device (a fresh tensor; every rank's home device across processes)."""
    return _reduce(parts, mesh,
                   lambda out, p: torch.minimum(out, p, out=out),
                   lambda t: _all_reduce(t, dist.ReduceOp.MIN, mesh))


def _lane_all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    sums = _all_reduce(t[:, _SUM_LANES].contiguous(), dist.ReduceOp.SUM,
                       mesh)
    maxs = _all_reduce(t[:, _MAX_LANES].contiguous(), dist.ReduceOp.MAX,
                       mesh)
    t[:, _SUM_LANES] = sums
    t[:, _MAX_LANES] = maxs
    return t


def lane_merge_to_first(parts: Sequence[torch.Tensor],
                        mesh: Mesh) -> torch.Tensor:
    """The shards' ``[R, 8]`` row statistics merged by the lane rule on
    the first shard's device (a fresh tensor; every rank's home device
    across processes): lanes 3 and 7 (the maxima) by elementwise max, the
    others by sum."""
    return _reduce(parts, mesh, lambda out, p: merge_row_stats_at(out, p, 0),
                   lambda t: _lane_all_reduce(t, mesh))


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """The shards' tensors concatenated along dim 0 in shard order, on
    every shard's device: entry i is a fresh tensor on device i (also
    where shards share a device), so no shard aliases another's copy.
    Across processes only this rank's entries are filled."""
    if not mesh.multiprocess:
        return [torch.cat([p.to(dev) for p in parts])
                for dev in mesh.devices]
    full = torch.cat(_all_parts(parts, mesh))
    out: list = [None] * mesh.size
    for k, i in enumerate(mesh.local):
        out[i] = full if k == 0 and mesh.devices[i] == full.device else \
            _fresh_copy(full, mesh.devices[i])
    return out


def broadcast_from_first(t: torch.Tensor, mesh: Mesh) -> list:
    """``t`` (on the first shard's device) replicated to every shard: the
    first shard's entry is ``t``, the others fresh copies. Across
    processes the first shard's rank broadcasts its ``t`` (every rank
    passes a tensor of the same shape, on its home device), and only this
    rank's entries are filled."""
    if not mesh.multiprocess:
        return [t] + [_fresh_copy(t, dev) for dev in mesh.devices[1:]]
    src = mesh.ranks[0]
    t = _bcast(t if src == mesh.rank else None, src, mesh, t.shape, t.dtype)
    out: list = [None] * mesh.size
    for k, i in enumerate(mesh.local):
        out[i] = t if k == 0 else _fresh_copy(t, mesh.devices[i])
    return out
