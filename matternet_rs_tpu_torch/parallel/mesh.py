"""The device mesh, sharded arrays and the collectives (twin of the
reference's ``parallel/mesh.py``).

The reference is single-controller: one Python call runs a ``shard_map``
body on every device and returns a replicated result. The port keeps that
model. A :class:`Mesh` is an array of ``torch.device`` slots (its shape the
mesh shape, its slot order row-major over that array, the reference's
``flat_axis_index``), with the axis names ``("data",)`` or ``("slice",
"data")``. A :class:`ShardedArray` is one tensor per slot, each on its
slot's device, slot ``i`` holding global rows ``[i·per, (i+1)·per)``. A
body becomes a loop over this process's slots (:func:`local_map`), each
step on its slot's device, and the collectives are explicit functions:
:func:`all_gather` (stacked or tiled: a copy to the lead device, then
``torch.stack`` or ``torch.cat``), :func:`psum` (and the min/max forms of
:func:`reduce`) and the ring step of ``ppermute`` (:func:`ring_shift`).

When :func:`..distributed.initialize` has set up a process group, a mesh
spans the processes: each process owns a contiguous run of slots, places
only those, and every collective first gathers its local slots and then
calls ``torch.distributed`` (``all_gather`` / ``all_reduce``, gloo on the
CPU and NCCL on cards), so every process holds the same replicated result.

A device may be listed more than once in ``devices=``: the counterpart of
XLA's host device count, which PyTorch lacks. The tests run 8 slots on the
CPU this way, and ``chip_smoke.py`` 4 slots on the one card; every slot
then runs its own kernel launches with its own rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(eq=False)
class Mesh:
    """Slots over devices. ``devices`` is an object array of
    ``torch.device`` (shape = the mesh shape, every slot of every process;
    a process's own slots are ``local_slots``); ``group`` the process group
    when the mesh spans processes."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    group: object | None = None
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def slot_devices(self) -> list[torch.device]:
        return list(self.devices.reshape(-1))

    @property
    def local_slots(self) -> range:
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    @property
    def lead(self) -> torch.device:
        """Where replicated values and collective results live: the device
        of this process's first slot."""
        return self.slot_devices[self.local_slots[0]]

    @property
    def spans_processes(self) -> bool:
        return self.group is not None


def _local_devices(devices) -> list[torch.device]:
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    out = [torch.device("cuda", torch.cuda.current_device())
           if d.type == "cuda" and d.index is None and torch.cuda.is_available() else d
           for d in out]
    for d in out:
        if d.type == "cuda" and (not torch.cuda.is_available()
                                 or (d.index or 0) >= torch.cuda.device_count()):
            raise ValueError(f"device {d} is not available")
    return out


def _process_group():
    """``(group, rank, world)`` of an initialised ``torch.distributed``, or
    ``(None, 0, 1)``."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    return None, 0, 1


def _mesh_of(local: list[torch.device], need: int, shape: tuple, axes: tuple) -> Mesh:
    group, rank, world = _process_group()
    have = len(local) * world
    if have < need:
        raise ValueError(f"requested {need} devices, only {have} available")
    if need % world:
        raise ValueError(f"{need} slots do not split over {world} processes")
    per_proc = need // world
    slots = np.empty(need, dtype=object)
    for p in range(world):           # every process's slots, as each lists them
        for j in range(per_proc):
            slots[p * per_proc + j] = local[j]
    return Mesh(slots.reshape(shape), axes, group, rank, world)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh ``("data",)`` over ``n_devices`` slots (default: every
    device). ``devices`` lists this process's devices (default: every
    visible CUDA card; never the CPU unless listed); a device listed twice
    makes two slots on it. ``ValueError`` when too few are available."""
    local = _local_devices(devices)
    _, _, world = _process_group()
    n = len(local) * world if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"requested {n_devices} devices, only {len(local) * world} available")
    return _mesh_of(local, n, (n,), (DATA_AXIS,))


def make_mesh_2d(n_slices: int, per_slice: int | None = None, devices=None) -> Mesh:
    """2-D mesh ``("slice", "data")``: the item axis shards over both
    jointly (slot = slice·per_slice + data), and the multi-slice search
    merges over ``data`` first, then over ``slice``."""
    local = _local_devices(devices)
    _, _, world = _process_group()
    if per_slice is None:
        per_slice = len(local) * world // n_slices
    need = n_slices * per_slice
    if len(local) * world < need:
        raise ValueError(f"need {need} devices, have {len(local) * world}")
    return _mesh_of(local, need, (n_slices, per_slice), ("slice", DATA_AXIS))


def pad_to_mesh(n: int, mesh: Mesh) -> int:
    return n + ((-n) % mesh.size)


def on_slot(dev: torch.device):
    """Make ``dev`` the current card inside the block (kernels launch on
    the current card); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@dataclasses.dataclass(eq=False)
class ShardedArray:
    """A ``[N_pad, ...]`` array over the mesh's slots: ``shards[i]`` holds
    global rows ``[i·per, (i+1)·per)`` on slot ``i``'s device (``None`` for
    another process's slot)."""

    mesh: Mesh
    shards: list
    shape: tuple

    @property
    def per(self) -> int:
        return self.shape[0] // self.mesh.size

    def local(self) -> list[tuple[int, torch.Tensor]]:
        return [(i, self.shards[i]) for i in self.mesh.local_slots]

    def gather(self) -> torch.Tensor:
        """The whole array on the lead device (tests, small arrays)."""
        return all_gather(self.mesh, [t for _, t in self.local()], tiled=True)


def _moved(value, dev: torch.device):
    """A tensor, or a dataclass of tensors (an ELL graph), on ``dev``."""
    if isinstance(value, torch.Tensor):
        return value.to(dev)
    return dataclasses.replace(value, **{
        f.name: getattr(value, f.name).to(dev) for f in dataclasses.fields(value)
        if isinstance(getattr(value, f.name), torch.Tensor)})


class Replicated:
    """One value for every slot (a tensor or an ELL graph): the lead
    device's copy, copied to another device once, on first use there."""

    def __init__(self, value):
        self.value = value
        self._copies = {value.device: value}

    def on(self, dev: torch.device):
        t = self._copies.get(dev)
        if t is None:
            t = self._copies[dev] = _moved(self.value, dev)
        return t


def replicate(mesh: Mesh, x) -> Replicated:
    """A value every slot reads (graphs, queries, λ stats): a tensor, an
    array or an ELL graph."""
    if isinstance(x, Replicated):
        return x
    if not isinstance(x, torch.Tensor) and dataclasses.is_dataclass(x):
        return Replicated(_moved(x, mesh.lead))
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return Replicated(t.to(mesh.lead))


def local_map(mesh: Mesh, fn: Callable, *arrays) -> list:
    """``fn(slot, *local_parts)`` on each of this process's slots, under its
    device; ``arrays`` are :class:`ShardedArray` (the slot's shard is
    passed), :class:`Replicated` (its copy on the slot's device) or plain
    values (passed as they are). Returns the results in slot order."""
    out = []
    devs = mesh.slot_devices
    for i in mesh.local_slots:
        dev = devs[i]
        parts = []
        for a in arrays:
            if isinstance(a, ShardedArray):
                parts.append(a.shards[i])
            elif isinstance(a, Replicated):
                parts.append(a.on(dev))
            else:
                parts.append(a)
        with on_slot(dev):
            out.append(fn(i, *parts))
    return out


def sharded(mesh: Mesh, parts: list, shape: tuple) -> ShardedArray:
    """The global ``shape`` array of this process's per-slot ``parts``
    (slot order), as :func:`local_map` returns them."""
    shards = [None] * mesh.size
    for i, t in zip(mesh.local_slots, parts):
        shards[i] = t
    return ShardedArray(mesh, shards, tuple(shape))


# -- collectives -------------------------------------------------------------
def _across_processes(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """``[L, ...]`` local parts → ``[world·L, ...]`` in rank order."""
    if not mesh.spans_processes:
        return local
    bufs = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(bufs, local.contiguous(), group=mesh.group)
    return torch.cat(bufs)


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor], tiled: bool = False) -> torch.Tensor:
    """Every slot's part, in slot order, on the lead device: stacked
    ``[D, ...]`` or, ``tiled``, concatenated along dim 0."""
    lead = mesh.lead
    stacked = torch.stack([p.to(lead) for p in parts])
    out = _across_processes(mesh, stacked)
    return out.reshape((-1,) + tuple(out.shape[2:])) if tiled else out


_REDUCE = {"sum": (torch.sum, "SUM"), "min": (torch.amin, "MIN"), "max": (torch.amax, "MAX")}


def reduce(mesh: Mesh, parts: Sequence[torch.Tensor], op: str = "sum") -> torch.Tensor:
    """The element-wise ``op`` (``sum``, ``min``, ``max``) of every slot's
    part, on the lead device: the local parts in slot order, then across
    processes."""
    fn, dop = _REDUCE[op]
    lead = mesh.lead
    out = fn(torch.stack([p.to(lead) for p in parts]), dim=0)
    if mesh.spans_processes:
        out = out.contiguous()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, dop), group=mesh.group)
    return out


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return reduce(mesh, parts, "sum")


def ring_shift(mesh: Mesh, parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """One ring step of ``ppermute`` (slot i → slot i + 1): this process's
    parts, each now the previous slot's, on its own slot's device."""
    devs = [mesh.slot_devices[i] for i in mesh.local_slots]
    last = parts[-1]
    if mesh.spans_processes:
        src = (mesh.rank - 1) % mesh.world
        dst = (mesh.rank + 1) % mesh.world
        recv = torch.empty_like(last)
        ops = [dist.P2POp(dist.isend, last.contiguous(), dst, group=mesh.group),
               dist.P2POp(dist.irecv, recv, src, group=mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        last = recv
    moved = [last] + list(parts[:-1])
    return [t.to(d) for t, d in zip(moved, devs)]


# -- placement ---------------------------------------------------------------
def shard_items(mesh: Mesh, x) -> ShardedArray:
    """Shard a ``[N, ...]`` array over the item axis, zero rows padding N
    to a multiple of the slot count (padded rows are masked by global id
    wherever they could rank). Only this process's slots are placed."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    n = t.shape[0]
    d = mesh.size
    n_pad = n + ((-n) % d)
    per = n_pad // d
    shards = [None] * d
    devs = mesh.slot_devices
    for i in mesh.local_slots:
        lo, hi = i * per, min((i + 1) * per, n)
        part = t[lo:hi] if lo < n else t[:0]
        if part.shape[0] < per:
            part = torch.cat([part, torch.zeros((per - part.shape[0],) + tuple(t.shape[1:]),
                                                dtype=t.dtype, device=t.device)])
        shards[i] = part.to(devs[i]).contiguous()
    return ShardedArray(mesh, shards, (n_pad,) + tuple(t.shape[1:]))


def shard_items_from_blocks(mesh: Mesh, blocks) -> ShardedArray:
    """A sharded ``[N_pad, F]`` float32 array from host blocks (in global
    row order) without concatenating them: each slot receives its own rows,
    so the largest host temporary is one slot's block. Every process passes
    the same blocks and places only its slots."""
    blocks = [np.asarray(b, np.float32) for b in blocks]
    if not blocks:
        raise ValueError("need at least one shard")
    f = blocks[0].shape[1]
    for b in blocks:
        if b.ndim != 2 or b.shape[1] != f:
            raise ValueError("all shards must be [n_i, F] with equal F")
    n = sum(b.shape[0] for b in blocks)
    d = mesh.size
    n_pad = n + ((-n) % d)
    per = n_pad // d
    starts = np.cumsum([0] + [b.shape[0] for b in blocks])

    def rows(lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the virtual global array, zero past n."""
        pieces = []
        for bi, b in enumerate(blocks):
            s, e = max(lo, starts[bi]), min(hi, starts[bi + 1])
            if s < e:
                pieces.append(b[s - starts[bi]: e - starts[bi]])
        got = sum(p.shape[0] for p in pieces)
        if got < hi - lo:
            pieces.append(np.zeros((hi - lo - got, f), np.float32))
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)

    shards = [None] * d
    devs = mesh.slot_devices
    for i in mesh.local_slots:
        shards[i] = torch.from_numpy(np.ascontiguousarray(rows(i * per, (i + 1) * per))).to(devs[i])
    return ShardedArray(mesh, shards, (n_pad, f))
