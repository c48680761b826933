"""Meshes of devices and the split of a batch over them.

Port of ``dynode_tpu/parallel/mesh.py``. JAX shards one array over a mesh
and lets GSPMD partition the program. PyTorch has no tensor that spans
cards and no compiler that splits a program, so the port's mesh splits
work instead: an entry point given ``mesh=`` cuts its batch (ensemble
members, chains, SVI starts) along the leading axis into one shard per
device of a mesh axis, runs each shard on its device, and returns the
whole result on the mesh's first device with the shards concatenated in
mesh order.

- :class:`Mesh` is a numpy object array of ``torch.device`` with its axis
  names, and the rank of the process that owns each entry
  (:func:`~.distributed.create_hybrid_mesh` spans processes).
- :func:`shard_batch`, :func:`ensemble_sharding` and :func:`replicated`
  name a split of the leading axis over mesh axes, or a copy per device.
- :func:`shard_plan` checks a split before anything runs (the batch must
  divide the axis; ``ValueError`` with the numbers), :func:`run_shards`
  runs a function on every shard of this process, and
  :func:`gather_shards` concatenates the shards' results on the first
  device, and across processes through ``torch.distributed.all_gather``.

The shards run in turn on the calling thread. A card's launches are
asynchronous, so shards on distinct cards overlap where a shard's work
does not sync the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import _device

AxisNames = Union[str, Tuple[str, ...]]


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """A named grid of devices.

    ``devices``: an array of ``torch.device`` whose shape gives the axis
    sizes; ``axis_names``: one name per axis; ``processes``: the rank that
    owns each entry (default: this process for every entry). As in JAX,
    ``mesh.shape[name]`` is an axis's size and ``mesh.devices`` the array.
    A device may appear more than once (``[cuda:0] * 2`` runs the split
    on one card, its shards in turn).
    """

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        devs = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names {axis_names} for a {devs.ndim}-d device array")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        self.devices = devs
        self.axis_names = axis_names
        if processes is None:
            processes = np.full(devs.shape, _rank(), dtype=np.int64)
        self.processes = np.asarray(processes, dtype=np.int64).reshape(devs.shape)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """The device the entry points gather their results on: this
        process's first entry in mesh order."""
        mine = self.devices[self.processes == _rank()]
        if mine.size == 0:
            raise ValueError(f"no device of this mesh belongs to process {_rank()}")
        return mine.flat[0]

    def key(self) -> tuple:
        """A hashable description: axis names, device names, owners."""
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat),
                tuple(self.processes.flat))

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def default_device_count() -> int:
    """The number of visible CUDA devices (0 where there is none)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def create_mesh(
    axis_names: Sequence[str] = ("chain",),
    axis_sizes: Optional[Tuple[int, ...]] = None,
    devices=None,
) -> Mesh:
    """A named mesh over ``devices`` (default: every visible CUDA device).

    ``axis_sizes`` defaults to every device on the first axis; one entry
    may be ``-1``, inferred from the device count as in a reshape. Raises
    where no device is given and there is no card (as
    :func:`~dynode_tpu_torch._device.default_device`), and ``ValueError``
    when the sizes do not multiply to the device count. A test passes
    ``devices=[torch.device("cpu")] * 8``; one card may be listed twice.
    """
    if devices is None:
        _device.default_device()  # raises without a Hopper card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    sizes = [int(s) for s in axis_sizes]
    if len(sizes) != len(axis_names):
        raise ValueError(f"{len(sizes)} axis sizes {tuple(sizes)} for the axes {axis_names}")
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one mesh axis size may be -1, got {tuple(sizes)}")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if known <= 0 or n % known:
            raise ValueError(f"mesh axis sizes {tuple(sizes)} cannot be inferred for {n} devices")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh axis sizes {sizes} must multiply to the device count {n}")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(sizes), axis_names)


@dataclass(frozen=True)
class Sharding:
    """A split of an array's leading axis over the mesh axes ``axes`` (in
    that order), copies over the others; ``axes == ()`` is a copy on
    every device."""

    mesh: Mesh
    axes: Tuple[str, ...]

    @property
    def is_fully_replicated(self) -> bool:
        return not self.axes

    @property
    def num_shards(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes)


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself; ``TypeError`` unless it is a :class:`Mesh` (a JAX
    mesh, or any other object, is refused before anything runs)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a dynode_tpu_torch.parallel.Mesh (create_mesh, create_hybrid_mesh), "
            f"got {type(mesh).__name__}"
        )
    return mesh


def _axes(mesh: Mesh, axis_name: AxisNames) -> Tuple[str, ...]:
    check_mesh(mesh)
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh axis {a!r} is not one of {mesh.axis_names}")
    return axes


def shard_batch(mesh: Mesh, axis_name: AxisNames = "chain") -> Sharding:
    """The split of an array's leading axis over ``axis_name`` (a name, or
    a tuple of names split together in mesh order)."""
    return Sharding(mesh, _axes(mesh, axis_name))


def ensemble_sharding(mesh: Mesh, axis_name: AxisNames = "ensemble") -> Sharding:
    """:func:`shard_batch` for an ensemble axis."""
    return shard_batch(mesh, axis_name)


def replicated(mesh: Mesh) -> Sharding:
    """A copy of an array on every device of the mesh."""
    return Sharding(mesh, ())


def host_batch(mesh: Mesh, batch: int, axis_name: AxisNames) -> int:
    """``batch`` rounded up to a multiple of the axis size: the width to
    pad a parameter stack to before splitting it."""
    size = shard_batch(mesh, axis_name).num_shards
    return -(-batch // size) * size


@dataclass(frozen=True)
class ShardPlan:
    """Where each shard of a split batch runs: ``devices[s]`` and
    ``owners[s]`` (a rank) for shard ``s``, ``width`` members each, and
    the device ``home`` that gathers them."""

    devices: Tuple[torch.device, ...]
    owners: Tuple[int, ...]
    width: int
    home: torch.device
    rank: int

    def place(self, shard: int) -> torch.device:
        """The device the tensors of ``shard`` live on: its mesh device, or
        ``cpu`` for any CPU entry (``cpu:3`` of a test mesh names a shard's
        place in the mesh, not another memory)."""
        dev = self.devices[shard]
        return torch.device("cpu") if dev.type == "cpu" else dev

    @property
    def local(self) -> Tuple[int, ...]:
        """The shards this process runs, in mesh order."""
        return tuple(s for s, o in enumerate(self.owners) if o == self.rank)

    @property
    def spans_processes(self) -> bool:
        return len(set(self.owners)) > 1


def _shards(sharding: Sharding) -> Tuple[Tuple[torch.device, ...], Tuple[int, ...]]:
    """Each shard's device and owner: the split axes lead, in their order;
    of a shard's copies over the other axes, this process's first, else the
    first in mesh order."""
    mesh = sharding.mesh
    order = [mesh.axis_names.index(a) for a in sharding.axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    n = sharding.num_shards
    devs = np.transpose(mesh.devices, order + rest).reshape(n, -1)
    procs = np.transpose(mesh.processes, order + rest).reshape(n, -1)
    rank = _rank()
    devices, owners = [], []
    for s in range(n):
        pick = int(np.argmax(procs[s] == rank)) if (procs[s] == rank).any() else 0
        devices.append(devs[s, pick])
        owners.append(int(procs[s, pick]))
    return tuple(devices), tuple(owners)


def shard_plan(mesh: Mesh, axis_name: AxisNames, batch: int, what: str = "batch") -> ShardPlan:
    """The split of ``batch`` members over ``axis_name`` of ``mesh``,
    checked before anything runs: the batch must divide over the axis,
    and every process of a mesh that spans several must own as many
    shards as each other (``all_gather`` takes equal pieces)."""
    sharding = shard_batch(mesh, axis_name)
    n = sharding.num_shards
    if batch % n:
        raise ValueError(
            f"{what} width {batch} must divide over the {n}-device {sharding.axes} mesh axis "
            f"({batch} = {batch // n} x {n} + {batch % n})"
        )
    devices, owners = _shards(sharding)
    counts = {r: owners.count(r) for r in set(owners)}
    if len(set(counts.values())) > 1:
        raise ValueError(f"the processes own unequal numbers of shards {counts}; gathering needs equal ones")
    home = mesh.first_device
    return ShardPlan(devices, owners, batch // n, torch.device("cpu") if home.type == "cpu" else home, _rank())


def split(x: torch.Tensor, plan: ShardPlan, shard: int, dim: int = 0) -> torch.Tensor:
    """Shard ``shard`` of ``x`` along ``dim``, on its device (an async copy
    where the devices differ)."""
    piece = x.narrow(dim, shard * plan.width, plan.width)
    return piece.to(plan.place(shard), non_blocking=True)


def run_shards(plan: ShardPlan, fn: Callable[[int], object]) -> dict:
    """``{shard: fn(shard)}`` for this process's shards, in mesh order.

    ``fn`` places its own work on ``plan.devices[shard]``; a shard on a
    CUDA device runs with that device current. The shards run in turn on
    the calling thread: the card's launches are asynchronous, so shards on
    distinct cards overlap as far as ``fn`` does not sync the host, and a
    CUDA-graph capture inside ``fn`` (which holds process-wide state) is
    never concurrent with another.
    """
    out = {}
    for s in plan.local:
        dev = plan.devices[s]
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                out[s] = fn(s)
        else:
            out[s] = fn(s)
    return out


def _all_gather(piece: torch.Tensor) -> list:
    dist = torch.distributed
    flag = piece.dtype == torch.bool
    send = piece.to(torch.uint8) if flag else piece.contiguous()
    got = [torch.empty_like(send) for _ in range(dist.get_world_size())]
    dist.all_gather(got, send)
    return [g.to(torch.bool) for g in got] if flag else got


def gather_shards(plan: ShardPlan, outs: dict, dim: Union[int, Callable] = 0):
    """The shards' results as one, on ``plan.home``: each leaf of the
    results (pytrees of one structure) concatenated over the shards in
    mesh order along ``dim`` (or ``dim(leaf)``). Where the mesh spans
    processes, each leaf's local pieces go to every process through
    ``torch.distributed.all_gather``, so that every process holds the
    whole result."""
    local = plan.local
    flat = {s: pytree.tree_flatten(outs[s]) for s in local}
    spec = flat[local[0]][1]
    n_leaves = len(flat[local[0]][0])
    ranks = sorted(set(plan.owners))
    joined = []
    for i in range(n_leaves):
        pieces = {s: flat[s][0][i] for s in local}
        first = pieces[local[0]]
        if not isinstance(first, torch.Tensor):
            joined.append(first)
            continue
        pieces = {s: p.to(plan.home, non_blocking=True) for s, p in pieces.items()}
        if plan.spans_processes:
            mine = torch.stack([pieces[s] for s in local])
            gathered = _all_gather(mine)
            slot = {r: 0 for r in ranks}
            for s, owner in enumerate(plan.owners):
                pieces[s] = gathered[owner][slot[owner]]
                slot[owner] += 1
        d = dim(first) if callable(dim) else dim
        joined.append(torch.cat([pieces[s] for s in range(len(plan.owners))], dim=d))
    return pytree.tree_unflatten(joined, spec)


def device_put_sharded_tree(tree, sharding: Sharding):
    """The per-device pieces of every tensor leaf of ``tree``: a list with
    one tree per shard of ``sharding`` (this process's shards; a copy per
    device where it is replicated), each leaf on its shard's device."""
    if sharding.is_fully_replicated:
        devices = [d for d, p in zip(sharding.mesh.devices.flat, sharding.mesh.processes.flat) if p == _rank()]
        return [pytree.tree_map(lambda x: x.to(d) if isinstance(x, torch.Tensor) else x, tree)
                for d in devices]
    leaves = [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]
    plan = shard_plan(sharding.mesh, sharding.axes, leaves[0].shape[0] if leaves else 0)
    return [pytree.tree_map(lambda x: split(x, plan, s) if isinstance(x, torch.Tensor) else x, tree)
            for s in plan.local]


def jit_donated(fn, donate_argnums=(0,), **jit_kwargs):
    """JAX's ``jit`` with buffer donation. The port compiles nothing and an
    eager call copies no argument that donation would spare, so ``fn``
    comes back unchanged (the keywords are accepted for the call form)."""
    return fn


__all__ = [
    "Mesh",
    "Sharding",
    "ShardPlan",
    "create_mesh",
    "default_device_count",
    "shard_batch",
    "ensemble_sharding",
    "replicated",
    "host_batch",
    "device_put_sharded_tree",
    "jit_donated",
    "check_mesh",
    "shard_plan",
    "split",
    "run_shards",
    "gather_shards",
]
