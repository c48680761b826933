"""Several processes: ``torch.distributed`` and meshes that span them.

Port of ``dynode_tpu/parallel/distributed.py``.

- :func:`initialize_distributed` wraps ``torch.distributed.init_process_group``
  idempotently, and does nothing in a single process, so that one script
  runs unchanged alone or under ``torchrun``.
- :func:`create_hybrid_mesh` lays a mesh out with one axis across the
  processes (JAX's DCN axis across slices; here the process boundary plays
  it, as in JAX's own fallback for several processes on one slice) and the
  other axes over each process's devices.

Every axis this package splits is a batch axis (members, chains, SVI
starts), so nothing crosses processes until the results are gathered:
each process runs its own shards, and ``all_gather`` on the default group
gives every process the whole result
(:func:`~dynode_tpu_torch.parallel.mesh.gather_shards`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh

#: the variables ``torchrun`` sets for each process
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Join this process to a group of ``num_processes``; idempotent.

    ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` become ``init_method="tcp://host:port"``, ``world_size``
    and ``rank`` of ``torch.distributed.init_process_group``; the backend
    is ``nccl`` where the process has a CUDA device, ``gloo`` otherwise
    (``backend=`` in ``kwargs`` overrides it). With no arguments the
    variables ``torchrun`` sets are read; in a single process (none of
    them, or a world of one) this does nothing and returns False.

    Returns True when a group of several processes is (or already was)
    initialized.
    """
    dist = torch.distributed
    if dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        if not all(v in os.environ for v in _TORCHRUN) or int(os.environ["WORLD_SIZE"]) <= 1:
            return False
        init = dict(init_method="env://")
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "initialize_distributed needs coordinator_address, num_processes and process_id together "
                f"(got {coordinator_address!r}, {num_processes!r}, {process_id!r})"
            )
        address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        init = dict(init_method=address, world_size=int(num_processes), rank=int(process_id))
    kwargs.setdefault("backend", _backend())
    dist.init_process_group(**init, **kwargs)
    return True


def create_hybrid_mesh(
    axis_names: Sequence[str] = ("slice", "chain"),
    dcn_axis: str = "slice",
    num_slices: Optional[int] = None,
    devices=None,
) -> Mesh:
    """A mesh whose ``dcn_axis`` spans processes and whose other axes span
    each process's devices.

    ``num_slices`` defaults to the number of processes (1 without a
    group, where this is :func:`~.mesh.create_mesh` with the same axis
    names). ``devices`` are this process's devices (default: every
    visible CUDA device; with one process per card, as ``torchrun`` starts
    them, pass that card: ``[torch.device("cuda", local_rank)]``); each
    process is taken to have the same number.
    With one process and ``num_slices`` > 1, the given devices are split
    slice-major, as in JAX's fallback. The last non-DCN axis holds the
    devices of a slice; the other non-DCN axes have size 1.
    """
    from .mesh import _rank, create_mesh

    axis_names = tuple(axis_names)
    if dcn_axis not in axis_names:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in {axis_names}")
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is None:
        devices = create_mesh(("d",)).devices.ravel().tolist()
    devices = [torch.device(d) for d in devices]
    if num_slices is None:
        num_slices = world
    num_slices = int(num_slices)
    ici_names = [a for a in axis_names if a != dcn_axis]
    if world > 1:
        if num_slices != world:
            raise ValueError(f"num_slices={num_slices} across {world} processes: one slice per process")
        per_slice = len(devices)
        # every process lists its own devices; entry [p, ...] is process p's
        all_devices = devices * world
        owners = np.repeat(np.arange(world), per_slice)
    else:
        if len(devices) % num_slices:
            raise ValueError(f"{len(devices)} devices do not split into {num_slices} slices")
        per_slice = len(devices) // num_slices
        all_devices = devices
        owners = np.full(len(devices), _rank())
    ici_shape = [1] * len(ici_names)
    if ici_names:
        ici_shape[-1] = per_slice
    shape = _interleave(axis_names, dcn_axis, num_slices, ici_names, ici_shape)
    dev_array = np.empty(len(all_devices), dtype=object)
    dev_array[:] = all_devices
    return Mesh(dev_array.reshape(shape), axis_names, owners.reshape(shape))


def _interleave(axis_names, dcn_axis, dcn_size, ici_names, ici_shape) -> Tuple[int, ...]:
    """The full mesh shape with ``dcn_size`` at the DCN axis's place."""
    out = []
    it = iter(ici_shape)
    for a in axis_names:
        out.append(dcn_size if a == dcn_axis else next(it))
    return tuple(out)


__all__ = ["initialize_distributed", "create_hybrid_mesh"]
