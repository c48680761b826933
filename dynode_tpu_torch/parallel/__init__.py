"""Meshes of devices and the split of a batch over them (chains, ensemble
members, SVI starts), in one process or across several."""

from .distributed import create_hybrid_mesh, initialize_distributed
from .mesh import (
    Mesh,
    create_mesh,
    default_device_count,
    device_put_sharded_tree,
    ensemble_sharding,
    host_batch,
    jit_donated,
    replicated,
    shard_batch,
)

__all__ = [
    "create_mesh",
    "default_device_count",
    "shard_batch",
    "ensemble_sharding",
    "replicated",
    "host_batch",
    "device_put_sharded_tree",
    "jit_donated",
    "initialize_distributed",
    "create_hybrid_mesh",
    "Mesh",
]
