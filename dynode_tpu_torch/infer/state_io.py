"""Serialize inference state to disk (resume / chained fits across processes).

Port of ``dynode_tpu/infer/state_io.py``: the same ``.npz`` layout, one
``leaf_i`` array per leaf plus ``__treedef__``, for trees of tensors,
arrays and numbers (``MCMC`` warm starts, SVI parameters, posterior sample
dicts). The JAX package pickles a JAX treedef there, which cannot be read
without JAX; the port writes a treedef of its own, as JSON, and unpickles
nothing. A file written by the JAX package raises a ``ValueError`` that
says how to carry it over (:func:`~dynode_tpu_torch.convert.warm_start_from_numpy`).
"""

import importlib
import json
from typing import Any

import numpy as np
import torch

from .. import _device

_PACKAGE = __name__.split(".")[0]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _flatten(tree, leaves: list):
    """The JSON treedef of ``tree``; its leaves appended to ``leaves``."""
    if tree is None:
        return {"none": True}
    if _is_namedtuple(tree):
        cls = type(tree)
        if not cls.__module__.startswith(_PACKAGE + "."):
            raise TypeError(f"save_pytree keeps only this package's named tuples, not {cls.__qualname__}")
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "items": [_flatten(x, leaves) for x in tree]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(x, leaves) for x in tree]}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError("save_pytree keeps dicts with string keys only")
        return {"dict": [[k, _flatten(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        leaves.append((t.float() if t.dtype == torch.bfloat16 else t).numpy())
        return {"leaf": len(leaves) - 1, "tensor": str(tree.dtype).replace("torch.", "")}
    if isinstance(tree, (bool, int, float)):
        leaves.append(np.asarray(tree))
        return {"leaf": len(leaves) - 1, "python": type(tree).__name__}
    if isinstance(tree, (np.ndarray, np.generic)):
        leaves.append(np.asarray(tree))
        return {"leaf": len(leaves) - 1}
    raise TypeError(f"save_pytree cannot keep a leaf of type {type(tree).__name__}")


def _unflatten(node, leaves, device):
    if "none" in node:
        return None
    if "namedtuple" in node:
        module, name = node["namedtuple"].split(":")
        if not module.startswith(_PACKAGE + "."):
            raise ValueError(f"the file names a type outside this package: {node['namedtuple']}")
        cls = getattr(importlib.import_module(module), name)
        return cls(*(_unflatten(x, leaves, device) for x in node["items"]))
    if "list" in node:
        return [_unflatten(x, leaves, device) for x in node["list"]]
    if "tuple" in node:
        return tuple(_unflatten(x, leaves, device) for x in node["tuple"])
    if "dict" in node:
        return {k: _unflatten(v, leaves, device) for k, v in node["dict"]}
    leaf = leaves[node["leaf"]]
    if "tensor" in node:
        return torch.as_tensor(leaf).to(device=device, dtype=getattr(torch, node["tensor"]))
    if "python" in node:
        return {"bool": bool, "int": int, "float": float}[node["python"]](leaf)
    return leaf


def save_pytree(path: str, tree: Any) -> None:
    """Write a tree of tensors, arrays and numbers (nested dicts with string
    keys, lists, tuples and this package's named tuples) to ``path`` (.npz)."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    np.savez(
        path,
        __treedef__=np.frombuffer(json.dumps(treedef).encode(), dtype=np.uint8),
        **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
    )


def load_pytree(path: str, *, device=None) -> Any:
    """Inverse of :func:`save_pytree`. Tensors come back on ``device`` (with
    no ``device``, the card; pass ``device="cpu"`` for the CPU), arrays and
    numbers as they were."""
    with np.load(path, allow_pickle=False) as data:
        raw = data["__treedef__"].tobytes()
        try:
            treedef = json.loads(raw.decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise ValueError(
                f"{path} was not written by this package's save_pytree: its treedef is a pickle, as the JAX "
                "package's save_pytree writes, which cannot be read without JAX. Load it with "
                "dynode_tpu.infer.load_mcmc_warm_start where JAX is installed and pass that warm start, as numpy, "
                "to dynode_tpu_torch.convert.warm_start_from_numpy"
            ) from None
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    return _unflatten(treedef, leaves, _device.resolve(device) if _has_tensors(treedef) else None)


def _has_tensors(node) -> bool:
    if isinstance(node, dict):
        return "tensor" in node or any(_has_tensors(v) for v in node.values())
    if isinstance(node, list):
        return any(_has_tensors(v) for v in node)
    return False


def save_mcmc(path: str, mcmc) -> None:
    """Persist an MCMC run: samples, extra fields, and warm-start state."""
    save_pytree(
        path,
        {
            "samples": mcmc.get_samples(group_by_chain=True),
            "extra_fields": mcmc.get_extra_fields(group_by_chain=True),
            "warm_start": mcmc.warm_start_state(),
        },
    )


def load_mcmc_warm_start(path: str, *, device=None):
    """The warm start saved by :func:`save_mcmc`, with its state type
    (``HMCState`` or ``ChEESBankState``) and its tensors on ``device`` (as
    :func:`load_pytree`)."""
    return load_pytree(path, device=device)["warm_start"]


__all__ = ["save_pytree", "load_pytree", "save_mcmc", "load_mcmc_warm_start"]
