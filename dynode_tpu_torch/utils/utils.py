"""Object-to-tensor bridge helpers and posterior-dict utilities.

Port of ``dynode_tpu/utils/utils.py``. ``vectorize_objects`` is how
per-strain object fields become strain-axis tensors for the RHS;
``flatten_list_parameters`` / ``identify_distribution_indexes`` translate
between plated sample arrays and flat ``key_i_j`` naming.
"""

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..dist import Distribution


def vectorize_objects(
    objs: List[Any],
    target: str,
    filter: Callable[[Any], bool] = lambda _: True,
) -> List[Any]:
    """Collect ``obj.<target>`` from each object passing ``filter``."""
    if not isinstance(target, str):
        raise AssertionError("target must be a string")
    return [getattr(o, target) for o in objs if filter(o)]


def flatten_list_parameters(samples: Dict[str, Any]) -> Dict[str, Any]:
    """Split plated ``(chain, sample, *plate)`` arrays into ``key_i_j`` 2-D entries.

    Arrays (numpy or tensors) of ndim <= 2 pass through unchanged.
    """
    out: Dict[str, Any] = {}
    for key, value in samples.items():
        if isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim > 2:
            plate_ndim = value.ndim - 2
            plate_shape = tuple(value.shape[-plate_ndim:])
            for flat_idx in np.ndindex(*plate_shape):
                suffix = "_".join(str(i) for i in flat_idx)
                out[f"{key}_{suffix}"] = value[(slice(None), slice(None)) + flat_idx]
        else:
            out[key] = value
    return out


def drop_keys_with_substring(dct: Dict[str, Any], drop_s: str) -> Dict[str, Any]:
    """Remove (in place) keys containing ``drop_s``; returns the dict."""
    for key in [k for k in dct if drop_s in k]:
        del dct[key]
    return dct


def identify_distribution_indexes(parameters: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Map sample-site names back to their parameter name and list index.

    A Distribution at ``parameters["test"][1]`` was sampled as site
    ``test_1``; this returns ``{"test_1": {"sample_name": "test",
    "sample_idx": (1,)}}``, with ``sample_idx=None`` for non-list parameters.
    """
    found: Dict[str, Dict[str, Any]] = {}
    for key, param in parameters.items():
        if isinstance(param, Distribution):
            found[key] = {"sample_name": key, "sample_idx": None}
        elif isinstance(param, (np.ndarray, list)):
            arr = np.array(param, dtype=object)
            flat = arr.ravel()
            if not any(isinstance(p, Distribution) for p in flat):
                continue
            for flat_i, p in enumerate(flat):
                if isinstance(p, Distribution):
                    idx = np.unravel_index(flat_i, arr.shape)
                    site = key + "_" + "_".join(str(i) for i in idx)
                    found[site] = {"sample_name": key, "sample_idx": tuple(int(i) for i in idx)}
    return found


__all__ = [
    "vectorize_objects",
    "flatten_list_parameters",
    "drop_keys_with_substring",
    "identify_distribution_indexes",
]
