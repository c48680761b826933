"""Config values as float64 tensors, for the config-based constructors.

A config holds Python numbers, numpy arrays and, once sampled, tensors
(on the card, with a graph). The constructors combine them in float64 and
cast the result to the caller's dtype at the end, as the config-free
constructors do with numpy; tensors keep their graph, and move only when
the caller asks for another device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device


def f64(values, device: torch.device) -> torch.Tensor:
    """``values`` (a number, an array, a tensor, or a list of them) as one
    float64 tensor on ``device``. Host values bound for the card go there
    through :func:`~dynode_tpu_torch._device.from_host`, so a model that
    builds its parameters inside a captured potential copies nothing from
    the host."""
    if isinstance(values, torch.Tensor):
        if values.device.type == "cpu" and torch.device(device).type != "cpu" and not values.requires_grad:
            return _device.from_host(values, device, torch.float64)
        return values.to(device=device, dtype=torch.float64)
    if isinstance(values, (list, tuple)) and any(isinstance(v, torch.Tensor) for v in values):
        return torch.stack([f64(v, device) for v in values])
    return _device.from_host(np.asarray(values, np.float64), device)


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a short 1-D tensor left to right (numpy's order below 8
    elements), so the result does not depend on the device's reduction."""
    total = x[0]
    for item in x[1:]:
        total = total + item
    return total


__all__ = ["f64", "ordered_sum"]
