"""Carry the JAX package's parameters and state into the port.

Both take numpy arrays (``np.asarray`` of the JAX values) and never import
JAX: a mapping or any object with ``beta/sigma/gamma/omega/contact_matrix``
becomes :class:`~dynode_tpu_torch.models.multistrain.MultiStrainParams`, and
the ``(s, e, i, r, c)`` tuple becomes a tuple of tensors.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .models.multistrain import MultiStrainParams

_PARAM_FIELDS = ("beta", "sigma", "gamma", "omega", "contact_matrix")


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def params_from_numpy(
    params, *, dtype: torch.dtype = torch.float32, device=None
) -> MultiStrainParams:
    """Multi-strain parameters from a mapping or an attribute object."""

    def field(name):
        if isinstance(params, Mapping):
            return params[name]
        return getattr(params, name)

    return MultiStrainParams(
        **{name: _tensor(field(name), dtype, device) for name in _PARAM_FIELDS}
    )


def state_from_numpy(
    state, *, dtype: torch.dtype = torch.float32, device=None
) -> tuple[torch.Tensor, ...]:
    """The ``(s, e, i, r, c)`` compartment tuple as tensors."""
    if len(state) != 5:
        raise ValueError(f"expected the (s, e, i, r, c) tuple, got {len(state)} parts")
    return tuple(_tensor(x, dtype, device) for x in state)


__all__ = ["params_from_numpy", "state_from_numpy"]
