"""Carry the JAX package's parameters and state into the port.

Both take numpy arrays (``np.asarray`` of the JAX values) and never import
JAX: a mapping or any object with ``beta/sigma/gamma/omega/contact_matrix``
becomes :class:`~dynode_tpu_torch.models.multistrain.MultiStrainParams`, and
the ``(s, e, i, r, c)`` tuple becomes a tuple of tensors; for the SEIP model
a mapping or object with the ``SEIPParams`` field names becomes
:class:`~dynode_tpu_torch.models.seip.SEIPParams`, and ``(S, E, I, C)`` a
tuple of tensors. With no
``device`` the tensors go to the card (raises where there is none); pass
``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from . import _device
from .models.multistrain import MultiStrainParams
from .models.seip import SEIPParams

_PARAM_FIELDS = ("beta", "sigma", "gamma", "omega", "contact_matrix")


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=_device.resolve(device))


def _field(params, name):
    if isinstance(params, Mapping):
        return params[name]
    return getattr(params, name)


def params_from_numpy(
    params, *, dtype: torch.dtype = torch.float32, device=None
) -> MultiStrainParams:
    """Multi-strain parameters from a mapping or an attribute object."""
    return MultiStrainParams(
        **{name: _tensor(_field(params, name), dtype, device) for name in _PARAM_FIELDS}
    )


def state_from_numpy(
    state, *, dtype: torch.dtype = torch.float32, device=None
) -> tuple[torch.Tensor, ...]:
    """The ``(s, e, i, r, c)`` compartment tuple as tensors."""
    if len(state) != 5:
        raise ValueError(f"expected the (s, e, i, r, c) tuple, got {len(state)} parts")
    return tuple(_tensor(x, dtype, device) for x in state)


def seip_params_from_numpy(
    params, *, dtype: torch.dtype = torch.float32, device=None
) -> SEIPParams:
    """SEIP parameters from a mapping or an attribute object with the
    ``SEIPParams`` field names; ``seasonal_vaccination`` stays a bool and
    the static ``idx`` is not carried over."""
    tensors = {
        f.name: _tensor(_field(params, f.name), dtype, device)
        for f in dataclasses.fields(SEIPParams) if f.name not in ("idx", "seasonal_vaccination")
    }
    return SEIPParams(**tensors, seasonal_vaccination=bool(_field(params, "seasonal_vaccination")))


def seip_state_from_numpy(
    state, *, dtype: torch.dtype = torch.float32, device=None
) -> tuple[torch.Tensor, ...]:
    """The SEIP ``(S, E, I, C)`` compartment tuple as tensors."""
    if len(state) != 4:
        raise ValueError(f"expected the (S, E, I, C) tuple, got {len(state)} parts")
    return tuple(_tensor(x, dtype, device) for x in state)


__all__ = ["params_from_numpy", "seip_params_from_numpy", "seip_state_from_numpy", "state_from_numpy"]
