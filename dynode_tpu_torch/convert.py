"""Carry the JAX package's parameters and state into the port.

They take numpy arrays (``np.asarray`` of the JAX values) and never import
JAX: a mapping or any object with ``beta/sigma/gamma/omega/contact_matrix``
becomes :class:`~dynode_tpu_torch.models.multistrain.MultiStrainParams`, and
the ``(s, e, i, r, c)`` tuple becomes a tuple of tensors; for the SEIP model
a mapping or object with the ``SEIPParams`` field names becomes
:class:`~dynode_tpu_torch.models.seip.SEIPParams`, and ``(S, E, I, C)`` a
tuple of tensors; a JAX ``MCMC.warm_start_state()`` becomes the port's
warm start (:func:`warm_start_from_numpy`). With no
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


def warm_start_from_numpy(saved, *, dtype: torch.dtype = None, device=None):
    """The port's ``MCMC.run(warm_start=...)`` value from the JAX
    ``MCMC.warm_start_state()``, with every array as numpy (``np.asarray``).

    ``saved`` is ``(state, tuned)``. A NUTS state (fields ``z, potential,
    grad, energy, accept_prob, num_steps, diverging``, chains leading) and
    ``(inv_mass, chol, step_size)`` become an ``infer.hmc.HMCState`` and a
    tuple of tensors; a ChEES state (its fields plus ``iter_idx``) and
    ``(inv_mass, chol, step_size, trajectory)`` an
    ``infer.chees.ChEESBankState`` and a tuple. The per-chain keys have no
    counterpart and are dropped. Floating arrays take ``dtype`` (default:
    their own), on ``device`` (default: the card).
    """
    from .infer.chees import ChEESBankState
    from .infer.hmc import HMCState

    state, tuned = saved
    dev = _device.resolve(device)

    def tensor(x):
        t = torch.as_tensor(np.array(x), device=dev)  # a copy: JAX's arrays are read-only
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    fields = {f: tensor(_field(state, f)) for f in HMCState._fields}
    fields["num_steps"] = fields["num_steps"].to(torch.int32)
    fields["diverging"] = fields["diverging"].to(torch.bool)
    if len(tuned) == 4:
        new_state = ChEESBankState(**fields, iter_idx=int(np.asarray(_field(state, "iter_idx"))))
    elif len(tuned) == 3:
        new_state = HMCState(**fields)
    else:
        raise ValueError(f"expected 3 (NUTS) or 4 (ChEES) tuned parameters, got {len(tuned)}")
    return new_state, tuple(tensor(x) for x in tuned)


__all__ = [
    "params_from_numpy",
    "seip_params_from_numpy",
    "seip_state_from_numpy",
    "state_from_numpy",
    "warm_start_from_numpy",
]
