"""Multi-strain, age-stratified SEIRS: the scenario-ensemble workload.

Port of ``dynode_tpu/models/multistrain.py``. The state is the tuple
``(s, e, i, r, c)``: ``s`` is ``(A,)``, the others ``(A, K)`` for A age groups
and K strains (``c`` is cumulative incidence). The pydantic config layer is
not ported yet: :func:`multistrain_default_params` and
:func:`multistrain_initial_state` compute from the same defaults what
``multistrain_config`` -> ``multistrain_odeparams`` /
``MultiStrainInitializer`` compute in the JAX package.

The ``A x A`` contact contraction is written as an elementwise product and a
sum, so it runs in full float32 on every device (no TF32 matmul path).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

#: defaults of ``dynode_tpu.models.multistrain.multistrain_config``
DEFAULT_R0S = (2.0, 2.5, 1.8)
DEFAULT_INFECTIOUS_PERIODS = (7.0, 6.0, 8.0)
DEFAULT_LATENT_PERIODS = (3.0, 2.5, 4.0)
DEFAULT_WANING_PERIODS = (60.0, 80.0, 50.0)
DEFAULT_AGE_DEMOGRAPHICS = (0.75, 0.25)
DEFAULT_POPULATION = 1000.0


@dataclass(frozen=True)
class MultiStrainParams:
    """ODE parameters: per-strain rates ``(K,)`` (``beta`` may be ``(K, B)``
    in the ensemble form) and the ``(A, A)`` contact matrix."""

    beta: torch.Tensor
    sigma: torch.Tensor
    gamma: torch.Tensor
    omega: torch.Tensor
    contact_matrix: torch.Tensor

    def replace(self, **changes) -> "MultiStrainParams":
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)


def default_contact_matrix(n_age: int) -> np.ndarray:
    """``0.3 + 0.4 * I``, the default of ``multistrain_config``."""
    return np.full((n_age, n_age), 0.3) + 0.4 * np.eye(n_age)


def multistrain_default_params(
    r0s: Sequence[float] = DEFAULT_R0S,
    infectious_periods: Sequence[float] = DEFAULT_INFECTIOUS_PERIODS,
    latent_periods: Sequence[float] = DEFAULT_LATENT_PERIODS,
    waning_periods: Sequence[float] = DEFAULT_WANING_PERIODS,
    n_age: int = len(DEFAULT_AGE_DEMOGRAPHICS),
    contact_matrix=None,
    *,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> MultiStrainParams:
    """beta = r0 / T_inf, sigma = 1 / T_lat, gamma = 1 / T_inf,
    omega = 1 / T_wane (computed in float64, then cast to ``dtype``)."""
    r0s = np.asarray(r0s, np.float64)
    inf_p = np.asarray(infectious_periods, np.float64)
    lat_p = np.asarray(latent_periods, np.float64)
    wane_p = np.asarray(waning_periods, np.float64)
    if contact_matrix is None:
        contact_matrix = default_contact_matrix(n_age)

    def cast(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return MultiStrainParams(
        beta=cast(r0s / inf_p),
        sigma=cast(1.0 / lat_p),
        gamma=cast(1.0 / inf_p),
        omega=cast(1.0 / wane_p),
        contact_matrix=cast(contact_matrix),
    )


def multistrain_initial_state(
    r0s: Sequence[float] = DEFAULT_R0S,
    age_demographics: Sequence[float] = DEFAULT_AGE_DEMOGRAPHICS,
    population_size: float = DEFAULT_POPULATION,
    s0_prop: float = 0.99,
    i0_prop: float = 0.01,
    *,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, ...]:
    """``S0 = N * 0.99 * demo``; ``I0 = N * 0.01 * demo x (r0 / sum r0)``;
    E, R, C zero. Mirrors ``MultiStrainInitializer.get_initial_state``."""
    demo = np.asarray(age_demographics, np.float64)
    r0s = np.asarray(r0s, np.float64)
    n_age, n_strain = demo.shape[0], r0s.shape[0]
    s0 = population_size * s0_prop * demo
    dominance = r0s / np.sum(r0s)
    i0 = population_size * i0_prop * demo[:, None] * dominance
    zeros = np.zeros((n_age, n_strain))
    return tuple(
        torch.as_tensor(x, dtype=dtype, device=device)
        for x in (s0, zeros, i0, zeros, zeros)
    )


def multistrain_ode(t, state, p: MultiStrainParams):
    """RHS of one trajectory: ``foi[a, k] = beta[k] * (C @ (i / N))[a, k]``.

    state: ``s (A,)``, ``e/i/r/c (A, K)``.
    """
    s, e, i, r, _ = state
    n_age = s + e.sum(dim=-1) + i.sum(dim=-1) + r.sum(dim=-1)
    infectious_frac = i / n_age[:, None]  # (A, K)
    mixed = (p.contact_matrix[:, :, None] * infectious_frac[None, :, :]).sum(dim=1)
    foi = p.beta[None, :] * mixed
    new_inf = foi * s[:, None]
    ds = -new_inf.sum(dim=-1) + (p.omega * r).sum(dim=-1)
    de = new_inf - p.sigma * e
    di = p.sigma * e - p.gamma * i
    dr = p.gamma * i - p.omega * r
    return (ds, de, di, dr, new_inf)


def multistrain_ensemble_state(y0, batch: int):
    """Broadcast one initial state to a trailing ensemble axis (views)."""
    return tuple(a[..., None].expand(*a.shape, batch) for a in y0)


def multistrain_ensemble_params(
    base: MultiStrainParams, beta_scales: torch.Tensor
) -> MultiStrainParams:
    """Per-member transmission scaling: ``beta`` becomes ``(K, B)``."""
    return base.replace(beta=base.beta[:, None] * beta_scales[None, :])


def multistrain_ode_ensemble(t, state, p: MultiStrainParams):
    """RHS over a trailing ensemble axis.

    state: ``s (A, B)``, ``e/i/r/c (A, K, B)``; ``p.beta`` is ``(K, B)``.
    """
    s, e, i, r, _ = state
    n_age = s + e.sum(dim=1) + i.sum(dim=1) + r.sum(dim=1)  # (A, B)
    infectious_frac = i / n_age[:, None, :]  # (A, K, B)
    mixed = (
        p.contact_matrix[:, :, None, None] * infectious_frac[None, :, :, :]
    ).sum(dim=1)  # (A, K, B)
    foi = p.beta[None, :, :] * mixed
    new_inf = foi * s[:, None, :]
    ds = -new_inf.sum(dim=1) + (p.omega[:, None] * r).sum(dim=1)
    de = new_inf - p.sigma[:, None] * e
    di = p.sigma[:, None] * e - p.gamma[:, None] * i
    dr = p.gamma[:, None] * i - p.omega[:, None] * r
    return (ds, de, di, dr, new_inf)


__all__ = [
    "MultiStrainParams",
    "default_contact_matrix",
    "multistrain_default_params",
    "multistrain_initial_state",
    "multistrain_ode",
    "multistrain_ode_ensemble",
    "multistrain_ensemble_state",
    "multistrain_ensemble_params",
]
