"""Multi-strain, age-stratified SEIRS: the scenario-ensemble workload.

Port of ``dynode_tpu/models/multistrain.py``. The state is the tuple
``(s, e, i, r, c)``: ``s`` is ``(A,)``, the others ``(A, K)`` for A age groups
and K strains (``c`` is cumulative incidence).

:func:`multistrain_config` builds the ``SimulationConfig`` (the port's
config layer), :func:`multistrain_odeparams` vectorises a (possibly
sampled) config into :class:`MultiStrainParams`, and
:func:`multistrain_initial_state` runs its :class:`MultiStrainInitializer`.
The config-free forms :func:`multistrain_default_params` (a wrapper over
the config) and ``multistrain_initial_state(r0s, ...)`` keep their
signatures. Every constructor puts its tensors on the card unless the
caller names a device (``device="cpu"``); numbers are combined in float64
and cast to ``dtype`` at the end.

The ``A x A`` contact contraction is written as an elementwise product and a
sum, so it runs in full float32 on every device (no TF32 matmul path).
"""

from __future__ import annotations

import dataclasses
from datetime import date
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _device
from .. import _validate as V
from ..config import (
    Bin,
    Compartment,
    Dimension,
    Initializer,
    Params,
    SimulationConfig,
    SolverParams,
    Strain,
    TransmissionParams,
)
from ..config._model import Field
from ..struct import pytree_dataclass
from ..utils import vectorize_objects
from ._values import f64, ordered_sum

#: defaults of ``multistrain_config``
DEFAULT_R0S = (2.0, 2.5, 1.8)
DEFAULT_INFECTIOUS_PERIODS = (7.0, 6.0, 8.0)
DEFAULT_LATENT_PERIODS = (3.0, 2.5, 4.0)
DEFAULT_WANING_PERIODS = (60.0, 80.0, 50.0)
DEFAULT_AGE_DEMOGRAPHICS = (0.75, 0.25)
DEFAULT_POPULATION = 1000.0


@pytree_dataclass(frozen=True, static_fieldnames=("idx",))
class MultiStrainParams:
    """ODE parameters: per-strain rates ``(K,)`` (``beta`` may be ``(K, B)``
    in the ensemble form), the ``(A, A)`` contact matrix, and the config's
    ``idx`` namespace (static, None for the config-free form)."""

    beta: torch.Tensor
    sigma: torch.Tensor
    gamma: torch.Tensor
    omega: torch.Tensor
    contact_matrix: torch.Tensor
    idx: Optional[SimpleNamespace] = None

    def replace(self, **changes) -> "MultiStrainParams":
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)


def default_contact_matrix(n_age: int) -> np.ndarray:
    """``0.3 + 0.4 * I``, the default of ``multistrain_config``."""
    return np.full((n_age, n_age), 0.3) + 0.4 * np.eye(n_age)


def _initial_state(config_shapes, r0s, age_demographics, population_size, s0_prop, i0_prop,
                   dtype, device):
    """``S0 = N s0_prop demo``; ``I0 = N i0_prop demo x (r0 / sum r0)``;
    E, R, C zero; float64, then cast."""
    demo = f64(age_demographics, device)
    r0s = f64(r0s, device)
    e_shape, r_shape, c_shape = config_shapes or ((demo.shape[0], r0s.shape[0]),) * 3
    s0 = population_size * s0_prop * demo
    dominance = r0s / ordered_sum(r0s)
    i0 = population_size * i0_prop * demo[:, None] * dominance
    zeros = [torch.zeros(shape, dtype=torch.float64, device=device) for shape in (e_shape, r_shape, c_shape)]
    return tuple(x.to(dtype) for x in (s0, zeros[0], i0, zeros[1], zeros[2]))


class MultiStrainInitializer(Initializer):
    """Distributes initial infections across strains proportional to r0."""

    s0_prop = Field(V.float_, 0.99)
    i0_prop = Field(V.float_, 0.01)
    age_demographics = Field(V.sequence_of(V.float_), DEFAULT_AGE_DEMOGRAPHICS)

    def get_initial_state(self, config: SimulationConfig, *, dtype: torch.dtype = torch.float32,
                          device: torch.device | str | None = None, **kwargs):
        """Initial (S, E, I, R, C) compartments from demographics and seeds."""
        shapes = tuple(config.get_compartment(name).shape for name in ("e", "r", "c"))
        r0s = vectorize_objects(config.parameters.transmission_params.strains, target="r0")
        return _initial_state(shapes, r0s, self.age_demographics, self.population_size,
                              self.s0_prop, self.i0_prop, dtype, _device.resolve(device))


def multistrain_config(
    r0s=DEFAULT_R0S,
    infectious_periods=DEFAULT_INFECTIOUS_PERIODS,
    latent_periods=DEFAULT_LATENT_PERIODS,
    waning_periods=DEFAULT_WANING_PERIODS,
    strain_names=("A", "B", "C"),
    age_names=("young", "old"),
    age_demographics=DEFAULT_AGE_DEMOGRAPHICS,
    contact_matrix=None,
    solver_params: Optional[SolverParams] = None,
) -> SimulationConfig:
    """Age x strain SEIRS+C config, generalized to any strain/age count."""
    strains = [
        Strain(
            strain_name=name,
            r0=r0s[k],
            infectious_period=infectious_periods[k],
            exposed_to_infectious=latent_periods[k],
        )
        for k, name in enumerate(strain_names)
    ]
    age_dim = Dimension(name="age", bins=[Bin(name=a) for a in age_names])
    strain_dim = Dimension(name="strain", bins=[Bin(name=s.strain_name) for s in strains])
    if contact_matrix is None:
        contact_matrix = default_contact_matrix(len(age_names))
    if not isinstance(contact_matrix, torch.Tensor):
        contact_matrix = torch.as_tensor(np.asarray(contact_matrix, np.float64))
    interactions = {s1: {s2: 1.0 for s2 in strain_names} for s1 in strain_names}
    return SimulationConfig(
        compartments=[
            Compartment(name="s", dimensions=[age_dim]),
            Compartment(name="e", dimensions=[age_dim, strain_dim]),
            Compartment(name="i", dimensions=[age_dim, strain_dim]),
            Compartment(name="r", dimensions=[age_dim, strain_dim]),
            Compartment(name="c", dimensions=[age_dim, strain_dim]),
        ],
        initializer=MultiStrainInitializer(
            description="age x strain SEIRS initializer",
            initialize_date=date(2022, 2, 11),
            population_size=1000,
            age_demographics=age_demographics,
        ),
        parameters=Params(
            solver_params=solver_params or SolverParams(step_budget=512),
            transmission_params=TransmissionParams(
                strains=strains,
                strain_interactions=interactions,
                contact_matrix=contact_matrix,
                waning_period=tuple(waning_periods),
            ),
        ),
    )


def multistrain_odeparams(
    config: SimulationConfig,
    *,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> MultiStrainParams:
    """Vectorize a (possibly sampled) config into strain-axis tensors:
    beta = r0 / T_inf, sigma = 1 / T_lat, gamma = 1 / T_inf,
    omega = 1 / T_wane, in float64, then cast to ``dtype``; ``idx`` is
    ``config.idx``. Tensors in the config keep their graph."""
    device = _device.resolve(device)
    tp = config.parameters.transmission_params
    r0s = f64(vectorize_objects(tp.strains, target="r0"), device)
    inf_p = f64(vectorize_objects(tp.strains, target="infectious_period"), device)
    lat_p = f64(vectorize_objects(tp.strains, target="exposed_to_infectious"), device)
    return MultiStrainParams(
        beta=(r0s / inf_p).to(dtype),
        sigma=(1.0 / lat_p).to(dtype),
        gamma=(1.0 / inf_p).to(dtype),
        omega=(1.0 / f64(tp.waning_period, device)).to(dtype),
        contact_matrix=f64(tp.contact_matrix, device).to(dtype),
        idx=config.idx,
    )


def _names(prefix: str, n: int, default: tuple) -> tuple:
    return default if len(default) == n else tuple(f"{prefix}{k}" for k in range(n))


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
    """``multistrain_odeparams(multistrain_config(...))`` without the
    config's ``idx`` (None), for ``len(r0s)`` strains and ``n_age`` ages.

    With no ``device`` the tensors go to the card (raises where there is
    none); pass ``device="cpu"`` for the CPU.
    """
    device = _device.resolve(device)
    config = multistrain_config(
        r0s=r0s,
        infectious_periods=infectious_periods,
        latent_periods=latent_periods,
        waning_periods=waning_periods,
        strain_names=_names("S", len(r0s), ("A", "B", "C")),
        age_names=_names("age", n_age, ("young", "old")),
        contact_matrix=contact_matrix,
    )
    return multistrain_odeparams(config, dtype=dtype, device=device).replace(idx=None)


def multistrain_initial_state(
    r0s=DEFAULT_R0S,
    age_demographics: Sequence[float] = DEFAULT_AGE_DEMOGRAPHICS,
    population_size: float = DEFAULT_POPULATION,
    s0_prop: float = 0.99,
    i0_prop: float = 0.01,
    *,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, ...]:
    """The initial ``(s, e, i, r, c)``.

    Given a ``SimulationConfig`` (``multistrain_initial_state(config)``),
    its initializer's state. Otherwise the config-free form, the same
    computation on the arguments: ``S0 = N * 0.99 * demo``; ``I0 = N * 0.01
    * demo x (r0 / sum r0)``; E, R, C zero. ``device`` as in
    :func:`multistrain_default_params`.
    """
    if isinstance(r0s, SimulationConfig):
        return r0s.initializer.get_initial_state(r0s, dtype=dtype, device=device)
    return _initial_state(None, r0s, age_demographics, population_size, s0_prop, i0_prop,
                          dtype, _device.resolve(device))


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
    "MultiStrainInitializer",
    "default_contact_matrix",
    "multistrain_config",
    "multistrain_odeparams",
    "multistrain_default_params",
    "multistrain_initial_state",
    "multistrain_ode",
    "multistrain_ode_ensemble",
    "multistrain_ensemble_state",
    "multistrain_ensemble_params",
]
