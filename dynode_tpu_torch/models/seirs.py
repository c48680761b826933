"""SEIRS model family: basic and seasonally-forced.

Port of ``dynode_tpu/models/seirs.py``: the same defaults as the reference's
``examples/seirs.py`` and ``examples/seirs_seasonal_forcing.py``, so the
endemic-equilibrium and persistent-oscillation oracles line up.
:func:`seirs_odeparams` combines the config's values (numbers or sampled
tensors) in float64 and casts to the caller's dtype at the end, as the
other config-based constructors do.
"""

from __future__ import annotations

import math
from datetime import date
from typing import Optional

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
from ..simulation import AbstractODEParams
from ..struct import pytree_dataclass
from ..typing import CompartmentState
from ._values import f64


@pytree_dataclass
class SeasonalityParams:
    """beta(t) = beta * (1 + amplitude * sin(2 pi t / period + phase))."""

    amplitude: torch.Tensor
    period: torch.Tensor
    phase: torch.Tensor


@pytree_dataclass
class SEIRSParams(AbstractODEParams):
    """ODE parameter pytree of the SEIRS model."""

    beta: torch.Tensor
    sigma: torch.Tensor  # 1 / latent_period
    gamma: torch.Tensor  # 1 / infectious_period
    omega: torch.Tensor  # 1 / waning_period (R -> S)
    seasonality: Optional[SeasonalityParams] = None


def _seirs_flows(beta_t, state, p):
    s, e, i, r = state
    n = s + e + i + r
    s_to_e = beta_t * s * i / n
    e_to_i = p.sigma * e
    i_to_r = p.gamma * i
    r_to_s = p.omega * r
    return (
        r_to_s - s_to_e,
        s_to_e - e_to_i,
        e_to_i - i_to_r,
        i_to_r - r_to_s,
    )


def seirs_ode(t, state: CompartmentState, p: SEIRSParams):
    """Plain SEIRS with waning R->S."""
    return _seirs_flows(p.beta, state, p)


def seirs_seasonal_ode(t, state: CompartmentState, p: SEIRSParams):
    """SEIRS with sinusoidal transmission forcing."""
    seas = p.seasonality
    beta_t = p.beta * (1.0 + seas.amplitude * torch.sin(2.0 * math.pi * t / seas.period + seas.phase))
    return _seirs_flows(beta_t, state, p)


class SEIRSInitializer(Initializer):
    """Proportion-based SEIRS initial-state builder."""

    s0_prop = Field(V.float_, 0.99)
    i0_prop = Field(V.float_, 0.01)

    def get_initial_state(self, config: Optional[SimulationConfig] = None, *,
                          dtype: torch.dtype = torch.float32,
                          device: torch.device | str | None = None, **kwargs) -> CompartmentState:
        """Initial (S, E, I, R) from proportions (``config`` is not read)."""
        device = _device.resolve(device)
        s0 = torch.tensor([self.population_size * self.s0_prop], dtype=torch.float64, device=device)
        i0 = torch.tensor([self.population_size * self.i0_prop], dtype=torch.float64, device=device)
        zero = torch.zeros_like(s0)
        return tuple(x.to(dtype) for x in (s0, zero, i0, zero))


def _seirs_config(
    r_0,
    infectious_period,
    latent_period,
    waning_period,
    solver_params,
    extra_tp,
) -> SimulationConfig:
    dim = Dimension(name="age", bins=[Bin(name="all")])
    return SimulationConfig(
        compartments=[Compartment(name=n, dimensions=[dim]) for n in ("s", "e", "i", "r")],
        initializer=SEIRSInitializer(
            description="SEIRS proportions",
            initialize_date=date(2022, 2, 11),
            population_size=1000,
        ),
        parameters=Params(
            solver_params=solver_params or SolverParams(step_budget=512),
            transmission_params=TransmissionParams(
                strains=[
                    Strain(
                        strain_name="base",
                        r0=r_0,
                        infectious_period=infectious_period,
                        exposed_to_infectious=latent_period,
                    )
                ],
                strain_interactions={"base": {"base": 1.0}},
                latent_period=latent_period,
                waning_period=waning_period,
                **extra_tp,
            ),
        ),
    )


def seirs_config(
    r_0=2.0,
    infectious_period=7.0,
    latent_period=3.0,
    waning_period=60.0,
    solver_params: Optional[SolverParams] = None,
) -> SimulationConfig:
    """Plain SEIRS (reference workload: examples/seirs.py)."""
    return _seirs_config(r_0, infectious_period, latent_period, waning_period, solver_params, {})


def seirs_seasonal_config(
    r_0=2.0,
    infectious_period=7.0,
    latent_period=3.0,
    waning_period=60.0,
    seasonal_amplitude=0.2,
    seasonal_period=365.0,
    seasonal_phase=0.0,
    solver_params: Optional[SolverParams] = None,
) -> SimulationConfig:
    """Seasonally-forced SEIRS (reference workload: examples/seirs_seasonal_forcing.py)."""
    return _seirs_config(
        r_0,
        infectious_period,
        latent_period,
        waning_period,
        solver_params,
        dict(
            seasonal_amplitude=seasonal_amplitude,
            seasonal_period=seasonal_period,
            seasonal_phase=seasonal_phase,
        ),
    )


def seirs_odeparams(
    config: SimulationConfig,
    seasonal: bool = False,
    *,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> SEIRSParams:
    """Vectorize a (possibly sampled) SEIRS config into RHS parameters, in
    float64, then cast to ``dtype``; tensors in the config keep their
    graph. With no ``device`` the tensors go to the card."""
    device = _device.resolve(device)
    tp = config.parameters.transmission_params
    strain = tp.strains[0]

    def cast(x):
        return f64(x, device).to(dtype)

    seas = None
    if seasonal:
        seas = SeasonalityParams(
            amplitude=cast(tp.seasonal_amplitude),
            period=cast(tp.seasonal_period),
            phase=cast(tp.seasonal_phase),
        )
    r0, period = f64(strain.r0, device), f64(strain.infectious_period, device)
    return SEIRSParams(
        beta=(r0 / period).to(dtype),
        sigma=(1.0 / f64(tp.latent_period, device)).to(dtype),
        gamma=(1.0 / period).to(dtype),
        omega=(1.0 / f64(tp.waning_period, device)).to(dtype),
        seasonality=seas,
    )


__all__ = [
    "SeasonalityParams",
    "SEIRSParams",
    "seirs_ode",
    "seirs_seasonal_ode",
    "SEIRSInitializer",
    "seirs_config",
    "seirs_seasonal_config",
    "seirs_odeparams",
]
