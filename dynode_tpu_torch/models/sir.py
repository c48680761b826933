"""SIR model family: scalar and age-stratified.

Port of ``dynode_tpu/models/sir.py``: the same parameter defaults as the
reference's ``examples/sir.py`` and ``examples/sir_age_stratified.py``, so
closed-form oracles and golden trajectories line up. The initializer
combines its numbers in float64 and casts to the caller's dtype at the end;
its tensors go to the card unless the caller names a device.
"""

from __future__ import annotations

from datetime import date
from typing import Optional

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
from ..simulation import AbstractODEParams
from ..struct import pytree_dataclass
from ..typing import CompartmentState
from ._values import f64


@pytree_dataclass
class SIRParams(AbstractODEParams):
    """beta = r0/infectious_period, gamma = 1/infectious_period."""

    beta: torch.Tensor
    gamma: torch.Tensor
    contact_matrix: torch.Tensor


def sir_ode(t, state: CompartmentState, p: SIRParams):
    """FOI = beta * sum_j C[a,j] i_j / N_j; works for any age count."""
    s, i, r = state
    n = s + i + r
    foi = p.beta * torch.sum(p.contact_matrix * (i / n), dim=-1)
    s_to_i = s * foi
    i_to_r = p.gamma * i
    return (-s_to_i, s_to_i - i_to_r, i_to_r)


class ProportionInitializer(Initializer):
    """Splits population_size across age demographics and S/I proportions."""

    s0_prop = Field(V.float_, 0.99)
    i0_prop = Field(V.float_, 0.01)
    age_demographics = Field(V.sequence_of(V.float_), (1.0,))

    def get_initial_state(self, config: Optional[SimulationConfig] = None, *,
                          dtype: torch.dtype = torch.float32,
                          device: torch.device | str | None = None, **kwargs) -> CompartmentState:
        """Initial (S, I, R) from proportions and demographics (``config``
        is not read; it is taken for the initializers' common call)."""
        demo = f64(self.age_demographics, _device.resolve(device))
        s0 = self.population_size * self.s0_prop * demo
        i0 = self.population_size * self.i0_prop * demo
        return (s0.to(dtype), i0.to(dtype), torch.zeros_like(s0, dtype=dtype))


def sir_config(
    r_0=2.0,
    infectious_period=7.0,
    solver_params: Optional[SolverParams] = None,
) -> SimulationConfig:
    """Single-bin SIR (reference workload: examples/sir.py)."""
    dim = Dimension(name="age", bins=[Bin(name="all")])
    return SimulationConfig(
        compartments=[
            Compartment(name="s", dimensions=[dim]),
            Compartment(name="i", dimensions=[dim]),
            Compartment(name="r", dimensions=[dim]),
        ],
        initializer=ProportionInitializer(
            description="simple SIR proportions",
            initialize_date=date(2022, 2, 11),
            population_size=1,
            s0_prop=0.9,
            i0_prop=0.1,
        ),
        parameters=Params(
            solver_params=solver_params or SolverParams(step_budget=512),
            transmission_params=TransmissionParams(
                strains=[
                    Strain(
                        strain_name="test",
                        r0=r_0,
                        infectious_period=infectious_period,
                    )
                ],
                strain_interactions={"test": {"test": 1.0}},
                contact_matrix=torch.tensor([[1.0]], dtype=torch.float64),
            ),
        ),
    )


def sir_age_config(
    r_0=2.0,
    infectious_period=7.0,
    solver_params: Optional[SolverParams] = None,
) -> SimulationConfig:
    """Two-age-group SIR with a spectral-radius-normalized contact matrix
    (reference workload: examples/sir_age_stratified.py)."""
    contact = np.array([[0.7, 0.3], [0.3, 0.7]])
    contact = contact / np.max(np.real(np.linalg.eigvals(contact)))
    dim = Dimension(name="age", bins=[Bin(name="young"), Bin(name="old")])
    return SimulationConfig(
        compartments=[
            Compartment(name="s", dimensions=[dim]),
            Compartment(name="i", dimensions=[dim]),
            Compartment(name="r", dimensions=[dim]),
        ],
        initializer=ProportionInitializer(
            description="age-stratified SIR proportions",
            initialize_date=date(2022, 2, 11),
            population_size=1000,
            s0_prop=0.99,
            i0_prop=0.01,
            age_demographics=(0.75, 0.25),
        ),
        parameters=Params(
            solver_params=solver_params or SolverParams(step_budget=512),
            transmission_params=TransmissionParams(
                strains=[
                    Strain(
                        strain_name="swo9",
                        r0=r_0,
                        infectious_period=infectious_period,
                    )
                ],
                strain_interactions={"swo9": {"swo9": 1.0}},
                contact_matrix=torch.as_tensor(contact),
            ),
        ),
    )


__all__ = ["SIRParams", "sir_ode", "sir_config", "sir_age_config", "ProportionInitializer"]
