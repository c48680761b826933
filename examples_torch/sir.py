"""Minimal SIR example: config -> initializer -> simulate -> plot.

The port of examples/sir.py (the reference's parameters) on
dynode_tpu_torch::

    python examples_torch/sir.py                 # on the card
    python examples_torch/sir.py --device cpu

``steps_per_save=3`` bounds the solve's steps per day (it takes at most two
after the first day); it changes no step of the example's solve. On the card
the grid engine runs every step slot of a save interval, masked, so the
bound sets the card's work.
"""

import _bootstrap

from datetime import date

import torch

from dynode_tpu_torch import _device, pytree_dataclass, simulate
from dynode_tpu_torch.config import (
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
from dynode_tpu_torch.simulation import AbstractODEParams
from dynode_tpu_torch.typing import CompartmentState

DAYS = 150


class SimpleSIRInitializer(Initializer):
    def __init__(self):
        super().__init__(
            description="Simple SIR initializer",
            initialize_date=date(2022, 2, 11),
            population_size=1,
        )

    def get_initial_state(self, s_0=0.9, i_0=0.1, r_0=0.0, *, dtype=torch.float32, device=None,
                          **kwargs) -> CompartmentState:
        device = _device.resolve(device)
        return tuple(torch.tensor([v], dtype=dtype, device=device) for v in (s_0, i_0, r_0))


def get_config(r_0=2.0, infectious_period=7.0) -> SimulationConfig:
    dim = Dimension(name="age", bins=[Bin(name="all")])
    return SimulationConfig(
        compartments=[
            Compartment(name="s", dimensions=[dim]),
            Compartment(name="i", dimensions=[dim]),
            Compartment(name="r", dimensions=[dim]),
        ],
        initializer=SimpleSIRInitializer(),
        parameters=Params(
            solver_params=SolverParams(steps_per_save=3),
            transmission_params=TransmissionParams(
                strains=[Strain(strain_name="test", r0=r_0, infectious_period=infectious_period)],
                strain_interactions={"test": {"test": 1.0}},
                contact_matrix=torch.tensor([[1.0]]),
            ),
        ),
    )


@pytree_dataclass
class SIR_ODEParams(AbstractODEParams):
    beta: torch.Tensor
    gamma: torch.Tensor


def sir_ode(t, state: CompartmentState, p: SIR_ODEParams):
    s, i, r = state
    n = s + i + r
    flow = p.beta * s * i / n
    return (-flow, flow - p.gamma * i, p.gamma * i)


def get_odeparams(config: SimulationConfig, *, dtype=torch.float32, device=None) -> SIR_ODEParams:
    strain = config.parameters.transmission_params.strains[0]
    device = _device.resolve(device)
    return SIR_ODEParams(
        beta=torch.tensor(strain.r0 / strain.infectious_period, dtype=dtype, device=device),
        gamma=torch.tensor(1.0 / strain.infectious_period, dtype=dtype, device=device),
    )


def run(device, dtype=torch.float32) -> dict:
    """The example's solve: S, I and R over 150 days."""
    config = get_config()
    sol = simulate(
        ode=sir_ode,
        duration_days=DAYS,
        initial_state=config.initializer.get_initial_state(dtype=dtype, device=device),
        ode_parameters=get_odeparams(config, dtype=dtype, device=device),
        solver_parameters=config.parameters.solver_params,
    )
    s, i, r = (arr.squeeze(-1) for arr in sol.ys)
    return {"ts": sol.ts, "s": s, "i": i, "r": r}


def draw(plt, out):
    fig, ax = plt.subplots()
    for key, label in (("s", "Susceptible"), ("i", "Infectious"), ("r", "Recovered")):
        ax.plot(out["ts"], out[key], label=label)
    ax.set_xlabel("Days")
    ax.set_ylabel("Population")
    ax.legend()
    ax.set_title("Simple SIR Model (dynode_tpu_torch)")
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, args.dtype)
    print("final S/I/R:", float(out["s"][-1]), float(out["i"][-1]), float(out["r"][-1]))
    _bootstrap.save("sir_example", out, draw)
