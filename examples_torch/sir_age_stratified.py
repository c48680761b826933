"""Age-stratified SIR with priors sampled via sample_then_resolve.

The port of examples/sir_age_stratified.py. Exports ``get_config``,
``get_odeparams`` and ``run_simulation``, which sir_infer_parameters.py,
model_selection.py and svi_multistart.py reuse::

    python examples_torch/sir_age_stratified.py [--device cpu]

``steps_per_save=3`` bounds the solve's steps per day (it takes at most two
after the first day, from every r0 and infectious period of the fits'
priors); it changes no step of the example's solve. On the card the grid
engine runs every step slot of a save interval, masked, so the bound sets
the card's work.
"""

import _bootstrap

import torch

from dynode_tpu_torch import _device, pytree_dataclass, simulate
from dynode_tpu_torch.config import SimulationConfig, SolverParams
from dynode_tpu_torch.infer import sample_then_resolve
from dynode_tpu_torch.models.sir import sir_age_config
from dynode_tpu_torch.ode import Solution
from dynode_tpu_torch.simulation import AbstractODEParams
from dynode_tpu_torch.typing import CompartmentGradients, CompartmentState

DAYS = 150


def get_config(r_0=2.0, infectious_period=7.0) -> SimulationConfig:
    """Two-age-group SIR with a spectral-radius-normalized contact matrix."""
    return sir_age_config(r_0=r_0, infectious_period=infectious_period,
                          solver_params=SolverParams(step_budget=512, steps_per_save=3))


@pytree_dataclass
class SIR_ODEParams(AbstractODEParams):
    beta: torch.Tensor
    gamma: torch.Tensor
    contact_matrix: torch.Tensor


def get_odeparams(config: SimulationConfig, *, dtype=torch.float32, device=None) -> SIR_ODEParams:
    """Sample/resolve any priors, then vectorize into RHS parameters.

    A sampled prior decides the dtype and device (the sampler's bank); a
    config of numbers takes ``dtype`` and ``device``.
    """
    tp = sample_then_resolve(config.parameters.transmission_params)
    strain = tp.strains[0]
    drawn = [x for x in (strain.r0, strain.infectious_period) if isinstance(x, torch.Tensor)]
    if drawn:
        dtype, device = drawn[0].dtype, drawn[0].device
    device = _device.resolve(device)
    return SIR_ODEParams(
        beta=torch.as_tensor(strain.r0 / strain.infectious_period, dtype=dtype, device=device),
        gamma=torch.as_tensor(1.0 / strain.infectious_period, dtype=dtype, device=device),
        contact_matrix=_device.from_host(tp.contact_matrix, device, dtype),
    )


def sir_ode(t, state: CompartmentState, p: SIR_ODEParams) -> CompartmentGradients:
    s, i, r = state
    n = s + i + r
    foi = p.beta * torch.sum(p.contact_matrix * i / n, dim=1)
    s_to_i = s * foi
    i_to_r = p.gamma * i
    return (-s_to_i, s_to_i - i_to_r, i_to_r)


def run_simulation(config: SimulationConfig, tf, *, dtype=torch.float32, device=None) -> Solution:
    """``simulate`` of ``config``; the state goes where the parameters are."""
    params = get_odeparams(config, dtype=dtype, device=device)
    return simulate(
        ode=sir_ode,
        duration_days=tf,
        initial_state=config.initializer.get_initial_state(dtype=params.beta.dtype, device=params.beta.device),
        ode_parameters=params,
        solver_parameters=config.parameters.solver_params,
    )


def run(device, dtype=torch.float32) -> dict:
    """The example's solve: S, I and R by age over 150 days."""
    sol = run_simulation(get_config(), DAYS, dtype=dtype, device=device)
    s, i, r = sol.ys
    return {"ts": sol.ts, "s": s, "i": i, "r": r}


def draw(plt, out):
    fig, ax = plt.subplots()
    for idx, label in enumerate(["Young", "Old"]):
        for key in ("s", "i", "r"):
            ax.plot(out["ts"], out[key][:, idx], label=f"{key.upper()} ({label})")
    ax.set_xlabel("Days")
    ax.set_ylabel("Population")
    ax.legend()
    ax.set_title("Age-Stratified SIR (dynode_tpu_torch)")
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, args.dtype)
    print("final I by age:", [float(v) for v in out["i"][-1]])
    _bootstrap.save("sir_age_stratified", out, draw)
