"""SEIP: the production respiratory model (age x history x vax x wane x strain).

The port of examples/seip.py: layered immunity, bitwise-OR immune-history
transitions, spline-driven vaccination with a seasonal reset, external
strain introduction and seasonal transmission forcing, solved adaptively
over a year::

    python examples_torch/seip.py [--device cpu]

``steps_per_save=4`` bounds the solve's steps per day (it takes at most
three after the first day); it changes no step of the example's solve. On
the card the grid engine runs every step slot of a save interval, masked, so
the bound sets the card's work.
"""

import _bootstrap

import torch

from dynode_tpu_torch import simulate
from dynode_tpu_torch.config import SolverParams
from dynode_tpu_torch.models.seip import seip_config, seip_initial_state, seip_ode, seip_odeparams

DAYS = 365


def get_config():
    return seip_config(seasonal_vaccination=True, solver_params=SolverParams(step_budget=1024, steps_per_save=4))


def run(device, dtype=torch.float32) -> dict:
    """The example's solve: S, E, I and C over 365 days."""
    config = get_config()
    sol = simulate(
        ode=seip_ode,
        duration_days=DAYS,
        initial_state=seip_initial_state(config, dtype=dtype, device=device),
        ode_parameters=seip_odeparams(config, dtype=dtype, device=device),
        solver_parameters=config.parameters.solver_params,
    )
    S, E, I, C = sol.ys
    return {"ts": sol.ts, "S": S, "E": E, "I": I, "C": C}


def draw(plt, out):
    config = get_config()
    S, I, t = out["S"], out["I"], out["ts"]
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    for k, strain in enumerate(config.parameters.transmission_params.strains):
        axes[0][0].plot(t, I[:, :, :, :, k].sum(axis=(1, 2, 3)), label=strain.strain_name)
    axes[0][0].set_title("Infectious by strain")
    for k in range(S.shape[3]):
        axes[0][1].plot(t, S[:, :, :, k, :].sum(axis=(1, 2, 3)), label=f"dose {k}")
    axes[0][1].set_title("Susceptibles by vaccine dose")
    for m in range(S.shape[4]):
        axes[1][0].plot(t, S[:, :, :, :, m].sum(axis=(1, 2, 3)), label=f"W{m}")
    axes[1][0].set_title("Susceptibles by waning stage")
    for j, hist in enumerate(config.get_compartment("s").dimensions[1].bins):
        axes[1][1].plot(t, S[:, :, j].sum(axis=(1, 2, 3)), label=hist.name)
    axes[1][1].set_title("Susceptibles by immune history")
    for ax in axes.flat:
        ax.legend()
    fig.tight_layout()
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, args.dtype)
    print("final cumulative infections by strain:", out["C"][-1].sum(dim=(0, 1, 2)))
    _bootstrap.save("seip_overview", out, draw)
