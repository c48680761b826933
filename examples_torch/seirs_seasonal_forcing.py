"""SEIRS with sinusoidal seasonal transmission forcing.

The port of examples/seirs_seasonal_forcing.py: beta(t) = beta * (1 +
amplitude * sin(2 pi t / period + phase)) via a nested pytree dataclass
inside the ODE params::

    python examples_torch/seirs_seasonal_forcing.py [--device cpu]
"""

import _bootstrap

import torch

from dynode_tpu_torch import simulate
from dynode_tpu_torch.models.seirs import seirs_odeparams, seirs_seasonal_config, seirs_seasonal_ode

DAYS = 3 * 365


def run(device, dtype=torch.float32) -> dict:
    """The example's solve: S, E, I and R over three years."""
    config = seirs_seasonal_config(
        r_0=2.0,
        infectious_period=7.0,
        latent_period=3.0,
        waning_period=60.0,
        seasonal_amplitude=0.2,
        seasonal_period=365.0,
    )
    sol = simulate(
        ode=seirs_seasonal_ode,
        duration_days=DAYS,
        initial_state=config.initializer.get_initial_state(dtype=dtype, device=device),
        ode_parameters=seirs_odeparams(config, seasonal=True, dtype=dtype, device=device),
        solver_parameters=config.parameters.solver_params,
    )
    s, e, i, r = (a.squeeze(-1) for a in sol.ys)
    return {"ts": sol.ts, "s": s, "e": e, "i": i, "r": r}


def draw(plt, out):
    fig, ax = plt.subplots()
    ax.plot(out["ts"], out["i"], label="Infectious")
    ax.set_xlabel("Days")
    ax.set_ylabel("Population")
    ax.legend()
    ax.set_title("Seasonally-forced SEIRS (dynode_tpu_torch)")
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, args.dtype)
    print("oscillation amplitude in final year (std):", float(out["i"][-365:].std(unbiased=False)))
    _bootstrap.save("seirs_seasonal", out, draw)
