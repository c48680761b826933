"""SEIRS with immune waning (R -> S), using the library model family.

The port of examples/seirs.py: extra parameters (latent_period,
waning_period) ride on TransmissionParams' open extras::

    python examples_torch/seirs.py [--device cpu]
"""

import _bootstrap

import torch

from dynode_tpu_torch import simulate
from dynode_tpu_torch.models.seirs import seirs_config, seirs_ode, seirs_odeparams

DAYS = 500


def run(device, dtype=torch.float32) -> dict:
    """The example's solve: S, E, I and R over 500 days."""
    config = seirs_config(r_0=2.0, infectious_period=7.0, latent_period=3.0, waning_period=60.0)
    sol = simulate(
        ode=seirs_ode,
        duration_days=DAYS,
        initial_state=config.initializer.get_initial_state(dtype=dtype, device=device),
        ode_parameters=seirs_odeparams(config, dtype=dtype, device=device),
        solver_parameters=config.parameters.solver_params,
    )
    s, e, i, r = (a.squeeze(-1) for a in sol.ys)
    return {"ts": sol.ts, "s": s, "e": e, "i": i, "r": r}


def draw(plt, out):
    fig, ax = plt.subplots()
    for name in "seir":
        ax.plot(out["ts"], out[name], label=name.upper())
    ax.set_xlabel("Days")
    ax.set_ylabel("Population")
    ax.legend()
    ax.set_title("SEIRS with waning (dynode_tpu_torch)")
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, args.dtype)
    print("endemic S (expect N/R0=500):", float(out["s"][-1]))
    _bootstrap.save("seirs_example", out, draw)
