"""Stiff SEIRS: a fast immune-boosting/waning sub-process.

The port of examples/seirs_stiff_waning.py. A rapid post-recovery boosting
compartment decays at 50/day into long-term immunity, against multi-week
transmission dynamics, so an explicit solver's stability limit -- not its
accuracy -- pins its step size: Tsit5 holds dt under about 0.05 days for
100 days. The L-stable TRBDF2 scheme steps at the epidemic's own timescale
and reaches the same answer with far fewer steps. This runs both solvers,
checks that they agree and prints the step counts::

    python examples_torch/seirs_stiff_waning.py [--device cpu]

Each solver's ``steps_per_save`` bounds its steps per day (a little above
what it takes) and changes no step: on the card the grid engine runs every
step slot of a save interval, masked, so the bound sets the card's work.
"""

import _bootstrap

import torch

from dynode_tpu_torch import simulate
from dynode_tpu_torch.config import SolverParams
from dynode_tpu_torch.ode import TRBDF2
from dynode_tpu_torch.struct import pytree_dataclass


def days(fast: bool) -> int:
    return 40 if fast else 100


@pytree_dataclass
class StiffSEIRSParams:
    beta: torch.Tensor
    sigma: torch.Tensor  # E -> I
    gamma: torch.Tensor  # I -> B (fast boosting compartment)
    kappa: torch.Tensor  # B -> R, FAST (the stiff rate)
    omega: torch.Tensor  # R -> S waning


def stiff_seirs_ode(t, state, p: StiffSEIRSParams):
    s, e, i, b, r = state
    n = s + e + i + b + r
    foi = p.beta * i / n
    return (
        -foi * s + p.omega * r,
        foi * s - p.sigma * e,
        p.sigma * e - p.gamma * i,
        p.gamma * i - p.kappa * b,  # kappa >> everything else
        p.kappa * b - p.omega * r,
    )


def problem(device, dtype=torch.float32):
    """The parameters (boosting decays in about 30 minutes) and the state."""
    def as_t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    p = StiffSEIRSParams(beta=as_t(0.3), sigma=as_t(1 / 3.6), gamma=as_t(1 / 7.0), kappa=as_t(50.0),
                         omega=as_t(1 / 90.0))
    y0 = tuple(as_t(v) for v in (9_990.0, 0.0, 10.0, 0.0, 0.0))
    return p, y0


#: TRBDF2 and Tsit5 at the example's tolerances (states are O(1e4))
STIFF_SP = dict(solver_method=TRBDF2(), ode_solver_rel_tolerance=1e-6, ode_solver_abs_tolerance=1e-4,
                step_budget=512, steps_per_save=5)
EXPLICIT_SP = dict(ode_solver_rel_tolerance=1e-6, ode_solver_abs_tolerance=1e-4,
                   step_budget=8192, steps_per_save=21)  # Tsit5 needs dt <~ 0.05 d just for stability


def run(device, fast=False, dtype=torch.float32) -> dict:
    """Both solves; raises if either fails or they disagree."""
    p, y0 = problem(device, dtype)
    n_days = days(fast)
    sol_i = simulate(stiff_seirs_ode, n_days, y0, p, SolverParams(**STIFF_SP))
    sol_e = simulate(stiff_seirs_ode, n_days, y0, p, SolverParams(**EXPLICIT_SP))
    if int(sol_i.result) != 0 or int(sol_e.result) != 0:
        raise RuntimeError(f"a solve failed: TRBDF2 result {int(sol_i.result)}, Tsit5 {int(sol_e.result)}")
    for a, b_ in zip(sol_i.ys, sol_e.ys):
        torch.testing.assert_close(a, b_, rtol=5e-3, atol=1.0)
    n_i = int(sol_i.stats["num_steps"])
    n_e = int(sol_e.stats["num_steps"])
    if not n_i < n_e / 4:
        raise RuntimeError(f"TRBDF2 took {n_i} steps, not under a quarter of Tsit5's {n_e}")
    out = {"ts": sol_i.ts, "trbdf2_steps": n_i, "tsit5_steps": n_e}
    for name, a, b_ in zip("seibr", sol_i.ys, sol_e.ys):
        out[name] = a
        out[f"{name}_tsit5"] = b_
    return out


def draw(plt, out):
    fig, ax = plt.subplots(figsize=(7, 4))
    for name in "seibr":
        ax.plot(out["ts"], out[name], label=name.upper())
    ax.set_xlabel("day")
    ax.set_ylabel("population")
    ax.set_title(f"stiff SEIRS (kappa=50/day) via TRBDF2, {int(out['trbdf2_steps'])} steps")
    ax.legend()
    fig.tight_layout()
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, _bootstrap.fast_mode(), args.dtype)
    n_i, n_e = out["trbdf2_steps"], out["tsit5_steps"]
    print(f"TRBDF2 (implicit): {n_i} steps; Tsit5 (explicit, stability-limited): {n_e} steps -> "
          f"{n_e / n_i:.0f}x fewer steps for the same trajectory")
    _bootstrap.save("seirs_stiff_waning", out, draw)
