"""Multi-strain age-stratified SEIRS with a cumulative-incidence compartment.

The port of examples/seirs_multi_strain_age_stratified.py (2 ages x 3
strains, a C book-keeping compartment), on the library's batched-einsum
RHS::

    python examples_torch/seirs_multi_strain_age_stratified.py [--device cpu]
"""

import _bootstrap

import torch

from dynode_tpu_torch import simulate
from dynode_tpu_torch.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)

DAYS = 500
STRAINS = ("A", "B", "C")


def run(device, dtype=torch.float32) -> dict:
    """The example's solve over 500 days: identical strains except strain
    C's higher R0, which eventually dominates."""
    config = multistrain_config(
        r0s=(2.4, 2.5, 2.8),
        infectious_periods=(7.0, 7.0, 7.0),
        latent_periods=(3.0, 3.0, 3.0),
        waning_periods=(60.0, 60.0, 60.0),
        contact_matrix=torch.tensor([[0.7, 0.3], [0.3, 0.7]], dtype=torch.float64),
    )
    sol = simulate(
        ode=multistrain_ode,
        duration_days=DAYS,
        initial_state=multistrain_initial_state(config, dtype=dtype, device=device),
        ode_parameters=multistrain_odeparams(config, dtype=dtype, device=device),
        solver_parameters=config.parameters.solver_params,
    )
    s, e, i, r, c = sol.ys
    return {"ts": sol.ts, "s": s, "e": e, "i": i, "r": r, "c": c}


def draw(plt, out):
    c, ts = out["c"], out["ts"]
    fig, (left, right) = plt.subplots(1, 2, figsize=(12, 5))
    for k, label in enumerate(STRAINS):
        total = c[:, :, k].sum(axis=1)
        left.plot(ts, total, label=f"Cumulative ({label})")
        right.plot(ts[1:], total[1:] - total[:-1], label=f"Incidence ({label})")
    left.set_xlabel("Days")
    left.set_ylabel("Cumulative Incidence")
    left.legend()
    right.set_xlabel("Days")
    right.legend()
    fig.tight_layout()
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, args.dtype)
    print("final cumulative incidence by strain:", out["c"][-1].sum(dim=0))
    _bootstrap.save("seirs_multistrain", out, draw)
