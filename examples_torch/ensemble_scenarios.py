"""The headline workload: 4,096 scenario trajectories + a many-chain NUTS fit.

The port of examples/ensemble_scenarios.py: sample R0 scales from a prior,
simulate every member in one launch of the multi-strain CUDA kernel
(``ensemble_solve_tsit5``; its plain version on CPU tensors), then fit the
strains' transmission multipliers to synthetic observations with a wide
bank of vectorized NUTS chains::

    python examples_torch/ensemble_scenarios.py [--device cpu]

On the card ``MCMC`` captures the fit's potential and gradient over the
chain bank into a CUDA graph at the run's first evaluation and replays it
at every later one.
``steps_per_call`` is JAX's chunking of the chain loop; the port takes it
for the API only.
"""

import _bootstrap

import numpy as np
import torch

from dynode_tpu_torch import dist, simulate
from dynode_tpu_torch.config import SolverParams
from dynode_tpu_torch.infer import MCMC, NUTS, handlers
from dynode_tpu_torch.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)
from dynode_tpu_torch.ops import ensemble_solve_tsit5, unpack_saves

#: (ensemble, its days, NUTS warmup, draws, chains, fit days) of the example
COUNTS = dict(ensemble=4096, duration=200, warmup=150, samples=150, chains=64, fit_days=100)
FAST_COUNTS = dict(ensemble=256, duration=50, warmup=30, samples=30, chains=4, fit_days=50)
MAX_TREE_DEPTH = 6
PRIOR = (1.0, 0.15, 0.6, 1.6)  # TruncatedNormal(loc, scale, low, high) of the scenario R0 scales
TRUE_SCALES = (1.1, 0.95, 1.05)


def counts(fast: bool) -> dict:
    return dict(FAST_COUNTS if fast else COUNTS)


def model_parts(device, dtype=torch.float32):
    """The multi-strain model's (params, initial state) from its config."""
    config = multistrain_config(solver_params=SolverParams(constant_step_size=0.5))
    return (multistrain_odeparams(config, dtype=dtype, device=device),
            multistrain_initial_state(config, dtype=dtype, device=device))


def scenario_ensemble(device, ensemble: int, duration: int, r0_scales=None, seed: int = 0) -> dict:
    """``ensemble`` prior-sampled trajectories over ``duration`` days in one
    kernel launch; ``r0_scales`` (B,) replaces the prior draws."""
    base, y0 = model_parts(device)
    if r0_scales is None:
        prior = dist.TruncatedNormal(loc=PRIOR[0], scale=PRIOR[1], low=PRIOR[2], high=PRIOR[3])
        r0_scales = prior.sample(torch.Generator(device=device).manual_seed(seed), (ensemble,))
    r0_scales = torch.as_tensor(r0_scales, dtype=torch.float32, device=device)
    beta = base.beta[None, :] * r0_scales[:, None]
    saves = ensemble_solve_tsit5(y0, beta, base.sigma, base.gamma, base.omega, base.contact_matrix,
                                 batch=ensemble, duration=float(duration), dt=0.5)
    c = unpack_saves(saves)[-1]
    peak_day = torch.argmax(torch.diff(c.sum(dim=(2, 3)), dim=0), dim=0)
    return {"r0_scales": r0_scales, "saves": saves, "peak_day": peak_day}


def fit_problem(device, fit_days: int, dtype=torch.float32, obs=None, seed: int = 1):
    """The fit's model and its keyword arguments: Poisson counts of the daily
    incidence at ``TRUE_SCALES`` (drawn unless ``obs`` is given)."""
    base, y0 = model_parts(device, dtype)
    sp = SolverParams(constant_step_size=0.5)

    def forward(scales):
        p = base.replace(beta=base.beta * scales)
        return simulate(multistrain_ode, fit_days, y0, p, sp).ys[-1]

    if obs is None:
        rate = torch.clamp(torch.diff(forward(torch.tensor(TRUE_SCALES, dtype=dtype, device=device)), dim=0),
                           min=1e-6)
        obs = torch.poisson(rate, generator=torch.Generator(device=device).manual_seed(seed))
    ones = torch.ones(3, dtype=dtype, device=device)

    def model(obs_data=None):
        scales = handlers.sample("r0_scales", dist.TruncatedNormal(loc=ones, scale=0.3 * ones, low=0.5, high=2.0))
        incidence = torch.clamp(torch.diff(forward(scales), dim=0), min=1e-6)
        handlers.sample("obs", dist.Poisson(incidence), obs=obs_data)

    return model, {"obs_data": torch.as_tensor(obs, dtype=dtype, device=device)}


def fit(model, model_kwargs, *, chains, warmup, samples, max_tree_depth=MAX_TREE_DEPTH, seed=2,
        progress_bar=True) -> MCMC:
    mcmc = MCMC(
        NUTS(model, dense_mass=True, max_tree_depth=max_tree_depth),
        num_warmup=warmup,
        num_samples=samples,
        num_chains=chains,  # wide vectorized chain bank
        steps_per_call=16,
        progress_bar=progress_bar,
    )
    return mcmc.run(seed, **model_kwargs)


def run(device, fast=False, dtype=torch.float32, r0_scales=None, obs=None, overrides=None) -> dict:
    """The ensemble, then the fit, and each one's wall (``walls``);
    ``overrides`` replaces entries of :func:`counts` (and may hold
    ``max_tree_depth``)."""
    n = {**counts(fast), **(overrides or {})}
    walls = {}
    with _bootstrap.timed(walls, "ensemble", device):
        out = scenario_ensemble(device, n["ensemble"], n["duration"], r0_scales)
    model, kwargs = fit_problem(device, n["fit_days"], dtype, obs)
    with _bootstrap.timed(walls, "fit", device):
        mcmc = fit(model, kwargs, chains=n["chains"], warmup=n["warmup"], samples=n["samples"],
                   max_tree_depth=n.get("max_tree_depth", MAX_TREE_DEPTH), progress_bar=not fast)
    out.update(obs=kwargs["obs_data"], posterior=mcmc.get_samples()["r0_scales"], mcmc=mcmc, walls=walls)
    return out


def draw(plt, out):
    fig, (left, right) = plt.subplots(1, 2, figsize=(10, 4))
    left.hist(out["peak_day"], bins=30)
    left.set_xlabel("epidemic peak day")
    left.set_title(f"{out['peak_day'].shape[0]} scenarios")
    for k in range(out["posterior"].shape[1]):
        right.hist(out["posterior"][:, k], bins=30, alpha=0.5, label=f"strain {k} (true {TRUE_SCALES[k]})")
    right.set_xlabel("R0 scale")
    right.legend(fontsize=7)
    fig.tight_layout()
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, _bootstrap.fast_mode(), args.dtype)
    print(f"scenario ensemble: {out['peak_day'].shape[0]} trajectories; epidemic peak day 5%/50%/95% = "
          f"{np.percentile(_bootstrap.host(out['peak_day']), [5, 50, 95])}")
    print("posterior mean r0 scales:", _bootstrap.host(out["posterior"].mean(dim=0)).round(3),
          "(true", np.asarray(TRUE_SCALES), ")")
    out["mcmc"].print_summary()
    _bootstrap.save("ensemble_scenarios", {k: out[k] for k in ("r0_scales", "peak_day", "obs", "posterior")}, draw)
