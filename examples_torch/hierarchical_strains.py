"""Hierarchical (partial-pooling) strain fit with ``handlers.plate``.

The port of examples/hierarchical_strains.py: strain transmissibilities
share a population-level prior, so sparse strains borrow strength from
well-observed ones::

    mu  ~ TruncatedNormal(1.0, 0.3)        # population-mean R0 scale
    tau ~ HalfNormal(0.3)                  # between-strain spread
    with plate("strain", 3):
        r0_scale ~ Normal(mu, tau)         # one draw per strain, (3,)

The plated site runs through NUTS as one 3-vector latent (the chains stay
one vmapped bank), and ``flatten_list_parameters`` splits the posterior
back into ``r0_scale_0..2``::

    python examples_torch/hierarchical_strains.py [--device cpu]
"""

import _bootstrap

import numpy as np
import torch

from dynode_tpu_torch import _device, dist, simulate
from dynode_tpu_torch.config import SolverParams
from dynode_tpu_torch.infer import MCMC, NUTS, handlers, plate
from dynode_tpu_torch.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)
from dynode_tpu_torch.utils import flatten_list_parameters

#: (days, chains, NUTS warmup, draws) of the example
COUNTS = dict(duration=120.0, chains=16, warmup=300, samples=300)
FAST_COUNTS = dict(duration=40.0, chains=4, warmup=60, samples=60)
MAX_TREE_DEPTH = 10  # NUTS's default, as in the example
TRUE_SCALES = (0.85, 1.0, 1.25)


def counts(fast: bool) -> dict:
    return dict(FAST_COUNTS if fast else COUNTS)


def build_forward(device, duration, dtype=torch.float32):
    cfg = multistrain_config(solver_params=SolverParams(constant_step_size=0.5))
    base = multistrain_odeparams(cfg, dtype=dtype, device=device)
    y0 = multistrain_initial_state(cfg, dtype=dtype, device=device)
    sp = cfg.parameters.solver_params

    def forward(r0_scales):
        p = base.replace(beta=base.beta * r0_scales)
        sol = simulate(multistrain_ode, duration, y0, p, sp)
        return sol.ys[-1]  # cumulative incidence (T, ages, strains)

    return forward


def model(forward, obs=None, dtype=torch.float32, device=None):
    """The partially pooled model; its priors' numbers in ``dtype`` on
    ``device`` (the card by default)."""
    device = _device.resolve(device)

    def num(v):  # filled on the device: no copy from the host inside a captured potential
        return _device.scalar(v, dtype, device)

    mu = handlers.sample("mu", dist.TruncatedNormal(loc=num(1.0), scale=num(0.3), low=0.3, high=2.0))
    tau = handlers.sample("tau", dist.HalfNormal(num(0.3)))
    with plate("strain", 3):
        r0_scale = handlers.sample("r0_scale", dist.Normal(mu, tau))
    c = forward(torch.clamp(r0_scale, 0.2, 3.0))
    incidence = torch.clamp(torch.diff(c, dim=0), min=1e-6)
    handlers.sample("obs_incidence", dist.Poisson(incidence), obs=obs)


def fit_problem(device, duration, dtype=torch.float32, obs=None, seed: int = 0):
    """The fit's model and keyword arguments: Poisson counts at
    ``TRUE_SCALES`` (drawn unless ``obs`` is given)."""
    forward = build_forward(device, duration, dtype)
    if obs is None:
        c = forward(torch.tensor(TRUE_SCALES, dtype=dtype, device=device))
        obs = torch.poisson(torch.clamp(torch.diff(c, dim=0), min=1e-6),
                            generator=torch.Generator(device=device).manual_seed(seed))

    def fit_model(obs=None):
        return model(forward, obs, dtype, device)

    return fit_model, {"obs": torch.as_tensor(obs, dtype=dtype, device=device)}


def fit(fit_model, model_kwargs, *, chains, warmup, samples, max_tree_depth=MAX_TREE_DEPTH, seed=1) -> MCMC:
    mcmc = MCMC(NUTS(fit_model, max_tree_depth=max_tree_depth), num_warmup=warmup, num_samples=samples,
                num_chains=chains, steps_per_call=25)
    return mcmc.run(seed, **model_kwargs)


def run(device, fast=False, dtype=torch.float32, obs=None, overrides=None) -> dict:
    """The fit and its wall (``walls``); ``overrides`` replaces entries of
    :func:`counts` (and may hold ``max_tree_depth``)."""
    n = {**counts(fast), **(overrides or {})}
    fit_model, kwargs = fit_problem(device, n["duration"], dtype, obs)
    walls = {}
    with _bootstrap.timed(walls, "fit", device):
        mcmc = fit(fit_model, kwargs, chains=n["chains"], warmup=n["warmup"], samples=n["samples"],
                   max_tree_depth=n.get("max_tree_depth", MAX_TREE_DEPTH))
    samples = mcmc.get_samples()
    return {"obs": kwargs["obs"], "mu": samples["mu"], "tau": samples["tau"], "r0_scale": samples["r0_scale"],
            "mcmc": mcmc, "walls": walls}


def draw(plt, out):
    fig, ax = plt.subplots(figsize=(6, 4))
    for k in range(3):
        ax.hist(out["r0_scale"][:, k], bins=30, alpha=0.5, label=f"r0_scale_{k} (true {TRUE_SCALES[k]})")
    ax.set_xlabel("R0 scale")
    ax.legend(fontsize=7)
    fig.tight_layout()
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    fast = _bootstrap.fast_mode()
    out = run(args.device, fast, args.dtype)
    scales = _bootstrap.host(out["r0_scale"])  # (total draws, 3)
    flat = flatten_list_parameters({"r0_scale": out["mcmc"].get_samples(group_by_chain=True)["r0_scale"]})
    print("population mean mu:", float(out["mu"].mean()))
    print("between-strain tau:", float(out["tau"].mean()))
    for k in range(3):
        post = scales[:, k]
        print(f"strain {k}: posterior {post.mean():.3f} +- {post.std():.3f} (true {TRUE_SCALES[k]:.2f}; "
              f"flattened key r0_scale_{k} -> {float(flat[f'r0_scale_{k}'].mean()):.3f})")
    err = np.abs(scales.mean(0) - np.asarray(TRUE_SCALES))
    tol = 0.25 if fast else 0.15
    if not err.max() < tol:
        raise SystemExit(f"posterior drifted: {scales.mean(0)}")
    print("hierarchical fit OK")
    _bootstrap.save("hierarchical_strains", {k: out[k] for k in ("obs", "mu", "tau", "r0_scale")}, draw)
