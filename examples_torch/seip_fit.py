"""Fit the production SEIP model with a wide ChEES-HMC chain bank.

The port of examples/seip_fit.py: synthesize Poisson-noised incidence from
known per-strain transmission scales, fit them with
``MCMCProcess(sampler="chees")`` -- every leapfrog differentiates through
the constant-step SEIP solve -- and plot the posterior fit against the
data. ChEES is the wide-bank sampler: all chains take the same number of
leapfrog steps per iteration with cross-chain adaptation::

    python examples_torch/seip_fit.py [--device cpu]

On the card ``MCMC`` captures the model's potential and gradient over the
chain bank into a CUDA graph at the run's first evaluation and replays it
at every leapfrog.
"""

import _bootstrap

from types import SimpleNamespace

import numpy as np
import torch

from dynode_tpu_torch import MCMCProcess, dist, simulate
from dynode_tpu_torch.config import SolverParams, Strain
from dynode_tpu_torch.infer import handlers
from dynode_tpu_torch.models.seip import seip_config, seip_initial_state, seip_ode, seip_odeparams

# the second strain's transmission scale is only identified if the fit
# window covers its introduction and growth, so the FAST counts move the
# introduction day with the window
COUNTS = dict(fit_days=100, intro_day=60.0, chains=256, warmup=100, samples=100, max_num_steps=64)
FAST_COUNTS = dict(fit_days=30, intro_day=10.0, chains=4, warmup=16, samples=16, max_num_steps=16)
_MAX_VAX = 2


def counts(fast: bool) -> dict:
    return dict(FAST_COUNTS if fast else COUNTS)


def strains(intro_day: float) -> list:
    return [
        Strain(
            strain_name="alpha",
            r0=2.2,
            infectious_period=7.0,
            exposed_to_infectious=3.6,
            vaccine_efficacy={k: min(0.35 * k, 0.8) for k in range(_MAX_VAX + 2)},
        ),
        Strain(
            strain_name="delta",
            r0=3.0,
            infectious_period=7.0,
            exposed_to_infectious=3.6,
            vaccine_efficacy={k: min(0.30 * k, 0.7) for k in range(_MAX_VAX + 2)},
            is_introduced=True,
            introduction_time=intro_day,
            introduction_percentage=0.02,
            introduction_scale=5.0,
        ),
    ]


def problem(device, fast=False, dtype=torch.float32, obs=None, seed: int = 0, fit_days=None):
    """The fit problem: the model (S of shape (4, 4, 4, 4), two strains,
    seasonal vaccination), its data over ``fit_days`` (by default the
    example's) and ``incidence_curve``. ``obs`` (days, strains) replaces
    the drawn counts."""
    n = counts(fast)
    if fit_days is not None:
        n["fit_days"] = fit_days
    config = seip_config(strains=strains(n["intro_day"]), seasonal_vaccination=True,
                         solver_params=SolverParams(constant_step_size=0.5))
    base = seip_odeparams(config, dtype=dtype, device=device)
    y0 = seip_initial_state(config, dtype=dtype, device=device)
    sp = config.parameters.solver_params
    n_strains = base.beta.shape[0]
    true_scales = torch.linspace(1.1, 0.9, n_strains, dtype=dtype, device=device)

    def incidence_curve(scales, days):
        """Daily incidence from per-strain transmission scaling."""
        p = base.replace(beta=base.beta * scales)
        sol = simulate(seip_ode, days, y0, p, sp, sub_save_indices=(3,))
        cum = torch.sum(sol.ys[3], dim=(1, 2, 3))
        return torch.clamp(torch.diff(cum, dim=0), min=1e-6)

    ones = torch.ones(n_strains, dtype=dtype, device=device)

    def model(obs_data=None):
        scales = handlers.sample("beta_scales", dist.TruncatedNormal(loc=ones, scale=0.2 * ones, low=0.5, high=1.8))
        handlers.sample("obs", dist.Poisson(incidence_curve(scales, n["fit_days"])), obs=obs_data)

    if obs is None:
        rate = incidence_curve(true_scales, n["fit_days"])
        obs = torch.poisson(rate, generator=torch.Generator(device=device).manual_seed(seed))
    return SimpleNamespace(base=base, y0=y0, config=config, fit_days=n["fit_days"], true_scales=true_scales,
                           incidence_curve=incidence_curve, model=model,
                           kwargs={"obs_data": torch.as_tensor(obs, dtype=dtype, device=device)})


def fit(prob, *, chains, warmup, samples, max_num_steps, progress_bar=True) -> MCMCProcess:
    proc = MCMCProcess(
        numpyro_model=prob.model,
        num_warmup=warmup,
        num_samples=samples,
        num_chains=chains,
        nuts_max_tree_depth=6,  # unused by chees; required field
        sampler="chees",
        nuts_kwargs={"max_num_steps": max_num_steps},
        mcmc_kwargs={"steps_per_call": warmup},
        progress_bar=progress_bar,
    )
    proc.infer(**prob.kwargs)
    return proc


def run(device, fast=False, dtype=torch.float32, obs=None, overrides=None) -> dict:
    """The fit, the posterior-mean curve and the fit's wall (``walls``);
    ``overrides`` replaces entries of :func:`counts` but the introduction
    day."""
    n = {**counts(fast), **(overrides or {})}
    prob = problem(device, fast, dtype, obs, fit_days=n["fit_days"])
    walls = {}
    with _bootstrap.timed(walls, "fit", device):
        proc = fit(prob, chains=n["chains"], warmup=n["warmup"], samples=n["samples"],
                   max_num_steps=n["max_num_steps"], progress_bar=not fast)
    samples = proc.get_samples()["beta_scales"]
    curve = prob.incidence_curve(samples.mean(dim=0), prob.fit_days)
    return {"obs": prob.kwargs["obs_data"], "true_scales": prob.true_scales, "beta_scales": samples,
            "posterior_mean_curve": curve, "proc": proc, "chains": n["chains"], "warmup": n["warmup"],
            "samples": n["samples"], "walls": walls}


def draw(plt, out):
    fit_curve, obs = out["posterior_mean_curve"], out["obs"]
    t = np.arange(1, fit_curve.shape[0] + 1)
    fig, ax = plt.subplots(figsize=(8, 4))
    for a in range(fit_curve.shape[1]):
        ax.plot(t, obs[:, a], ".", ms=3, alpha=0.5)
        ax.plot(t, fit_curve[:, a], lw=1.5, label=f"group {a} (posterior mean)")
    ax.set_xlabel("day")
    ax.set_ylabel("daily incidence")
    ax.set_title(f"SEIP fit: {int(out['chains'])} ChEES chains x ({int(out['warmup'])}+{int(out['samples'])}) draws")
    ax.legend(fontsize=7)
    fig.tight_layout()
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, _bootstrap.fast_mode(), args.dtype)
    samples = _bootstrap.host(out["beta_scales"])
    print("true scales:     ", np.round(_bootstrap.host(out["true_scales"]), 3))
    print("posterior mean:  ", np.round(samples.mean(axis=0), 3))
    print("posterior std:   ", np.round(samples.std(axis=0), 4))
    _bootstrap.save("seip_fit", {k: v for k, v in out.items() if k not in ("proc", "walls")}, draw)
