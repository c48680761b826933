"""Full simulate -> noise -> fit -> project loop: the flagship inference demo.

The port of examples/sir_infer_parameters.py: Poisson incidence from a
fixed age-stratified SIR, NUTS (MCMC) and SVI fits of the r0 and
infectious-period priors, posterior inspection, and a posterior-predictive
projection to a longer horizon with obs_data=None::

    python examples_torch/sir_infer_parameters.py [--device cpu]

On the card the NUTS fit's potential and gradient are captured into a
CUDA graph and replayed at every leaf, and the SVI fit's step into
another, replayed at every step.
"""

import _bootstrap

import torch

from dynode_tpu_torch import MCMCProcess, Strain, SVIProcess, _device, dist
from dynode_tpu_torch.config import SimulationConfig
from dynode_tpu_torch.infer import Predictive, handlers
from sir_age_stratified import get_config as get_static_config
from sir_age_stratified import run_simulation

#: fit window, NUTS warmup / draws / depth, SVI steps / draws, predictive draws of the SVI guide
COUNTS = dict(tf_fit=100, warmup=500, samples=100, max_tree_depth=10, svi_iterations=500, svi_samples=100,
              predictive_samples=1000)
FAST_COUNTS = dict(tf_fit=50, warmup=100, samples=50, max_tree_depth=10, svi_iterations=100, svi_samples=50,
                   predictive_samples=100)


def counts(fast: bool) -> dict:
    return dict(FAST_COUNTS if fast else COUNTS)


def model(config: SimulationConfig, tf, obs_data):
    """Poisson-incidence observation model over an SIR simulation."""
    solution = run_simulation(config, tf)
    incidence = torch.diff(solution.ys[config.idx.r], dim=0)
    incidence = torch.clamp(incidence, min=1e-6)
    handlers.sample("inf_incidence", dist.Poisson(incidence), obs=obs_data)
    return solution


def get_config(dtype=torch.float32, device=None) -> SimulationConfig:
    """Static SIR config with the strain replaced by priors, their numbers
    in ``dtype`` on ``device`` (the card by default)."""
    device = _device.resolve(device)

    def num(v):
        return torch.tensor(v, dtype=dtype, device=device)

    sir_config = get_static_config(r_0=2.0, infectious_period=7.0)
    sir_config.parameters.transmission_params.strains = [
        Strain(
            strain_name="swo9",
            r0=dist.TransformedDistribution(dist.Beta(num(0.5), num(0.5)), dist.AffineTransform(1.5, 1)),
            infectious_period=dist.TruncatedNormal(loc=num(8.0), scale=num(2.0), low=2, high=15),
        )
    ]
    return sir_config


def observed(device, tf, dtype=torch.float32):
    """The synthetic data: the fixed-parameter model's daily incidence."""
    config = get_static_config()
    solution = run_simulation(config, tf, dtype=dtype, device=device)
    return torch.diff(solution.ys[config.idx.r], dim=0)


def run(device, fast=False, dtype=torch.float32, overrides=None, seed: int = 0) -> dict:
    """Both fits and both projections, and the walls of the MCMC fit, the
    SVI fit and the projections (``walls``); ``overrides`` replaces entries
    of :func:`counts`."""
    n = {**counts(fast), **(overrides or {})}
    incidence = observed(device, n["tf_fit"], dtype)
    config_infer = get_config(dtype, device)
    mcmc = MCMCProcess(numpyro_model=model, num_warmup=n["warmup"], num_samples=n["samples"], num_chains=1,
                       nuts_max_tree_depth=n["max_tree_depth"])
    svi = SVIProcess(numpyro_model=model, num_iterations=n["svi_iterations"], num_samples=n["svi_samples"])
    walls = {}
    print("fitting MCMC")
    with _bootstrap.timed(walls, "mcmc", device):
        mcmc.infer(config=config_infer, tf=n["tf_fit"], obs_data=incidence)
    print("fitting SVI")
    with _bootstrap.timed(walls, "svi", device):
        svi.infer(config=config_infer, tf=n["tf_fit"], obs_data=incidence)

    # project forward to a longer horizon with no observations
    tf_proj = 2 * n["tf_fit"]
    key = torch.Generator(device=device).manual_seed(seed)
    with _bootstrap.timed(walls, "predictive", device):
        proj_mcmc = Predictive(model, posterior_samples=mcmc.get_samples(), exclude_deterministic=False)(
            key, config=config_infer, tf=tf_proj, obs_data=None)
        proj_svi = Predictive(model, guide=svi._inferer.guide, params=svi._inference_state.params,
                              num_samples=n["predictive_samples"])(key, config=config_infer, tf=tf_proj,
                                                                   obs_data=None)
    return {"incidence": incidence, "mcmc": mcmc, "svi": svi, "mcmc_projection": proj_mcmc["inf_incidence"],
            "svi_projection": proj_svi["inf_incidence"], "walls": walls}


def draw(plt, out):
    fig, ax = plt.subplots()
    for draw_ in out["mcmc_projection"][:50]:
        ax.plot(draw_.sum(axis=1), color="C0", alpha=0.2)
    ax.plot(out["incidence"].sum(axis=1), color="k", label="true incidence")
    ax.legend()
    ax.set_title("MCMC posterior predictive projection (dynode_tpu_torch)")
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, _bootstrap.fast_mode(), args.dtype)
    post_mcmc, post_svi = out["mcmc"].get_samples(), out["svi"].get_samples()
    print(
        "True R0: 2.0, infectious period: 7.0\n"
        f"MCMC posterior R0: {float(post_mcmc['strains_0_r0'].mean()):.4f}, "
        f"infectious period: {float(post_mcmc['strains_0_infectious_period'].mean()):.4f}\n"
        f"SVI posterior R0: {float(post_svi['strains_0_r0'].mean()):.4f}, "
        f"infectious period: {float(post_svi['strains_0_infectious_period'].mean()):.4f}"
    )
    mcmc_idata = out["mcmc"].to_arviz()
    print(out["svi"].to_arviz())
    print(mcmc_idata)
    print("posterior summary:", mcmc_idata.summary())
    try:
        from dynode_tpu_torch.utils import plot_posterior_density

        fig = plot_posterior_density([mcmc_idata], data_labels=["R0"], var_names=["strains_0_r0"], shade=0.2)
        fig.suptitle("Density Interval for R0 Posterior Samples (MCMC)")
        fig.savefig("sir_infer_r0_density.png", dpi=100)
    except ImportError as err:
        print(f"no sir_infer_r0_density.png drawn: {err}")
    # 50 of the MCMC projection's draws, picked at random
    picks = torch.randint(out["mcmc_projection"].shape[0], (50,),
                          generator=torch.Generator(device=args.device).manual_seed(0), device=args.device)
    _bootstrap.save("sir_infer_mcmc", {"incidence": out["incidence"],
                                       "mcmc_projection": out["mcmc_projection"][picks],
                                       "svi_projection": out["svi_projection"]}, draw)
