"""Observation-model selection with PSIS-LOO: Poisson vs NegativeBinomial.

The port of examples/model_selection.py, the workflow a reference user runs
through arviz (``az.loo`` / ``az.compare`` on ``MCMCProcess.to_arviz()``),
entirely in the port (arviz is not needed):

1. simulate an age-stratified SIR epidemic,
2. draw overdispersed surveillance counts (negative-binomial noise around
   the true incidence, with numpy),
3. fit a Poisson (misspecified: variance pinned to the mean) and a
   NegativeBinomial observation model to the same counts,
4. score both with PSIS-LOO from the fits' ``log_likelihood`` groups and
   rank them with ``infer.compare``.

The NB model should win decisively::

    python examples_torch/model_selection.py [--device cpu]
"""

import _bootstrap

import numpy as np
import torch

from dynode_tpu_torch import MCMCProcess, Strain, _device, dist
from dynode_tpu_torch.config import SimulationConfig
from dynode_tpu_torch.infer import compare, handlers, loo
from sir_age_stratified import get_config as get_static_config
from sir_age_stratified import run_simulation

TRUE_CONCENTRATION = 4.0  # variance = mu + mu^2/4: strong overdispersion
#: fit window, NUTS warmup / draws / depth of each fit
COUNTS = dict(tf=100, warmup=400, samples=200, max_tree_depth=8)
FAST_COUNTS = dict(tf=50, warmup=100, samples=50, max_tree_depth=8)


def counts(fast: bool) -> dict:
    return dict(FAST_COUNTS if fast else COUNTS)


def _incidence(config: SimulationConfig, tf, dtype=torch.float32, device=None):
    solution = run_simulation(config, tf, dtype=dtype, device=device)
    return torch.clamp(torch.diff(solution.ys[config.idx.r], dim=0), min=1e-6)


def model_poisson(config: SimulationConfig, tf, obs_data):
    handlers.sample("cases", dist.Poisson(_incidence(config, tf)), obs=obs_data)


def model_negbin(config: SimulationConfig, tf, obs_data):
    # the prior's numbers in the dtype and on the device of the counts, filled
    # there (no copy from the host inside a captured potential)
    def num(v):
        return _device.scalar(v, obs_data.dtype, obs_data.device)

    conc = handlers.sample("concentration", dist.LogNormal(num(1.5), num(1.0)))
    handlers.sample("cases", dist.NegativeBinomial(_incidence(config, tf), conc), obs=obs_data)


MODELS = {"poisson": model_poisson, "negbin": model_negbin}


def get_config(dtype=torch.float32, device=None) -> SimulationConfig:
    """Static SIR config with the strain's rates replaced by priors, their
    numbers in ``dtype`` on ``device`` (the card by default)."""
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


def synthetic_counts(device, tf, dtype=torch.float32):
    """Overdispersed counts around the true incidence (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    mu = _incidence(get_static_config(), tf, dtype, device).cpu().numpy()
    gamma = rng.gamma(TRUE_CONCENTRATION, 1.0 / TRUE_CONCENTRATION, mu.shape)
    return torch.as_tensor(rng.poisson(mu * gamma), dtype=dtype, device=device)


def run(device, fast=False, dtype=torch.float32, overrides=None) -> dict:
    """Both fits on the same counts, their PSIS-LOO and the ranking, and
    the walls of the fits and of the scoring (``walls``); ``overrides``
    replaces entries of :func:`counts`."""
    n = {**counts(fast), **(overrides or {})}
    obs = synthetic_counts(device, n["tf"], dtype)
    fits, walls = {}, {}
    for name, m in MODELS.items():
        print(f"fitting {name}")
        proc = MCMCProcess(numpyro_model=m, num_warmup=n["warmup"], num_samples=n["samples"], num_chains=1,
                           nuts_max_tree_depth=n["max_tree_depth"], progress_bar=False)
        with _bootstrap.timed(walls, "fits", device):
            proc.infer(config=get_config(dtype, device), tf=n["tf"], obs_data=obs)
        fits[name] = proc
    with _bootstrap.timed(walls, "loo", device):
        scores = {name: loo(proc.to_arviz()) for name, proc in fits.items()}
    return {"counts": obs, "fits": fits, "scores": scores, "table": compare(scores), "walls": walls}


def draw(plt, out):
    fig, ax = plt.subplots()
    ax.bar(list(MODELS), out["elpd"], yerr=out["se"])
    ax.set_ylabel("elpd (PSIS-LOO)")
    ax.set_title("Observation-model selection")
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, _bootstrap.fast_mode(), args.dtype)
    for name, s in out["scores"].items():
        print(f"--- {name} ---\n{s}")
    table = out["table"]
    print(f"{'model':>10} {'rank':>4} {'elpd':>10} {'diff':>8} {'dse':>7} {'weight':>7}")
    for name, row in table.items():
        print(f"{name:>10} {row['rank']:>4} {row['elpd']:>10.1f} {row['elpd_diff']:>8.1f} "
              f"{row['dse']:>7.1f} {row['weight']:>7.2f}")
    best = next(iter(table))
    if best != "negbin":
        raise SystemExit(f"expected the overdispersion-aware model to win, got {best!r}")
    for name, proc in out["fits"].items():
        print(f"{name}: posterior mean r0 = {float(proc.get_samples()['strains_0_r0'].mean()):.3f} (true 2.0)")
    conc = float(out["fits"]["negbin"].get_samples()["concentration"].mean())
    print(f"negbin: posterior mean concentration = {conc:.2f} (true {TRUE_CONCENTRATION})")
    scores = [out["scores"][name] for name in MODELS]
    _bootstrap.save("model_selection", {"counts": out["counts"], "elpd": np.array([s.elpd for s in scores]),
                                        "se": np.array([s.se for s in scores])}, draw)
