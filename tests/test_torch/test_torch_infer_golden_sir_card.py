"""The golden SIR fit's NUTS and ChEES posteriors on the card, through
``MCMCProcess``: the port of
``tests/test_infer/test_nuts_through_ode.py::TestQuadratureOracle``'s
``test_nuts_matches_exact_posterior`` and
``test_chees_matches_exact_posterior``.

The JAX test's model (Poisson incidence of an age-stratified SIR, its
adaptive solve at ``sir_age_config``'s solver settings), priors and counts
(``golden/sir_obs.npz``, written by ``golden/gen_sir_obs.py`` from that
test's ``make_observed_incidence()``), in float64 on the card, at its
schedules (NUTS 150 warmup + 100 draws at 4 chains, tree depth 8; ChEES
200 + 100 at 16 chains) and gates against the exact posterior
``tests/golden/quadrature.npz``: means within 1%, stds within 25%, each
mean inside the exact 94% interval. The generic potential (the chain
``torch.func.vmap`` of the adaptive solve) is captured into a CUDA graph
and replayed at every evaluation. It runs on an H100 only and imports no
JAX (give its path: the other test files import JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m "cuda and slow" \
        tests/test_torch/test_torch_infer_golden_sir_card.py -s
"""

import pathlib
import time

import numpy as np
import pytest
import torch

from dynode_tpu_torch import MCMCProcess, Strain, _device, dist, sample_then_resolve, simulate
from dynode_tpu_torch.infer import handlers
from dynode_tpu_torch.models.sir import SIRParams, sir_age_config, sir_ode

HERE = pathlib.Path(__file__).resolve().parent
F64 = torch.float64


def _model(config, tf, obs_data):
    """The JAX test's ``_model`` on the device of ``obs_data``."""
    device = obs_data.device
    tp = sample_then_resolve(config.parameters.transmission_params)
    strain = tp.strains[0]
    params = SIRParams(
        beta=torch.as_tensor(strain.r0 / strain.infectious_period, dtype=F64, device=device),
        gamma=torch.as_tensor(1.0 / strain.infectious_period, dtype=F64, device=device),
        contact_matrix=_device.from_host(tp.contact_matrix, device, F64),
    )
    solution = simulate(sir_ode, tf, config.initializer.get_initial_state(dtype=F64, device=device), params,
                        config.parameters.solver_params)
    incidence = torch.clamp(torch.diff(solution.ys[config.idx.r], dim=0), min=1e-6)
    handlers.sample("inf_incidence", dist.Poisson(incidence), obs=obs_data)
    return solution


def _prior_config(population, device):
    """The JAX test's ``make_prior_config()``, its priors' numbers on ``device``."""
    def num(v):
        return torch.tensor(v, dtype=F64, device=device)

    config = sir_age_config()
    config.initializer.population_size = population
    config.parameters.transmission_params.strains = [
        Strain(
            strain_name="swo9",
            r0=dist.TransformedDistribution(dist.Beta(num(0.5), num(0.5)), dist.AffineTransform(1.5, 1)),
            infectious_period=dist.TruncatedNormal(loc=num(8.0), scale=num(2.0), low=2, high=15),
        )
    ]
    return config


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("sampler, warmup, samples, chains", [("nuts", 150, 100, 4), ("chees", 200, 100, 16)])
def test_sampler_matches_exact_posterior_on_the_card(sampler, warmup, samples, chains):
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an H100 (CUDA compute capability 9.0)")
    cuda = torch.device("cuda")
    data = np.load(HERE / "golden" / "sir_obs.npz")
    quad = np.load(HERE.parent / "golden" / "quadrature.npz")
    proc = MCMCProcess(numpyro_model=_model, num_warmup=warmup, num_samples=samples, num_chains=chains,
                       nuts_max_tree_depth=8, sampler=sampler, progress_bar=False)
    t = time.perf_counter()
    proc.infer(config=_prior_config(int(data["population"]), cuda), tf=int(data["days"]),
               obs_data=torch.as_tensor(data["obs"], dtype=F64, device=cuda))
    wall = time.perf_counter() - t
    mcmc = proc._inferer
    samples_ = {k: v.double().cpu().numpy() for k, v in proc.get_samples().items()}
    print(f"golden SIR {sampler} on {torch.cuda.get_device_name(0)}: {wall:.1f} s, graph replays "
          f"{mcmc.graph.replays}, captures {mcmc.graph.captures}; "
          + "; ".join(f"{site} mean {samples_[site].mean():.6f} std {samples_[site].std():.6f} (exact "
                      f"{float(quad[f'{site}_mean']):.6f}, {float(quad[f'{site}_std']):.6f})"
                      for site in ("strains_0_r0", "strains_0_infectious_period")))
    assert mcmc.graph is not None and mcmc.graph.replays > 0 and mcmc.graph.device.type == "cuda"
    for site in ("strains_0_r0", "strains_0_infectious_period"):
        arr = samples_[site]
        q_mean, q_std = float(quad[f"{site}_mean"]), float(quad[f"{site}_std"])
        assert arr.mean() == pytest.approx(q_mean, rel=0.01), (site, arr.mean(), q_mean)
        assert arr.std() == pytest.approx(q_std, rel=0.25), (site, arr.std(), q_std)
        lo, hi = np.asarray(quad[f"{site}_eti94"])
        assert lo < arr.mean() < hi, (site, arr.mean(), (lo, hi))
