"""The golden SIR posterior through the port's ``SVIProcess`` (slow).

The fit of ``tests/test_infer/test_nuts_through_ode.py``'s ``svi_fit`` on
the port: the same prior config, model and counts
(``golden/sir_obs.npz``, written by ``golden/gen_sir_obs.py`` from that
test's ``make_observed_incidence()``), ``SVIProcess`` at its settings (400
iterations of ``Adam(0.1)`` on ``AutoMultivariateNormal``, 200 draws),
held to the exact posterior ``tests/golden/quadrature.npz`` at that test's
tolerances: means within 1%, stds within 55% (the full-rank guide
overestimates the rho = 0.96 posterior's marginal stds), each mean inside
the exact 94% interval. Each step differentiates an eager adaptive SIR
solve on the CPU (about half a second), so the test takes minutes and is
marked ``slow``::

    python -m pytest -m slow tests/test_torch/test_torch_infer_golden.py
"""

import pathlib

import numpy as np
import pytest
import torch

from dynode_tpu_torch import SVIProcess, Strain, dist, sample_then_resolve, simulate
from dynode_tpu_torch.infer import handlers
from dynode_tpu_torch.models.sir import SIRParams, sir_age_config, sir_ode

HERE = pathlib.Path(__file__).resolve().parent
F64 = torch.float64


def _run_simulation(config, tf):
    tp = sample_then_resolve(config.parameters.transmission_params)
    strain = tp.strains[0]
    params = SIRParams(
        beta=torch.as_tensor(strain.r0 / strain.infectious_period, dtype=F64),
        gamma=torch.as_tensor(1.0 / strain.infectious_period, dtype=F64),
        contact_matrix=tp.contact_matrix,
    )
    return simulate(sir_ode, tf, config.initializer.get_initial_state(dtype=F64, device="cpu"), params,
                    config.parameters.solver_params)


def _model(config, tf, obs_data):
    solution = _run_simulation(config, tf)
    incidence = torch.clamp(torch.diff(solution.ys[config.idx.r], dim=0), min=1e-6)
    handlers.sample("inf_incidence", dist.Poisson(incidence), obs=obs_data)
    return solution


def _prior_config(population):
    config = sir_age_config()
    config.initializer.population_size = population
    config.parameters.transmission_params.strains = [
        Strain(
            strain_name="swo9",
            r0=dist.TransformedDistribution(dist.Beta(torch.tensor(0.5, dtype=F64), torch.tensor(0.5, dtype=F64)),
                                            dist.AffineTransform(1.5, 1)),
            infectious_period=dist.TruncatedNormal(loc=torch.tensor(8.0, dtype=F64), scale=torch.tensor(2.0, dtype=F64),
                                                   low=2, high=15),
        )
    ]
    return config


@pytest.mark.slow
def test_svi_process_matches_the_exact_posterior():
    data = np.load(HERE / "golden" / "sir_obs.npz")
    quad = np.load(HERE.parent / "golden" / "quadrature.npz")
    obs = torch.as_tensor(data["obs"], dtype=F64)
    proc = SVIProcess(numpyro_model=_model, num_iterations=400, num_samples=200, progress_bar=False)
    proc.infer(config=_prior_config(int(data["population"])), tf=int(data["days"]), obs_data=obs)
    samples = proc.get_samples()
    for site in ("strains_0_r0", "strains_0_infectious_period"):
        arr = samples[site].double().numpy()
        q_mean, q_std = float(quad[f"{site}_mean"]), float(quad[f"{site}_std"])
        assert arr.mean() == pytest.approx(q_mean, rel=0.01), (site, arr.mean(), q_mean)
        assert arr.std() == pytest.approx(q_std, rel=0.55), (site, arr.std(), q_std)
        lo, hi = np.asarray(quad[f"{site}_eti94"])
        assert lo < arr.mean() < hi, (site, arr.mean(), (lo, hi))
