"""The fits of ``examples_torch/`` against their JAX twins in ``examples/``:
ensemble_scenarios.py, hierarchical_strains.py and seip_fit.py.

For each fit, the model's joint log density and its gradient at
numpy-seeded positions (with numpy-made counts) are held against the JAX
example's model within 1e-10 in float64, and one short sampling call
(2 warmup + 2 draws, 2 chains or starts, one leapfrog a transition, over
a fit window cut to ``SAMPLING_DAYS``) runs the port's own fit code on the
CPU; ``test_torch_examples_sir_fits.py`` does the same for the SIR-family
fits. The fit scripts run whole, at the FAST counts, only in the ``slow``
tests at the end (minutes each: every gradient is an eager solve).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynode_tpu.config import SolverParams as JSolverParams
from dynode_tpu.infer import handlers as jhandlers
from example_twins import finite, hold_log_density, load, start_script

CPU = torch.device("cpu")
F64 = torch.float64
SAMPLING_DAYS = 10  # the sampling calls' fit window: each gradient is an eager solve


def test_ensemble_scenarios_fit():
    tm = load("torch", "ensemble_scenarios")
    from dynode_tpu import dist, simulate
    from dynode_tpu.models.multistrain import (
        multistrain_config,
        multistrain_initial_state,
        multistrain_ode,
        multistrain_odeparams,
    )

    days = tm.FAST_COUNTS["fit_days"]
    rng = np.random.default_rng(0)
    obs = rng.poisson(40.0, (days, 2, 3)).astype(np.float64)
    # examples/ensemble_scenarios.py's forward and model (its __main__)
    config = multistrain_config(solver_params=JSolverParams(constant_step_size=0.5))
    base, y0 = multistrain_odeparams(config), multistrain_initial_state(config)

    def forward(scales):
        p = base.replace(beta=base.beta * scales)
        return simulate(multistrain_ode, days, y0, p, config.parameters.solver_params).ys[-1]

    def jmodel(obs_data=None):
        scales = jhandlers.sample("r0_scales", dist.TruncatedNormal(loc=jnp.ones(3), scale=0.3 * jnp.ones(3),
                                                                    low=0.5, high=2.0))
        incidence = jnp.maximum(jnp.diff(forward(scales), axis=0), 1e-6)
        jhandlers.sample("obs", dist.Poisson(incidence), obs=obs_data)

    tmodel, tkwargs = tm.fit_problem(CPU, days, F64, obs)
    hold_log_density(jmodel, {"obs_data": jnp.asarray(obs)}, tmodel, tkwargs, {"r0_scales": rng.uniform(0.8, 1.2, 3)})
    tmodel, tkwargs = tm.fit_problem(CPU, SAMPLING_DAYS, F64)
    mcmc = tm.fit(tmodel, tkwargs, chains=2, warmup=2, samples=2, max_tree_depth=1, progress_bar=False)
    finite(mcmc.get_samples(), 4)


def test_hierarchical_strains_fit():
    tm, jm = load("torch", "hierarchical_strains"), load("jax", "hierarchical_strains")
    duration = tm.FAST_COUNTS["duration"]
    assert jm.DURATION == duration
    rng = np.random.default_rng(1)
    obs = rng.poisson(30.0, (int(duration), 2, 3)).astype(np.float64)
    jforward = jm.build_forward()
    tmodel, tkwargs = tm.fit_problem(CPU, duration, F64, obs)
    hold_log_density(lambda obs=None: jm.model(jforward, obs), {"obs": jnp.asarray(obs)}, tmodel, tkwargs,
          {"mu": 1.05, "tau": 0.2, "r0_scale": rng.uniform(0.8, 1.3, 3)})
    tmodel, tkwargs = tm.fit_problem(CPU, float(SAMPLING_DAYS), F64)
    mcmc = tm.fit(tmodel, tkwargs, chains=2, warmup=2, samples=2, max_tree_depth=1)
    finite(mcmc.get_samples(), 4)


def test_seip_fit(monkeypatch):
    tm, jm = load("torch", "seip_fit"), load("jax", "seip_fit")
    n = tm.counts(True)
    assert (jm.FIT_DAYS, jm.INTRO_DAY) == (n["fit_days"], n["intro_day"])
    rng = np.random.default_rng(2)
    obs = rng.poisson(500.0, (n["fit_days"], 2)).astype(np.float64)
    prob = tm.problem(CPU, fast=True, dtype=F64, obs=obs)
    np.testing.assert_allclose(prob.true_scales.numpy(), np.asarray(jm.TRUE_SCALES), rtol=1e-15)
    hold_log_density(jm.model, {"obs_data": jnp.asarray(obs)}, prob.model, prob.kwargs,
          {"beta_scales": rng.uniform(0.9, 1.1, 2)})
    monkeypatch.setitem(tm.FAST_COUNTS, "fit_days", SAMPLING_DAYS)
    proc = tm.fit(tm.problem(CPU, fast=True, dtype=F64), chains=2, warmup=2, samples=2, max_num_steps=1,
                  progress_bar=False)
    finite(proc.get_samples(), 4)


FITS = ("ensemble_scenarios", "hierarchical_strains", "seip_fit", "seip_forecast", "sir_infer_parameters",
        "model_selection", "svi_multistart")


@pytest.mark.slow
@pytest.mark.parametrize("name", FITS)
def test_fit_script_runs_whole_at_fast_counts(name, tmp_path):
    """``DYNODE_FAST_EXAMPLES=1 python examples_torch/<name>.py --device
    cpu``: exit 0 and the figure's arrays written. Each gradient is an
    eager solve on the CPU, so a script takes up to hours (its wall is in
    ``CHANGES.md``)."""
    proc = start_script(name, tmp_path, "--device", "cpu", fast=True)
    stdout, stderr = proc.communicate(timeout=4 * 3600)
    assert proc.returncode == 0, stderr[-3000:]
    assert list(tmp_path.glob("*.npz")), stdout[-2000:]
