"""The SIR-family fits of ``examples_torch/`` (sir_infer_parameters.py,
model_selection.py, svi_multistart.py) against their JAX twins.

As in ``test_torch_examples_fits.py``: each model's joint log density and
its gradient at numpy-seeded positions, with numpy-made counts, within
1e-10 of the JAX example's model in float64, and one short sampling call
(2 warmup + 2 draws, one leapfrog a transition, 2 starts or chains) over a
fit window cut to ``SAMPLING_DAYS``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from example_twins import finite, hold_log_density, load

CPU = torch.device("cpu")
F64 = torch.float64
SAMPLING_DAYS = 10  # the sampling calls' fit window: each gradient is an eager adaptive solve


def _sir_positions(rng):
    return {"strains_0_r0": rng.uniform(1.6, 2.4), "strains_0_infectious_period": rng.uniform(4.0, 10.0)}


def test_sir_infer_parameters_fit():
    tm, jm = load("torch", "sir_infer_parameters"), load("jax", "sir_infer_parameters")
    tf = tm.FAST_COUNTS["tf_fit"]
    rng = np.random.default_rng(3)
    obs = rng.poisson(5.0, (tf, 2)).astype(np.float64)
    hold_log_density(jm.model, dict(config=jm.get_config(), tf=tf, obs_data=jnp.asarray(obs)), tm.model,
          dict(config=tm.get_config(F64, CPU), tf=tf, obs_data=torch.as_tensor(obs)), _sir_positions(rng))
    out = tm.run(CPU, fast=True, dtype=F64, overrides=dict(tf_fit=SAMPLING_DAYS, warmup=2, samples=2, max_tree_depth=1,
                                                           svi_iterations=2, svi_samples=2, predictive_samples=2))
    finite(out["mcmc"].get_samples(), 2)
    assert out["mcmc_projection"].shape == out["svi_projection"].shape == (2, 2 * SAMPLING_DAYS, 2)


@pytest.mark.parametrize("name", ["poisson", "negbin"])
def test_model_selection_models(name):
    tm, jm = load("torch", "model_selection"), load("jax", "model_selection")
    tf = tm.FAST_COUNTS["tf"]
    rng = np.random.default_rng(4)
    obs = rng.poisson(5.0, (tf, 2)).astype(np.float64)
    positions = _sir_positions(rng)
    if name == "negbin":
        positions["concentration"] = 3.5
    hold_log_density(getattr(jm, f"model_{name}"), dict(config=jm.get_config(), tf=tf, obs_data=jnp.asarray(obs)),
          tm.MODELS[name], dict(config=tm.get_config(F64, CPU), tf=tf, obs_data=torch.as_tensor(obs)), positions)


def test_model_selection_counts_and_ranking_run():
    """The counts are the JAX example's (numpy draws around the same
    incidence), and a 2 + 2 run of both fits gives scores and a ranking."""
    tm, jm = load("torch", "model_selection"), load("jax", "model_selection")
    tf = tm.FAST_COUNTS["tf"]
    rng = np.random.default_rng(0)
    mu = np.asarray(jm._incidence(jm.get_static_config(), tf))
    want = rng.poisson(mu * rng.gamma(jm.TRUE_CONCENTRATION, 1.0 / jm.TRUE_CONCENTRATION, mu.shape))
    np.testing.assert_array_equal(tm.synthetic_counts(CPU, tf, F64).numpy(), want)
    out = tm.run(CPU, fast=True, dtype=F64, overrides=dict(tf=SAMPLING_DAYS, warmup=2, samples=2, max_tree_depth=1))
    assert set(out["table"]) == set(tm.MODELS) and all(np.isfinite(s.elpd) for s in out["scores"].values())


def test_svi_multistart_fit():
    """The model is sir_infer_parameters.py's (held above); a bank of 2
    starts x 2 steps, then 2 zero-warmup ChEES draws of 2 chains."""
    tm = load("torch", "svi_multistart")
    assert tm.model.__module__ == "sir_infer_parameters" and tm.get_config.__module__ == "sir_infer_parameters"
    assert tm.start_mesh(CPU, 64) is None
    out = tm.run(CPU, fast=True, dtype=F64, overrides=dict(tf_fit=SAMPLING_DAYS, starts=2, iterations=2, num_samples=2,
                                                           chains=2, draws=2, burn=0))
    assert out["final_elbos"].shape == (2,) and bool(torch.isfinite(out["final_elbos"]).all())
    assert out["chees_r0"].shape == (2, 2) and bool(torch.isfinite(out["chees_r0"]).all())
