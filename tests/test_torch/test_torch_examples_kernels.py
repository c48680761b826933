"""The kernel parts of ``examples_torch/ensemble_scenarios.py`` (kernel #2)
and ``examples_torch/seip_forecast.py`` (kernel #5) against the JAX
entries, on the CPU at a small width, on numpy-made scales and draws.

On CPU tensors each entry runs its plain version; the card's launches are
``chip_smoke.py`` phase 19's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynode_tpu.config import SolverParams
from dynode_tpu.infer import member_quantiles
from dynode_tpu.models.multistrain import multistrain_config, multistrain_initial_state, multistrain_odeparams
from dynode_tpu.ops import ensemble_solve_tsit5, unpack_saves
from dynode_tpu.ops.seip_pallas import seip_ensemble_solve_adaptive
from example_twins import load, rel

CPU = torch.device("cpu")
TOL_F32 = 1e-5  # float32 saves: max |d| / max |ref|
TOL_ADAPTIVE = 1e-3  # kernel #5's blocks of 4 against JAX's one block: the solve tolerance


def test_scenario_ensemble_matches_jax():
    """``scenario_ensemble`` at 48 members over 30 days against
    ``examples/ensemble_scenarios.py``'s call of the JAX entry."""
    scales = np.random.default_rng(0).uniform(0.6, 1.6, 48).astype(np.float32)
    got = load("torch", "ensemble_scenarios").scenario_ensemble(CPU, 48, 30, r0_scales=scales)

    config = multistrain_config(solver_params=SolverParams(constant_step_size=0.5))
    base, y0 = multistrain_odeparams(config), multistrain_initial_state(config)
    beta = base.beta[None, :] * jnp.asarray(scales)[:, None]
    saves = ensemble_solve_tsit5(y0, beta, base.sigma, base.gamma, base.omega, base.contact_matrix, batch=48,
                                 duration=30.0, dt=0.5)
    c = unpack_saves(saves)[-1]
    peak_day = jnp.argmax(jnp.diff(c.sum(axis=(2, 3)), axis=0), axis=0)

    assert got["saves"].shape == saves.shape == (31, 26, 48) and got["saves"].dtype == torch.float32
    assert rel(got["saves"].numpy(), saves) <= TOL_F32
    np.testing.assert_array_equal(got["peak_day"].numpy(), np.asarray(peak_day))


def test_scenario_ensemble_draws_from_the_prior():
    m = load("torch", "ensemble_scenarios")
    got = m.scenario_ensemble(CPU, 64, 20)
    scales = got["r0_scales"].numpy()
    _, _, low, high = m.PRIOR
    assert scales.shape == (64,) and scales.min() >= low and scales.max() <= high and scales.std() > 0.05
    again = m.scenario_ensemble(CPU, 64, 20)
    assert torch.equal(got["saves"], again["saves"])  # the draws come from a seeded generator


@pytest.fixture(scope="module")
def seip_problem():
    """The FAST fit problem (30 days, the second strain introduced on day
    10) in float64 with numpy-made counts."""
    obs = np.random.default_rng(1).poisson(200.0, (30, 2)).astype(np.float64)
    return load("torch", "seip_fit").problem(CPU, fast=True, dtype=torch.float64, obs=obs)


def test_forecast_bands_match_jax(seip_problem):
    """``forecast_bands`` at 16 members over 45 days against
    ``examples/seip_forecast.py``'s calls of the JAX entry and
    ``member_quantiles`` on the same bank."""
    forecast, jfit = load("torch", "seip_forecast"), load("jax", "seip_fit")
    bank = np.random.default_rng(2).uniform(0.85, 1.15, (2, 16))
    days = jfit.FIT_DAYS + forecast.horizon(True)
    got = forecast.forecast_bands(seip_problem, torch.as_tensor(bank), days)

    outs, stats = seip_ensemble_solve_adaptive(jfit.y0, jfit.base, jnp.asarray(bank, dtype=jnp.float32),
                                               duration=float(days), rtol=1e-4, atol=1e-3, save=(3,),
                                               save_dtype=jnp.float32, packed=False)
    inc = jnp.diff(jnp.sum(outs[0], axis=(1, 2, 3, 4), dtype=jnp.float32), axis=0)
    bands = np.asarray(member_quantiles(inc, forecast.QS, member_axes=(-1,)))

    assert int(np.asarray(stats["exhausted_intervals"]).sum()) == 0
    assert int(got["stats"]["exhausted_intervals"].sum()) == 0
    assert got["c"].shape == outs[0].shape == (days + 1, 4, 4, 4, 2, 16) and got["c"].dtype == torch.float32
    assert rel(got["c"].numpy(), outs[0]) <= TOL_ADAPTIVE
    assert got["bands"].shape == bands.shape == (5, days)
    assert rel(got["bands"].numpy(), bands) <= TOL_ADAPTIVE
    assert (np.diff(got["bands"].numpy(), axis=0) >= 0).all()


def test_forecast_run_from_given_draws(seip_problem):
    """``run`` with numpy draws near the true scales: the bank is resampled
    from them, and the median tracks the data inside the fitted window."""
    forecast = load("torch", "seip_forecast")
    true = seip_problem.true_scales.numpy()
    draws = true + 0.005 * np.random.default_rng(3).standard_normal((64, 2))
    out = forecast.run(CPU, fast=True, dtype=torch.float64, draws=draws)
    assert forecast.width(CPU, True) == 16 and out["bank"].shape == (2, 16)
    picked = out["bank"].T.numpy()
    assert all(any(np.array_equal(row, d) for d in draws) for row in picked)  # every member is a draw
    assert out["bands"].shape == (5, 45) and np.isfinite(out["bands"].numpy()).all()
    assert out["correlation"] > forecast.MIN_CORRELATION
