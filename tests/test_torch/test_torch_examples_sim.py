"""The eight simulation examples of ``examples_torch/`` against their JAX
twins in ``examples/``.

Each port script runs headless in a subprocess (``--device cpu
--float64``), as ``tests/test_examples/test_examples_run.py`` runs the JAX
scripts, and every array of its ``<figure>.npz`` is held against the same
calls of the JAX example in float64 within 1e-10 of the array's largest
value (step counts equal). The eight scripts start together, when the
first test of the module asks for them.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dynode_tpu import simulate
from dynode_tpu.config import SolverParams
from dynode_tpu.ode import TRBDF2
from example_twins import DIRS, SIMULATIONS, load, rel, start_script

TOL = 1e-10
FIGURES = {"sir": "sir_example", "sir_age_stratified": "sir_age_stratified", "sir_age_risk_stratified": "sir_age_risk",
           "seirs": "seirs_example", "seirs_seasonal_forcing": "seirs_seasonal",
           "seirs_multi_strain_age_stratified": "seirs_multistrain", "seip": "seip_overview",
           "seirs_stiff_waning": "seirs_stiff_waning"}


def _solve(ode, days, config, y0, params):
    return simulate(ode=ode, duration_days=days, initial_state=y0, ode_parameters=params,
                    solver_parameters=config.parameters.solver_params)


def _sir():
    m = load("jax", "sir")
    config = m.get_config()
    sol = _solve(m.sir_ode, 150, config, config.initializer.get_initial_state(), m.get_odeparams(config))
    return {"ts": sol.ts, **{k: a.squeeze(-1) for k, a in zip("sir", sol.ys)}}


def _sir_age_stratified():
    m = load("jax", "sir_age_stratified")
    sol = m.run_simulation(m.get_config(), 150)
    return {"ts": sol.ts, **dict(zip("sir", sol.ys))}


def _sir_age_risk_stratified():
    m = load("jax", "sir_age_risk_stratified")
    config = m.get_config()
    sol = _solve(m.sir_age_risk_ode, 200, config, config.initializer.get_initial_state(), m.get_odeparams(config))
    return {"ts": sol.ts, **dict(zip("sir", sol.ys))}


def _seirs():
    from dynode_tpu.models.seirs import seirs_config, seirs_ode, seirs_odeparams

    config = seirs_config(r_0=2.0, infectious_period=7.0, latent_period=3.0, waning_period=60.0)
    sol = _solve(seirs_ode, 500, config, config.initializer.get_initial_state(), seirs_odeparams(config))
    return {"ts": sol.ts, **{k: a.squeeze(-1) for k, a in zip("seir", sol.ys)}}


def _seirs_seasonal_forcing():
    from dynode_tpu.models.seirs import seirs_odeparams, seirs_seasonal_config, seirs_seasonal_ode

    config = seirs_seasonal_config(r_0=2.0, infectious_period=7.0, latent_period=3.0, waning_period=60.0,
                                   seasonal_amplitude=0.2, seasonal_period=365.0)
    sol = _solve(seirs_seasonal_ode, 3 * 365, config, config.initializer.get_initial_state(),
                 seirs_odeparams(config, seasonal=True))
    return {"ts": sol.ts, **{k: a.squeeze(-1) for k, a in zip("seir", sol.ys)}}


def _seirs_multi_strain_age_stratified():
    from dynode_tpu.models.multistrain import (
        multistrain_config,
        multistrain_initial_state,
        multistrain_ode,
        multistrain_odeparams,
    )

    config = multistrain_config(r0s=(2.4, 2.5, 2.8), infectious_periods=(7.0, 7.0, 7.0),
                                latent_periods=(3.0, 3.0, 3.0), waning_periods=(60.0, 60.0, 60.0),
                                contact_matrix=jnp.array([[0.7, 0.3], [0.3, 0.7]]))
    sol = _solve(multistrain_ode, 500, config, multistrain_initial_state(config), multistrain_odeparams(config))
    return {"ts": sol.ts, **dict(zip("seirc", sol.ys))}


def _seip():
    from dynode_tpu.models.seip import seip_config, seip_initial_state, seip_ode, seip_odeparams

    config = seip_config(seasonal_vaccination=True, solver_params=SolverParams(step_budget=1024))
    sol = _solve(seip_ode, 365, config, seip_initial_state(config), seip_odeparams(config))
    return {"ts": sol.ts, **dict(zip("SEIC", sol.ys))}


def _seirs_stiff_waning():
    m = load("jax", "seirs_stiff_waning")
    p = m.StiffSEIRSParams(beta=jnp.asarray(0.3), sigma=jnp.asarray(1 / 3.6), gamma=jnp.asarray(1 / 7.0),
                           kappa=jnp.asarray(50.0), omega=jnp.asarray(1 / 90.0))
    y0 = tuple(jnp.asarray(v) for v in (9_990.0, 0.0, 10.0, 0.0, 0.0))
    stiff_sp = SolverParams(solver_method=TRBDF2(), ode_solver_rel_tolerance=1e-6, ode_solver_abs_tolerance=1e-4,
                            step_budget=512)
    explicit_sp = SolverParams(ode_solver_rel_tolerance=1e-6, ode_solver_abs_tolerance=1e-4, step_budget=8192)
    sol_i = simulate(m.stiff_seirs_ode, 100, y0, p, stiff_sp)
    sol_e = simulate(m.stiff_seirs_ode, 100, y0, p, explicit_sp)
    out = {"ts": sol_i.ts, "trbdf2_steps": sol_i.stats["num_steps"], "tsit5_steps": sol_e.stats["num_steps"]}
    for name, a, b in zip("seibr", sol_i.ys, sol_e.ys):
        out[name], out[f"{name}_tsit5"] = a, b
    return out


JAX_RUNS = {name: globals()[f"_{name}"] for name in SIMULATIONS}


def test_examples_torch_holds_every_example():
    """The 15 scripts of ``examples/``, by the same names, and ``_bootstrap.py``."""
    def scripts(d):
        return {p.stem for p in d.glob("*.py")}

    fits = {"ensemble_scenarios", "hierarchical_strains", "model_selection", "seip_fit", "seip_forecast",
            "sir_infer_parameters", "svi_multistart"}
    assert scripts(DIRS["torch"]) == scripts(DIRS["jax"]) == set(SIMULATIONS) | fits | {"_bootstrap"}
    assert set(JAX_RUNS) == set(FIGURES) == set(SIMULATIONS) and len(SIMULATIONS) == 8


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """Every simulation script, started at once: name -> (process, its directory)."""
    runs = {}
    for name in SIMULATIONS:
        cwd = tmp_path_factory.mktemp(name)
        runs[name] = (start_script(name, cwd, "--device", "cpu", "--float64"), cwd)
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("name", SIMULATIONS)
def test_simulation_example_matches_jax(name, scripts):
    proc, cwd = scripts[name]
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    assert f"saved {FIGURES[name]}.png" in stdout
    got = dict(np.load(cwd / f"{FIGURES[name]}.npz"))
    want = {k: np.asarray(v) for k, v in JAX_RUNS[name]().items()}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        g = got[key]
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g.dtype == np.float64 and g.shape == w.shape, (key, g.dtype, g.shape, w.shape)
            assert np.isfinite(g).all(), key
            assert rel(g, w) <= TOL, (key, rel(g, w))
