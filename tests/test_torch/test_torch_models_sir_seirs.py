"""SIR, SEIRS and the SEIP scatter forms of the port against the JAX package.

Inputs are drawn with numpy from a seed and handed to both sides; the root
conftest turns on JAX x64, so both work in float64. Tolerance: 1e-12
relative for every RHS, config value, ``*_odeparams``, initializer and
``simulate`` (the same float64 arithmetic; an adaptive solve takes the same
steps, so its saves differ by rounding only).
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynode_tpu import simulate as j_simulate
from dynode_tpu.config import SolverParams as JSolverParams
from dynode_tpu.models import seip as jseip
from dynode_tpu.models import seirs as jseirs
from dynode_tpu.models import sir as jsir
from dynode_tpu.utils import datetime_utils as jdt
from dynode_tpu_torch import convert, simulate
from dynode_tpu_torch.models import seip as tseip
from dynode_tpu_torch.models import seirs as tseirs
from dynode_tpu_torch.models import sir as tsir
from dynode_tpu_torch.utils import date_to_sim_day, sim_day_to_date

RTOL, ATOL = 1e-12, 1e-15
F64 = torch.float64


def _close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


def _state(rng, n_comp, n_age):
    return tuple(np.abs(rng.normal(1.0, 0.3, n_age)) * 100.0 for _ in range(n_comp))


@pytest.mark.parametrize("n_age", [1, 2, 3])
def test_sir_ode_matches_jax(n_age):
    rng = np.random.default_rng(n_age)
    state = _state(rng, 3, n_age)
    beta, gamma, contact = 0.3, 1 / 7, rng.uniform(0.1, 1.0, (n_age, n_age))
    want = jsir.sir_ode(0.0, tuple(jnp.asarray(x) for x in state),
                        jsir.SIRParams(beta=jnp.asarray(beta), gamma=jnp.asarray(gamma), contact_matrix=jnp.asarray(contact)))
    got = tsir.sir_ode(torch.tensor(0.0, dtype=F64), tuple(torch.as_tensor(x) for x in state),
                       tsir.SIRParams(beta=torch.tensor(beta, dtype=F64), gamma=torch.tensor(gamma, dtype=F64),
                                      contact_matrix=torch.as_tensor(contact)))
    _close(got, want)


@pytest.mark.parametrize("maker", ["sir_config", "sir_age_config"])
def test_sir_configs_and_initial_state_match_jax(maker):
    j_cfg, t_cfg = getattr(jsir, maker)(r_0=2.5), getattr(tsir, maker)(r_0=2.5)
    jtp, ttp = j_cfg.parameters.transmission_params, t_cfg.parameters.transmission_params
    np.testing.assert_allclose(ttp.contact_matrix.numpy(), np.asarray(jtp.contact_matrix), rtol=RTOL)
    assert [s.strain_name for s in ttp.strains] == [s.strain_name for s in jtp.strains]
    assert (ttp.strains[0].r0, ttp.strains[0].infectious_period) == (jtp.strains[0].r0, jtp.strains[0].infectious_period)
    ti, ji = t_cfg.initializer, j_cfg.initializer
    assert (ti.population_size, ti.s0_prop, ti.i0_prop, tuple(ti.age_demographics)) == (
        ji.population_size, ji.s0_prop, ji.i0_prop, tuple(ji.age_demographics))
    assert ti.initialize_date == ji.initialize_date
    assert t_cfg.parameters.solver_params.step_budget == j_cfg.parameters.solver_params.step_budget == 512
    assert vars(t_cfg.idx) == vars(j_cfg.idx)
    _close(ti.get_initial_state(dtype=F64, device="cpu"), ji.get_initial_state())


@pytest.mark.parametrize("seasonal", [False, True])
@pytest.mark.parametrize("t", [0.0, 40.5, 200.0])
def test_seirs_ode_matches_jax(seasonal, t):
    rng = np.random.default_rng(7)
    state = _state(rng, 4, 1)
    kw = dict(r_0=1.8, infectious_period=5.0, latent_period=2.5, waning_period=90.0)
    if seasonal:
        j_cfg = jseirs.seirs_seasonal_config(**kw, seasonal_amplitude=0.3, seasonal_phase=0.7)
        t_cfg = tseirs.seirs_seasonal_config(**kw, seasonal_amplitude=0.3, seasonal_phase=0.7)
    else:
        j_cfg, t_cfg = jseirs.seirs_config(**kw), tseirs.seirs_config(**kw)
    jp = jseirs.seirs_odeparams(j_cfg, seasonal=seasonal)
    tp = tseirs.seirs_odeparams(t_cfg, seasonal=seasonal, dtype=F64, device="cpu")
    for name in ("beta", "sigma", "gamma", "omega"):
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), rtol=RTOL)
    assert (tp.seasonality is None) == (not seasonal)
    j_ode = jseirs.seirs_seasonal_ode if seasonal else jseirs.seirs_ode
    t_ode = tseirs.seirs_seasonal_ode if seasonal else tseirs.seirs_ode
    want = j_ode(jnp.asarray(t), tuple(jnp.asarray(x) for x in state), jp)
    got = t_ode(torch.tensor(t, dtype=F64), tuple(torch.as_tensor(x) for x in state), tp)
    _close(got, want)
    _close(t_cfg.initializer.get_initial_state(dtype=F64, device="cpu"), j_cfg.initializer.get_initial_state())


def test_seirs_odeparams_keep_sampled_tensors_in_float64():
    """A sampled (tensor) r0 keeps its graph through ``seirs_odeparams``,
    and the float32 result is the float64 combination cast once."""
    cfg = tseirs.seirs_config()
    r0 = torch.tensor(2.2, dtype=F64, requires_grad=True)
    cfg.parameters.transmission_params.strains[0].r0 = r0
    p = tseirs.seirs_odeparams(cfg, dtype=torch.float32, device="cpu")
    assert p.beta.dtype == torch.float32
    assert float(p.beta.detach()) == float(torch.tensor(2.2 / 7.0, dtype=F64).float())
    p.beta.backward()
    np.testing.assert_allclose(float(r0.grad), 1.0 / 7.0, rtol=1e-7)


#: family -> (config maker, RHS name, days)
FAMILIES = {
    "sir": ("sir_config", "sir_ode", 100),
    "sir_age": ("sir_age_config", "sir_ode", 100),
    "seirs": ("seirs_config", "seirs_ode", 200),
    "seirs_seasonal": ("seirs_seasonal_config", "seirs_seasonal_ode", 400),
}


def _params(family, mod, cfg, torch_side):
    if family.startswith("seirs"):
        seasonal = family == "seirs_seasonal"
        if torch_side:
            return mod.seirs_odeparams(cfg, seasonal=seasonal, dtype=F64, device="cpu")
        return mod.seirs_odeparams(cfg, seasonal=seasonal)
    strain = cfg.parameters.transmission_params.strains[0]
    contact = cfg.parameters.transmission_params.contact_matrix
    if torch_side:
        return mod.SIRParams(beta=torch.tensor(strain.r0 / strain.infectious_period, dtype=F64),
                             gamma=torch.tensor(1.0 / strain.infectious_period, dtype=F64),
                             contact_matrix=contact.to(F64))
    return mod.SIRParams(beta=jnp.asarray(strain.r0 / strain.infectious_period),
                         gamma=jnp.asarray(1.0 / strain.infectious_period), contact_matrix=jnp.asarray(contact))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_simulate_each_family_matches_jax(family):
    """An adaptive Tsit5 ``simulate`` of each family from its config:
    equal step statistics, saves within 1e-12."""
    make, ode, days = FAMILIES[family]
    jmod = jseirs if family.startswith("seirs") else jsir
    tmod = tseirs if family.startswith("seirs") else tsir
    j_cfg, t_cfg = getattr(jmod, make)(), getattr(tmod, make)()
    want = j_simulate(getattr(jmod, ode), days, j_cfg.initializer.get_initial_state(), _params(family, jmod, j_cfg, False),
                      j_cfg.parameters.solver_params)
    got = simulate(getattr(tmod, ode), days, t_cfg.initializer.get_initial_state(dtype=F64, device="cpu"),
                   _params(family, tmod, t_cfg, True), t_cfg.parameters.solver_params)
    assert int(got.result) == int(want.result) == 0
    for key in ("num_accepted", "num_rejected", "num_steps"):
        assert int(got.stats[key]) == int(want.stats[key]), key
    _close(got.ys, want.ys)


def test_datetime_utils_match_jax():
    init = datetime.date(2022, 2, 11)
    for day in (-40, 0, 1, 365, 1000):
        assert sim_day_to_date(day, init) == jdt.sim_day_to_date(day, init)
        assert date_to_sim_day(sim_day_to_date(day, init), init) == jdt.date_to_sim_day(jdt.sim_day_to_date(day, init), init) == day


def _seip_case(seasonal, batch=None):
    j_cfg = jseip.seip_config(seasonal_vaccination=seasonal, solver_params=JSolverParams(constant_step_size=0.5))
    jp, jy = jseip.seip_odeparams(j_cfg), jseip.seip_initial_state(j_cfg)
    rng = np.random.default_rng(11)
    # a perturbed state, so every flow of the RHS is non-zero
    jy = tuple(np.asarray(x) + rng.uniform(0.0, 50.0, np.shape(x)) for x in jy)
    tp = convert.seip_params_from_numpy(jp, dtype=F64, device="cpu")
    ty = tuple(torch.as_tensor(x) for x in jy)
    jy = tuple(jnp.asarray(x) for x in jy)
    if batch is None:
        return jp, jy, tp, ty
    scales = rng.uniform(0.8, 1.2, batch)
    jp_b = jseip.seip_ensemble_params(jp, jnp.asarray(scales))
    tp_b = tseip.seip_ensemble_params(tp, torch.as_tensor(scales))
    jy_b = tuple(jnp.asarray(np.asarray(x)[..., None] * rng.uniform(0.9, 1.1, batch)) for x in jy)
    ty_b = tuple(torch.as_tensor(np.array(x)) for x in jy_b)
    return jp_b, jy_b, tp_b, ty_b


@pytest.mark.parametrize("seasonal", [False, True])
@pytest.mark.parametrize("t", [60.0, 137.5])
def test_seip_scatter_forms_match_jax_and_the_pad_forms(seasonal, t):
    """``seip_ode_scatter`` against JAX's and against the port's
    ``seip_ode``; ``seip_ode_ensemble_scatter`` (3 members) against JAX's
    and against ``seip_ode_ensemble``. Tolerance 1e-12 relative with an
    absolute floor of 1e-9 of the largest derivative (the forms sum the
    same terms in other orders)."""
    for batch, j_fn, t_fn, t_pad in ((None, jseip.seip_ode_scatter, tseip.seip_ode_scatter, tseip.seip_ode),
                                     (3, jseip.seip_ode_ensemble_scatter, tseip.seip_ode_ensemble_scatter,
                                      tseip.seip_ode_ensemble)):
        jp, jy, tp, ty = _seip_case(seasonal, batch)
        want = [np.asarray(w) for w in jax.jit(j_fn)(jnp.asarray(t), jy, jp)]
        tt = torch.tensor(t, dtype=F64)
        got, pad = t_fn(tt, ty, tp), t_pad(tt, ty, tp)
        for g, p, w in zip(got, pad, want):
            atol = 1e-9 * np.abs(w).max()
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=atol)
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=RTOL, atol=atol)
