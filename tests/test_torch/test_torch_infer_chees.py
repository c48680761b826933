"""The port's ``infer.chees`` against ``dynode_tpu.infer.chees``, in float64.

Deterministic pieces within 1e-12: ``_halton`` (float32, bit for bit,
including past 2**31), the bank metric algebra, ``chees_rate_grad`` (with
a divergent, non-finite chain in the bank), the trajectory adaptation and
``welford_update_bank``. ``chees_transition`` and
``find_reasonable_step_size_bank`` take the draws the JAX functions drew
(recorded under ``jax.disable_jit()``, one stream of whole-bank arrays)
and must match within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_infer_draws import Replay, record

import dynode_tpu.infer.chees as jc
import dynode_tpu.infer.hmc as jh
import dynode_tpu_torch.infer.chees as tc
import dynode_tpu_torch.infer.hmc as th

RTOL = 1e-12
TOL_TRANSITION = 1e-10
C, D = 8, 3
RNG = np.random.default_rng(41)
A = RNG.normal(size=(D, D))
PRECISION = A @ A.T + D * np.eye(D)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _metric(dense):
    if dense:
        a = RNG.normal(size=(D, D))
        return 0.1 * a @ a.T / D + 0.3 * np.eye(D)
    return RNG.uniform(0.2, 1.0, D)


def _pag_bank_jax(scale):
    P = jnp.asarray(PRECISION * scale)
    return jax.vmap(jax.value_and_grad(lambda z: 0.5 * z @ P @ z))


def _pag_bank_torch(scale):
    P = torch.as_tensor(PRECISION * scale)

    def pag(zb):
        g = zb @ P
        return 0.5 * torch.sum(zb * g, dim=-1), g

    return pag


def test_halton_matches_jax_bit_for_bit():
    idx = np.r_[np.arange(0, 40), [2**16 - 2, 2**16 - 1, 2**20 + 7, 2**31 - 2, 2**31 - 1, 2**32 - 2]]
    got = np.array([float(tc._halton(int(i))) for i in idx], dtype=np.float32)
    want = np.array([np.float32(jc._halton(jnp.asarray(int(i), dtype=jnp.int64))) for i in idx])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "diag"])
def test_bank_metric_algebra_matches_jax(dense):
    inv = _metric(dense)
    r = RNG.normal(size=(C, D))
    chol = np.asarray(jh.chol_of_inv(jnp.asarray(inv)))
    _close(th.chol_of_inv(torch.as_tensor(inv), dense), chol)
    _close(tc.velocity_bank(torch.as_tensor(inv), torch.as_tensor(r)), jc.velocity_bank(jnp.asarray(inv), r))
    _close(tc.kinetic_bank(torch.as_tensor(inv), torch.as_tensor(r)), jc.kinetic_bank(jnp.asarray(inv), r))
    mom_j, (normals,) = record(pytest.MonkeyPatch(), jc.sample_momentum_bank, jnp.asarray(inv), jnp.asarray(chol),
                               jax.random.PRNGKey(1), (C, D), jnp.float64)
    _close(tc.sample_momentum_bank(torch.as_tensor(inv), torch.as_tensor(chol), torch.as_tensor(normals)), mom_j)


def test_rate_grad_and_trajectory_adaptation_match_jax():
    z_old = RNG.normal(size=(C, D))
    z_prop = RNG.normal(size=(C, D))
    v_end = RNG.normal(size=(C, D))
    z_prop[3, 1] = np.inf  # a divergent proposal: masked out of the bank means
    v_end[5, 0] = np.nan
    p_acc = RNG.uniform(0.0, 1.0, C)
    aux_j = jc._TransitionAux(jnp.asarray(z_prop), jnp.asarray(v_end), jnp.asarray(p_acc), jnp.asarray(0.37),
                              jnp.int32(4))
    aux_t = tc._TransitionAux(torch.as_tensor(z_prop), torch.as_tensor(v_end), torch.as_tensor(p_acc),
                              torch.tensor(0.37, dtype=torch.float64), 4)
    g_t = tc.chees_rate_grad(torch.as_tensor(z_old), aux_t)
    g_j = jc.chees_rate_grad(jnp.asarray(z_old), aux_j)
    assert np.isfinite(float(g_t))
    _close(g_t, g_j)
    grads = np.r_[RNG.normal(size=20), np.nan, np.inf, RNG.normal(size=5)]
    ts_t = tc.traj_adapt_init(torch.tensor(0.8, dtype=torch.float64))
    ts_j = jc.traj_adapt_init(jnp.asarray(0.8))
    for g in grads:
        ts_t = tc.traj_adapt_update(ts_t, torch.tensor(g, dtype=torch.float64), lr=0.05)
        ts_j = jc.traj_adapt_update(ts_j, jnp.asarray(g), lr=0.05)
    for got, want in zip(ts_t, ts_j):
        _close(got, want)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "diag"])
def test_welford_update_bank_matches_jax(dense):
    w_t = th.welford_init(D, dense, torch.float64)
    w_j = jh.welford_init(D, dense, jnp.float64)
    for _ in range(4):
        zb = RNG.normal(size=(C, D)) * np.array([1.0, 3.0, 0.5])
        w_t = tc.welford_update_bank(w_t, torch.as_tensor(zb))
        w_j = jc.welford_update_bank(w_j, jnp.asarray(zb))
    for got, want in zip(w_t, w_j):
        _close(got, want)
    _close(th.welford_covariance(w_t), jh.welford_covariance(w_j))


@pytest.mark.parametrize("dense, scale, traj", [(True, 1.0, 2.0), (False, 1.0, 0.3), (True, 400.0, 5.0),
                                                 (False, 400.0, 5.0)],
                         ids=["dense-long", "diag-short", "dense-diverging", "diag-diverging"])
def test_chees_transition_matches_jax_given_its_draws(monkeypatch, dense, scale, traj):
    inv = _metric(dense)
    chol = jh.chol_of_inv(jnp.asarray(inv))
    z0 = RNG.normal(size=(C, D))
    eps = 0.25
    pag_j = _pag_bank_jax(scale)
    state_j = jc.init_bank_state(pag_j, jnp.asarray(z0), jax.random.PRNGKey(2))._replace(iter_idx=jnp.int32(5))
    (new_j, aux_j), draws = record(monkeypatch, jc.chees_transition, pag_j, jnp.asarray(inv), chol,
                                   jnp.asarray(eps), jnp.asarray(traj), 64, state_j)
    pag_t = _pag_bank_torch(scale)
    inv_t = torch.as_tensor(inv)
    state_t = tc.init_bank_state(pag_t, torch.as_tensor(z0))._replace(iter_idx=5)
    replay = Replay([draws], bank=True)
    f64 = dict(dtype=torch.float64)
    new_t, aux_t = tc.chees_transition(pag_t, inv_t, th.chol_of_inv(inv_t, dense), torch.tensor(eps, **f64),
                                       torch.tensor(traj, **f64), 64, state_t, replay)
    assert replay.done()
    assert aux_t.n_steps == int(aux_j.n_steps) and new_t.iter_idx == int(new_j.iter_idx)
    for field in ("z", "potential", "grad", "energy", "accept_prob"):
        _close(getattr(new_t, field), getattr(new_j, field), rtol=TOL_TRANSITION, atol=1e-300)
    np.testing.assert_array_equal(new_t.diverging.numpy(), np.asarray(new_j.diverging))
    np.testing.assert_array_equal(new_t.num_steps.numpy(), np.asarray(new_j.num_steps))
    if scale > 1.0:
        assert bool(new_t.diverging.any())
    finite = np.isfinite(np.asarray(aux_j.z_prop)).all()
    if finite:
        _close(aux_t.z_prop, aux_j.z_prop, rtol=TOL_TRANSITION)
    _close(tc.chees_rate_grad(torch.as_tensor(z0), aux_t), jc.chees_rate_grad(jnp.asarray(z0), aux_j),
           rtol=TOL_TRANSITION)


@pytest.mark.parametrize("scale", [1.0, 1e-4, 1e4], ids=["unit", "flat", "sharp"])
def test_find_reasonable_step_size_bank_matches_jax_given_its_draws(monkeypatch, scale):
    inv = _metric(True)
    chol = jh.chol_of_inv(jnp.asarray(inv))
    z0 = RNG.normal(size=(C, D))
    pag_j = _pag_bank_jax(scale)
    state_j = jc.init_bank_state(pag_j, jnp.asarray(z0), jax.random.PRNGKey(3))
    eps_j, draws = record(monkeypatch, jc.find_reasonable_step_size_bank, pag_j, jnp.asarray(inv), chol,
                          state_j, jax.random.PRNGKey(4))
    pag_t = _pag_bank_torch(scale)
    inv_t = torch.as_tensor(inv)
    replay = Replay([draws], bank=True)
    eps_t = tc.find_reasonable_step_size_bank(pag_t, inv_t, th.chol_of_inv(inv_t, True),
                                              tc.init_bank_state(pag_t, torch.as_tensor(z0)), replay)
    assert replay.done()
    _close(eps_t, eps_j, rtol=TOL_TRANSITION)


def test_chees_chunked_and_mesh():
    """``MCMC(ChEES(...), steps_per_call=, mesh=)`` (``test_chees.py``'s
    mesh case) on a Normal-mean model: the bank's potential split over 8
    CPU devices gives the unsplit bank's draws bit for bit (the sampler's
    state and its pooled adaptation stay on the first device), and the
    posterior mean within 0.05 of the conjugate one."""
    from dynode_tpu_torch import dist
    from dynode_tpu_torch.infer import MCMC, ChEES, handlers
    from dynode_tpu_torch.parallel import create_mesh

    data = torch.as_tensor(np.random.default_rng(5).normal(0.7, 1.0, 64))

    def toy_model(obs=None):
        mu = handlers.sample("mu", dist.Normal(0.0, 1.0))
        handlers.sample("x", dist.Normal(mu, 1.0), obs=obs)

    mesh = create_mesh(("chain",), devices=[torch.device("cpu", i) for i in range(8)])
    draws = []
    for m in (None, mesh):
        mc = MCMC(ChEES(toy_model), num_warmup=64, num_samples=48, num_chains=16, steps_per_call=25, mesh=m,
                  chain_axis="chain")
        mc.run(torch.Generator().manual_seed(2), obs=data)
        draws.append(mc.get_samples()["mu"])
    assert draws[1].shape == (16 * 48,)
    assert torch.equal(draws[0], draws[1])
    assert abs(float(draws[1].mean()) - float(data.mean()) * 64 / 65) < 0.05
