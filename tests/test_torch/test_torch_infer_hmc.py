"""The port's ``infer.hmc`` (a bank of chains) against ``dynode_tpu.infer.hmc``
(one chain, vmapped in JAX), in float64.

Deterministic pieces within 1e-12: the mass-matrix algebra, ``leapfrog``,
``is_turning``, dual averaging, Welford, ``build_warmup_schedule``. The
transitions -- ``nuts_transition`` for one chain and for a bank of 4,
dense and diagonal, in a regime that turns and one that diverges, and
``find_reasonable_step_size`` -- take the draws the JAX functions drew
(recorded under ``jax.disable_jit()``, ``torch_infer_draws``) and must
match within 1e-10, take every draw in JAX's order, and agree on
``num_steps`` and ``diverging`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_infer_draws import Replay, record

import dynode_tpu.infer.hmc as jh
import dynode_tpu_torch.infer.hmc as th

RTOL = 1e-12
TOL_TRANSITION = 1e-10
D = 3
RNG = np.random.default_rng(31)
A = RNG.normal(size=(D, D))
PRECISION = A @ A.T + D * np.eye(D)  # a correlated Gaussian target


def _spd(rng, n):
    a = rng.normal(size=(n, n))
    return 0.1 * (a @ a.T) / n + 0.2 * np.eye(n)


def _metric(dense, chains, seed=1):
    rng = np.random.default_rng(seed)
    if dense:
        return np.stack([_spd(rng, D) for _ in range(chains)])
    return rng.uniform(0.2, 1.0, (chains, D))


def _pag_jax(scale):
    P = jnp.asarray(PRECISION * scale)
    return jax.value_and_grad(lambda z: 0.5 * z @ P @ z)


def _pag_torch(scale):
    P = torch.as_tensor(PRECISION * scale)

    def pag(zb):
        g = zb @ P
        return 0.5 * torch.sum(zb * g, dim=-1), g

    return pag


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "diag"])
def test_mass_algebra_leapfrog_and_turning_match_jax(dense):
    C = 4
    inv = _metric(dense, C)
    r = RNG.normal(size=(C, D))
    eps_n = RNG.normal(size=(C, D))
    z = RNG.normal(size=(C, D))
    eps = RNG.uniform(0.05, 0.3, C)
    inv_t = torch.as_tensor(inv)
    chol_t = th.chol_of_inv(inv_t, dense)
    state_t = th.IntegratorState(torch.as_tensor(z), torch.as_tensor(r), *_pag_torch(1.0)(torch.as_tensor(z)))
    new_t = th.leapfrog(_pag_torch(1.0), inv_t, torch.as_tensor(eps), state_t)
    rl, rr, rs = RNG.normal(size=(3, C, D))
    turn_t = th.is_turning(inv_t, torch.as_tensor(rl), torch.as_tensor(rr), torch.as_tensor(rs))
    for c in range(C):
        chol_j = jh.chol_of_inv(jnp.asarray(inv[c]))
        _close(chol_t[c], chol_j)
        _close(th.velocity(inv_t, torch.as_tensor(r))[c], jh.velocity(jnp.asarray(inv[c]), jnp.asarray(r[c])))
        _close(th.kinetic_energy(inv_t, torch.as_tensor(r))[c],
               jh.kinetic_energy(jnp.asarray(inv[c]), jnp.asarray(r[c])))
        # sample_momentum from given standard normals: JAX's own draw, replayed
        mom_j, (normals,) = record(pytest.MonkeyPatch(), jh.sample_momentum, jnp.asarray(inv[c]), chol_j,
                                   jax.random.PRNGKey(c), jnp.float64)
        mom_t = th.sample_momentum(inv_t[c:c + 1], chol_t[c:c + 1], torch.as_tensor(normals)[None])
        _close(mom_t[0], mom_j)
        pe, g = _pag_jax(1.0)(jnp.asarray(z[c]))
        new_j = jh.leapfrog(_pag_jax(1.0), jnp.asarray(inv[c]), eps[c],
                            jh.IntegratorState(jnp.asarray(z[c]), jnp.asarray(r[c]), pe, g))
        for got, want in zip(new_t, new_j):
            _close(got[c], want)
        assert bool(turn_t[c]) == bool(jh.is_turning(jnp.asarray(inv[c]), jnp.asarray(rl[c]),
                                                     jnp.asarray(rr[c]), jnp.asarray(rs[c])))
    del eps_n


def test_dual_averaging_matches_jax():
    eps0 = RNG.uniform(0.01, 1.0, 4)
    accepts = RNG.uniform(0.0, 1.0, (30, 4))
    da_t = th.da_init(torch.as_tensor(eps0))
    for a in accepts:
        da_t = th.da_update(da_t, torch.as_tensor(a), target=0.75)
    for c in range(4):
        da_j = jh.da_init(jnp.asarray(eps0[c]))
        for a in accepts:
            da_j = jh.da_update(da_j, jnp.asarray(a[c]), target=0.75)
        for got, want in zip(da_t, da_j):
            _close(got[c], want)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "diag"])
def test_welford_matches_jax(dense):
    xs = RNG.normal(size=(25, 4, D)) * np.array([1.0, 2.0, 0.5])
    w_t = th.welford_init(D, dense, torch.float64, batch=(4,))
    for x in xs:
        w_t = th.welford_update(w_t, torch.as_tensor(x))
    cov_t = th.welford_covariance(w_t)
    for c in range(4):
        w_j = jh.welford_init(D, dense, jnp.float64)
        for x in xs:
            w_j = jh.welford_update(w_j, jnp.asarray(x[c]))
        for got, want in zip(w_t, w_j):
            _close(got[c], want)
        _close(cov_t[c], jh.welford_covariance(w_j))


@pytest.mark.parametrize("n", [0, 10, 19, 20, 60, 149, 150, 200, 1000])
def test_warmup_schedule_matches_jax(n):
    for got, want in zip(th.build_warmup_schedule(n), jh.build_warmup_schedule(n)):
        np.testing.assert_array_equal(got, want)


def test_ctz_is_exact():
    for i in range(1, 1 << 12):
        assert th._ctz(i) == int(np.log2(i & -i))


#: (curvature scale of the target, step sizes of the chains, max depth):
#: moderate steps that U-turn before the depth limit, and steps far above
#: the stable size that diverge (the bank mixes both in the last case)
REGIMES = {
    "turning": (1.0, None, 3),  # step sizes from each chain's stiffness: _turning_eps
    "diverging": (400.0, [1.5, 2.0, 1.2, 3.0], 4),
    "mixed": (30.0, [0.02, 0.9, 0.05, 1.7], 3),
}


def _turning_eps(dense):
    """1.1 / sqrt of each chain's largest eigenvalue of M^-1 P: a stable
    step that U-turns within a few leaves."""
    out = []
    for inv in _metric(dense, 4):
        m = inv if dense else np.diag(inv)
        out.append(1.1 / np.sqrt(np.max(np.real(np.linalg.eigvals(m @ PRECISION)))))
    return out


def _regime(regime, dense):
    scale, eps, depth = REGIMES[regime]
    return scale, _turning_eps(dense) if eps is None else eps, depth


def _jax_transition(monkeypatch, regime, dense, c, z0):
    scale, eps, depth = _regime(regime, dense)
    inv = _metric(dense, 4)[c]
    pag = _pag_jax(scale)
    state = jh.init_state(pag, jnp.asarray(z0), jax.random.PRNGKey(100 + c))
    out, draws = record(monkeypatch, jh.nuts_transition, pag, jnp.asarray(inv),
                        jh.chol_of_inv(jnp.asarray(inv)), eps[c], depth, state)
    return out, draws


CASES = [(4, "turning", True), (4, "turning", False), (4, "diverging", True), (4, "diverging", False),
         (4, "mixed", True), (1, "turning", True), (1, "mixed", False)]


@pytest.mark.parametrize("chains, regime, dense", CASES,
                         ids=[f"{'bank_of_4' if c == 4 else 'one_chain'}-{r}-{'dense' if d else 'diag'}"
                              for c, r, d in CASES])
def test_nuts_transition_matches_jax_given_its_draws(monkeypatch, regime, dense, chains):
    scale, eps, depth = _regime(regime, dense)
    z0 = np.random.default_rng(7).normal(size=(4, D))[:chains]
    outs, streams = zip(*(_jax_transition(monkeypatch, regime, dense, c, z0[c]) for c in range(chains)))
    inv = torch.as_tensor(_metric(dense, 4)[:chains])
    pag = _pag_torch(scale)
    state = th.init_state(pag, torch.as_tensor(z0))
    draws = Replay(streams)
    step = torch.tensor(eps[:chains], dtype=torch.float64)
    got = th.nuts_transition(pag, inv, th.chol_of_inv(inv, dense), step, depth, state, draws)
    assert draws.done(), "the port took fewer draws than JAX"
    for c, want in enumerate(outs):
        for field in ("z", "potential", "grad", "energy", "accept_prob"):
            _close(getattr(got, field)[c], getattr(want, field), rtol=TOL_TRANSITION, atol=1e-300)
        assert int(got.num_steps[c]) == int(want.num_steps)
        assert bool(got.diverging[c]) == bool(want.diverging)
    if regime == "diverging":
        assert bool(got.diverging.all())
    if regime == "turning":
        assert int(got.num_steps.min()) < 2**depth - 1  # a chain U-turned before the depth limit


@pytest.mark.parametrize("scale", [1.0, 1e-4, 1e4], ids=["unit", "flat", "sharp"])
def test_find_reasonable_step_size_matches_jax_given_its_draws(monkeypatch, scale):
    C = 4
    z0 = np.random.default_rng(8).normal(size=(C, D))
    inv = _metric(True, C)
    streams, want = [], []
    for c in range(C):
        pag = _pag_jax(scale)
        state = jh.init_state(pag, jnp.asarray(z0[c]), jax.random.PRNGKey(c))
        eps, draws = record(monkeypatch, jh.find_reasonable_step_size, pag, jnp.asarray(inv[c]),
                            jh.chol_of_inv(jnp.asarray(inv[c])), state, jax.random.PRNGKey(50 + c))
        streams.append(draws)
        want.append(float(eps))
    inv_t = torch.as_tensor(inv)
    pag = _pag_torch(scale)
    draws = Replay(streams)
    got = th.find_reasonable_step_size(pag, inv_t, th.chol_of_inv(inv_t, True),
                                       th.init_state(pag, torch.as_tensor(z0)), draws)
    assert draws.done()
    _close(got, want, rtol=TOL_TRANSITION)


def test_generator_draws_are_reproducible():
    gen = torch.Generator().manual_seed(3)
    a = th.Draws(gen)
    x = (a.normal((4, 3), torch.float64, "cpu"), a.uniform((4, 5), torch.float64, "cpu"), a.bernoulli((4,), "cpu"))
    gen.manual_seed(3)
    y = (a.normal((4, 3), torch.float64, "cpu"), a.uniform((4, 5), torch.float64, "cpu"), a.bernoulli((4,), "cpu"))
    for u, v in zip(x, y):
        assert torch.equal(u, v)
    assert x[2].dtype == torch.bool and bool(((x[1] >= 0) & (x[1] < 1)).all())
