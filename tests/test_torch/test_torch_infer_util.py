"""The port's ``infer.util`` against ``dynode_tpu.infer.util``, in float64.

Deterministic pieces within 1e-12: ``flatten_potential``'s flat vector and
``unravel`` (``ravel_pytree``'s layout: keys sorted, each leaf row-major),
``log_density`` with and without centres, the centres, transforms, the
potential and its gradient, and the deterministic init strategies. The
random strategies are held by shape and support. Last, ``bench_nuts.py``'s
fit at 10 days and 8 chains: the port's generic potential (the model
mapped over the chains by ``torch.func.vmap``) against its batched one
(``chip_smoke.fit_potential``, which ``test_torch_config.py`` holds to
``bench_nuts``'s lane-major potential on the same inputs), value and
gradient within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import chip_smoke
import dynode_tpu.dist as jd
import dynode_tpu.infer.handlers as jh
import dynode_tpu.infer.util as ju
import dynode_tpu_torch.dist as td
import dynode_tpu_torch.infer.handlers as th
import dynode_tpu_torch.infer.util as tu
from dynode_tpu_torch.infer.mcmc import batched_pot_and_grad, generic_pot_and_grad

RTOL = 1e-12
RNG = np.random.default_rng(21)
OBS = RNG.normal(1.0, 1.0, size=(5, 3))


def _model(lib):
    h, d = (jh, jd) if lib == "jax" else (th, td)
    T = (lambda x: jnp.asarray(x, jnp.float64)) if lib == "jax" else (
        lambda x: x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), dtype=torch.float64))

    def model(obs=None):
        sigma = h.sample("sigma", d.HalfNormal(T(1.0)))
        with h.plate("k", 3):
            mu = h.sample("mu", d.Normal(T(0.0), T(2.0)))
        w = h.sample("w", d.Dirichlet(T(np.ones(3))))
        frac = h.sample("frac", d.Beta(T(2.0), T(3.0)))
        h.deterministic("scaled", mu * frac)
        h.sample("y", d.Normal(mu + w, sigma), obs=None if obs is None else T(obs))

    return model


CONSTRAINED = {"sigma": np.float64(0.8), "mu": RNG.normal(size=3), "w": np.array([0.2, 0.5, 0.3]),
               "frac": np.float64(0.35)}


def _traces():
    tj = ju.get_model_trace(_model("jax"), jax.random.PRNGKey(0), obs=jnp.asarray(OBS),
                            substitutions={k: jnp.asarray(v) for k, v in CONSTRAINED.items()})
    tt = tu.get_model_trace(_model("torch"), torch.Generator().manual_seed(0), obs=torch.as_tensor(OBS),
                            substitutions={k: torch.as_tensor(v) for k, v in CONSTRAINED.items()})
    return tj, tt


def test_latent_sites_and_transforms_match_jax():
    tj, tt = _traces()
    assert list(tu.latent_sites(tt)) == list(ju.latent_sites(tj)) == ["sigma", "mu", "w", "frac"]
    xj, xt = ju.get_transforms(tj), tu.get_transforms(tt)
    for name, value in CONSTRAINED.items():
        uj = xj[name].inv(jnp.asarray(value))
        ut = xt[name].inv(torch.as_tensor(value))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=RTOL)
        np.testing.assert_allclose(xt[name](ut).numpy(), np.asarray(xj[name](uj)), rtol=RTOL)
        np.testing.assert_allclose(xt[name].log_abs_det_jacobian(ut, xt[name](ut)).numpy(),
                                   np.asarray(xj[name].log_abs_det_jacobian(uj, xj[name](uj))), rtol=RTOL)


@pytest.mark.parametrize("centred", [False, True])
def test_log_density_and_centres_match_jax(centred):
    tj, tt = _traces()
    cj = ju.observed_logprob_centers(tj)
    ct = tu.observed_logprob_centers(tt)
    np.testing.assert_allclose(ct["y"].numpy(), np.asarray(cj["y"]), rtol=RTOL)
    params = {k: (0.9 * np.asarray(v) + 0.01) for k, v in CONSTRAINED.items()}
    params["w"] = np.array([0.3, 0.3, 0.4])
    lj, _ = ju.log_density(_model("jax"), (), {"obs": jnp.asarray(OBS)},
                           {k: jnp.asarray(v) for k, v in params.items()}, centers=cj if centred else None)
    lt, _ = tu.log_density(_model("torch"), (), {"obs": torch.as_tensor(OBS)},
                           {k: torch.as_tensor(v) for k, v in params.items()}, centers=ct if centred else None)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)


def test_flatten_potential_matches_ravel_pytree():
    tj, tt = _traces()
    xj, xt = ju.get_transforms(tj), tu.get_transforms(tt)
    uj = ju.unconstrain_sample(xj, {k: jnp.asarray(v) for k, v in CONSTRAINED.items()})
    ut = tu.unconstrain_sample(xt, {k: torch.as_tensor(v) for k, v in CONSTRAINED.items()})
    cj = ju.observed_logprob_centers(tj)
    pot_j, flat_j, unravel_j = ju.flatten_potential(
        ju.make_potential_fn(_model("jax"), (), {"obs": jnp.asarray(OBS)}, xj, centers=cj), uj)
    pot_t, flat_t, unravel_t = tu.flatten_potential(
        tu.make_potential_fn(_model("torch"), (), {"obs": torch.as_tensor(OBS)}, xt,
                             centers=tu.observed_logprob_centers(tt)), ut)
    np.testing.assert_allclose(flat_t.numpy(), np.asarray(flat_j), rtol=RTOL)
    np.testing.assert_array_equal(flat_j, ravel_pytree(uj)[0])
    assert flat_t.shape == (1 + 3 + 2 + 1,)
    # a vector, and a (chains, draws, D) bank, back to the sites
    z = RNG.normal(size=flat_t.shape[0])
    for name, value in unravel_j(jnp.asarray(z)).items():
        np.testing.assert_array_equal(unravel_t(torch.as_tensor(z))[name].numpy(), np.asarray(value))
    zb = RNG.normal(size=(2, 4, flat_t.shape[0]))
    bank = unravel_t(torch.as_tensor(zb))
    assert bank["mu"].shape == (2, 4, 3) and bank["sigma"].shape == (2, 4)
    np.testing.assert_array_equal(unravel_t.ravel(bank, batch_dims=2).numpy(), zb)
    # the potential and its gradient at a few points
    vg_j = jax.jit(jax.value_and_grad(pot_j))
    for k in range(3):
        z = 0.3 * RNG.normal(size=flat_t.shape[0])
        vj, gj = vg_j(jnp.asarray(z))
        zt = torch.as_tensor(z).requires_grad_(True)
        vt = pot_t(zt)
        (gt,) = torch.autograd.grad(vt, zt)
        np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-11, atol=1e-13)
    # the generic bank potential: vmap of grad_and_value over 4 chains
    zb = 0.3 * RNG.normal(size=(4, flat_t.shape[0]))
    pe, g = generic_pot_and_grad(pot_t)(torch.as_tensor(zb))
    vj, gj = jax.jit(jax.vmap(jax.value_and_grad(pot_j)))(jnp.asarray(zb))
    np.testing.assert_allclose(pe.numpy(), np.asarray(vj), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-11, atol=1e-13)


def test_deterministic_init_strategies_match_jax():
    tj, tt = _traces()
    gen = torch.Generator().manual_seed(1)
    values = {"mu": np.array([0.5, -0.5, 1.0])}
    want = ju.initialize_latents(tj, jax.random.PRNGKey(1), ju.init_to_value(values, fallback=ju.init_to_mean))
    got = tu.initialize_latents(tt, gen, tu.init_to_value(values, fallback=tu.init_to_mean))
    for name in ("mu", "sigma", "w", "frac"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=RTOL)
    bank = tu.initialize_latents(tt, gen, tu.init_to_value(values, fallback=tu.init_to_mean), num_chains=5)
    assert bank["mu"].shape == (5, 3) and bank["w"].shape == (5, 3)
    np.testing.assert_allclose(bank["mu"].numpy(), np.tile(values["mu"], (5, 1)), rtol=0)


@pytest.mark.parametrize("strategy", ["init_to_median", "init_to_sample", "init_to_uniform"])
def test_random_init_strategies_land_in_the_support(strategy):
    _, tt = _traces()
    gen = torch.Generator().manual_seed(2)
    bank = tu.initialize_latents(tt, gen, getattr(tu, strategy), num_chains=16)
    assert bank["sigma"].shape == (16,) and bank["mu"].shape == (16, 3) and bank["w"].shape == (16, 3)
    assert bool((bank["sigma"] > 0).all()) and bool(((bank["frac"] > 0) & (bank["frac"] < 1)).all())
    assert bool((bank["w"] > 0).all())  # an elementwise median of simplex draws is off the simplex, as in JAX
    assert float(bank["mu"].std(0).min()) > 0  # the chains differ


def test_init_to_median_is_the_middle_draw():
    site = {"fn": td.Normal(torch.zeros(2, dtype=torch.float64), 1.0), "value": torch.zeros(2)}
    got = tu.init_to_median(site, torch.Generator().manual_seed(3), num_samples=5)
    draws = td.Normal(torch.zeros(2, dtype=torch.float64), 1.0).sample(torch.Generator().manual_seed(3), (5,))
    torch.testing.assert_close(got, torch.median(draws, dim=0).values, rtol=0, atol=0)


def test_generic_potential_of_bench_nuts_fit_matches_batched():
    """bench_nuts.py's model at 10 days, 8 chains, float64: the port's
    generic potential (its copy of ``build_model``'s model, traced,
    flattened and vmapped) against its batched one
    (``chip_smoke.fit_potential``), on the inputs with which
    ``test_torch_config.py::test_lane_major_potential_matches_bench_nuts``
    holds that one to ``bench_nuts.build_lane_major_potential`` (1e-10).
    The generic potential is centred on the batched one's saturated
    log-likelihood, so all three are the same function."""
    days, chains = 10, 8
    obs = np.random.default_rng(3).poisson(5.0, (days, 2, 3)).astype(np.float64)
    z = np.random.default_rng(4).normal(0.0, 0.6, (chains, 3))
    centre = {"obs_incidence": td.Poisson(torch.as_tensor(obs)).log_prob(torch.as_tensor(obs))}

    model = chip_smoke.fit_model(days=days, dtype=torch.float64, device="cpu")
    tr = tu.get_model_trace(model, torch.Generator().manual_seed(0), obs=torch.as_tensor(obs))
    transforms = tu.get_transforms(tr)
    u0 = tu.unconstrain_sample(transforms, tu.initialize_latents(tr, torch.Generator().manual_seed(0)))
    flat, _, _ = tu.flatten_potential(
        tu.make_potential_fn(model, (), {"obs": torch.as_tensor(obs)}, transforms, centers=centre), u0)
    pe, grad = generic_pot_and_grad(flat)(torch.as_tensor(z))

    fit = chip_smoke.fit_potential(obs, days=days, dtype=torch.float64, device="cpu")
    pe_b, grad_b = batched_pot_and_grad(fit.potential)(torch.as_tensor(z))
    np.testing.assert_allclose(pe.numpy(), pe_b.numpy(), rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), grad_b.numpy(), rtol=1e-10)


def test_golden_fit_data_are_bench_nuts_own():
    """``tests/test_torch/golden/bench_nuts_obs.npz`` (what ``chip_smoke.py``
    fits on the card) holds ``bench_nuts._make_workload()``'s counts: its
    jitted forward at the true scales, Poisson-drawn with ``PRNGKey(0)``."""
    import bench_nuts

    _, forward = bench_nuts.build_model()
    true_scales = jnp.array(chip_smoke.FIT_TRUE_SCALES)
    c = jax.jit(forward)(true_scales)
    want = jax.random.poisson(jax.random.PRNGKey(0), jnp.maximum(jnp.diff(c, axis=0), 1e-6))
    np.testing.assert_array_equal(chip_smoke.bench_nuts_obs().numpy(), np.asarray(want))


def test_adaptive_solve_runs_under_the_chain_vmap():
    """An adaptive (PID) solve in the model's potential runs under the
    generic potential's chain vmap (the host reads no step count there)
    and gives each chain its own solve: value and gradient equal the
    per-chain calls within 1e-12."""
    from dynode_tpu_torch import SolverParams, simulate
    from dynode_tpu_torch.models import multistrain as model

    p = model.multistrain_default_params(dtype=torch.float64, device="cpu")
    y0 = model.multistrain_initial_state(dtype=torch.float64, device="cpu")

    def flat(z):
        sol = simulate(model.multistrain_ode, 3, y0, p.replace(beta=p.beta * torch.exp(z)),
                       SolverParams(step_budget=64))
        return sol.ys[4][-1].sum()

    zb = torch.as_tensor(np.random.default_rng(6).normal(0.0, 0.3, (2, 3)))
    pe, grad = generic_pot_and_grad(flat)(zb)
    for c in range(2):
        z = zb[c].clone().requires_grad_(True)
        want = flat(z)
        (want_grad,) = torch.autograd.grad(want, z)
        torch.testing.assert_close(pe[c], want.detach(), rtol=1e-12, atol=0)
        torch.testing.assert_close(grad[c], want_grad, rtol=1e-12, atol=1e-14)
