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

The second case runs the same fit on the JAX package's draws: the JAX
test's ``SVIProcess`` fit (its default key) is run first, then its guide's
``init_to_median`` point (from its own prior draws) starts the port's
guide, and each of its steps' guide draws and its 200 posterior draws
(re-derived from its key by running its guide alone, recorded under
``jax.disable_jit()``) are replayed through the port's draw seam into
``SVI.run`` and ``Predictive``, as ``SVIProcess`` runs them. Held to the
JAX test's gates unchanged, and to JAX's fitted means and stds within
1e-4 (relative): the two fits take the same draws and the same
arithmetic, up to the solves' rounding (1e-10), which 400 Adam steps
carry to about 1e-5.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from dynode_tpu_torch import SVIProcess, Strain, dist, sample_then_resolve, simulate
from dynode_tpu_torch.infer import SVI, Adam, AutoMultivariateNormal, Predictive, Trace_ELBO, handlers, init_to_value
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


def _assert_quadrature_gates(samples, quad):
    """The JAX test's gates: means within 1%, stds within 55%, each mean
    inside the exact 94% interval."""
    for site in ("strains_0_r0", "strains_0_infectious_period"):
        arr = np.asarray(samples[site], dtype=np.float64)
        q_mean, q_std = float(quad[f"{site}_mean"]), float(quad[f"{site}_std"])
        assert arr.mean() == pytest.approx(q_mean, rel=0.01), (site, arr.mean(), q_mean)
        assert arr.std() == pytest.approx(q_std, rel=0.55), (site, arr.std(), q_std)
        lo, hi = np.asarray(quad[f"{site}_eti94"])
        assert lo < arr.mean() < hi, (site, arr.mean(), (lo, hi))


@pytest.mark.slow
def test_svi_process_matches_the_exact_posterior():
    data = np.load(HERE / "golden" / "sir_obs.npz")
    quad = np.load(HERE.parent / "golden" / "quadrature.npz")
    obs = torch.as_tensor(data["obs"], dtype=F64)
    proc = SVIProcess(numpyro_model=_model, num_iterations=400, num_samples=200, progress_bar=False)
    proc.infer(config=_prior_config(int(data["population"])), tf=int(data["days"]), obs_data=obs)
    samples = proc.get_samples()
    _assert_quadrature_gates({k: v.double().numpy() for k, v in samples.items()}, quad)


def _jax_golden_module():
    """``tests/test_infer/test_nuts_through_ode.py``, the JAX test, as a module."""
    path = HERE.parent / "test_infer" / "test_nuts_through_ode.py"
    spec = importlib.util.spec_from_file_location("jax_golden_sir_fit", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.slow
def test_svi_fit_on_the_jax_draws_matches_the_exact_posterior_and_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from dynode_tpu.infer import Predictive as JPredictive
    from dynode_tpu.infer import SVIProcess as JSVIProcess
    from dynode_tpu.infer import handlers as jh
    from torch_infer_draws import Replay, record

    data = np.load(HERE / "golden" / "sir_obs.npz")
    quad = np.load(HERE.parent / "golden" / "quadrature.npz")
    jgolden = _jax_golden_module()
    steps, n_draws = 400, 200

    # the JAX test's fit, at its default key
    jproc = JSVIProcess(numpyro_model=jgolden._model, num_iterations=steps, num_samples=n_draws, progress_bar=False)
    jkw = dict(config=jgolden.make_prior_config(), tf=int(data["days"]), obs_data=jnp.asarray(data["obs"]))
    jproc.infer(**jkw)
    jsamples = {k: np.asarray(v, dtype=np.float64) for k, v in jproc.get_samples().items()}
    jg, key = jproc._inferer.guide, jproc.inference_prngkey
    jparams = jproc._inference_state.params
    start = {n: float(jg._transforms[n](u)) for n, u in jg._unravel(jg._init_flat).items()}

    def guide_draws():
        """The guide's draws of ``SVIProcess.infer``: ``init`` at the key,
        then each step's at ``split``'s second key."""
        def once(k):
            with jh.trace(), jh.seed(k), jh.substitute(jparams):
                jg(**jkw)

        once(key)
        k = key
        for _ in range(steps):
            k, sub = jax.random.split(k)
            once(sub)

    _, fit_draws = record(monkeypatch, guide_draws)
    assert len(fit_draws) == steps + 1
    post = JPredictive(jg, params=jparams, num_samples=n_draws, parallel=False)
    want, post_draws = record(monkeypatch, post, key, **jkw)
    assert len(post_draws) == n_draws
    for site in jsamples:  # the recording re-derived get_samples()' draws
        np.testing.assert_array_equal(np.asarray(want[site], dtype=np.float64), jsamples[site])

    # the port: SVIProcess's SVI and Predictive on those draws
    obs = torch.as_tensor(data["obs"], dtype=F64)
    kw = dict(config=_prior_config(int(data["population"])), tf=int(data["days"]), obs_data=obs)
    guide = AutoMultivariateNormal(_model, init_loc_fn=init_to_value(start))
    seam = Replay([fit_draws], bank=True)
    result = SVI(_model, guide, Adam(step_size=0.1), Trace_ELBO()).run(seam, steps, **kw)
    assert seam.done()
    samples = Predictive(guide, params=result.params, num_samples=n_draws)(Replay([[d] for d in post_draws]), **kw)
    got = {k: v.double().numpy() for k, v in samples.items() if not k.startswith("_auto")}
    print("replayed port fit:", {k: (v.mean(), v.std()) for k, v in got.items()},
          "JAX:", {k: (v.mean(), v.std()) for k, v in jsamples.items()})
    _assert_quadrature_gates(got, quad)
    for site in ("strains_0_r0", "strains_0_infectious_period"):
        assert got[site].mean() == pytest.approx(jsamples[site].mean(), rel=1e-4), site
        assert got[site].std() == pytest.approx(jsamples[site].std(), rel=1e-4), site
