"""``Predictive``, ``log_likelihood``, ``sample_then_resolve`` and the two
reparameterizations of the port against the JAX package, on the CPU.

Replays of fixed posterior samples draw nothing, so their sites equal
JAX's within 1e-12 in float64; a guide's draws are JAX's own, recorded
under ``jax.disable_jit()`` (JAX's ``parallel=False`` replays draw by draw)
and replayed through the port's draw seam, one stream per draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.dist as jdist
import dynode_tpu.infer as jinfer
from dynode_tpu.config import DeterministicParameter as JDet
from dynode_tpu.config import Strain as JStrain
from dynode_tpu.config import TransmissionParams as JTP
from dynode_tpu.infer import handlers as jh
from dynode_tpu_torch import dist
from dynode_tpu_torch.config import DeterministicParameter, Strain, TransmissionParams
from dynode_tpu_torch.infer import (
    LocScaleReparam,
    Predictive,
    TransformReparam,
    handlers,
    log_likelihood,
    sample_then_resolve,
)
from dynode_tpu_torch.infer import svi as tsvi
from dynode_tpu_torch.infer.util import init_to_mean, log_density
from torch_infer_draws import Replay, record

F64 = torch.float64
TOL = 1e-12
OBS = np.array([[1.3, 0.4, 2.2], [1.7, 0.9, 1.1]])


def t_model(obs=None):
    mu = handlers.sample("mu", dist.Normal(torch.tensor(0.0, dtype=F64), torch.tensor(3.0, dtype=F64)))
    sd = handlers.sample("sd", dist.LogNormal(torch.tensor(0.0, dtype=F64), torch.tensor(0.5, dtype=F64)))
    handlers.deterministic("cv", sd / mu)
    with handlers.plate("col", 3), handlers.plate("row", 2, dim=-2):
        handlers.sample("y", dist.Normal(mu, sd), obs=obs)


def j_model(obs=None):
    mu = jh.sample("mu", jdist.Normal(0.0, 3.0))
    sd = jh.sample("sd", jdist.LogNormal(0.0, 0.5))
    jh.deterministic("cv", sd / mu)
    with jh.plate("col", 3), jh.plate("row", 2, dim=-2):
        jh.sample("y", jdist.Normal(mu, sd), obs=obs)


def _posterior(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return {"mu": rng.normal(1.0, 0.2, n), "sd": rng.uniform(0.5, 1.5, n)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(want), rtol=tol, atol=tol * 1e-3)


@pytest.mark.parametrize("exclude_deterministic", [True, False])
@pytest.mark.parametrize("return_sites", [None, ("cv", "mu")])
@pytest.mark.parametrize("parallel", [True, False])
def test_posterior_replay_matches_jax(exclude_deterministic, return_sites, parallel):
    post = _posterior()
    kw = dict(return_sites=return_sites, exclude_deterministic=exclude_deterministic)
    want = jinfer.Predictive(j_model, posterior_samples={k: jnp.asarray(v) for k, v in post.items()}, **kw)(
        jax.random.PRNGKey(0), obs=jnp.asarray(OBS))
    got = Predictive(t_model, posterior_samples={k: torch.as_tensor(v) for k, v in post.items()}, parallel=parallel,
                     **kw)(0, obs=torch.as_tensor(OBS))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("name", ["AutoMultivariateNormal", "AutoNormal"])
def test_guide_predictive_matches_jax_given_its_draws(name, monkeypatch):
    """``Predictive(guide, params=..., num_samples=6)`` and the model
    replayed over the guide's draws: each site, and its median and 5-95%
    quantiles over the draws."""
    params = {"auto_loc": np.array([0.8, -0.2]), "auto_scale_tril": np.array([[-1.0, 0.0], [0.3, -1.5]]),
              "auto_log_scale": np.array([-0.5, -1.2])}
    jg = getattr(jinfer, name)(j_model, init_loc_fn=jinfer.init_to_mean)
    tg = getattr(tsvi, name)(t_model, init_loc_fn=init_to_mean)
    jg._setup(obs=jnp.asarray(OBS))
    tg._setup(obs=torch.as_tensor(OBS))
    for model_too in (False, True):
        j_pred = jinfer.Predictive(j_model if model_too else jg, guide=jg if model_too else None,
                                   params={k: jnp.asarray(v) for k, v in params.items()}, num_samples=6,
                                   parallel=False, exclude_deterministic=False)
        want, draws = record(monkeypatch, j_pred, jax.random.PRNGKey(4), obs=jnp.asarray(OBS))
        assert len(draws) == 6
        t_pred = Predictive(t_model if model_too else tg, guide=tg if model_too else None,
                            params={k: torch.as_tensor(v) for k, v in params.items()}, num_samples=6,
                            exclude_deterministic=False)
        got = t_pred(Replay([[d] for d in draws]), obs=torch.as_tensor(OBS))
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
        for k in ("mu", "sd") if not model_too else ("cv",):
            g, w = got[k].numpy(), np.asarray(want[k])
            _close(np.median(g, axis=0), np.median(w, axis=0))
            _close(np.quantile(g, [0.05, 0.95], axis=0), np.quantile(w, [0.05, 0.95], axis=0))


def test_prior_and_unconditioned_replays_draw_per_draw():
    """A prior predictive and an unconditioned posterior predictive: the
    shapes of JAX's, and every draw its own."""
    gen = torch.Generator().manual_seed(1)
    prior = Predictive(t_model, num_samples=7)(gen, obs=torch.as_tensor(OBS))
    assert prior["mu"].shape == (7,) and prior["y"].shape == (7, 2, 3)
    assert torch.unique(prior["mu"]).numel() == 7
    np.testing.assert_array_equal(prior["y"][0].numpy(), OBS)  # observed sites echo the data
    post = {k: torch.as_tensor(v) for k, v in _posterior().items()}
    rep = Predictive(t_model, posterior_samples=post, uncondition_observed=True)(gen, obs=torch.as_tensor(OBS))
    assert rep["y"].shape == (5, 2, 3) and torch.unique(rep["y"]).numel() == 30
    with pytest.raises(ValueError, match="EITHER"):
        Predictive(t_model, posterior_samples=post, guide=t_model, params={})
    with pytest.raises(AssertionError, match="num_samples"):
        Predictive(t_model)


def test_log_likelihood_matches_jax_and_refuses_missing_latents():
    post = _posterior(4, 2)
    want = jinfer.log_likelihood(j_model, {k: jnp.asarray(v) for k, v in post.items()}, obs=jnp.asarray(OBS))
    got = log_likelihood(t_model, {k: torch.as_tensor(v) for k, v in post.items()}, obs=torch.as_tensor(OBS))
    assert list(got) == list(want) == ["y"] and got["y"].shape == (4, 2, 3)
    _close(got["y"], want["y"])
    with pytest.raises(ValueError, match=r"latent site\(s\) \['sd'\]"):
        log_likelihood(t_model, {"mu": torch.as_tensor(post["mu"])}, obs=torch.as_tensor(OBS))


def _configs():
    """The same parameter tree on both sides: two strains with
    distribution-valued fields and a link resolved against a sampled one."""
    def make(S, TP, Det, d, asarr):
        strains = [
            S(strain_name="a", r0=d.TruncatedNormal(asarr(2.0), asarr(0.5), low=asarr(1.0), high=asarr(4.0)),
              infectious_period=7.0),
            S(strain_name="b", r0=2.5, infectious_period=d.Normal(asarr(5.0), asarr(1.0))),
        ]
        return {"tp": TP(strains=strains, strain_interactions={"a": {"a": 1.0, "b": 0.5}, "b": {"a": 0.5, "b": 1.0}},
                         contact_scale=d.LogNormal(asarr(0.0), asarr(0.2))),
                "scale": d.Normal(asarr(1.0), asarr(0.1)),
                "twice_scale": Det("scale", transform=lambda x: 2 * x)}

    return (make(Strain, TransmissionParams, DeterministicParameter, dist, lambda x: torch.tensor(x, dtype=F64)),
            make(JStrain, JTP, JDet, jdist, jnp.asarray))


def test_sample_then_resolve_names_orders_and_values_sites_as_jax():
    """Given the same values for every distribution site (substitute), the
    two traces hold the same sites in the same order with the same values,
    and the resolved tree the same numbers."""
    t_cfg, j_cfg = _configs()
    values = {"tp_strains_0_r0": 2.3, "tp_strains_1_infectious_period": 4.2, "tp_contact_scale": 1.1, "scale": 0.95}
    with jh.trace() as jtr, jh.seed(jax.random.PRNGKey(0)), jh.substitute({k: jnp.asarray(v) for k, v in values.items()}):
        j_out = jinfer.sample_then_resolve(j_cfg)
    with handlers.trace() as ttr, handlers.seed(0, device="cpu"), \
            handlers.substitute({k: torch.tensor(v, dtype=F64) for k, v in values.items()}):
        t_out = sample_then_resolve(t_cfg)
    assert list(ttr) == list(jtr) == list(values) + ["twice_scale"]
    for name in jtr:
        assert ttr[name]["type"] == jtr[name]["type"]
        _close(ttr[name]["value"], jtr[name]["value"])
    assert float(t_out["twice_scale"]) == pytest.approx(2 * 0.95, rel=1e-15)
    assert float(t_out["tp"].strains[0].r0) == 2.3 and t_out["tp"].strains[1].r0 == 2.5
    assert isinstance(t_cfg["tp"].strains[0].r0, dist.TruncatedNormal)  # the input is not touched


@pytest.mark.parametrize("centered", [0.0, 0.4, 1.0])
def test_loc_scale_reparam_matches_jax(centered):
    def t_fit():
        with handlers.reparam({"x": LocScaleReparam(centered)}):
            handlers.sample("x", dist.Normal(torch.tensor([0.5, -1.0], dtype=F64), torch.tensor([2.0, 0.3], dtype=F64)))

    def j_fit():
        with jh.reparam({"x": jinfer.LocScaleReparam(centered)}):
            jh.sample("x", jdist.Normal(jnp.asarray([0.5, -1.0]), jnp.asarray([2.0, 0.3])))

    z = np.array([0.7, -0.4])
    t_lp, ttr = log_density(t_fit, (), {}, {"x_decentered": torch.as_tensor(z)})
    j_lp, jtr = jinfer.log_density(j_fit, (), {}, {"x_decentered": jnp.asarray(z)})
    _close(t_lp, j_lp)
    _close(ttr["x"]["value"], jtr["x"]["value"])
    with pytest.raises(TypeError, match="LocScaleReparam supports Normal"):
        LocScaleReparam()("x", dist.LogNormal(0.0, 1.0))
    with pytest.raises(ValueError, match="centered"):
        LocScaleReparam(1.5)


def test_transform_reparam_matches_jax():
    def t_fit():
        with handlers.reparam({"r0": TransformReparam()}):
            handlers.sample("r0", dist.TransformedDistribution(
                dist.Beta(torch.tensor(0.5, dtype=F64), torch.tensor(0.5, dtype=F64)), dist.AffineTransform(1.5, 1.0)))

    def j_fit():
        with jh.reparam({"r0": jinfer.TransformReparam()}):
            jh.sample("r0", jdist.TransformedDistribution(jdist.Beta(0.5, 0.5), jdist.AffineTransform(1.5, 1.0)))

    t_lp, ttr = log_density(t_fit, (), {}, {"r0_base": torch.tensor(0.3, dtype=F64)})
    j_lp, jtr = jinfer.log_density(j_fit, (), {}, {"r0_base": jnp.asarray(0.3)})
    _close(t_lp, j_lp)
    _close(ttr["r0"]["value"], jtr["r0"]["value"])
    assert float(ttr["r0"]["value"]) == pytest.approx(1.8, rel=1e-15)
    with pytest.raises(TypeError, match="TransformedDistribution"):
        TransformReparam()("r0", dist.Normal(0.0, 1.0))
