"""``InferenceProcess``, ``MCMCProcess`` and ``SVIProcess`` of the port.

- Their fields take and refuse what the JAX package's pydantic models take
  and refuse (a refusal is a ``ValueError`` on both sides: pydantic's
  ``ValidationError`` is one), with equal coerced values and defaults.
- The JAX package's error messages.
- ``infer`` / ``get_samples`` / ``to_arviz`` on a tiny model: the sites,
  groups and shapes of the JAX package's layout.
- A repeated ``infer()`` draws fresh randomness; the first uses the key as
  it is; ``nuts_kwargs`` reach either kernel.
"""

import jax
import numpy as np
import pytest
import torch

import dynode_tpu.infer as jinfer
from dynode_tpu_torch import dist
from dynode_tpu_torch.infer import (
    MCMC,
    NUTS,
    InferenceProcess,
    MCMCProcess,
    SVIProcess,
    handlers,
    init_to_mean,
    loo,
)
from dynode_tpu_torch.infer import svi as tsvi
from dynode_tpu_torch.infer.inference import call_seed

F64 = torch.float64
OBS = torch.tensor([1.3, 0.4, 2.2, 1.7, 0.9, 1.1], dtype=F64)


def model(obs=None):
    mu = handlers.sample("mu", dist.Normal(torch.tensor(0.0, dtype=F64), torch.tensor(3.0, dtype=F64)))
    sd = handlers.sample("sd", dist.LogNormal(torch.tensor(0.0, dtype=F64), torch.tensor(0.5, dtype=F64)))
    handlers.deterministic("cv", sd / mu)
    with handlers.plate("data", 6):
        handlers.sample("y", dist.Normal(mu, sd), obs=obs)


def potential(zb):
    """The model's potential over a (C, 2) bank of (mu, log sd)."""
    mu, log_sd = zb[:, 0], zb[:, 1]
    sd = torch.exp(log_sd)
    lp = dist.Normal(torch.tensor(0.0, dtype=F64), torch.tensor(3.0, dtype=F64)).log_prob(mu)
    lp = lp + dist.LogNormal(torch.tensor(0.0, dtype=F64), torch.tensor(0.5, dtype=F64)).log_prob(sd) + log_sd
    lp = lp + dist.Normal(mu[:, None], sd[:, None]).log_prob(OBS[None]).sum(-1)
    return -lp


MCMC_BASE = dict(num_samples=6, num_warmup=10, num_chains=2, nuts_max_tree_depth=3)
SVI_BASE = dict(num_iterations=5, num_samples=7)


def _both(cls_name, **kw):
    """(port instance or its error type, JAX instance or its error type)."""
    out = []
    for mod in (None, jinfer):
        cls = {"MCMCProcess": MCMCProcess, "SVIProcess": SVIProcess}[cls_name] if mod is None else getattr(mod, cls_name)
        try:
            out.append(cls(**kw))
        except ValueError as e:  # pydantic's ValidationError is a ValueError
            out.append(type(e))
    return out


MCMC_CASES = [("num_samples", v) for v in (True, "3", 2.0, 2.5, 0, -1, None)] + [
    ("num_chains", "x"), ("sampler", 3), ("sampler", "chees"), ("mcmc_kwargs", [("a", 1)]),
    ("mcmc_kwargs", {"steps_per_call": 4}), ("progress_bar", "no"), ("progress_bar", 2), ("nuts_init_strategy", None),
    ("nuts_init_strategy", init_to_mean), ("numpyro_model", 5)]
SVI_CASES = [("init_jitter", "1.5"), ("init_jitter", "x"), ("num_starts", 0), ("num_starts", 3),
             ("num_iterations", 1.5), ("guide_class", int), ("guide_class", "AutoNormal"), ("guide_kwargs", None),
             ("svi_mesh", 3)]


@pytest.mark.parametrize("cls_name,field,value", [("MCMCProcess", f, v) for f, v in MCMC_CASES]
                         + [("SVIProcess", f, v) for f, v in SVI_CASES])
def test_field_checks_match_pydantic(cls_name, field, value):
    base = dict(MCMC_BASE if cls_name == "MCMCProcess" else SVI_BASE, numpyro_model=model)
    if field == "guide_class" and value == "AutoNormal":
        value = tsvi.AutoNormal
        jvalue = jinfer.AutoNormal
    elif field == "nuts_init_strategy" and value is init_to_mean:
        jvalue = jinfer.init_to_mean
    else:
        jvalue = value
    got, _ = _both(cls_name, **{**base, field: value})
    _, want = _both(cls_name, **{**base, field: jvalue})
    if isinstance(want, type):
        assert got is ValueError or (isinstance(got, type) and issubclass(got, ValueError)), got
        return
    assert not isinstance(got, type), f"the port refused {value!r}"
    if field not in ("guide_class", "nuts_init_strategy", "numpyro_model"):
        assert getattr(got, field) == getattr(want, field)
        assert type(getattr(got, field)) is type(getattr(want, field))


def test_defaults_match_jax():
    tm, jm = _both("MCMCProcess", numpyro_model=model, **MCMC_BASE)
    for name in ("mcmc_kwargs", "nuts_kwargs", "sampler", "progress_bar"):
        assert getattr(tm, name) == getattr(jm, name)
    ts, js = _both("SVIProcess", numpyro_model=model, **SVI_BASE)
    for name in ("num_starts", "init_jitter", "progress_bar", "guide_kwargs", "svi_mesh"):
        assert getattr(ts, name) == getattr(js, name)
    assert ts.guide_class.__name__ == js.guide_class.__name__ == "AutoMultivariateNormal"
    assert ts.optimizer.step_size == js.optimizer.step_size == 0.1
    # JAX's default key is PRNGKey(8675314); the port's default seed is that number
    assert tm.inference_prngkey == 8675314
    assert int(np.asarray(jax.random.key_data(jm.inference_prngkey)).reshape(-1)[-1]) == 8675314
    with pytest.raises(ValueError):
        MCMCProcess(numpyro_model=model, inference_prngkey=1.5, **MCMC_BASE)
    assert "numpyro_model" in dict(tm) and "_infer_calls" not in dict(tm)


def test_error_messages_match_jax():
    for port, ref in ((InferenceProcess(numpyro_model=model), jinfer.InferenceProcess(numpyro_model=model)),):
        for call in (lambda p: p.infer(), lambda p: p.get_samples(), lambda p: p.to_arviz()):
            with pytest.raises(NotImplementedError) as a:
                call(port)
            with pytest.raises(NotImplementedError) as b:
                call(ref)
            assert str(a.value) == str(b.value)
    tm, jm = _both("MCMCProcess", numpyro_model=model, sampler="hmc", **MCMC_BASE)
    for call in (lambda p: p.get_samples(), lambda p: p.warm_start_state(), lambda p: p.to_arviz()):
        with pytest.raises(AssertionError) as a:
            call(tm)
        with pytest.raises(AssertionError) as b:
            call(jm)
        assert str(a.value) == str(b.value)
    with pytest.raises(ValueError) as a:
        tm.infer(obs=OBS)
    with pytest.raises(ValueError) as b:
        jm.infer()
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_mcmc_process_infer_samples_and_arviz(sampler):
    chains = 2 if sampler == "nuts" else 8
    proc = MCMCProcess(numpyro_model=model, progress_bar=False, sampler=sampler, inference_prngkey=3,
                       **{**MCMC_BASE, "num_chains": chains})
    mcmc = proc.infer(obs=OBS)
    assert isinstance(mcmc, MCMC) and proc._infer_calls == 1
    samples = proc.get_samples()
    assert sorted(samples) == ["mu", "sd"] and samples["mu"].shape == (chains * 6,)
    grouped = proc.get_samples(group_by_chain=True, exclude_deterministic=False)
    assert sorted(grouped) == ["cv", "mu", "sd"] and grouped["cv"].shape == (chains, 6)
    idata = proc.to_arviz()
    assert idata.groups() == ["posterior", "posterior_predictive", "prior", "sample_stats", "log_likelihood",
                              "observed_data"]
    assert idata.posterior["mu"].shape == (chains, 6) and idata.posterior_predictive["y"].shape == (chains * 6, 6)
    assert idata.prior["y"].shape == (6, 6) and idata.log_likelihood["y"].shape == (chains * 6, 6)
    np.testing.assert_array_equal(idata.observed_data["y"], OBS.numpy())
    assert not np.array_equal(idata.posterior_predictive["y"][0], OBS.numpy())  # replicates, not the data
    assert np.isfinite(loo(idata).elpd)


@pytest.mark.parametrize("num_starts", [1, 3])
def test_svi_process_infer_samples_and_arviz(num_starts):
    proc = SVIProcess(numpyro_model=model, progress_bar=False, guide_init_strategy=init_to_mean, num_starts=num_starts,
                      inference_prngkey=torch.Generator().manual_seed(0), **SVI_BASE)
    svi = proc.infer(obs=OBS)
    assert isinstance(svi, tsvi.SVI)
    assert isinstance(proc._inference_state, tsvi.SVIMultiStartResult if num_starts > 1 else tsvi.SVIRunResult)
    samples = proc.get_samples()
    assert sorted(samples) == ["mu", "sd"] and samples["sd"].shape == (7,) and bool((samples["sd"] > 0).all())
    with_det = proc.get_samples(exclude_deterministic=False)
    assert sorted(with_det) == ["cv", "mu", "sd", "y"] and with_det["cv"].shape == (7,)
    idata = proc.to_arviz()
    assert idata.groups() == ["posterior", "posterior_predictive", "prior", "log_likelihood"]
    assert idata.posterior["mu"].shape == (1, 7) and idata.prior["mu"].shape == (5,)
    assert idata.log_likelihood["y"].shape == (7, 6)


def test_a_repeated_infer_draws_fresh_randomness():
    """The first ``infer()`` is ``MCMC.run(key)``; the second, from that
    run's warm start, takes ``call_seed(key, 1)``; a generator's stream
    simply moves on."""
    assert call_seed(5, 0) == 5 and call_seed(5, 1) == call_seed(5, 1) != call_seed(5, 2)
    gen = torch.Generator()
    assert call_seed(gen, 3) is gen
    proc = MCMCProcess(numpyro_model=model, progress_bar=False, inference_prngkey=5, **MCMC_BASE)
    first = proc.infer(obs=OBS).get_samples()["mu"]
    alone = MCMC(NUTS(model, max_tree_depth=3), num_warmup=10, num_samples=6, num_chains=2)
    alone.run(5, obs=OBS)
    assert torch.equal(first, alone.get_samples()["mu"])
    second = proc.infer(warm_start=proc.warm_start_state(), obs=OBS).get_samples()["mu"]
    replayed = MCMC(NUTS(model, max_tree_depth=3), num_warmup=10, num_samples=6, num_chains=2)
    replayed.run(5, warm_start=alone.warm_start_state(), obs=OBS)
    assert not torch.equal(second, replayed.get_samples()["mu"])
    again = MCMC(NUTS(model, max_tree_depth=3), num_warmup=10, num_samples=6, num_chains=2)
    again.run(call_seed(5, 1), warm_start=alone.warm_start_state(), obs=OBS)
    assert torch.equal(second, again.get_samples()["mu"])


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_nuts_kwargs_reach_the_kernel(sampler):
    proc = MCMCProcess(numpyro_model=model, progress_bar=False, sampler=sampler, num_samples=3, num_warmup=3,
                       num_chains=8, nuts_max_tree_depth=2,
                       nuts_kwargs={"batched_potential_fn": potential, "dense_mass": False})
    mcmc = proc.infer(obs=OBS)
    assert mcmc.kernel.batched_potential_fn is potential and mcmc.kernel.dense_mass is False
    assert mcmc.get_samples()["mu"].shape == (24,)
    if sampler == "nuts":
        assert MCMCProcess(numpyro_model=model, progress_bar=False, **MCMC_BASE).infer(obs=OBS).kernel.dense_mass is True


def test_processes_pass_a_mesh_through():
    """``MCMCProcess(mcmc_kwargs={"mesh": ...})`` and ``SVIProcess(svi_mesh=)``
    hand the mesh to ``MCMC`` and ``run_multistart``: the processes' draws
    equal the unsplit processes' bit for bit, over 4 CPU devices."""
    from dynode_tpu_torch.parallel import create_mesh

    cpu4 = [torch.device("cpu", i) for i in range(4)]
    draws = []
    for kwargs in ({}, {"mesh": create_mesh(("chain",), devices=cpu4)}):
        proc = MCMCProcess(numpyro_model=model, progress_bar=False, sampler="chees", inference_prngkey=3,
                           mcmc_kwargs=kwargs, nuts_kwargs={"batched_potential_fn": potential},
                           **{**MCMC_BASE, "num_chains": 8})
        mcmc = proc.infer(obs=OBS)
        assert mcmc.mesh is kwargs.get("mesh")
        draws.append(proc.get_samples()["mu"])
    assert torch.equal(draws[0], draws[1])
    fits = []
    for mesh in (None, create_mesh(("start",), devices=cpu4)):
        proc = SVIProcess(numpyro_model=model, progress_bar=False, guide_init_strategy=init_to_mean, num_starts=4,
                          svi_mesh=mesh, inference_prngkey=torch.Generator().manual_seed(0), **SVI_BASE)
        proc.infer(obs=OBS)
        fits.append(proc._inference_state)
    assert torch.equal(fits[0].final_elbos, fits[1].final_elbos)
    assert int(fits[0].best_idx) == int(fits[1].best_idx)
