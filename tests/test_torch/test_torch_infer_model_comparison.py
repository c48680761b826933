"""PSIS-LOO, WAIC, LOO-PIT and ``compare`` of the port against the JAX
package on fixed log-likelihood arrays (numpy in float64 on both sides):
every estimate, Pareto k and pointwise value within 1e-12, given numpy
arrays, tensors, a dict of sites or an ``InferenceData``."""

import warnings

import numpy as np
import pytest
import torch

import dynode_tpu.infer.model_comparison as jmc
from dynode_tpu.infer import from_dynode as j_from_dynode
from dynode_tpu_torch.infer import from_dynode
from dynode_tpu_torch.infer import model_comparison as tmc

TOL = 1e-12


def _log_lik(seed, draws=400, n_obs=12, heavy=False):
    """A (draws, n_obs) pointwise log-likelihood: Normal data under a
    posterior; ``heavy`` makes a few observations outliers (large k)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0.0, 1.0, n_obs)
    if heavy:
        y[:3] += 6.0
    mu = rng.normal(0.0, 0.3, draws)[:, None]
    sd = np.exp(rng.normal(0.0, 0.1, draws))[:, None]
    return -0.5 * ((y[None] - mu) / sd) ** 2 - np.log(sd) - 0.5 * np.log(2 * np.pi), y, mu, sd


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("reff", [1.0, 0.4])
def test_psislw_matches_jax(heavy, reff):
    ll, *_ = _log_lik(1, heavy=heavy)
    lw, k = tmc.psislw(torch.as_tensor(-ll), reff=reff)
    jlw, jk = jmc.psislw(-ll, reff=reff)
    _close(lw, jlw)
    _close(k, jk)
    lw1, k1 = tmc.psislw(-ll[:, 0], reff=reff)
    jlw1, jk1 = jmc.psislw(-ll[:, 0], reff=reff)
    _close(lw1, jlw1)
    assert k1 == pytest.approx(jk1, rel=TOL)
    constant, k_const = tmc.psislw(np.zeros((50, 2)))
    assert np.all(k_const == -np.inf) and np.allclose(np.exp(constant).sum(axis=0), 1.0)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("form", ["array", "tensor", "dict", "idata"])
def test_loo_and_waic_match_jax(heavy, form):
    ll, *_ = _log_lik(2, heavy=heavy)
    inputs = {
        "array": (ll, ll),
        "tensor": (torch.as_tensor(ll), ll),
        "dict": ({"a": torch.as_tensor(ll[:, :5]), "b": torch.as_tensor(ll[:, 5:].reshape(400, 7, 1))},
                 {"a": ll[:, :5], "b": ll[:, 5:].reshape(400, 7, 1)}),
        "idata": (from_dynode(log_likelihood={"y": torch.as_tensor(ll)}), j_from_dynode(log_likelihood={"y": ll})),
    }[form]
    for fn in ("loo", "waic"):
        kw = {"n_chains": 4} if fn == "loo" else {}
        with warnings.catch_warnings(record=True) as mine:
            warnings.simplefilter("always")
            got = getattr(tmc, fn)(inputs[0], **kw)
        with warnings.catch_warnings(record=True) as theirs:
            warnings.simplefilter("always")
            want = getattr(jmc, fn)(inputs[1], **kw)
        assert [str(w.message) for w in mine] == [str(w.message) for w in theirs]
        assert (got.kind, got.n_samples, got.n_data_points, got.warning) == (
            want.kind, want.n_samples, want.n_data_points, want.warning)
        for name in ("elpd", "se", "p"):
            assert getattr(got, name) == pytest.approx(getattr(want, name), rel=TOL)
        _close(got.elpd_i, want.elpd_i)
        if fn == "loo":
            _close(got.pareto_k, want.pareto_k)
        assert repr(got) == repr(want)


def test_loo_pit_and_compare_match_jax():
    ll, y, mu, sd = _log_lik(3)
    rng = np.random.default_rng(4)
    y_rep = mu + sd * rng.normal(size=(400, 12))
    _close(tmc.loo_pit(torch.as_tensor(y), torch.as_tensor(y_rep), torch.as_tensor(ll)), jmc.loo_pit(y, y_rep, ll))
    other, *_ = _log_lik(3, heavy=True)
    for ic in ("loo", "waic"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = tmc.compare({"good": ll, "worse": torch.as_tensor(other), "scored": tmc.waic(ll) if ic == "waic"
                               else tmc.loo(ll)}, ic=ic)
            want = jmc.compare({"good": ll, "worse": other, "scored": jmc.waic(ll) if ic == "waic" else jmc.loo(ll)}, ic=ic)
        assert list(got) == list(want)
        for name in want:
            assert got[name].keys() == want[name].keys()
            for key, value in want[name].items():
                assert got[name][key] == pytest.approx(value, rel=TOL, abs=TOL), (name, key)
    with pytest.raises(AssertionError):
        tmc.compare({"a": ll}, ic="bic")
    with pytest.raises(AssertionError, match="across criteria"):
        tmc.compare({"a": tmc.loo(ll), "b": tmc.waic(ll)})
