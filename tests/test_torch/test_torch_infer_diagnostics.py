"""The port's ``infer.diagnostics`` against ``dynode_tpu.infer.diagnostics``.

Inputs are seeded with numpy: well-mixed, autocorrelated (AR(1)), heavy-
tailed and constant chains. Tolerance 1e-12 relative in float64 (NaN where
JAX has NaN). Each function also takes a tensor, which it moves to the CPU
and casts to float64 first.
"""

import math

import numpy as np
import pytest
import torch

import dynode_tpu.infer.diagnostics as jdiag
import dynode_tpu_torch.infer.diagnostics as tdiag

RTOL = 1e-12


def _chains(kind, m=4, n=64, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "iid":
        return rng.normal(size=(m, n))
    if kind == "ar1":
        x = np.zeros((m, n))
        e = rng.normal(size=(m, n))
        for t in range(1, n):
            x[:, t] = 0.9 * x[:, t - 1] + e[:, t]
        return x + rng.normal(size=(m, 1))
    if kind == "heavy":
        return rng.standard_cauchy(size=(m, n))
    if kind == "short":
        return rng.normal(size=(m, 3))
    if kind == "one_chain":
        return rng.normal(size=(n,))
    if kind == "constant":
        return np.full((m, n), 1.5)
    raise ValueError(kind)


KINDS = ["iid", "ar1", "heavy", "short", "one_chain", "constant"]
SCALARS = ["effective_sample_size", "ess_bulk", "ess_tail", "mcse_mean", "split_rhat"]


def _close(got, want):
    if math.isnan(want):
        return math.isnan(got)
    return abs(got - want) <= RTOL * max(abs(want), 1e-300)


@pytest.mark.parametrize("fn", SCALARS)
@pytest.mark.parametrize("kind", KINDS)
def test_scalar_diagnostics_match_jax(fn, kind):
    x = _chains(kind)
    want = getattr(jdiag, fn)(x)
    assert _close(getattr(tdiag, fn)(x), want)
    assert _close(getattr(tdiag, fn)(torch.as_tensor(x)), want)


@pytest.mark.parametrize("prob", [0.5, 0.9])
@pytest.mark.parametrize("kind", ["iid", "heavy", "short"])
def test_hdi_matches_jax(kind, prob):
    x = _chains(kind)
    np.testing.assert_allclose(tdiag.hdi(torch.as_tensor(x), prob), jdiag.hdi(x, prob), rtol=RTOL)


def test_float32_tensor_is_cast_to_float64_first():
    x32 = _chains("ar1").astype(np.float32)
    assert _close(tdiag.effective_sample_size(torch.as_tensor(x32)),
                  jdiag.effective_sample_size(x32.astype(np.float64)))


def test_summary_matches_jax():
    rng = np.random.default_rng(5)
    samples = {"a": rng.normal(size=(4, 50)), "b": rng.normal(size=(4, 50, 2, 3)) + 1.0}
    want = jdiag.summary(samples)
    got = tdiag.summary({k: torch.as_tensor(v) for k, v in samples.items()})
    assert list(got) == list(want)
    for site in want:
        assert list(got[site]) == list(want[site])
        for stat, value in want[site].items():
            assert _close(got[site][stat], value), (site, stat)
