"""Multi-strain model, defaults and conversion against the JAX package.

Inputs are drawn with numpy from a seed and handed to both sides. The root
conftest turns on JAX x64, so every JAX input is cast to the dtype stated in
the test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.ops.multistrain_pallas as jmp
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_ensemble_params,
    multistrain_ensemble_state,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_ode_ensemble,
    multistrain_odeparams,
)
from dynode_tpu_torch import convert
from dynode_tpu_torch.models import multistrain as tm
from dynode_tpu_torch.ops import multistrain as tops

# (A, K) shapes and the config arguments that give them
SHAPES = {
    (2, 3): {},
    (3, 2): dict(
        r0s=(2.0, 2.5), infectious_periods=(7.0, 6.0), latent_periods=(3.0, 2.5),
        waning_periods=(60.0, 80.0), strain_names=("A", "B"),
        age_names=("young", "mid", "old"), age_demographics=(0.4, 0.4, 0.2),
    ),
}


def _jax_side(shape):
    cfg = multistrain_config(**SHAPES[shape])
    return multistrain_odeparams(cfg), multistrain_initial_state(cfg)


def _port_defaults(shape, dtype=torch.float64):
    kw = SHAPES[shape]
    if not kw:
        return (tm.multistrain_default_params(dtype=dtype, device="cpu"),
                tm.multistrain_initial_state(dtype=dtype, device="cpu"))
    params = tm.multistrain_default_params(
        kw["r0s"], kw["infectious_periods"], kw["latent_periods"],
        kw["waning_periods"], n_age=len(kw["age_names"]), dtype=dtype, device="cpu",
    )
    state = tm.multistrain_initial_state(kw["r0s"], kw["age_demographics"], dtype=dtype,
                                     device="cpu")
    return params, state


@pytest.mark.parametrize("shape", list(SHAPES))
def test_default_params_and_state_equal_config(shape):
    """Tolerance: exact in float64 -- the same float64 arithmetic on both sides."""
    jp, jy = _jax_side(shape)
    tp, ty = _port_defaults(shape)
    for name in ("beta", "sigma", "gamma", "omega", "contact_matrix"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    for got, want in zip(ty, jy):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_from_jax_values():
    """Tolerance: exact -- conversion is a cast of the numpy values."""
    jp, jy = _jax_side((2, 3))
    params = convert.params_from_numpy(jp, dtype=torch.float64, device="cpu")
    as_map = convert.params_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in
         ("beta", "sigma", "gamma", "omega", "contact_matrix")},
        dtype=torch.float32, device="cpu",
    )
    state = convert.state_from_numpy(tuple(np.asarray(x) for x in jy), device="cpu")
    np.testing.assert_array_equal(params.beta.numpy(), np.asarray(jp.beta))
    np.testing.assert_array_equal(params.contact_matrix.numpy(), np.asarray(jp.contact_matrix))
    assert as_map.omega.dtype == torch.float32
    np.testing.assert_array_equal(as_map.omega.numpy(), np.asarray(jp.omega, np.float32))
    assert [x.dtype for x in state] == [torch.float32] * 5
    np.testing.assert_array_equal(state[2].numpy(), np.asarray(jy[2], np.float32))
    with pytest.raises(ValueError, match="s, e, i, r, c"):
        convert.state_from_numpy(tuple(np.asarray(x) for x in jy[:4]), device="cpu")


def _random_state(rng, A, K, batch=None):
    tail = () if batch is None else (batch,)
    s = rng.uniform(100.0, 700.0, (A, *tail))
    e, i, r, c = (rng.uniform(0.0, 50.0, (A, K, *tail)) for _ in range(4))
    return s, e, i, r, c


@pytest.mark.parametrize("shape", list(SHAPES))
def test_multistrain_ode_matches_jax(shape):
    """Tolerance: rtol 1e-6 in float32 -- same formula, the summation order
    of the A x A contraction may differ by an ulp or two."""
    A, K = shape
    rng = np.random.default_rng(10 + A)
    jp, _ = _jax_side(shape)
    state = _random_state(rng, A, K)
    want = multistrain_ode(0.0, tuple(jnp.asarray(x, jnp.float32) for x in state),
                           jp.replace(beta=jnp.asarray(jp.beta, jnp.float32),
                                      sigma=jnp.asarray(jp.sigma, jnp.float32),
                                      gamma=jnp.asarray(jp.gamma, jnp.float32),
                                      omega=jnp.asarray(jp.omega, jnp.float32),
                                      contact_matrix=jnp.asarray(jp.contact_matrix, jnp.float32)))
    tp = convert.params_from_numpy(jp, device="cpu")
    got = tm.multistrain_ode(0.0, convert.state_from_numpy(state, device="cpu"), tp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_multistrain_ode_ensemble_matches_jax(shape):
    """Tolerance: rtol 1e-6 in float32 (as the single-trajectory RHS)."""
    A, K = shape
    B = 16
    rng = np.random.default_rng(20 + A)
    jp, _ = _jax_side(shape)
    state = _random_state(rng, A, K, B)
    scales = rng.uniform(0.6, 1.6, B)
    jp32 = jp.replace(**{k: jnp.asarray(getattr(jp, k), jnp.float32) for k in
                         ("beta", "sigma", "gamma", "omega", "contact_matrix")})
    want = multistrain_ode_ensemble(
        0.0, tuple(jnp.asarray(x, jnp.float32) for x in state),
        multistrain_ensemble_params(jp32, jnp.asarray(scales, jnp.float32)),
    )
    tp = tm.multistrain_ensemble_params(
        convert.params_from_numpy(jp, device="cpu"), torch.as_tensor(scales, dtype=torch.float32)
    )
    got = tm.multistrain_ode_ensemble(0.0, convert.state_from_numpy(state, device="cpu"), tp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_ensemble_state_broadcast_matches_jax():
    """Tolerance: exact -- a broadcast."""
    _, jy = _jax_side((2, 3))
    want = multistrain_ensemble_state(jy, 5)
    got = tm.multistrain_ensemble_state(convert.state_from_numpy(jy, dtype=torch.float64, device="cpu"), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_rhs_rows_matches_jax(shape):
    """Tolerance: exact in float32 -- the same row operations in the same
    order on both sides."""
    A, K = shape
    B = 32
    rng = np.random.default_rng(30 + A)
    jp, _ = _jax_side(shape)
    d = A + 4 * A * K
    y = rng.uniform(1.0, 400.0, (d, B)).astype(np.float32)
    p = (np.asarray(jp.beta)[:, None] * rng.uniform(0.6, 1.6, (K, B))).astype(np.float32)
    rates = [p] + [np.broadcast_to(np.asarray(getattr(jp, n), np.float32)[:, None], (K, B))
                   for n in ("sigma", "gamma", "omega")]
    contact = tuple(tuple(float(v) for v in row) for row in np.asarray(jp.contact_matrix))
    want = jmp._rhs_rows([jnp.asarray(row) for row in y], contact,
                         *[[jnp.asarray(x[k]) for k in range(K)] for x in rates], A, K)
    got = tops._rhs_rows([torch.as_tensor(row) for row in y], contact,
                         *[[torch.as_tensor(np.ascontiguousarray(x[k])) for k in range(K)]
                           for x in rates], A, K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7, atol=0)
