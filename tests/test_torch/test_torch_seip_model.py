"""SEIP model, defaults, splines and conversion against the JAX package.

Inputs are drawn with numpy from a seed and handed to both sides. The root
conftest turns on JAX x64, so the JAX side works in float64; a float32 case
casts every JAX input to float32 first.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynode_tpu.config import SolverParams
from dynode_tpu.models import seip as js
from dynode_tpu.utils import splines as jspl
from dynode_tpu_torch import convert
from dynode_tpu_torch.models import seip as ts
from dynode_tpu_torch.utils import splines as tspl

TENSOR_FIELDS = [f.name for f in dataclasses.fields(ts.SEIPParams)
                 if f.name not in ("idx", "seasonal_vaccination")]


def _jax_side(seasonal):
    cfg = js.seip_config(seasonal_vaccination=seasonal,
                         solver_params=SolverParams(constant_step_size=0.5))
    return js.seip_odeparams(cfg), js.seip_initial_state(cfg)


@pytest.mark.parametrize("t", [-3.0, 0.0, 2.5, 10.0, 17.25, 40.0])
def test_splines_match_jax(t):
    """Random coefficients, ``t`` before, on, between and after the knots
    (0, 10, 30). Tolerance: rtol 1e-13 in float64 (the same formula; the
    powers may round differently)."""
    rng = np.random.default_rng(3)
    knots = np.broadcast_to(np.array([0.0, 10.0, 30.0]), (4, 3, 3)).copy()
    base = rng.normal(0.0, 1e-3, (4, 3, 4))
    kcoef = rng.normal(0.0, 1e-5, (4, 3, 3))
    for name in ("base_equation", "conditional_knots", "evaluate_cubic_spline"):
        args = {"base_equation": (base,), "conditional_knots": (knots, kcoef),
                "evaluate_cubic_spline": (knots, base, kcoef)}[name]
        want = np.asarray(getattr(jspl, name)(t, *(jnp.asarray(a) for a in args)))
        got = getattr(tspl, name)(t, *(torch.as_tensor(a) for a in args)).numpy()
        assert got.shape == want.shape == (4, 3)
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-18)


@pytest.mark.parametrize("seasonal", [True, False])
def test_default_params_and_state_equal_config(seasonal):
    """``seip_default_params`` / ``seip_initial_state`` against
    ``seip_odeparams(seip_config(...))`` / ``seip_initial_state``, field by
    field. Tolerance: exact in float64 (the same float64 arithmetic)."""
    jp, jy = _jax_side(seasonal)
    tp = ts.seip_default_params(seasonal, dtype=torch.float64, device="cpu")
    ty = ts.seip_initial_state(seasonal, dtype=torch.float64, device="cpu")
    assert tp.seasonal_vaccination is jp.seasonal_vaccination is seasonal
    for name in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert ty[0].shape[2] == (4 if seasonal else 3)
    for got, want in zip(ty, jy):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_from_jax_values():
    """Tolerance: exact -- conversion is a cast of the numpy values."""
    jp, jy = _jax_side(True)
    params = convert.seip_params_from_numpy(jp, dtype=torch.float64, device="cpu")
    as_map = convert.seip_params_from_numpy(
        {**{k: np.asarray(getattr(jp, k)) for k in TENSOR_FIELDS}, "seasonal_vaccination": True},
        device="cpu")
    for name in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(params, name).numpy(), np.asarray(getattr(jp, name)))
        assert getattr(as_map, name).dtype == torch.float32
    assert params.seasonal_vaccination is True and as_map.seasonal_vaccination is True
    state = convert.seip_state_from_numpy(tuple(np.asarray(x) for x in jy), device="cpu")
    assert [x.dtype for x in state] == [torch.float32] * 4
    np.testing.assert_array_equal(state[0].numpy(), np.asarray(jy[0], np.float32))
    with pytest.raises(ValueError, match="S, E, I, C"):
        convert.seip_state_from_numpy(tuple(np.asarray(x) for x in jy[:3]), device="cpu")


def _random_state(rng, jy, batch=None):
    tail = () if batch is None else (batch,)
    return tuple(rng.uniform(0.0, 2000.0, np.asarray(c).shape + tail) for c in jy)


def _cast(jp, dtype):
    return jp.replace(**{k: jnp.asarray(getattr(jp, k), dtype) for k in TENSOR_FIELDS})


@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-12), (np.float32, 1e-6)])
@pytest.mark.parametrize("seasonal", [True, False])
def test_seip_ode_matches_jax(seasonal, dtype, rtol):
    """Random states, at days before and during the second strain's
    introduction. Tolerance: max |diff| <= rtol * max |JAX| per compartment
    (the same formula; the small contractions sum in another order)."""
    jp, jy = _jax_side(seasonal)
    rng = np.random.default_rng(40 + seasonal)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tp = convert.seip_params_from_numpy(jp, dtype=tdt, device="cpu")
    for t in (0.7, 58.3):
        state = _random_state(rng, jy)
        want = js.seip_ode(t, tuple(jnp.asarray(x, dtype) for x in state), _cast(jp, dtype))
        got = ts.seip_ode(t, tuple(torch.as_tensor(x, dtype=tdt) for x in state), tp)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == tdt and g.shape == w.shape
            assert np.max(np.abs(g.numpy() - w)) <= rtol * np.max(np.abs(w))


@pytest.mark.parametrize("per_strain", [False, True])
@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_seip_ode_ensemble_matches_jax(dtype, rtol, per_strain):
    """B = 8 members with ``(B,)`` or ``(L, B)`` scales. Tolerance as the
    single-trajectory RHS."""
    jp, jy = _jax_side(True)
    rng = np.random.default_rng(50 + per_strain)
    B = 8
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    state = _random_state(rng, jy, B)
    scales = rng.uniform(0.85, 1.2, (2, B) if per_strain else B)
    want = js.seip_ode_ensemble(
        61.2, tuple(jnp.asarray(x, dtype) for x in state),
        js.seip_ensemble_params(_cast(jp, dtype), jnp.asarray(scales, dtype)))
    tp = ts.seip_ensemble_params(convert.seip_params_from_numpy(jp, dtype=tdt, device="cpu"),
                                 torch.as_tensor(scales, dtype=tdt))
    assert tp.beta.shape == (2, B)
    got = ts.seip_ode_ensemble(61.2, tuple(torch.as_tensor(x, dtype=tdt) for x in state), tp)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g.numpy() - w)) <= rtol * np.max(np.abs(w))


def test_ensemble_state_broadcast_matches_jax():
    """Tolerance: exact -- a broadcast."""
    _, jy = _jax_side(True)
    want = js.seip_ensemble_state(jy, 5)
    got = ts.seip_ensemble_state(convert.seip_state_from_numpy(jy, dtype=torch.float64, device="cpu"), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
