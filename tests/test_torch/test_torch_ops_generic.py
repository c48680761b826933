"""The generic rows-RHS ensemble solve of the port against the JAX package.

On the CPU, ``ensemble_solve_kernel`` runs its plain version; it is held
against ``dynode_tpu.ops.ensemble_solve_kernel`` on the CPU, which runs the
JAX plain version (``ensemble_solve_kernel_reference``). The Triton kernel
itself is compared with the plain version on the card by
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.ops.generic_pallas as jgp
import dynode_tpu.ops.multistrain_pallas as jmp
from dynode_tpu.models.multistrain import multistrain_config, multistrain_odeparams
from dynode_tpu_torch.ops import generic as tg
from dynode_tpu_torch.ops import multistrain as tms


def sir_rows(y, p, t):
    """SIR in the rows idiom: y = [s, i, r], p = [beta, gamma]."""
    s, i, r = y
    beta, gamma = p
    inf = beta * s * i
    rec = gamma * i
    return [-inf, inf - rec, rec]


def _sir_inputs(batch, seed):
    rng = np.random.default_rng(seed)
    y0 = np.stack([np.full(batch, 0.99), np.full(batch, 0.01), np.zeros(batch)])
    p = np.stack([rng.uniform(0.2, 0.5, batch), np.full(batch, 0.1)])
    return y0.astype(np.float32), p.astype(np.float32)


def _both(rhs, y0, p, **kw):
    want = jgp.ensemble_solve_kernel(rhs, jnp.asarray(y0),
                                     None if p is None else jnp.asarray(p), **kw)
    got = tg.ensemble_solve_kernel(rhs, torch.as_tensor(y0),
                                   None if p is None else torch.as_tensor(p), **kw)
    return got, np.asarray(want)


def test_pack_unpack_rows_roundtrip():
    """Tolerance: exact -- packing only moves values; matches the JAX packing."""
    B = 16
    leaves = [
        np.arange(2 * 3 * B, dtype=np.float32).reshape(2, 3, B),
        np.arange(B, dtype=np.float32),
        np.float32(7.0),
    ]
    packed, spec = tg.pack_rows([torch.as_tensor(x) for x in leaves], B)
    jpacked, jspec = jgp.pack_rows([jnp.asarray(x) for x in leaves], B)
    assert spec == jspec
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    out = tg.unpack_rows(packed, spec)
    np.testing.assert_array_equal(out[0].numpy(), leaves[0])
    np.testing.assert_array_equal(out[1].numpy(), leaves[1])
    assert np.all(out[2].numpy() == 7.0)
    out_t = tg.unpack_rows(torch.stack([packed, packed + 1.0]), spec)
    assert out_t[0].shape == (2, 2, 3, B)


@pytest.mark.parametrize("method", ["tsit5", "bosh3", "rk4"])
def test_methods_match_jax_on_sir(method):
    """B = 32, 40 days at dt = 0.5. Tolerance: max |diff| <= 1e-5 * max |JAX|:
    float32 in the same order on both sides; XLA may contract multiply-adds."""
    y0, p = _sir_inputs(32, seed=3)
    got, want = _both(sir_rows, y0, p, duration=40.0, dt=0.5, method=method)
    assert got.shape == want.shape == (41, 3, 32)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("method", ["tsit5", "bosh3", "rk4"])
def test_methods_match_jax_on_multistrain_rows(method):
    """The multi-strain rows-RHS (the bench's stage-2 RHS), B = 16, 40 days.
    Tolerance as the SIR case."""
    p = multistrain_odeparams(multistrain_config())
    B = 16
    scales = np.random.default_rng(4).uniform(0.6, 1.6, B)
    beta = (np.asarray(p.beta)[None, :] * scales[:, None]).astype(np.float32)
    rates = [np.asarray(getattr(p, n), np.float32) for n in ("sigma", "gamma", "omega")]
    y_packed = np.array(jmp.pack_state(jmp_state(), B))
    p_packed = np.array(jmp.pack_params(beta, *rates, B))
    contact = tuple(tuple(float(v) for v in row) for row in np.asarray(p.contact_matrix))

    def jax_rhs(y, pr, t):
        K = 3
        return jmp._rhs_rows(y, contact, pr[:K], pr[K:2 * K], pr[2 * K:3 * K],
                             pr[3 * K:4 * K], 2, 3)

    kw = dict(duration=40.0, dt=0.5, method=method)
    want = np.asarray(jgp.ensemble_solve_kernel(jax_rhs, y_packed, p_packed, **kw))
    rhs = tms.multistrain_rows_rhs(torch.tensor(np.asarray(p.contact_matrix)))
    got = tg.ensemble_solve_kernel(rhs, torch.as_tensor(y_packed), torch.as_tensor(p_packed), **kw)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))


def jmp_state():
    from dynode_tpu.models.multistrain import multistrain_initial_state

    return tuple(np.asarray(x, np.float32)
                 for x in multistrain_initial_state(multistrain_config()))


def test_t0_and_no_params_match_jax():
    """Time-dependent RHS with ``t0`` and ``p_rows=None``: y' = cos(t).
    Tolerance: atol 1e-6 -- the port computes each step's start time as
    ``t0 + (n - 1) * dt`` (as the JAX kernel does), the JAX plain version
    accumulates ``t += dt``; both are float32."""

    def rhs(y, p, t):
        c = jnp.cos(t) if isinstance(t, jnp.ndarray) else torch.cos(t)
        return [c * (y[0] * 0.0 + 1.0)]

    y0 = np.zeros((1, 8), np.float32)
    got, want = _both(rhs, y0, None, duration=4.0, dt=0.25, t0=0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, 0, 0], np.sin(0.5 + np.arange(5)) - np.sin(0.5),
                               rtol=0, atol=5e-6)


def test_save_rows_padded_bf16_match_jax():
    """``save_rows`` in any order, bf16 saves, the padded layout.
    Tolerance: rtol 2**-8 (one bf16 ulp) -- both round to bf16 (nearest
    even) float32 values that agree to 1e-5, so a value next to a rounding
    boundary may land one bf16 ulp apart."""
    y0, p = _sir_inputs(24, seed=5)
    kw = dict(duration=10.0, dt=0.5, save_rows=(2, 0), save_dtype=None, padded_rows=True)
    want = np.asarray(jgp.ensemble_solve_kernel(
        sir_rows, jnp.asarray(y0), jnp.asarray(p), **{**kw, "save_dtype": jnp.bfloat16}
    ).astype(jnp.float32))
    got = tg.ensemble_solve_kernel(sir_rows, torch.as_tensor(y0), torch.as_tensor(p),
                                   **{**kw, "save_dtype": torch.bfloat16})
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (11, 8, 24)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=0)
    assert not got[:, 2:].any()
    exact = tg.ensemble_solve_kernel(sir_rows, torch.as_tensor(y0), torch.as_tensor(p),
                                     duration=10.0, dt=0.5, save_rows=(2, 0))
    assert exact.shape == (11, 2, 24)
    assert torch.equal(exact.to(torch.bfloat16), got[:, :2])


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(duration=1.0, dt=0.5, method="dopri9"), "unknown method"),
        (dict(duration=1.3, dt=0.5), "whole number"),
        (dict(duration=3.0, dt=0.5, save_every=2.0), "whole strides"),
        (dict(duration=1.0, dt=0.5, save_rows=(3,)), "out of range"),
        (dict(duration=1.0, dt=0.5, save_rows=()), "at least one row"),
    ],
)
def test_validation_errors_match_jax(kwargs, match):
    """The same ValueErrors, with the same messages, as the JAX entry point."""
    y0 = np.zeros((3, 8), np.float32)
    with pytest.raises(ValueError, match=match):
        jgp.ensemble_solve_kernel(sir_rows, jnp.asarray(y0), **kwargs)
    with pytest.raises(ValueError, match=match):
        tg.ensemble_solve_kernel(sir_rows, torch.as_tensor(y0), **kwargs)


def test_validation_shape_and_dtype():
    with pytest.raises(ValueError, match="must be \\(R, B\\)"):
        tg.ensemble_solve_kernel(sir_rows, torch.zeros(8), duration=1.0, dt=0.5)
    with pytest.raises(ValueError, match="save_dtype"):
        tg.ensemble_solve_kernel(sir_rows, torch.zeros(3, 8), duration=1.0, dt=0.5,
                                 save_dtype=torch.float16)


@pytest.mark.parametrize("block_b", [None, 8, 64])
def test_block_b_keyword_takes_the_jax_call_form(block_b):
    """``block_b`` is the JAX entry point's lane-block width: the port
    accepts it, gives the result of the call without it (bit for bit: the
    kernel picks its own width and masks a ragged batch) and agrees with
    the JAX call of the same form within the tolerance of
    ``test_methods_match_jax_on_sir`` (1e-5 relative)."""
    y0, p = _sir_inputs(64, seed=11)
    kw = dict(duration=20.0, dt=0.5, block_b=block_b)
    got, want = _both(sir_rows, y0, p, **kw)
    plain = tg.ensemble_solve_kernel(sir_rows, torch.as_tensor(y0), torch.as_tensor(p),
                                     duration=20.0, dt=0.5)
    assert torch.equal(got, plain)
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("block_b", [0, -64])
def test_block_b_must_be_positive(block_b):
    y0, p = _sir_inputs(8, seed=12)
    with pytest.raises(ValueError, match="block_b must be positive"):
        tg.ensemble_solve_kernel(sir_rows, torch.as_tensor(y0), torch.as_tensor(p),
                                 duration=2.0, dt=0.5, block_b=block_b)
