"""The adaptive (lockstep-dt) rows-RHS solve of the port against the JAX package.

On the CPU, ``ensemble_solve_kernel_adaptive`` runs its plain version,
``ensemble_solve_kernel_adaptive_reference``. With one block of the whole
batch that is the JAX reference; with narrower blocks it is held against
the JAX kernel run in interpret mode, as the JAX package's own tests run it.
The Triton kernel itself is compared with the plain version on the card by
``test_torch_cuda.py``.

Tolerances: the controller's decisions (accepted, rejected and exhausted
counts) must be equal exactly; saves within rtol 2e-6, atol 1e-7, the bounds
of the JAX package's interpret-mode test (float32 on both sides, the same
expression order; XLA may contract a multiply-add the plain loop does not).
"""

import functools
import unittest.mock as um

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import dynode_tpu.ops.generic_pallas as jgp
import dynode_tpu.ops.multistrain_pallas as jmp
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_odeparams,
)
from dynode_tpu_torch.ode import solvers as tsolvers
from dynode_tpu_torch.ops import generic as tg
from dynode_tpu_torch.ops import multistrain as tms

STATS = ("exhausted_intervals", "n_accepted", "n_rejected")


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


def _multistrain_inputs(batch, seed):
    """Packed multi-strain rows and the JAX and port forms of its rows-RHS."""
    cfg = multistrain_config()
    p = multistrain_odeparams(cfg)
    scales = np.random.default_rng(seed).uniform(0.6, 1.6, batch)
    beta = (np.asarray(p.beta)[None, :] * scales[:, None]).astype(np.float32)
    rates = [np.asarray(getattr(p, n), np.float32) for n in ("sigma", "gamma", "omega")]
    y0 = tuple(np.asarray(x, np.float32) for x in multistrain_initial_state(cfg))
    y_packed = np.array(jmp.pack_state(y0, batch))
    p_packed = np.array(jmp.pack_params(beta, *rates, batch))
    contact = tuple(tuple(float(v) for v in row) for row in np.asarray(p.contact_matrix))

    def jax_rhs(y, pr, t):
        return jmp._rhs_rows(y, contact, pr[:3], pr[3:6], pr[6:9], pr[9:12], 2, 3)

    port_rhs = tms.multistrain_rows_rhs(torch.tensor(np.asarray(p.contact_matrix)))
    return y_packed, p_packed, jax_rhs, port_rhs


def _assert_close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-6, atol=1e-7)


def _assert_stats_equal(got, want):
    for key in STATS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def _interpret_kernel(*args, **kwargs):
    """The JAX kernel in interpret mode, as ``tests/test_ops`` runs it."""
    orig = pl.pallas_call
    jgp.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        with um.patch.object(jgp.jax, "default_backend", lambda: "tpu"):
            return jgp.ensemble_solve_kernel_adaptive(*args, **kwargs)
    finally:
        jgp.pl.pallas_call = orig


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_adaptive_methods_equal_jax(method):
    """Tolerance: none -- the same Python floats."""
    assert tsolvers.ADAPTIVE_METHODS[method] == jgp._ADAPTIVE_METHODS[method]


@pytest.mark.parametrize("t0", [0.0, 3.0])
@pytest.mark.parametrize("model", ["sir", "multistrain"])
@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_plain_one_block_matches_jax_reference(method, model, t0):
    """``block_b = batch`` is the JAX reference: SIR at B = 64 over 20 days
    (rtol 1e-5, atol 1e-8), the multi-strain rows-RHS at B = 32 over 40 days
    at the bench's rtol 1e-4, atol 1e-6."""
    if model == "sir":
        B = 64
        y0, p = _sir_inputs(B, seed=5)
        jax_rhs = port_rhs = sir_rows
        kw = dict(duration=20.0, rtol=1e-5, atol=1e-8)
    else:
        B = 32
        y0, p, jax_rhs, port_rhs = _multistrain_inputs(B, seed=6)
        kw = dict(duration=40.0, rtol=1e-4, atol=1e-6)
    kw.update(method=method, t0=t0)
    want, wstats = jgp.ensemble_solve_kernel_adaptive_reference(
        jax_rhs, jnp.asarray(y0), jnp.asarray(p), **kw)
    got, stats = tg.ensemble_solve_kernel_adaptive_reference(
        port_rhs, torch.as_tensor(y0), torch.as_tensor(p), block_b=B, **kw)
    assert got.shape == want.shape and stats["n_accepted"].shape == (1,)
    _assert_stats_equal(stats, wstats)
    _assert_close(got, want)
    # the entry point on CPU tensors is the plain version
    entry, estats = tg.ensemble_solve_kernel_adaptive(
        port_rhs, torch.as_tensor(y0), torch.as_tensor(p), block_b=B, **kw)
    assert torch.equal(entry, got)
    _assert_stats_equal(estats, wstats)


@pytest.mark.parametrize(
    "method, rtol, atol", [("bosh3", 1e-5, 1e-8), ("tsit5", 1e-6, 1e-9)],
)
def test_plain_rejections_match_jax_reference(method, rtol, atol):
    """A first step of a whole save interval (``dt0 = 1``) is rejected and
    shrunk: the reject path's decisions and the saves match the JAX
    reference (SIR, B = 64, 20 days)."""
    y0, p = _sir_inputs(64, seed=5)
    kw = dict(duration=20.0, rtol=rtol, atol=atol, dt0=1.0, method=method)
    want, wstats = jgp.ensemble_solve_kernel_adaptive_reference(
        sir_rows, jnp.asarray(y0), jnp.asarray(p), **kw)
    got, stats = tg.ensemble_solve_kernel_adaptive_reference(
        sir_rows, torch.as_tensor(y0), torch.as_tensor(p), **kw)
    assert int(stats["n_rejected"][0]) > 0
    _assert_stats_equal(stats, wstats)
    _assert_close(got, want)


def _sir_nan(where):
    """SIR whose members give NaN from their own time on: ``p = [beta,
    gamma, t_nan]``, ds/dt is NaN once ``t >= t_nan``; ``where`` is
    ``jnp.where`` or ``torch.where``."""

    def rhs(y, p, t):
        s, i, r = y
        beta, gamma, t_nan = p
        inf = beta * s * i
        rec = gamma * i
        return [where(t >= t_nan, float("nan"), -inf), inf - rec, rec]

    return rhs


@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_plain_non_finite_norm_matches_jax_reference(method):
    """One member turns NaN at t = 5.3 (SIR, B = 64, one block, 20 days): a
    NaN norm wins the block max, so every attempt that reaches 5.3 is
    rejected at factor 0.2 and the block runs out of budget in every
    interval from (5, 6] on. The plain version's statistics equal the JAX
    reference's exactly, its NaN slots are the same, and its saves agree
    within the module's tolerance."""
    B, bad, t_nan = 64, 10, 5.3
    y0, p = _sir_inputs(B, seed=5)
    t_row = np.full((1, B), np.inf, np.float32)
    t_row[0, bad] = t_nan
    p = np.concatenate([p, t_row])
    kw = dict(duration=20.0, rtol=1e-5, atol=1e-8, method=method)
    want, wstats = jgp.ensemble_solve_kernel_adaptive_reference(
        _sir_nan(jnp.where), jnp.asarray(y0), jnp.asarray(p), **kw)
    got, stats = tg.ensemble_solve_kernel_adaptive_reference(
        _sir_nan(torch.where), torch.as_tensor(y0), torch.as_tensor(p), **kw)
    _assert_stats_equal(stats, wstats)
    assert int(stats["exhausted_intervals"][0]) == 20 - int(t_nan)
    assert int(stats["n_rejected"][0]) > int(stats["exhausted_intervals"][0])
    nan_slots = torch.isnan(got).all(dim=(1, 2))
    assert int(nan_slots.sum()) == 20 - int(t_nan) and not nan_slots[: int(t_nan) + 1].any()
    np.testing.assert_array_equal(torch.isnan(got).numpy(), np.isnan(np.asarray(want)))
    _assert_close(got, want)


def test_adaptive_launcher_refuses_cpu_tensors():
    """The Triton launcher takes CUDA rows only: on CPU tensors it raises
    before it builds anything (no Triton here) and counts no launch."""
    from dynode_tpu_torch.ops import generic_triton as gtri

    y0, p = _sir_inputs(64, seed=5)
    before = gtri.launch_rk_solve_adaptive.launches
    with pytest.raises(RuntimeError, match="CUDA device"):
        gtri.launch_rk_solve_adaptive(
            tg.RowsRHS(sir_rows, lambda: None), torch.as_tensor(y0), torch.as_tensor(p),
            n_saves=3, save_every=1.0, rtol=1e-4, atol=1e-6, dt0=0.125, steps_per_save=8,
            method="bosh3", t0=0.0, block_b=64, save_rows=(0, 1, 2), save_dtype=torch.float32,
            padded_rows=False)
    assert gtri.launch_rk_solve_adaptive.launches == before


def test_plain_blocks_match_jax_kernel_interpret():
    """Two 128-member blocks at B = 256 carry independent dt chains: the
    per-block statistics equal those of the JAX kernel in interpret mode."""
    B = 256
    y0, p = _sir_inputs(B, seed=9)
    kw = dict(duration=20.0, rtol=1e-5, atol=1e-8, block_b=128)
    want, wstats = _interpret_kernel(sir_rows, jnp.asarray(y0), jnp.asarray(p), **kw)
    got, stats = tg.ensemble_solve_kernel_adaptive(
        sir_rows, torch.as_tensor(y0), torch.as_tensor(p), **kw)
    assert stats["n_accepted"].shape == (2,) and stats["n_accepted"].dtype == torch.int32
    _assert_stats_equal(stats, wstats)
    _assert_close(got, want)


def test_ragged_last_block_is_its_own_solve():
    """B = 100 in blocks of 32: the short last block (4 members) decides on
    its own members only, so every block equals a one-block solve of its
    members, statistics and saves. Tolerance: exact -- the same operations
    on the same values."""
    B, blk = 100, 32
    y0, p = _sir_inputs(B, seed=3)
    kw = dict(duration=20.0, rtol=1e-5, atol=1e-8)
    got, stats = tg.ensemble_solve_kernel_adaptive_reference(
        sir_rows, torch.as_tensor(y0), torch.as_tensor(p), block_b=blk, **kw)
    assert stats["n_accepted"].shape == (4,)
    for i in range(4):
        cols = slice(i * blk, min((i + 1) * blk, B))
        one, one_stats = tg.ensemble_solve_kernel_adaptive_reference(
            sir_rows, torch.as_tensor(y0[:, cols]), torch.as_tensor(p[:, cols]), **kw)
        assert torch.equal(got[..., cols], one)
        for key in STATS:
            assert int(stats[key][i]) == int(one_stats[key][0]), (i, key)
    # the last block's decisions differ from the full blocks' (its own dt chain)
    assert len({int(n) for n in stats["n_accepted"]}) > 1


def test_budget_exhaustion_gives_nan_slots_and_flags():
    """rtol 1e-10 cannot be met in float32 with 2 attempts per interval: each
    block's count of all-NaN save slots is its ``exhausted_intervals``; the
    initial state is always saved.

    At this tolerance each decision turns on float32 rounding noise in the
    norm. Against the JAX reference run op by op (``jax.disable_jit``, each
    operation rounded on its own, as the plain loop rounds it) the stats are
    equal exactly and the saves bit for bit. The jitted JAX reference fuses
    the loop, which rounds differently: it takes other decisions (accepted
    and rejected counts off by one to five on seeds 5-9; ROADMAP, Queue 3)
    but the same exhausted counts and NaN slots, which are held here too."""
    B = 32
    y0, p = _sir_inputs(B, seed=6)
    kw = dict(duration=20.0, rtol=1e-10, atol=1e-14, steps_per_save=2)
    got, stats = tg.ensemble_solve_kernel_adaptive_reference(
        sir_rows, torch.as_tensor(y0), torch.as_tensor(p), **kw)
    with jax.disable_jit():
        eager, estats = jgp.ensemble_solve_kernel_adaptive_reference(
            sir_rows, jnp.asarray(y0), jnp.asarray(p), **kw)
    _assert_stats_equal(stats, estats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))  # NaNs equal too
    want, wstats = jgp.ensemble_solve_kernel_adaptive_reference(
        sir_rows, jnp.asarray(y0), jnp.asarray(p), **kw)
    assert int(stats["exhausted_intervals"][0]) == int(wstats["exhausted_intervals"][0]) > 0
    np.testing.assert_array_equal(torch.isnan(got).numpy(), np.isnan(np.asarray(want)))
    blocked, bstats = tg.ensemble_solve_kernel_adaptive(
        sir_rows, torch.as_tensor(y0), torch.as_tensor(p), block_b=16, **kw)
    for i in range(2):
        nan_slots = torch.isnan(blocked[..., i * 16 : (i + 1) * 16]).all(dim=(1, 2))
        n_bad = int(bstats["exhausted_intervals"][i])
        assert n_bad > 0 and int(nan_slots.sum()) == n_bad
        assert not nan_slots[0]


def test_save_rows_bf16_padded_match_jax():
    """``save_rows`` in any order, bf16 saves, the padded layout, ``t0``.
    Tolerance: rtol 2**-8 (one bf16 ulp), as both round float32 values that
    agree to 2e-6 to bf16."""
    B = 64
    y0, p = _sir_inputs(B, seed=7)
    kw = dict(duration=10.0, rtol=1e-5, atol=1e-8, t0=3.0, save_rows=(2, 0), padded_rows=True)
    want, _ = jgp.ensemble_solve_kernel_adaptive(
        sir_rows, jnp.asarray(y0), jnp.asarray(p), save_dtype=jnp.bfloat16, **kw)
    got, _ = tg.ensemble_solve_kernel_adaptive(
        sir_rows, torch.as_tensor(y0), torch.as_tensor(p), save_dtype=torch.bfloat16,
        block_b=B, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (11, 8, B)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=0)
    assert not got[:, 2:].any()
    exact, _ = tg.ensemble_solve_kernel_adaptive(
        sir_rows, torch.as_tensor(y0), torch.as_tensor(p), block_b=B,
        **{**kw, "padded_rows": False})
    assert exact.shape == (11, 2, B) and torch.equal(exact.to(torch.bfloat16), got[:, :2])


def test_default_block_width():
    """With no ``block_b`` the CPU route decides in blocks of
    ``ADAPTIVE_BLOCK`` members, the kernel's default width."""
    B = 2 * tg.ADAPTIVE_BLOCK + 5
    y0, p = _sir_inputs(B, seed=8)
    _, stats = tg.ensemble_solve_kernel_adaptive(
        sir_rows, torch.as_tensor(y0), torch.as_tensor(p), duration=4.0)
    assert stats["n_accepted"].shape == (3,)


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(duration=2.0, method="rk4"), "unknown method"),
        (dict(duration=2.5), "whole number of save intervals"),
        (dict(duration=0.0), "at least one save interval"),
        (dict(duration=2.0, save_rows=(3,)), "out of range"),
        (dict(duration=2.0, save_rows=()), "at least one row"),
    ],
)
def test_validation_errors_match_jax(kwargs, match):
    """The same ValueErrors, with the same messages, as the JAX entry point."""
    y0 = np.full((3, 8), 0.5, np.float32)
    with pytest.raises(ValueError, match=match):
        jgp.ensemble_solve_kernel_adaptive(sir_rows, jnp.asarray(y0), **kwargs)
    with pytest.raises(ValueError, match=match):
        tg.ensemble_solve_kernel_adaptive(sir_rows, torch.as_tensor(y0), **kwargs)


def test_validation_of_port_arguments():
    y0 = torch.full((3, 8), 0.5)
    with pytest.raises(ValueError, match="save_dtype"):
        tg.ensemble_solve_kernel_adaptive(sir_rows, y0, duration=2.0, save_dtype=torch.float16)
    with pytest.raises(ValueError, match="must be \\(R, B\\)"):
        tg.ensemble_solve_kernel_adaptive(sir_rows, torch.zeros(8), duration=2.0)
    for block_b in (0, 8, 100, 2048):  # the kernel's rule, on the CPU too
        with pytest.raises(ValueError, match="block_b must be a power of two"):
            tg.ensemble_solve_kernel_adaptive(sir_rows, y0, duration=2.0, block_b=block_b)
