"""The adaptive (lockstep-dt) SEIP ensemble of the port against the JAX package.

On the CPU, ``seip_ensemble_solve_adaptive`` runs its plain version,
``seip_solve_adaptive_reference``: the adaptive kernel's decisions (FSAL,
the exp/log controller, per-block dt chains) on the kernels' RHS. With one
block of the whole batch it is held against the JAX reference, which has no
FSAL and a pow controller and works in float64 here: in the normal regime
the decisions are equal all the same (FSAL's first stage differs from a
recomputed one only in the rounding of the landing time). The CUDA kernel is
compared with the plain version on the card by ``test_torch_cuda.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.ops.seip_pallas as jsp
from dynode_tpu.config import SolverParams
from dynode_tpu.models import seip as js
from dynode_tpu_torch.models import seip as ts
from dynode_tpu_torch.ops import seip as tsp

STATS = ("exhausted_intervals", "n_accepted", "n_rejected")
B = 16


@functools.cache
def _jax_side():
    cfg = js.seip_config(seasonal_vaccination=True,
                         solver_params=SolverParams(constant_step_size=0.5))
    return js.seip_odeparams(cfg), js.seip_initial_state(cfg)


def _port_side(dtype=torch.float32):
    return (ts.seip_default_params(True, dtype=dtype, device="cpu"),
            ts.seip_initial_state(True, dtype=dtype, device="cpu"))


def _scales(seed=1, batch=B):
    return np.random.default_rng(seed).uniform(0.85, 1.2, batch)


@functools.cache
def _jax_reference(duration, rtol, atol, steps_per_save=8):
    jp, jy = _jax_side()
    outs, stats = jsp.seip_solve_adaptive_reference(
        jy, jp, jnp.asarray(_scales()), duration=duration, rtol=rtol, atol=atol,
        steps_per_save=steps_per_save)
    return [np.asarray(o) for o in outs], {k: np.asarray(v) for k, v in stats.items()}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("duration, rtol, atol", [(60.0, 1e-4, 1e-3), (30.0, 1e-5, 1e-5)])
def test_one_block_matches_jax_reference(duration, rtol, atol, dtype):
    """``block_b = batch`` (B = 16): the statistics equal the JAX
    reference's exactly (69 accepted at rtol 1e-4; 83 accepted and 2
    rejected at rtol 1e-5), and the saves agree within 1e-3 of the largest
    value, the bound of the JAX package's interpret-mode test (measured:
    4e-15 in float64, 2e-6 in float32)."""
    want, wstats = _jax_reference(duration, rtol, atol)
    tp, ty = _port_side(dtype)
    got, stats = tsp.seip_solve_adaptive_reference(
        ty, tp, torch.as_tensor(_scales(), dtype=dtype), duration=duration, rtol=rtol, atol=atol)
    assert stats["n_accepted"].shape == (1,) and stats["n_accepted"].dtype == torch.int32
    for key in STATS:
        np.testing.assert_array_equal(stats[key].numpy(), wstats[key], err_msg=key)
    assert int(stats["n_accepted"][0]) > duration  # more than one step per interval
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert np.max(np.abs(g.double().numpy() - w)) <= 1e-3 * np.max(np.abs(w))
    if rtol == 1e-5:
        assert int(stats["n_rejected"][0]) > 0


def test_blocks_are_independent_solves():
    """``block_b = 4`` at B = 16: every block equals a one-block solve of its
    own members, statistics and saves, and their decisions differ. Tolerance:
    exact -- the same operations on the same values."""
    tp, ty = _port_side()
    scales = torch.as_tensor(_scales(5), dtype=torch.float32)
    kw = dict(duration=30.0, rtol=1e-5, atol=1e-5)
    got, stats = tsp.seip_ensemble_solve_adaptive(ty, tp, scales, block_b=4, **kw)
    assert stats["n_accepted"].shape == (4,)
    for i in range(4):
        cols = slice(4 * i, 4 * i + 4)
        one, one_stats = tsp.seip_solve_adaptive_reference(ty, tp, scales[cols], **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[..., cols], o)
        for key in STATS:
            assert int(stats[key][i]) == int(one_stats[key][0]), (i, key)
    assert len({int(n) for n in stats["n_accepted"]}) > 1


def test_ragged_last_block():
    """B = 10 in blocks of 4: the short last block (2 members) decides on its
    own members only. Tolerance: exact."""
    tp, ty = _port_side()
    scales = torch.as_tensor(_scales(6, 10), dtype=torch.float32)
    kw = dict(duration=12.0, rtol=1e-5, atol=1e-5)
    got, stats = tsp.seip_ensemble_solve_adaptive(ty, tp, scales, block_b=4, **kw)
    assert stats["n_accepted"].shape == (3,) and got[0].shape[-1] == 10
    last, last_stats = tsp.seip_solve_adaptive_reference(ty, tp, scales[8:], **kw)
    for g, o in zip(got, last):
        assert torch.equal(g[..., 8:], o)
    for key in STATS:
        assert int(stats[key][2]) == int(last_stats[key][0])


def test_budget_exhaustion_gives_nan_slots():
    """One attempt per interval at rtol 1e-6 cannot keep up: each block's
    all-NaN save slots are its ``exhausted_intervals``, slot 0 (the initial
    state) is never NaN, and one global block takes the JAX reference's
    decisions and NaN slots exactly."""
    want, wstats = _jax_reference(10.0, 1e-6, 1e-6, steps_per_save=1)
    tp, ty = _port_side()
    kw = dict(duration=10.0, rtol=1e-6, atol=1e-6, steps_per_save=1)
    got, stats = tsp.seip_solve_adaptive_reference(
        ty, tp, torch.as_tensor(_scales(), dtype=torch.float32), **kw)
    for key in STATS:
        np.testing.assert_array_equal(stats[key].numpy(), wstats[key], err_msg=key)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(torch.isnan(g).numpy(), np.isnan(w))
    blocked, bstats = tsp.seip_ensemble_solve_adaptive(
        ty, tp, torch.as_tensor(_scales(), dtype=torch.float32), block_b=8, **kw)
    for i in range(2):
        nan_slots = torch.isnan(blocked[0][..., 8 * i:8 * i + 8]).flatten(1).all(dim=1)
        n_bad = int(bstats["exhausted_intervals"][i])
        assert n_bad > 0 and int(nan_slots.sum()) == n_bad
        assert not nan_slots[0]


def test_save_selection_bf16_and_packed():
    """``save``, bf16 saves and the packed layout, as the JAX package's
    adaptive tests check them. Tolerance: exact, and one bf16 rounding."""
    tp, ty = _port_side()
    scales = torch.as_tensor(_scales(), dtype=torch.float32)
    kw = dict(duration=5.0, block_b=16)
    full, _ = tsp.seip_ensemble_solve_adaptive(ty, tp, scales, **kw)
    c_only, _ = tsp.seip_ensemble_solve_adaptive(ty, tp, scales, save=(3,), **kw)
    assert len(full) == 4 and len(c_only) == 1 and torch.equal(c_only[0], full[3])
    bf, _ = tsp.seip_ensemble_solve_adaptive(ty, tp, scales, save=(3,), save_dtype=torch.bfloat16, **kw)
    assert bf[0].dtype == torch.bfloat16 and torch.equal(bf[0], full[3].to(torch.bfloat16))
    wide = torch.linspace(0.9, 1.1, 1024)
    pk, _ = tsp.seip_ensemble_solve_adaptive(ty, tp, wide, duration=2.0, save=(3,), packed=True)
    up, _ = tsp.seip_ensemble_solve_adaptive(ty, tp, wide, duration=2.0, save=(3,))
    assert pk[0].shape == up[0].shape[:-1] + (8, 128)
    assert torch.equal(tsp.unpack_members(pk[0]), up[0])


def test_mass_is_conserved():
    """Per age, S + E + I is constant. Tolerance: rel 1e-5 in float32."""
    tp, ty = _port_side()
    (S, E, I), stats = tsp.seip_ensemble_solve_adaptive(
        ty, tp, torch.tensor([0.9, 1.0, 1.1, 1.2]), duration=60.0, save=(0, 1, 2), block_b=4)
    assert int(stats["exhausted_intervals"].sum()) == 0
    living = S.sum(dim=(2, 3, 4)) + E.sum(dim=(2, 3, 4)) + I.sum(dim=(2, 3, 4))
    assert float(((living - living[0]).abs() / living[0]).max()) <= 1e-5


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(duration=10.5), "multiple of save_every"),
        (dict(duration=0.0), "at least one save interval"),
        (dict(duration=2.0, block_b=64), "block_b must be one of"),
        (dict(duration=2.0, block_b=6), "block_b must be one of"),
        (dict(duration=2.0, save=(5,)), "save must select"),
        (dict(duration=2.0, packed=True), "multiple of 1024"),
    ],
)
def test_validation_errors(kwargs, match):
    """The JAX entry point's ValueError on a duration that is no multiple of
    ``save_every``, and the port's own checks: at least one interval,
    ``block_b`` (on every device), ``save`` and the packed layout."""
    tp, ty = _port_side()
    with pytest.raises(ValueError, match=match):
        tsp.seip_ensemble_solve_adaptive(ty, tp, torch.ones(4), **kwargs)
    if kwargs == dict(duration=10.5):
        jp, jy = _jax_side()
        with pytest.raises(ValueError):
            jsp.seip_ensemble_solve_adaptive(jy, jp, jnp.ones(4), **kwargs)
