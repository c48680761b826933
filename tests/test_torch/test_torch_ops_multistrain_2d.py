"""The multi-strain solve on the aligned 2-D layout against the JAX package.

On the CPU, ``ensemble_solve_tsit5_2d`` runs its plain version; it is held
against ``dynode_tpu.ops.multistrain_pallas.ensemble_solve_tsit5_2d`` on the
CPU, which runs the JAX plain version (``_solve_2d_reference``). The CUDA
kernel itself is compared with the plain version on the card by
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.ops.multistrain_pallas as jmp
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_odeparams,
)
from dynode_tpu_torch.ops import _build
from dynode_tpu_torch.ops import multistrain as tms

SHAPES = {
    (2, 3): {},
    (3, 2): dict(
        r0s=(2.0, 2.5), infectious_periods=(7.0, 6.0), latent_periods=(3.0, 2.5),
        waning_periods=(60.0, 80.0), strain_names=("A", "B"),
        age_names=("young", "mid", "old"), age_demographics=(0.4, 0.4, 0.2),
    ),
}


def _inputs(shape, batch, seed):
    cfg = multistrain_config(**SHAPES[shape])
    p = multistrain_odeparams(cfg)
    y0 = tuple(np.asarray(x, np.float32) for x in multistrain_initial_state(cfg))
    scales = np.random.default_rng(seed).uniform(0.6, 1.6, batch)
    beta = (np.asarray(p.beta)[None, :] * scales[:, None]).astype(np.float32)
    rates = tuple(np.asarray(getattr(p, n), np.float32) for n in ("sigma", "gamma", "omega"))
    return y0, beta, rates, np.asarray(p.contact_matrix, np.float32)


def _torch(y0, beta, rates, contact):
    return (tuple(torch.as_tensor(x) for x in y0), torch.as_tensor(beta),
            *map(torch.as_tensor, rates), torch.as_tensor(contact))


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_pack_and_unpack_2d_match_jax(shape):
    """Tolerance: exact -- the aligned layout only moves values; D2 = 40."""
    A, K = shape
    B = 8
    y0, beta, rates, _ = _inputs(shape, B, seed=0)
    assert tms._offsets_2d(A, K) == jmp._offsets_2d(A, K)
    assert tms._offsets_2d(A, K)[1] == 40
    packed = tms.pack_state_2d(tuple(map(torch.as_tensor, y0)), B, A, K)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jmp.pack_state_2d(y0, B, A, K)))
    for b in (beta, beta[0]):  # per member (B, K) and shared (K,)
        got = tms.pack_rates_2d(torch.as_tensor(b), *map(torch.as_tensor, rates), B, A, K)
        want = jmp.pack_rates_2d(b, *rates, B, A, K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    saves = np.random.default_rng(1).uniform(size=(3, 40, B)).astype(np.float32)
    for got, want in zip(tms.unpack_saves_2d(torch.as_tensor(saves), A, K),
                         jmp.unpack_saves_2d(jnp.asarray(saves), A, K)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_rhs_2d_matches_jax(shape):
    """One RHS evaluation on a random aligned state. Tolerance: max |diff| <=
    1e-6 * max |JAX| -- float32 in the same order on both sides."""
    A, K = shape
    B = 16
    _, beta, rates, contact = _inputs(shape, B, seed=2)
    rng = np.random.default_rng(3)
    y = np.array(jmp.pack_state_2d(
        (rng.uniform(100, 300, A), *(rng.uniform(0, 50, (A, K)) for _ in range(4))), B, A, K))
    pr = np.array(jmp.pack_rates_2d(beta, *rates, B, A, K))
    ct = tuple(tuple(float(v) for v in row) for row in contact)
    want = jmp._rhs_2d(jnp.asarray(y), *(jnp.asarray(pr[q * 8:(q + 1) * 8]) for q in range(4)),
                       ct, A, K)
    got = tms._rhs_2d(torch.as_tensor(y), *(torch.as_tensor(pr[q * 8:(q + 1) * 8]) for q in range(4)),
                      ct, A, K)
    assert got.shape == want.shape == (40, B)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("shape", list(SHAPES))
def test_solve_2d_matches_jax(shape):
    """Per-member betas, B = 64, 60 days at dt = 0.5.

    Tolerance: max |diff| <= 1e-5 * max |JAX| -- float32 in the same
    expression order; XLA may contract a multiply-add the plain loop does
    not, and those last-bit differences grow slowly over 120 steps. The
    padding rows are zero on both sides.
    """
    A, K = shape
    B = 64
    y0, beta, rates, contact = _inputs(shape, B, seed=4 + A)
    kw = dict(batch=B, duration=60.0, dt=0.5, n_age=A, n_strain=K)
    want = np.asarray(jmp.ensemble_solve_tsit5_2d(y0, beta, *rates, contact, **kw))
    got = tms.ensemble_solve_tsit5_2d(*_torch(y0, beta, rates, contact), **kw)
    assert got.shape == want.shape == (61, 40, B) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    pad = sorted(set(range(40)) - set(tms._live_rows_2d(A, K)))
    assert len(pad) == 40 - (A + 4 * A * K)
    assert not got[:, pad].any()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_solve_2d_agrees_with_row_solve(shape):
    """The 2-D and the row solve are the same model in another expression
    order. Tolerance: max |diff| <= 1e-5 * max |row| per compartment."""
    A, K = shape
    B = 16
    args = _torch(*_inputs(shape, B, seed=9))
    kw = dict(batch=B, duration=40.0, n_age=A, n_strain=K)
    got = tms.unpack_saves_2d(tms.ensemble_solve_tsit5_2d(*args, **kw), A, K)
    want = tms.unpack_saves(tms.ensemble_solve_tsit5(*args, **kw), A, K)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w.numpy()) <= 1e-5


def test_2d_kernel_rejects_uninstantiated_shape():
    """The library compiles the 2-D kernel for (2, 3) and (3, 2), as the
    source instantiates; any other shape goes to a shape build, up to
    ``MAX_ROWS`` state rows: a larger one raises before any device work."""
    src = (_build.SRC_DIR / "multistrain_tsit5_2d.cu").read_text()
    for a, k in tms.INSTANTIATED:
        assert f"launch<{a}, {k}>" in src
    a, k = 8, 32  # 8 + 4 * 8 * 32 = 1,032 rows
    with pytest.raises(ValueError, match=f"at most {tms.MAX_ROWS} state rows"):
        tms.launch_multistrain_tsit5_2d(
            torch.zeros(8 + 4 * 256, 8), torch.zeros(4 * 256, 8), ((1.0,) * a,) * a,
            dt=0.5, n_steps=2, save_stride=1, n_age=a, n_strain=k,
        )


@pytest.mark.parametrize("block_b", [256, 8])
def test_block_b_keyword_takes_the_jax_call_form(block_b):
    """The JAX ``ensemble_solve_tsit5_2d(..., block_b=...)`` call form (its
    default is 256) runs and gives the result of the call without it, bit
    for bit, and agrees with the JAX call of the same form within 1e-5 (as
    ``test_solve_2d_matches_jax``)."""
    B = 64
    y0, beta, rates, contact = _inputs((2, 3), B, seed=13)
    kw = dict(batch=B, duration=10.0, dt=0.5)
    got = tms.ensemble_solve_tsit5_2d(*_torch(y0, beta, rates, contact), block_b=block_b, **kw)
    assert torch.equal(got, tms.ensemble_solve_tsit5_2d(*_torch(y0, beta, rates, contact), **kw))
    want = np.asarray(jmp.ensemble_solve_tsit5_2d(y0, beta, *rates, contact, block_b=block_b, **kw))
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("block_b", [0, -256])
def test_block_b_must_be_positive(block_b):
    y0, beta, rates, contact = _inputs((2, 3), 8, seed=13)
    with pytest.raises(ValueError, match="block_b must be positive"):
        tms.ensemble_solve_tsit5_2d(*_torch(y0, beta, rates, contact), batch=8, duration=2.0,
                                    block_b=block_b)


def _former_pack_state_2d(y0, batch, n_age, n_strain):
    """``pack_state_2d`` as it was: a zero buffer and one slice assignment
    per group."""
    offs, d2 = tms._offsets_2d(n_age, n_strain)
    parts = [torch.as_tensor(x) for x in y0]
    buf = torch.zeros((d2, batch), dtype=torch.float32, device=parts[0].device)
    for off, x in zip(offs, parts):
        flat = x.to(torch.float32).reshape(-1)
        buf[off : off + flat.shape[0]] = flat[:, None]
    return buf


def _former_pack_rates_2d(beta, sigma, gamma, omega, batch, n_age, n_strain):
    """``pack_rates_2d`` as it was: per rate a zero section, the rates
    repeated per age, then one concatenation."""
    ak, sak = n_age * n_strain, tms._blk8(n_age * n_strain)

    def section(x):
        x = torch.as_tensor(x).to(torch.float32)
        if x.ndim == 1:
            x = x[None, :].expand(batch, n_strain)
        out = torch.zeros((sak, batch), dtype=torch.float32, device=x.device)
        out[:ak] = x.T.repeat(n_age, 1)
        return out

    return torch.cat([section(beta), section(sigma), section(gamma), section(omega)])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_packing_matches_its_former_formulas(shape):
    """The 2-D packing helpers, rewritten with fewer device operations,
    return bit for bit what their former formulas returned: float32 and
    float64 inputs, per-member and shared rates, a ragged width."""
    A, K = shape
    B = 13
    for dtype in (np.float32, np.float64):
        y0, beta, rates, _ = _inputs(shape, B, seed=21)
        y0 = tuple(x.astype(dtype) for x in y0)
        got = tms.pack_state_2d(y0, B, A, K)
        want = _former_pack_state_2d(y0, B, A, K)
        assert torch.equal(got, want) and got.is_contiguous() and got.dtype == torch.float32
        for b in (beta.astype(dtype), beta[0].astype(dtype)):
            args = (torch.as_tensor(b), *(torch.as_tensor(x.astype(dtype)) for x in rates))
            got = tms.pack_rates_2d(*args, B, A, K)
            want = _former_pack_rates_2d(*args, B, A, K)
            assert torch.equal(got, want) and got.is_contiguous() and got.dtype == torch.float32
