"""The multi-strain ensemble solve of the port against the JAX package.

On the CPU, ``ensemble_solve_tsit5`` runs its plain version; it is held
against ``dynode_tpu.ops.ensemble_solve_reference`` (the JAX plain version,
which the JAX package's own tests hold against its Pallas kernel in
interpret mode). The CUDA kernel itself is compared with the plain version
on the card by ``test_torch_cuda.py``.
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
from dynode_tpu_torch import convert
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


def test_pack_unpack_roundtrip():
    """Tolerance: exact -- packing only moves values."""
    y0, beta, rates, _ = _inputs((2, 3), 8, 0)
    packed = tms.pack_state(convert.state_from_numpy(y0, device="cpu"), 8)
    assert packed.shape == (tms.D_ROWS, 8) and packed.is_contiguous()
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jmp.pack_state(y0, 8)))
    s, e, i, r, c = tms.unpack_saves(packed[None])
    np.testing.assert_array_equal(s[0, 3].numpy(), y0[0])
    np.testing.assert_array_equal(i[0, 5].numpy(), y0[2])
    pp = tms.pack_params(torch.as_tensor(beta), *map(torch.as_tensor, rates), 8)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jmp.pack_params(beta, *rates, 8)))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_unpack_saves_matches_jax(shape):
    """Tolerance: exact -- a reshape and transpose on both sides."""
    A, K = shape
    saves = np.random.default_rng(1).uniform(size=(4, A + 4 * A * K, 5)).astype(np.float32)
    for got, want in zip(tms.unpack_saves(torch.as_tensor(saves), A, K),
                         jmp.unpack_saves(jnp.asarray(saves), A, K)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_ensemble_solve_tsit5_matches_jax_reference(shape):
    """Per-member betas, B = 64, 60 days at dt = 0.5.

    Tolerance: max |diff| <= 1e-5 * max |JAX| -- both are float32 in the same
    expression order; XLA may contract a multiply-add the plain loop does not,
    and those last-bit differences grow slowly over 120 steps.
    """
    A, K = shape
    B = 64
    y0, beta, rates, contact = _inputs(shape, B, seed=2 + A)
    kw = dict(batch=B, duration=60.0, dt=0.5, n_age=A, n_strain=K)
    want = np.asarray(jmp.ensemble_solve_reference(y0, beta, *rates, contact, **kw))
    got = tms.ensemble_solve_tsit5(
        convert.state_from_numpy(y0, device="cpu"), torch.as_tensor(beta),
        *map(torch.as_tensor, rates), torch.as_tensor(contact), **kw,
    )
    assert got.shape == want.shape == (61, A + 4 * A * K, B)
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))


def test_save_every_stride():
    """Saves every 2 days are every second daily save. Tolerance: exact --
    the same steps in the same order."""
    y0, beta, rates, contact = _inputs((2, 3), 4, 5)
    args = (convert.state_from_numpy(y0, device="cpu"), torch.as_tensor(beta),
            *map(torch.as_tensor, rates), torch.as_tensor(contact))
    daily = tms.ensemble_solve_reference(*args, batch=4, duration=10.0)
    every2 = tms.ensemble_solve_reference(*args, batch=4, duration=10.0, save_every=2.0)
    np.testing.assert_array_equal(every2.numpy(), daily[::2].numpy())


def test_kernel_rejects_uninstantiated_shape():
    """The CUDA kernel is compiled for (2, 3) and (3, 2) only; a launch at
    another shape raises and names the compiled set, before any device work."""
    assert tms.INSTANTIATED == ((2, 3), (3, 2))
    with pytest.raises(ValueError, match="instantiated for"):
        tms.launch_multistrain_tsit5(
            torch.zeros(4 + 4 * 4 * 1, 8), torch.zeros(4, 8), ((1.0,) * 4,) * 4,
            dt=0.5, n_steps=2, save_stride=1, n_age=4, n_strain=1,
        )
