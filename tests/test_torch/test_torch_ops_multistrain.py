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
    """The library compiles the CUDA kernel for (2, 3) and (3, 2); any other
    shape goes to a shape build of the same templates, up to ``MAX_ROWS``
    state rows: a launch past it raises and names the limit, before any
    device work."""
    assert tms.INSTANTIATED == ((2, 3), (3, 2))
    a, k = 40, 7  # 40 + 4 * 40 * 7 = 1,160 rows
    with pytest.raises(ValueError, match=f"at most {tms.MAX_ROWS} state rows"):
        tms.launch_multistrain_tsit5(
            torch.zeros(a + 4 * a * k, 8), torch.zeros(4 * k, 8), ((1.0,) * a,) * a,
            dt=0.5, n_steps=2, save_stride=1, n_age=a, n_strain=k,
        )


@pytest.mark.parametrize("block_b", [None, 8, 64])
def test_block_b_keyword_takes_the_jax_call_form(block_b):
    """The JAX ``ensemble_solve_tsit5(..., block_b=...)`` call form runs and
    gives the result of the call without it, bit for bit (the port's kernel
    picks its own width and masks a ragged batch), and agrees with the JAX
    call of the same form within 1e-5 (as above)."""
    B = 64
    y0, beta, rates, contact = _inputs((2, 3), B, seed=7)
    args = (convert.state_from_numpy(y0, device="cpu"), torch.as_tensor(beta),
            *map(torch.as_tensor, rates), torch.as_tensor(contact))
    got = tms.ensemble_solve_tsit5(*args, batch=B, duration=10.0, block_b=block_b)
    assert torch.equal(got, tms.ensemble_solve_tsit5(*args, batch=B, duration=10.0))
    want = np.asarray(jmp.ensemble_solve_tsit5(y0, beta, *rates, contact, batch=B, duration=10.0,
                                               block_b=block_b))
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("block_b", [0, -8])
def test_block_b_must_be_positive(block_b):
    y0, beta, rates, contact = _inputs((2, 3), 8, seed=7)
    with pytest.raises(ValueError, match="block_b must be positive"):
        tms.ensemble_solve_tsit5(convert.state_from_numpy(y0, device="cpu"), torch.as_tensor(beta),
                                 *map(torch.as_tensor, rates), torch.as_tensor(contact), batch=8,
                                 duration=2.0, block_b=block_b)


def test_pack_helpers_match_their_former_formulas():
    """``pack_state`` and ``pack_params`` give, bit for bit, what their
    former bodies gave (a concatenation after ``as_tensor``, one ``to``
    at the end; ``.T`` of the broadcast rates), for float32 and float64
    inputs and shared or per-member rates."""
    B = 8
    for dtype in (np.float32, np.float64):
        y0, beta, rates, _ = _inputs((3, 2), B, seed=8)
        y0 = tuple(x.astype(dtype) for x in y0)
        s, e, i, r, c = (torch.as_tensor(x) for x in y0)
        flat = torch.cat([s.reshape(-1), e.reshape(-1), i.reshape(-1), r.reshape(-1), c.reshape(-1)])
        want = flat.to(torch.float32)[:, None].expand(flat.shape[0], B).contiguous()
        assert torch.equal(tms.pack_state(y0, B, 3, 2), want)
        for b in (beta.astype(dtype), beta[0].astype(dtype)):
            def rows(x):
                x = torch.as_tensor(x).to(torch.float32)
                return (x[None, :].expand(B, 2) if x.ndim == 1 else x).T

            want = torch.cat([rows(b), *(rows(x.astype(dtype)) for x in rates)]).contiguous()
            got = tms.pack_params(b, *(x.astype(dtype) for x in rates), B, 2)
            assert torch.equal(got, want) and got.is_contiguous()


def test_contact_goes_to_the_device_without_a_round_trip(monkeypatch):
    """A contact matrix already on the launch device is used as it is (a
    view, no copy and no ``tolist``); host data is built once per matrix
    and device, and kept."""
    cpu = torch.device("cpu")
    contact = torch.tensor([[1.5, 0.5], [0.25, 2.0]], dtype=torch.float32)
    monkeypatch.setattr(tms, "_contact_tuple", lambda c: pytest.fail("a device tensor went through tolist"))
    flat = tms._contact_on(contact, cpu, 2)
    assert flat.data_ptr() == contact.data_ptr() and flat.shape == (4,)
    monkeypatch.undo()
    host = ((1.5, 0.5), (0.25, 2.0))
    first = tms._contact_on(host, cpu, 2)
    assert tms._contact_on(np.asarray(host), cpu, 2) is first  # built once, kept
    assert torch.equal(first, flat)
    with pytest.raises(ValueError, match="contact has 4 entries"):
        tms._contact_on(host, cpu, 3)


def test_team_choice_and_launch_checks():
    """The launchers take a team of one lane per member or one per age (the
    widths the sources instantiate), one per age up to ``TEAM_UP_TO``
    members, and a block of a multiple of 32 threads up to 256."""
    for a, _ in tms.INSTANTIATED:
        assert tms.teams(a) == (1, a)
        assert tms.pick_team(9984, a) == tms.pick_team(tms.TEAM_UP_TO, a) == a
        assert tms.pick_team(tms.TEAM_UP_TO + 1, a) == 1
        assert tms._launch_shape(17, a, None, None) == (a, tms.THREADS)
        assert tms._launch_shape(17, a, 1, 64) == (1, 64)
    for team, threads in ((4, 128), (2, 48), (2, 512), (2, 0)):
        with pytest.raises(ValueError, match="team must be|threads must be"):
            tms._launch_shape(17, 3 if team == 4 else 2, team, threads)
    for name in ("multistrain_tsit5.cu", "multistrain_tsit5_2d.cu"):
        src = (tms._build.SRC_DIR / name).read_text()
        assert "launch_team<A, K, 1>" in src and "launch_team<A, K, A>" in src
        assert '#include "multistrain_team.cuh"' in src
    header = (tms._build.SRC_DIR / "multistrain_team.cuh").read_text()
    assert "static_assert(T == 1 || T == A" in header


_ROW = ("_ZN53_GLOBAL__N__60a38f7a_20_multistrain_tsit5_cu_a4f11b3524multistrain_tsit5_kernel"
        "ILi2ELi3ELi2EEEvPKfS2_S2_Pfifii")
_TWO_D = ("_ZN56_GLOBAL__N__24279cfa_23_multistrain_tsit5_2d_cu_7e226f6027multistrain_tsit5_2d_kernel"
          "ILi3ELi2ELi1EEEvPKfS2_S2_PfiNS_7WeightsEii")


def test_compile_facts_name_each_instantiation():
    """Registers, spills and the SASS mix of the multi-strain kernels, by
    (A, K, team); other kernels of the build log are left out."""
    assert tms.kernel_label(_ROW) == tms.kernel_name("multistrain_tsit5", 2, 3, 2)
    assert tms.kernel_label(_TWO_D) == "multistrain_tsit5_2d_kernel<3,2,1>"
    assert tms.kernel_label("_ZN44_seip_rk4_kernelILi4EE") is None
    log = (f"ptxas info    : Compiling entry function '{_ROW}' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 145 registers, used 0 barriers\n"
           f"ptxas info    : Compiling entry function '{_TWO_D}' for 'sm_90a'\n"
           "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 0 barriers\n"
           "ptxas info    : Compiling entry function '_ZN44_seip_rk4_kernelILi4EE' for 'sm_90a'\n"
           "ptxas info    : Used 99 registers, used 0 barriers\n")
    facts = tms.compile_facts(log, {_ROW: {"total": 10, "SHFL": 8}})
    assert facts == {
        "multistrain_tsit5_kernel<2,3,2>": {"spill_stores": 0, "spill_loads": 0, "registers": 145,
                                            "sass": {"total": 10, "SHFL": 8}},
        "multistrain_tsit5_2d_kernel<3,2,1>": {"spill_stores": 8, "spill_loads": 8, "registers": 128,
                                               "sass": None},
    }
    assert tms.compile_facts(log, None)["multistrain_tsit5_kernel<2,3,2>"]["sass"] is None
