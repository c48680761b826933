"""The constant-step SEIP ensemble of the port against the JAX package.

On the CPU, ``seip_ensemble_solve`` runs its plain version,
``seip_solve_reference``: RK4 on the kernels' RHS (``seip_kernel_rhs``, a
transcription of the JAX kernel's ``_build_rhs``). The CUDA kernel itself is
compared with the plain version on the card by ``test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.ops.seip_pallas as jsp
from dynode_tpu.config import SolverParams
from dynode_tpu.models import seip as js
from dynode_tpu_torch import convert
from dynode_tpu_torch.models import seip as ts
from dynode_tpu_torch.ops import seip as tsp


def _jax_side(seasonal=True):
    cfg = js.seip_config(seasonal_vaccination=seasonal,
                         solver_params=SolverParams(constant_step_size=0.5))
    return js.seip_odeparams(cfg), js.seip_initial_state(cfg)


def _port_side(seasonal=True, dtype=torch.float64):
    return (ts.seip_default_params(seasonal, dtype=dtype, device="cpu"),
            ts.seip_initial_state(seasonal, dtype=dtype, device="cpu"))


def _rel(got, want) -> float:
    got = np.asarray(got.double().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("per_strain", [False, True])
@pytest.mark.parametrize("seasonal", [True, False])
def test_kernel_rhs_matches_model_rhs(seasonal, per_strain):
    """The kernels' RHS against ``seip_ode_ensemble`` of both packages, at
    random states and a day inside the introduction pulse. Tolerance: rel
    1e-12 in float64, 1e-6 in float32 (the same flows; the kernel form sums
    the member's structure in the order of the warp reductions)."""
    jp, jy = _jax_side(seasonal)
    tp, _ = _port_side(seasonal)
    rng = np.random.default_rng(60 + seasonal + 2 * per_strain)
    B = 8
    state = tuple(rng.uniform(0.0, 2000.0, np.asarray(c).shape + (B,)) for c in jy)
    scales = rng.uniform(0.85, 1.2, (2, B) if per_strain else B)
    want = js.seip_ode_ensemble(59.4, tuple(jnp.asarray(x) for x in state),
                                js.seip_ensemble_params(jp, jnp.asarray(scales)))
    model = ts.seip_ode_ensemble(59.4, tuple(torch.as_tensor(x) for x in state),
                                 ts.seip_ensemble_params(tp, torch.as_tensor(scales)))
    P = tsp.seip_static_params(tp)
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        C = tsp._Consts(P, dtype, torch.device("cpu"))
        got = tsp.seip_kernel_rhs(
            C, tuple(torch.as_tensor(x, dtype=dtype) for x in state),
            torch.tensor([59.4], dtype=dtype), tsp._norm_scales(scales, 2, dtype))
        for g, w, m in zip(got, want, model):
            assert g.dtype == dtype and g.shape == m.shape
            assert _rel(g, w) <= rtol and _rel(g, m) <= rtol


@pytest.mark.parametrize("seasonal", [True, False])
def test_static_params_match_jax(seasonal):
    """Escape table and recovery targets against the JAX ``_static_params``.
    Tolerance: exact (float64 on both sides, the same formula)."""
    jp, _ = _jax_side(seasonal)
    P, dims, jseasonal = jsp._static_params(jp)
    got = tsp.seip_static_params(convert.seip_params_from_numpy(jp, dtype=torch.float64, device="cpu"))
    assert got.dims == dims and got.seasonal == jseasonal == seasonal
    np.testing.assert_array_equal(got.escape, np.asarray(P.escape))
    assert got.eta_to == P.eta_to
    assert float(got.seasonal_vax_tau) == P.seasonal_vax_tau


def test_static_params_reject_a_soft_transition():
    tp, _ = _port_side()
    eta = tp.eta_onehot.clone()
    eta[1, 0] = 0.5 * eta[1, 0] + 0.5 * eta[2, 0]
    with pytest.raises(ValueError, match="strictly one-hot"):
        tsp.seip_static_params(tp.replace(eta_onehot=eta))


def test_pack_unpack_match_jax():
    """Tolerance: exact -- a permutation."""
    x = np.random.default_rng(1).normal(size=(3, 5, 2048)).astype(np.float32)
    packed = tsp.pack_members(torch.as_tensor(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jsp.pack_members(jnp.asarray(x))))
    assert packed.shape == (3, 5, 8, 256)
    np.testing.assert_array_equal(tsp.unpack_members(packed).numpy(), x)
    np.testing.assert_array_equal(
        tsp.unpack_members(packed).numpy(), np.asarray(jsp.unpack_members(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError, match="multiple of 1024"):
        tsp.pack_members(torch.zeros(3, 1000))


@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
@pytest.mark.parametrize("per_strain", [False, True])
def test_plain_solve_matches_jax_reference(per_strain, dtype, rtol):
    """B = 8 members over 40 days at dt = 0.5 against the JAX
    ``seip_solve_reference`` (float64). Tolerance: rel 1e-12 in float64 (the
    same RK4 order; the RHS sums in another order); 2e-6 in float32, the
    rounding of 80 float32 steps (measured 6e-7)."""
    jp, jy = _jax_side()
    tp, ty = _port_side()
    B = 8
    rng = np.random.default_rng(70 + per_strain)
    scales = rng.uniform(0.85, 1.2, (2, B) if per_strain else B)
    want = jsp.seip_solve_reference(jy, jp, jnp.asarray(scales), duration=40, dt=0.5)
    got = tsp.seip_solve_reference(ty, tp, torch.as_tensor(scales), duration=40, dt=0.5, dtype=dtype)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == np.asarray(w).shape
        assert _rel(g, w) <= rtol


def test_entry_point_runs_the_plain_version_on_cpu():
    """CPU tensors take the plain version, in float32, at a ragged batch (13;
    only ``packed=True`` needs a multiple of 1,024). Tolerance: exact."""
    tp, ty = _port_side(dtype=torch.float32)
    scales = torch.as_tensor(np.random.default_rng(2).uniform(0.85, 1.2, 13), dtype=torch.float32)
    got = tsp.seip_ensemble_solve(ty, tp, scales, duration=6.0)
    want = tsp.seip_solve_reference(ty, tp, scales, duration=6.0, dtype=torch.float32)
    assert [g.shape[-1] for g in got] == [13] * 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_save_selection_subsets_full_solve():
    """``save`` picks compartments in ascending order. Tolerance: exact."""
    tp, ty = _port_side(dtype=torch.float32)
    scales = torch.tensor([0.95, 1.05])
    full = tsp.seip_ensemble_solve(ty, tp, scales, duration=10)
    c_only = tsp.seip_ensemble_solve(ty, tp, scales, duration=10, save=(3,))
    assert len(full) == 4 and len(c_only) == 1
    assert torch.equal(c_only[0], full[3])
    s_i = tsp.seip_ensemble_solve(ty, tp, scales, duration=10, save=(2, 0))
    assert torch.equal(s_i[0], full[0]) and torch.equal(s_i[1], full[2])


def test_bf16_saves_round_the_f32_solve():
    """Only the saves are rounded. Tolerance: max |bf16 - f32| / max(|f32|, 1)
    < 8e-3, the bound of the JAX package's test (bf16 keeps 8 bits)."""
    tp, ty = _port_side(dtype=torch.float32)
    scales = torch.tensor([0.95, 1.05])
    (c32,) = tsp.seip_ensemble_solve(ty, tp, scales, duration=10, save=(3,))
    (c16,) = tsp.seip_ensemble_solve(ty, tp, scales, duration=10, save=(3,), save_dtype=torch.bfloat16)
    assert c16.dtype == torch.bfloat16 and c16.shape == c32.shape
    a32, a16 = c32.double(), c16.double()
    assert float(((a16 - a32).abs() / a32.abs().clamp(min=1.0)).max()) < 8e-3
    assert torch.equal(c16, c32.to(torch.bfloat16))


def test_packed_output_is_pack_of_unpacked():
    """``packed=True`` is exactly ``pack_members`` of the member-last saves."""
    tp, ty = _port_side(dtype=torch.float32)
    scales = torch.linspace(0.9, 1.1, 1024)
    plain = tsp.seip_ensemble_solve(ty, tp, scales, duration=2, save=(0, 3))
    packed = tsp.seip_ensemble_solve(ty, tp, scales, duration=2, save=(0, 3), packed=True)
    for a, b in zip(plain, packed):
        assert b.shape == a.shape[:-1] + (8, 128)
        assert torch.equal(tsp.pack_members(a), b) and torch.equal(tsp.unpack_members(b), a)


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(duration=10.5), "whole strides"),
        (dict(duration=10.0, dt=0.3), "whole number of dt steps"),
        (dict(duration=9.0, dt=0.3), "save_every must be a whole number of dt steps"),
        (dict(duration=4.0, save=()), "save must select"),
        (dict(duration=4.0, save=(4,)), "save must select"),
        (dict(duration=4.0, save_dtype=torch.float16), "save_dtype"),
        (dict(duration=4.0, packed=True), "multiple of 1024"),
    ],
)
def test_validation_errors(kwargs, match):
    tp, ty = _port_side(dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        tsp.seip_ensemble_solve(ty, tp, torch.ones(4), **kwargs)


def test_scales_shape_is_checked():
    tp, ty = _port_side(dtype=torch.float32)
    with pytest.raises(ValueError, match="beta_scales must be"):
        tsp.seip_ensemble_solve(ty, tp, torch.ones(3, 4), duration=2.0)


def test_plain_solve_conserves_mass_per_age():
    """S + E + I summed per age (C counts incidence) is constant: every flow
    stays inside an age group. Tolerance: rel 1e-5 in float32 over 100 days."""
    tp, ty = _port_side(dtype=torch.float32)
    S, E, I, C = tsp.seip_ensemble_solve(ty, tp, torch.tensor([0.9, 1.2]), duration=100)
    living = S.sum(dim=(2, 3, 4)) + E.sum(dim=(2, 3, 4)) + I.sum(dim=(2, 3, 4))  # (T, A, B)
    assert float(((living - living[0]).abs() / living[0]).max()) <= 1e-5
    assert float(C[-1].sum()) > 0.0


def test_kernel_route_refuses_other_shapes(monkeypatch):
    """The library's CUDA kernels serve the production shape and the
    general kernels every other; past the kernels' limits (here more than
    ``MAX_KNOTS`` spline knots) the kernel route raises, before anything is
    launched."""
    tp, ty = _port_side(seasonal=False, dtype=torch.float32)
    P = tsp.seip_static_params(tp)
    knots = np.zeros(P.vax_knots.shape[:-1] + (tsp.MAX_KNOTS + 1,))
    P = dataclasses.replace(P, vax_knots=knots, vax_knot_coeffs=knots)
    with pytest.raises(ValueError, match=f"at most {tsp.MAX_KNOTS} spline knots"):
        tsp.launch_seip_rk4(ty, P, torch.ones(2, 4), dt=0.5, n_steps=2, save_stride=2,
                            save=(3,), save_dtype=torch.float32, packed=False)
    tp, ty = _port_side(dtype=torch.float32)
    with pytest.raises(ValueError, match="block_b must be one of"):
        tsp.launch_seip_bs3(ty, tsp.seip_static_params(tp), torch.ones(2, 4), n_saves=2,
                            save_every=1.0, rtol=1e-4, atol=1e-3, dt0=0.125, steps_per_save=8,
                            block_b=64, save=(3,), save_dtype=torch.float32, packed=False)


@pytest.mark.parametrize("dt", [0.5, 0.3, 0.05])
def test_rk4_stage_times_are_the_float32_formulas(dt):
    """``rk4_stage_times`` forms step n's stage times as the kernel does:
    ``float(n) * float(dt)``, then ``+ float(0.5 dt)`` and ``+ float(dt)``,
    each rounded to float32 once. Tolerance: exact. Away from dt = 0.5,
    ``t_n + dt`` differs from ``t_(n+1)`` at some steps, which is why the
    kernel's time table keeps three rows per step."""
    n = 400
    f32 = np.float32
    got = tsp.rk4_stage_times(dt, n)
    assert got.dtype == torch.float32 and got.shape == (n, 3)
    for step in range(n):
        t0 = f32(f32(step) * f32(dt))
        assert got[step, 0].item() == t0
        assert got[step, 1].item() == f32(t0 + f32(0.5 * dt))
        assert got[step, 2].item() == f32(t0 + f32(dt))
    off_grid = int((got[:-1, 2] != got[1:, 0]).sum())
    assert off_grid == 0 if dt == 0.5 else off_grid > 0
    t64 = tsp.rk4_stage_times(dt, n, torch.float64)
    np.testing.assert_array_equal(t64[:, 0].numpy(), np.arange(n) * dt)
    np.testing.assert_array_equal(t64[:, 2].numpy(), np.arange(n) * dt + dt)


@pytest.mark.parametrize("seasonal", [True, False])
def test_time_rows_match_jax_time_scalars(seasonal):
    """The plain time rows (the RK4 kernel's table) against the JAX kernel's
    time scalars at the same stage times, from the JAX static parameters:
    ``_build_rhs``'s seasonal forcing and introduction pulses,
    ``models/seip.py::_phi_seasonal`` and ``seip_pallas._spline_scalar``
    clipped at 0, all float64. Tolerance: rel 1e-12 of each column's largest
    value in float64; the float32 table (``seip_time_table_reference``) within
    2e-4 of it (phi = sin^1000 multiplies sin's rounding by 1,000)."""
    jp, _ = _jax_side(seasonal)
    tp, _ = _port_side(seasonal)
    JP, dims, _ = jsp._static_params(jp)
    A, _, K, _, L = dims
    P = tsp.seip_static_params(tp)
    t = tsp.rk4_stage_times(0.5, 400, torch.float64).reshape(-1)
    got = tsp._time_rows(tsp._Consts(P, torch.float64, torch.device("cpu")), t).numpy()
    tj = jnp.asarray(t.numpy())
    want = np.zeros_like(got)
    want[:, 0] = 1.0 + JP.season_amp * jnp.cos(2.0 * jnp.pi * (tj - JP.season_peak) / 365.0)
    for l in range(L):
        if JP.intro_perc[l] != 0.0:
            z = (tj - JP.intro_time[l]) / JP.intro_scale[l]
            want[:, 1 + l] = (JP.intro_perc[l] * jnp.exp(-0.5 * z * z)
                              / (JP.intro_scale[l] * np.sqrt(2.0 * np.pi)))
    if seasonal:
        want[:, 1 + L] = js._phi_seasonal(tj, JP.seasonal_vax_tau)
    for a in range(A):
        for k in range(K):
            spline = jsp._spline_scalar(tj, JP.vax_knots[a][k], JP.vax_base_coeffs[a][k],
                                        JP.vax_knot_coeffs[a][k])
            want[:, tsp.TIME_HEAD + a * K + k] = np.maximum(np.asarray(spline), 0.0)
    assert got.shape == (1200, tsp.TIME_HEAD + A * K)
    scale = np.maximum(np.abs(want).max(axis=0), 1e-300)
    assert float((np.abs(got - want) / scale).max()) <= 1e-12
    table = tsp.seip_time_table_reference(P, dt=0.5, n_steps=400, device="cpu")
    assert table.dtype == torch.float32 and table.shape == got.shape
    assert float((np.abs(table.double().numpy() - want) / scale).max()) <= 2e-4


def test_seip_launchers_refuse_cpu_tensors():
    """The launch wrappers run their kernels only: given CPU tensors they
    raise before anything is built, never solving on the CPU."""
    tp, ty = _port_side(dtype=torch.float32)
    P = tsp.seip_static_params(tp)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsp.launch_seip_time_table(P, dt=0.5, n_steps=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsp.launch_seip_rk4(ty, P, torch.ones(2, 4), dt=0.5, n_steps=2, save_stride=2, save=(3,),
                            save_dtype=torch.float32, packed=False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsp.launch_seip_bs3(ty, P, torch.ones(2, 4), n_saves=2, save_every=1.0, rtol=1e-4,
                            atol=1e-3, dt0=0.125, steps_per_save=8, block_b=4, save=(3,),
                            save_dtype=torch.float32, packed=False)
