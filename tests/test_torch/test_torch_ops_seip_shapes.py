"""The SEIP ensembles at the shapes ``seip_config`` builds beyond the
production one, against the JAX package; and the general SEIP kernels
(``csrc/shapes/``) run on the CPU under a host emulation of CUDA.

Three shapes (``chip_smoke.seip_shape_config``): ``seip_config()``'s default
(4, 4, 3, 4, 2, no seasonal vaccination), a second one (2, 2, 3, 3, 1,
seasonal: two ages, one strain, one vaccination, three waning stages) and
a three-strain one (4, 8, 3, 4, 3). On the CPU the entry points run their
plain versions, which at these shapes sum over the member's structure in
the general kernels' order; they are held against the JAX package's
references. The general kernels' sources are compiled for the host
(``cuda_emulation.py``) and held against the plain versions: the time
table and RK4 bit for bit, BS3 with equal decisions. On the card,
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 18 hold them again.
"""

import ctypes
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cuda_emulation
import dynode_tpu.ops.seip_pallas as jsp
from dynode_tpu import config as jconfig
from dynode_tpu.models import seip as js
from dynode_tpu_torch import config as tconfig
from dynode_tpu_torch.models import seip as ts
from dynode_tpu_torch.ops import seip as tsp

SHAPES = {"default": (4, 4, 3, 4, 2, False), "second": (2, 2, 3, 3, 1, True), "three": (4, 8, 3, 4, 3, False)}
STATS = ("exhausted_intervals", "n_accepted", "n_rejected")
B = 16
DAYS = 20.0


@functools.cache
def _jax_side(name):
    cfg = chip_smoke.seip_shape_config(js, jconfig.Strain, name)
    return js.seip_odeparams(cfg), js.seip_initial_state(cfg)


def _port_side(name, dtype=torch.float32):
    cfg = chip_smoke.seip_shape_config(ts, tconfig.Strain, name)
    return (ts.seip_odeparams(cfg, dtype=dtype, device="cpu"),
            ts.seip_initial_state(cfg, dtype=dtype, device="cpu"))


def _scales(name, batch=B):
    L = SHAPES[name][4]
    return np.random.default_rng(len(name)).uniform(0.85, 1.2, (L, batch))


def _rel(got, want) -> float:
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = want.double().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name", list(SHAPES))
def test_configs_build_the_shapes(name):
    """Each configuration gives its shape on both sides, with a strictly
    one-hot eta and at most ``MAX_KNOTS`` knots, and it is not the library's
    production shape: the general kernels serve it."""
    tp, _ = _port_side(name)
    P = tsp.seip_static_params(tp)
    assert (*P.dims, P.seasonal) == SHAPES[name]
    assert not tsp.is_production(P.dims, P.seasonal)
    tsp.check_kernel_shape(P)
    for block_b in tsp.ADAPTIVE_BLOCKS:
        tsp.check_kernel_shape(P, block_b)
    JP, dims, seasonal = jsp._static_params(_jax_side(name)[0])
    assert (*dims, seasonal) == SHAPES[name]


@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
@pytest.mark.parametrize("name", list(SHAPES))
def test_rk4_matches_jax_reference(name, dtype, rtol):
    """B = 16 members with per-strain scales over 20 days at dt = 0.5
    against the JAX ``seip_solve_reference`` (float64). Tolerance: rel 1e-12
    in float64 (the same RK4 order; the RHS sums in another order); 2e-6 in
    float32 (the entry point, on CPU tensors the plain version), the
    rounding of 40 float32 steps."""
    jp, jy = _jax_side(name)
    tp, ty = _port_side(name, dtype)
    scales = _scales(name)
    want = jsp.seip_solve_reference(jy, jp, jnp.asarray(scales), duration=DAYS, dt=0.5)
    if dtype == torch.float32:
        got = tsp.seip_ensemble_solve(ty, tp, torch.as_tensor(scales, dtype=dtype), duration=DAYS)
    else:
        got = tsp.seip_solve_reference(ty, tp, torch.as_tensor(scales), duration=DAYS, dtype=dtype)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == np.asarray(w).shape
        assert _rel(g, w) <= rtol


@pytest.mark.parametrize("name", list(SHAPES))
def test_bs3_matches_jax_reference(name):
    """One lockstep block of the 16 members (``block_b=16``, the JAX
    reference's single block), rtol 1e-4, atol 1e-3, 20 days: the
    statistics equal the JAX reference's, and the float32 saves agree within
    2e-6 of the largest value (the JAX reference works in float64 with a
    pow controller and no FSAL; the decisions are equal all the same)."""
    jp, jy = _jax_side(name)
    tp, ty = _port_side(name)
    scales = _scales(name)
    want, wstats = jsp.seip_solve_adaptive_reference(jy, jp, jnp.asarray(scales), duration=DAYS,
                                                     rtol=1e-4, atol=1e-3)
    got, stats = tsp.seip_ensemble_solve_adaptive(ty, tp, torch.as_tensor(scales, dtype=torch.float32),
                                                  duration=DAYS, block_b=B)
    for key in STATS:
        np.testing.assert_array_equal(stats[key].numpy(), np.asarray(wstats[key]), err_msg=key)
    assert int(stats["n_accepted"][0]) > DAYS
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == np.asarray(w).shape
        assert _rel(g, w) <= 2e-6


# ---------------------------------------------------------------------------
# the general kernels, emulated on the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """The RK4 and BS3 units of each shape, built for the host."""
    if cuda_emulation.shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    specs = [(family, (*shape[:5], int(shape[5]))) for shape in SHAPES.values()
             for family in ("seip_rk4", "seip_bs3")]
    built = cuda_emulation.build_family_units(specs, tmp_path_factory)
    return {(name, family): built[family, (*shape[:5], int(shape[5]))] for name, shape in SHAPES.items()
            for family in ("seip_rk4", "seip_bs3")}


def _kernel_args(name, batch):
    tp, ty = _port_side(name)
    P = tsp.seip_static_params(tp)
    y0 = torch.cat([c.reshape(-1) for c in ty]).contiguous()
    scales = torch.as_tensor(_scales(name, batch), dtype=torch.float32).contiguous()
    return tp, ty, P, y0, scales, tsp._host_constants(P)


@pytest.mark.parametrize("name", list(SHAPES))
def test_constants_layout_is_the_kernels(units, name):
    """``kernel_constants`` laid out field by field as the general kernels'
    ``ConstLayout`` reads it (``dynode_seip_any_layout``): each field starts
    where the sizes before it end, and the array is as long as the layout."""
    _, _, P, _, _, consts = _kernel_args(name, 1)
    offsets = (ctypes.c_int * 19)()
    units[name, "seip_rk4"].dynode_seip_any_layout(P.vax_knots.shape[-1], offsets)
    sizes = [np.asarray(v).size for v in tsp.kernel_constants(P).values()]
    assert list(offsets) == list(np.cumsum([0] + sizes))
    assert offsets[-1] == consts.size


@pytest.mark.parametrize("name", list(SHAPES))
def test_general_rk4_matches_plain_version(units, name):
    """The table kernel and the RK4 kernel against their plain versions, bit
    for bit: the time rows (host ``cosf``/``expf``/``sinf`` happen to round
    as PyTorch's here), then, from the plain version's table, 10 members (a
    CTA of 8 and a ragged one of 2; warps past the batch store nothing: the
    saves start as NaN) over 4 days, every compartment in float32, and C in
    bf16 (rounded once from float32, as ``.to(torch.bfloat16)``)."""
    lib = units[name, "seip_rk4"]
    tp, ty, P, y0, scales, consts = _kernel_args(name, 10)
    n_knots, n_steps = P.vax_knots.shape[-1], 8
    A, _, K, _, L = P.dims
    table = torch.full((3 * n_steps, tsp.time_head(L) + A * K), float("nan"))
    assert lib.dynode_seip_any_time_table(n_knots, consts.ctypes.data, 0.5, n_steps, table.data_ptr(), None) == 0
    want_table = tsp.seip_time_table_reference(P, dt=0.5, n_steps=n_steps, device="cpu")
    assert torch.equal(table, want_table)
    want = tsp.seip_solve_reference(ty, tp, scales, duration=4.0, dtype=torch.float32)
    for bf16 in (0, 1):
        outs = [torch.full_like(w, float("nan"), dtype=torch.bfloat16 if bf16 else torch.float32) for w in want]
        ptrs = [o.data_ptr() if (not bf16 or i == 3) else 0 for i, o in enumerate(outs)]
        rc = lib.dynode_seip_any_rk4(n_knots, consts.ctypes.data, want_table.data_ptr(), y0.data_ptr(),
                                     scales.data_ptr(), *ptrs, bf16, 0, 10, 0.5, n_steps, 2, None)
        assert rc == 0
        if bf16:
            assert torch.equal(outs[3], want[3].to(torch.bfloat16))
        else:
            for o, w in zip(outs, want):
                assert torch.equal(o, w)


@pytest.mark.parametrize("name", list(SHAPES))
def test_general_bs3_matches_plain_version(units, name):
    """The BS3 kernel against its plain version, 6 members in lockstep
    blocks of 4 (the last ragged) over 3 days: every block's statistics
    equal, and the saves within 1e-6 of the largest value (the kernel forms
    its own time rows with the host's ``cosf``/``expf``/``sinf``, which may
    round otherwise than PyTorch's in the last bit; bit for bit where they
    do not). An attempt budget of 1 at rtol 1e-6 runs out: the same
    exhausted intervals, NaN in the same slots."""
    lib = units[name, "seip_bs3"]
    tp, ty, P, y0, scales, consts = _kernel_args(name, 6)
    for kw in (dict(rtol=1e-4, atol=1e-3, steps_per_save=8), dict(rtol=1e-6, atol=1e-6, steps_per_save=1)):
        want, wstats = tsp.seip_solve_adaptive_reference(ty, tp, scales, duration=3.0, block_b=4,
                                                         dtype=torch.float32, **kw)
        outs = [torch.full_like(w, -1.0) for w in want]
        flags = torch.full((2, 3), -1, dtype=torch.int32)
        rc = lib.dynode_seip_any_bs3(P.vax_knots.shape[-1], consts.ctypes.data, y0.data_ptr(), scales.data_ptr(),
                                     *[o.data_ptr() for o in outs], flags.data_ptr(), 0, 0, 6, 4, 4, 1.0,
                                     kw["rtol"], kw["atol"], 0.125, kw["steps_per_save"], None)
        assert rc == 0
        for col, key in enumerate(STATS):
            assert torch.equal(flags[:, col], wstats[key]), key
        for o, w in zip(outs, want):
            assert torch.equal(torch.isnan(o), torch.isnan(w))
            o, w = torch.nan_to_num(o), torch.nan_to_num(w)
            assert float((o - w).abs().max()) <= 1e-6 * float(w.abs().max())
    assert int(flags[:, 0].min()) > 0  # the budget of 1 ran out in every block


def test_kernel_shape_limits():
    """The general kernels' limit: a CTA's shared memory (the constants, a
    slab per warp) within the card's 227 KB, named when it is not; the
    production shape has no such check. More than ``MAX_KNOTS`` knots raise
    at every shape. The widths the host counts with are the sources'."""
    shapes_dir = tsp._build.SHAPES_DIR
    assert f"constexpr int kWidth = {tsp.ANY_RK4_WIDTH};" in (shapes_dir / "seip_rk4_any.cu").read_text()
    assert f"constexpr int kMaxBlock = {tsp.ANY_MAX_BLOCK};" in (shapes_dir / "seip_bs3_any.cu").read_text()
    assert max(tsp.ADAPTIVE_BLOCKS) <= tsp.ANY_MAX_BLOCK
    tp, _ = _port_side("three")
    P = tsp.seip_static_params(tp)
    assert tsp.any_shared_bytes(P.dims, "bs3", 16) <= tsp.MAX_SHARED_BYTES
    big = dataclasses.replace(P, dims=(8, 16, 6, 8, 4))
    assert tsp.any_shared_bytes(big.dims, "rk4") > tsp.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tsp.check_kernel_shape(big)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tsp.check_kernel_shape(big, 16)
    knots = np.zeros(P.vax_knots.shape[:-1] + (tsp.MAX_KNOTS + 1,))
    with pytest.raises(ValueError, match="spline knots"):
        tsp.check_kernel_shape(dataclasses.replace(P, vax_knots=knots))


@pytest.mark.parametrize("name", list(SHAPES))
def test_launchers_take_the_shape(name):
    """The kernel route takes every shape now: given CPU tensors the
    launchers get past the shape checks and refuse the device only."""
    tp, ty = _port_side(name)
    P = tsp.seip_static_params(tp)
    scales = torch.ones(P.dims[-1], 4)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsp.launch_seip_rk4(ty, P, scales, dt=0.5, n_steps=2, save_stride=2, save=(3,),
                            save_dtype=torch.float32, packed=False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tsp.launch_seip_bs3(ty, P, scales, n_saves=2, save_every=1.0, rtol=1e-4, atol=1e-3, dt0=0.125,
                            steps_per_save=8, block_b=4, save=(3,), save_dtype=torch.float32, packed=False)
