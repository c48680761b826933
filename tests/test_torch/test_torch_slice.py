"""The scenario-ensemble slice end to end, and the port's guard rails.

The slice is the path of ``examples/ensemble_scenarios.py`` part 1: default
parameters and initial state, per-member R0 scales, ``ensemble_solve_tsit5``,
``unpack_saves`` and the peak-day summary. Both packages get the same numpy
draws.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.ops.multistrain_pallas as jmp
import dynode_tpu.ops.seip_pallas as jsp
from dynode_tpu.config import SolverParams
from dynode_tpu.models import seip as jseip
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_odeparams,
)
import dynode_tpu_torch
from dynode_tpu_torch import _device
from dynode_tpu_torch.ops import _build
from dynode_tpu_torch.ops import multistrain as tms
from dynode_tpu_torch.ops import seip as tseip

REPO = Path(__file__).resolve().parents[2]


def test_slice_matches_jax_path():
    """B = 256 trajectories over 200 days at dt = 0.5.

    Tolerance: max |diff| <= 1e-5 * max |JAX| on every compartment (float32
    on both sides, same expression order, last-bit differences from XLA's
    multiply-add contraction grow slowly over 400 steps); the peak-day
    percentiles, an integer summary, must be equal.
    """
    B = 256
    scales = np.clip(np.random.default_rng(11).normal(1.0, 0.15, B), 0.6, 1.6)

    cfg = multistrain_config()
    jp = multistrain_odeparams(cfg)
    jy0 = tuple(np.asarray(x, np.float32) for x in multistrain_initial_state(cfg))
    jbeta = (np.asarray(jp.beta)[None, :] * scales[:, None]).astype(np.float32)
    jrates = [np.asarray(getattr(jp, n), np.float32) for n in ("sigma", "gamma", "omega")]
    jsaves = jmp.ensemble_solve_reference(
        jy0, jbeta, *jrates, np.asarray(jp.contact_matrix), batch=B, duration=200.0, dt=0.5,
    )
    want = [np.asarray(x) for x in jmp.unpack_saves(jsaves)]

    params = dynode_tpu_torch.multistrain_default_params(device="cpu")
    y0 = dynode_tpu_torch.multistrain_initial_state(device="cpu")
    beta = params.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32)[:, None]
    saves = dynode_tpu_torch.ensemble_solve_tsit5(
        y0, beta, params.sigma, params.gamma, params.omega, params.contact_matrix,
        batch=B, duration=200.0, dt=0.5,
    )
    got = [x.numpy() for x in dynode_tpu_torch.unpack_saves(saves)]

    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= 1e-5 * np.max(np.abs(w))

    def peak_days(c):
        return np.percentile(np.argmax(np.diff(c.sum(axis=(2, 3)), axis=0), axis=0), [5, 50, 95])

    np.testing.assert_array_equal(peak_days(got[4]), peak_days(want[4]))


@pytest.mark.parametrize("adaptive", [False, True])
def test_seip_slice_matches_jax_path(adaptive):
    """The path of ``bench_seip.py``: the production SEIP configuration
    (seasonal vaccination), Uniform(0.85, 1.2) transmission scales, the
    cumulative incidence C saved daily, B = 16 over 60 days, constant-step
    RK4 at dt = 0.5 or the adaptive BS3 at rtol 1e-4, atol 1e-3 (one lockstep
    block, ``block_b = B``).

    The JAX entry points on the CPU run their float64 references; the port
    runs float32. Tolerance: max |diff| <= 5e-6 * max |JAX| (float32 rounding
    over 120 steps, measured 6e-7 over 80); the adaptive statistics and the
    daily-incidence peak days must be equal.
    """
    B = 16
    scales = np.random.default_rng(12).uniform(0.85, 1.2, B)
    cfg = jseip.seip_config(seasonal_vaccination=True,
                            solver_params=SolverParams(constant_step_size=0.5))
    jp, jy = jseip.seip_odeparams(cfg), jseip.seip_initial_state(cfg)
    params = dynode_tpu_torch.seip_default_params(True, device="cpu")
    y0 = dynode_tpu_torch.seip_initial_state(True, device="cpu")
    tscales = torch.as_tensor(scales, dtype=torch.float32)
    if adaptive:
        kw = dict(duration=60.0, rtol=1e-4, atol=1e-3, save=(3,))
        (want,), wstats = jsp.seip_ensemble_solve_adaptive(jy, jp, jnp.asarray(scales), **kw)
        (got,), stats = dynode_tpu_torch.seip_ensemble_solve_adaptive(y0, params, tscales,
                                                                     block_b=B, **kw)
        for key in wstats:
            np.testing.assert_array_equal(stats[key].numpy(), np.asarray(wstats[key]))
    else:
        kw = dict(duration=60.0, dt=0.5, save=(3,))
        (want,) = jsp.seip_ensemble_solve(jy, jp, jnp.asarray(scales), **kw)
        (got,) = dynode_tpu_torch.seip_ensemble_solve(y0, params, tscales, **kw)
    want = np.asarray(want)
    assert got.shape == want.shape == (61, 4, 4, 4, 2, B) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= 5e-6 * np.max(np.abs(want))

    def peak_days(c):
        return np.argmax(np.diff(c.sum(axis=(1, 2, 3, 4)), axis=0), axis=0)

    np.testing.assert_array_equal(peak_days(got.numpy()), peak_days(want))


def test_import_leaves_jax_out():
    """``import dynode_tpu_torch`` (every module of it) and every module of
    ``examples_torch/`` load no JAX and nothing of ``dynode_tpu``."""
    code = (
        "import sys, pkgutil, importlib, dynode_tpu_torch\n"
        "for m in pkgutil.walk_packages(dynode_tpu_torch.__path__, 'dynode_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, 'examples_torch')\n"
        "for p in sorted(__import__('pathlib').Path('examples_torch').glob('*.py')):\n"
        "    importlib.import_module(p.stem)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'dynode_tpu'], 'dynode_tpu'\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    paths = [*(REPO / "dynode_tpu_torch").rglob("*.py"), *(REPO / "examples_torch").glob("*.py")]
    assert len([p for p in paths if p.parent.name == "examples_torch"]) == 16
    for path in paths:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import dynode_tpu\n" not in text and "from dynode_tpu " not in text, path
        assert "from dynode_tpu." not in text and "import dynode_tpu." not in text, path


def test_example_without_device_raises_without_a_card(tmp_path):
    """An example given no ``--device`` asks for the card and raises where
    there is none; it never drops to the CPU."""
    code = (
        "import runpy, sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = ['sir.py']\n"
        f"sys.path.insert(0, {str(REPO / 'examples_torch')!r})\n"
        f"runpy.run_path({str(REPO / 'examples_torch' / 'sir.py')!r}, run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "is_available() is False" in proc.stderr, proc.stderr[-2000:]
    assert not list(tmp_path.iterdir())  # no result written


def test_cuda_request_raises_without_card(monkeypatch):
    """Asking for the CUDA route where there is no Hopper card raises; it
    never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _device.require_hopper("cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _device.require_hopper("meta")
    assert _device.uses_kernel(torch.device("cpu")) is False
    with pytest.raises(RuntimeError):
        _device.uses_kernel(torch.device("meta"))

    # a non-CPU tensor reaches the gate and raises instead of solving
    params = dynode_tpu_torch.multistrain_default_params(device="meta")
    y0 = dynode_tpu_torch.multistrain_initial_state(device="meta")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tms.ensemble_solve_tsit5(y0, params.beta, params.sigma, params.gamma, params.omega,
                                 params.contact_matrix, batch=4, duration=2.0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        dynode_tpu_torch.ensemble_solve_kernel(
            tms.multistrain_rows_rhs(
                dynode_tpu_torch.multistrain_default_params(device="cpu").contact_matrix),
            torch.zeros(26, 4, device="meta"), duration=1.0, dt=0.5,
        )
    with pytest.raises(ValueError, match="several devices"):
        _device.common_device(torch.zeros(1), torch.zeros(1, device="meta"))


def test_gate_rejects_other_capabilities(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        _device.require_hopper("cuda")


def test_build_command_targets_sm90a(tmp_path):
    """The nvcc commands are composed, not run: one compile for sm_90a per
    source with the generated include dir, then one link of the objects
    into a shared library with a plain C interface."""
    compiles, link = _build.nvcc_commands("cuda/bin/nvcc", tmp_path / "lib.so", tmp_path / "inc")
    sources = sorted(_build.SRC_DIR.glob("*.cu"))
    assert [cmd[-1] for cmd in compiles] == [str(p) for p in sources]
    assert str(_build.SRC_DIR / "multistrain_tsit5.cu") in compiles[0]
    for cmd in compiles:
        assert cmd[0] == "cuda/bin/nvcc"
        joined = " ".join(cmd)
        for flag in ("-gencode arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-c",
                     "-Xcompiler -fPIC", f"-I {tmp_path / 'inc'}"):
            assert flag in joined
    # the adaptive SEIP kernel rounds as its plain version: no contraction,
    # IEEE division and square root; the other sources keep the defaults
    for cmd in compiles:
        per_source = ("-fmad=false", "-prec-div=true", "-prec-sqrt=true")
        if cmd[-1].endswith("seip_bs3.cu"):
            assert all(flag in cmd for flag in per_source)
        else:
            assert not any(flag in cmd for flag in per_source)
    assert _build.SOURCE_FLAGS["seip_bs3.cu"] == per_source
    objs = [str(tmp_path / f"{p.stem}.o") for p in sources]
    assert link == ["cuda/bin/nvcc", "-shared", "-o", str(tmp_path / "lib.so"), *objs]
    for path in sources:
        assert "torch/extension.h" not in path.read_text()
    assert _build.BUILD_ROOT == REPO / "build" / "dynode_tpu_torch"
    assert len(_build.build_key()) == 16 and _build.build_key() == _build.build_key()


def test_generated_header_is_the_tsit5_tableau():
    """The kernel's coefficients are generated from the tableau: parsing the
    header back gives the JAX package's Tsit5 floats exactly."""
    import re

    from dynode_tpu.ode.solvers import Tsit5

    header = _build.tableau_header()
    a_block = header[header.index("a[6][6]"):header.index("return a[s][j]")]
    rows = [[float(v) for v in re.findall(r"-?\d[\d.e+-]*", line)]
            for line in a_block.splitlines() if line.strip().startswith("{")]
    assert len(rows) == 6 and rows[0] == [0.0] * 6
    for s in range(1, 6):
        assert tuple(rows[s][:s]) == Tsit5.a[s - 1]
        assert all(v == 0.0 for v in rows[s][s:])
    b_line = header[header.index("b[6] = {"):].split("}")[0]
    assert tuple(float(v) for v in b_line.split("{")[1].split(",")) == Tsit5.b[:6]


def test_kernel_instantiations_match_the_source():
    """The shapes the wrappers accept are the ones the .cu files instantiate,
    and every C entry point the wrappers call is defined in a source."""
    src = (_build.SRC_DIR / "multistrain_tsit5.cu").read_text()
    for a, k in tms.INSTANTIATED:
        assert f"launch<{a}, {k}>" in src
    rk4 = (_build.SRC_DIR / "seip_rk4.cu").read_text()
    bs3 = (_build.SRC_DIR / "seip_bs3.cu").read_text()
    for A, J, K, M, L, seasonal in tseip.INSTANTIATED:
        shape = f"{A}, {J}, {K}, {M}, {L}, {str(seasonal).lower()}"
        assert f"seip_time_table_kernel<{shape}>" in rk4
        assert f"return launch<{shape}, kWidth>(" in rk4
        for block_b in tseip.ADAPTIVE_BLOCKS:
            assert f"case {block_b}:" in bs3 and f"launch<{shape}, {block_b}>" in bs3
    assert f"constexpr int kWidth = {tseip.RK4_WIDTH};" in rk4
    rhs = (_build.SRC_DIR / "seip_rhs.cuh").read_text()
    assert f"kMaxKnots = {tseip.MAX_KNOTS};" in rhs
    assert f"kHead = {tseip.TIME_HEAD};" in rhs
    for name, text in (("dynode_seip_time_table", rk4), ("dynode_seip_rk4", rk4),
                       ("dynode_seip_bs3", bs3)):
        assert f'extern "C" int {name}(' in text


_RK4_MANGLED = ("_ZN44_GLOBAL__N__b6e0147a_11_seip_rk4_cu_1e2cf0b615seip_rk4_kernelILi4ELi4ELi4ELi4ELi2E"
                "Lb1ELi16EEEvN11dynode_seip6ConstsIXT_EXT0_EXT1_EXT2_EXT3_EEEPKfS5_S5_NS1_4OutsEifffii")
_TABLE_MANGLED = ("_ZN44_GLOBAL__N__b6e0147a_11_seip_rk4_cu_1e2cf0b622seip_time_table_kernelILi4ELi4ELi4E"
                  "Li4ELi2ELb1EEEvN11dynode_seip6ConstsIXT_EXT0_EXT1_EXT2_EXT3_EEEffiPf")
_OTHER_MANGLED = ("_ZN53_GLOBAL__N__60a38f7a_20_multistrain_tsit5_cu_a4f11b3524multistrain_tsit5_kernel"
                  "ILi3ELi2EEEvPKfS2_S2_Pfifii")


@pytest.mark.parametrize("mangled, label", [
    (_RK4_MANGLED, "seip_rk4_kernel<16>"),
    (_TABLE_MANGLED, "seip_time_table_kernel"),
    (_OTHER_MANGLED, _OTHER_MANGLED),
])
def test_kernel_label_names_the_variant(mangled, label):
    """A SEIP kernel is named by the template arguments after the model's
    shape (the RK4 kernel's CTA width); other symbols keep their
    mangled name."""
    assert _build.kernel_label(mangled) == label


def test_ptxas_resources_reads_registers_and_spills():
    """Registers and spill bytes of each kernel of an ``-Xptxas -v`` log, by
    kernel label (the log's lines as nvcc 12.8 writes them)."""
    log = (f"ptxas info    : Compiling entry function '{_RK4_MANGLED}' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    80 bytes stack frame, 84 bytes spill stores, 192 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers, 80 bytes cumulative stack size\n"
           f"ptxas info    : Compiling entry function '{_TABLE_MANGLED}' for 'sm_90a'\n"
           "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 26 registers, used 0 barriers\n")
    assert _build.ptxas_resources(log) == {
        "seip_rk4_kernel<16>": {"spill_stores": 84, "spill_loads": 192, "registers": 128},
        "seip_time_table_kernel": {"spill_stores": 0, "spill_loads": 0, "registers": 26},
    }


def test_sass_mix_counts_the_instruction_classes():
    """The static mix of a ``cuobjdump -sass`` listing: predicated
    instructions count by their opcode, encoding lines and kernels whose name
    lacks the match are skipped, MUFU counts in all and by function."""
    text = "\n".join([
        f"\t\tFunction : {_OTHER_MANGLED}",
        "        /*0000*/                   FFMA R1, R2, R3, R4 ;   /* 0x000 */",
        f"\t\tFunction : {_RK4_MANGLED}",
        "\t.headerflags\t@\"EF_CUDA_SM90\"",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */",
        "                                                            /* 0x000fe40000000800 */",
        "        /*0010*/                   FFMA R2, R3, R4, R5 ;",
        "        /*0020*/                   FADD.FTZ R2, R3, R4 ;",
        "        /*0030*/              @!P0 FMUL R2, R3, R4 ;",
        "        /*0040*/                   FMNMX R2, R3, R4, !PT ;",
        "        /*0050*/                   MUFU.RCP R6, R2 ;",
        "        /*0060*/               @P1 MUFU.EX2 R6, R2 ;",
        "        /*0070*/                   SHFL.BFLY PT, R7, R6, 0x1, 0x1f ;",
        "        /*0080*/                   LDS.128 R8, [R1] ;",
        "        /*0090*/                   STS [R1], R8 ;",
        "        /*00a0*/                   LDG.E.CONSTANT R8, desc[UR4][R2.64] ;",
        "        /*00b0*/                   STG.E.128 desc[UR4][R2.64], R8 ;",
        "        /*00c0*/                   STL [R1], R8 ;",
        "        /*00d0*/                   LDL R8, [R1] ;",
        "        /*00e0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
        "        /*00f0*/                   EXIT ;",
    ])
    assert _build.sass_mix(text) == {"seip_rk4_kernel<16>": {
        "total": 16, "FP32": 4, "FFMA": 1, "MUFU": 2, "MUFU.RCP": 1, "MUFU.EX2": 1, "SHFL": 1, "LDS": 1,
        "STS": 1, "LDG": 1, "STG": 1, "LDL/STL": 2, "BAR": 1}}


def test_sass_mix_takes_any_kernel_name():
    """``match`` picks the kernels of a listing by name: the Triton adaptive
    kernel's cubin names it ``solve_adaptive``, and the default still picks
    only the SEIP kernels."""
    text = "\n".join([
        "\t\tFunction : solve_adaptive",
        "        /*0000*/                   FMUL R2, R3, R4 ;",
        "        /*0010*/                   SHFL.BFLY PT, R7, R6, 0x1, 0x1f ;",
        "        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;",
        f"\t\tFunction : {_RK4_MANGLED}",
        "        /*0000*/                   FADD R2, R3, R4 ;",
    ])
    assert _build.sass_mix(text, match="solve_adaptive") == {"solve_adaptive": {
        "total": 3, "FP32": 1, "SHFL": 1, "BAR": 1}}
    assert _build.sass_mix(text) == {"seip_rk4_kernel<16>": {"total": 1, "FP32": 1}}


def test_cuobjdump_beside_nvcc_then_in_triton(tmp_path, monkeypatch):
    """The tool beside nvcc wins; without it, the one Triton ships under
    ``triton/backends/nvidia/bin/``; with neither, None."""
    cuda_bin, triton_pkg = tmp_path / "cuda" / "bin", tmp_path / "triton"
    (triton_pkg / "backends" / "nvidia" / "bin").mkdir(parents=True)
    cuda_bin.mkdir(parents=True)
    (triton_pkg / "__init__.py").write_text("")
    shipped = triton_pkg / "backends" / "nvidia" / "bin" / "cuobjdump"
    shipped.write_text("")
    spec = type("Spec", (), {"origin": str(triton_pkg / "__init__.py")})()
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(cuda_bin / "nvcc"))
    monkeypatch.setattr(_build.importlib.util, "find_spec", lambda name: spec if name == "triton" else None)
    assert _build.cuobjdump() == shipped
    (cuda_bin / "cuobjdump").write_text("")
    assert _build.cuobjdump() == cuda_bin / "cuobjdump"

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    assert _build.cuobjdump() == shipped
    monkeypatch.setattr(_build.importlib.util, "find_spec", lambda name: None)
    assert _build.cuobjdump() is None
    assert _build.sass_counts(tmp_path / "lib.so") is None


@pytest.mark.parametrize(
    "make",
    [
        lambda: dynode_tpu_torch.multistrain_default_params(),
        lambda: dynode_tpu_torch.multistrain_initial_state(),
        lambda: dynode_tpu_torch.convert.params_from_numpy(
            {k: np.ones(3) for k in ("beta", "sigma", "gamma", "omega", "contact_matrix")}),
        lambda: dynode_tpu_torch.convert.state_from_numpy((np.ones(2),) + (np.ones((2, 3)),) * 4),
        lambda: dynode_tpu_torch.seip_default_params(True),
        lambda: dynode_tpu_torch.seip_initial_state(True),
        lambda: dynode_tpu_torch.convert.seip_params_from_numpy(
            {**{k: np.ones(2) for k in ("beta", "sigma", "gamma")}, "seasonal_vaccination": False}),
        lambda: dynode_tpu_torch.convert.seip_state_from_numpy((np.ones((4, 4, 3, 4)),) * 4),
    ],
    ids=["default_params", "initial_state", "params_from_numpy", "state_from_numpy",
         "seip_default_params", "seip_initial_state", "seip_params_from_numpy",
         "seip_state_from_numpy"],
)
def test_constructors_default_to_the_card(make, monkeypatch):
    """With no device a constructor puts its tensors on the card; on a box
    without one it raises and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make()
    with pytest.raises(RuntimeError, match="is_available"):
        _device.default_device()
