"""The scenario-ensemble slice end to end, and the port's guard rails.

The slice is the path of ``examples/ensemble_scenarios.py`` part 1: default
parameters and initial state, per-member R0 scales, ``ensemble_solve_tsit5``,
``unpack_saves`` and the peak-day summary. Both packages get the same numpy
draws.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dynode_tpu.ops.multistrain_pallas as jmp
from dynode_tpu.models.multistrain import (
    multistrain_config,
    multistrain_initial_state,
    multistrain_odeparams,
)
import dynode_tpu_torch
from dynode_tpu_torch import _device
from dynode_tpu_torch.ops import _build
from dynode_tpu_torch.ops import multistrain as tms

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

    params = dynode_tpu_torch.multistrain_default_params()
    y0 = dynode_tpu_torch.multistrain_initial_state()
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


def test_import_leaves_jax_out():
    """``import dynode_tpu_torch`` (every module of it) loads no JAX."""
    code = (
        "import sys, pkgutil, importlib, dynode_tpu_torch\n"
        "for m in pkgutil.walk_packages(dynode_tpu_torch.__path__, 'dynode_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for path in (REPO / "dynode_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path


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
            tms.multistrain_rows_rhs(dynode_tpu_torch.multistrain_default_params().contact_matrix),
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
    """The nvcc command is composed, not run: sm_90a, a shared library with
    a plain C interface, the generated include dir, every source."""
    cmd = _build.nvcc_command("cuda/bin/nvcc", tmp_path / "lib.so", tmp_path / "inc")
    assert cmd[0] == "cuda/bin/nvcc"
    joined = " ".join(cmd)
    for flag in ("-gencode arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                 "-Xcompiler -fPIC", f"-I {tmp_path / 'inc'}", f"-o {tmp_path / 'lib.so'}"):
        assert flag in joined
    assert str(_build.SRC_DIR / "multistrain_tsit5.cu") in cmd
    assert "torch/extension.h" not in (_build.SRC_DIR / "multistrain_tsit5.cu").read_text()
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
    """The shapes the wrapper accepts are the ones the .cu instantiates."""
    src = (_build.SRC_DIR / "multistrain_tsit5.cu").read_text()
    for a, k in tms.INSTANTIATED:
        assert f"launch<{a}, {k}>" in src
