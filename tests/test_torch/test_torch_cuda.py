"""The port's kernels against their plain versions, on the card.

Every test here needs an H100 (compute capability 9.0) and skips elsewhere.
The file imports no JAX, so that it also runs where JAX is not installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch/test_torch_cuda.py

(``--noconftest`` because the repository's root conftest configures JAX.)
Tolerance throughout: max |kernel - plain| <= 1e-5 * max |plain| for float32
saves -- both are float32, but nvcc and Triton contract multiply-adds into
FMAs where the plain version rounds twice.
"""

import numpy as np
import pytest
import torch

from dynode_tpu_torch.models import multistrain as model
from dynode_tpu_torch.ops import generic as gen
from dynode_tpu_torch.ops import generic_triton as gtri
from dynode_tpu_torch.ops import multistrain as ms

B = 4096
DAYS = 200.0
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an H100 (CUDA compute capability 9.0)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _inputs(dev, n_age=2):
    if n_age == 2:
        params = model.multistrain_default_params(device=dev)
        y0 = model.multistrain_initial_state(device=dev)
    else:
        r0s = (2.0, 2.5)
        params = model.multistrain_default_params(
            r0s, (7.0, 6.0), (3.0, 2.5), (60.0, 80.0), n_age=3, device=dev)
        y0 = model.multistrain_initial_state(r0s, (0.4, 0.4, 0.2), device=dev)
    scales = np.random.default_rng(7).uniform(0.6, 1.6, B)
    beta = params.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32, device=dev)[:, None]
    return params, y0, beta


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ms.INSTANTIATED)
def test_cuda_kernel_matches_plain_version(cuda, shape):
    n_age, n_strain = shape
    params, y0, beta = _inputs(cuda, n_age)
    args = (y0, beta, params.sigma, params.gamma, params.omega, params.contact_matrix)
    kw = dict(batch=B, duration=DAYS, dt=0.5, n_age=n_age, n_strain=n_strain)
    before = ms.launch_multistrain_tsit5.launches
    got = ms.ensemble_solve_tsit5(*args, **kw)
    assert ms.launch_multistrain_tsit5.launches == before + 1
    want = ms.ensemble_solve_reference(*args, **kw)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["tsit5", "bosh3", "rk4"])
def test_triton_kernel_matches_plain_version(cuda, method):
    params, y0, beta = _inputs(cuda)
    rhs = ms.multistrain_rows_rhs(params.contact_matrix)
    y = ms.pack_state(y0, B)
    p = ms.pack_params(beta, params.sigma, params.gamma, params.omega, B)
    before = gtri.launch_rk_solve.launches
    got = gen.ensemble_solve_kernel(rhs, y, p, duration=DAYS, dt=0.5, method=method)
    assert gtri.launch_rk_solve.launches == before + 1
    want = gen.ensemble_solve_kernel_reference(rhs, y, p, duration=DAYS, dt=0.5, method=method)
    assert _rel(got, want) <= TOL


@pytest.mark.cuda
def test_triton_obs_saves_bf16_padded(cuda):
    """c rows only, bf16, padded layout: zero padding rows; tolerance 1e-2
    (one bf16 ulp is 2**-8 of the value)."""
    params, y0, beta = _inputs(cuda)
    rhs = ms.multistrain_rows_rhs(params.contact_matrix)
    y = ms.pack_state(y0, B)
    p = ms.pack_params(beta, params.sigma, params.gamma, params.omega, B)
    rows = tuple(range(20, 26))
    got = gen.ensemble_solve_kernel(rhs, y, p, duration=DAYS, dt=0.5, save_rows=rows,
                                    save_dtype=torch.bfloat16, padded_rows=True)
    assert got.shape == (int(DAYS) + 1, 8, B) and got.dtype == torch.bfloat16
    assert not got[:, 6:].any()
    full = gen.ensemble_solve_kernel_reference(rhs, y, p, duration=DAYS, dt=0.5)
    want = gen.select_saves(full, rows, torch.bfloat16, True)
    assert _rel(got[:, :6], want[:, :6]) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["cuda", "triton"])
def test_ragged_last_block_matches_plain_version(cuda, kernel):
    """B = 4,095 is a multiple of neither the CUDA block (128 threads) nor the
    Triton BLOCK (64), so each kernel runs its masked last block."""
    n = B - 1
    params, y0, beta = _inputs(cuda)
    beta = beta[:n]
    if kernel == "cuda":
        args = (y0, beta, params.sigma, params.gamma, params.omega, params.contact_matrix)
        kw = dict(batch=n, duration=DAYS, dt=0.5)
        got = ms.ensemble_solve_tsit5(*args, **kw)
        want = ms.ensemble_solve_reference(*args, **kw)
    else:
        rhs = ms.multistrain_rows_rhs(params.contact_matrix)
        y = ms.pack_state(y0, n)
        p = ms.pack_params(beta, params.sigma, params.gamma, params.omega, n)
        got = gen.ensemble_solve_kernel(rhs, y, p, duration=DAYS, dt=0.5)
        want = gen.ensemble_solve_kernel_reference(rhs, y, p, duration=DAYS, dt=0.5)
    assert got.shape == want.shape and got.shape[-1] == n
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL


@pytest.mark.cuda
def test_kernels_agree_with_each_other(cuda):
    """The CUDA and Triton kernels are independent implementations of the
    same Tsit5 solve."""
    params, y0, beta = _inputs(cuda)
    a = ms.ensemble_solve_tsit5(y0, beta, params.sigma, params.gamma, params.omega,
                                params.contact_matrix, batch=B, duration=DAYS)
    b = gen.ensemble_solve_kernel(
        ms.multistrain_rows_rhs(params.contact_matrix), ms.pack_state(y0, B),
        ms.pack_params(beta, params.sigma, params.gamma, params.omega, B),
        duration=DAYS, dt=0.5)
    assert _rel(b, a) <= TOL
