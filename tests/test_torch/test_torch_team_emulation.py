"""The two multi-strain CUDA kernels' team mapping, checked on the CPU.

A CUDA kernel cannot run here, but the two multi-strain sources use only a
few CUDA pieces: thread and block indices, ``__ldg`` and ``__shfl_sync``.
This test compiles ``csrc/multistrain_tsit5.cu`` and
``csrc/multistrain_tsit5_2d.cu`` with the host C++ compiler against a small
emulation of those pieces (``cuda_emulation.py``: each warp is 32 threads
that meet at every shuffle, as a warp's lanes do) and holds what they
compute against the plain versions on the same inputs. It shows that the
lanes of a team hold the right ages, read the right lanes, store the right
rows (the 2-D kernel's padding rows as zero) and that lanes past the batch
store nothing, at every team width the launchers may pick and on ragged
batches.

Tolerance: bit for bit. The emulation rounds every float32 operation
(``-ffp-contract=off``), in the kernels' expression order, which is the
plain versions'; on the card nvcc contracts multiply-adds, and
``test_torch_cuda.py`` holds the kernels there to 1e-5.
"""

import shutil

import numpy as np
import pytest
import torch

import cuda_emulation
from dynode_tpu_torch.models import multistrain as model
from dynode_tpu_torch.ops import _build
from dynode_tpu_torch.ops import multistrain as ms

DAYS = 3.0
OTHER = dict(r0s=(2.0, 2.5), tinf=(7.0, 6.0), tlat=(3.0, 2.5), twane=(60.0, 80.0), demo=(0.4, 0.4, 0.2))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both sources built for the host, with the CUDA pieces emulated
    (``cuda_emulation.py``)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    return {name: getattr(cuda_emulation.build(name, (_build.SRC_DIR / f"{name}.cu").read_text(),
                                               tmp_path_factory.mktemp(name),
                                               {f"dynode_{name}": _build.argtypes()[f"dynode_{name}"]}),
                          f"dynode_{name}")
            for name in ("multistrain_tsit5", "multistrain_tsit5_2d")}


def _inputs(shape, batch):
    if shape == (2, 3):
        params = model.multistrain_default_params(device="cpu")
        y0 = model.multistrain_initial_state(device="cpu")
    else:
        params = model.multistrain_default_params(OTHER["r0s"], OTHER["tinf"], OTHER["tlat"],
                                                  OTHER["twane"], n_age=3, device="cpu")
        y0 = model.multistrain_initial_state(OTHER["r0s"], OTHER["demo"], device="cpu")
    scales = np.random.default_rng(batch).uniform(0.6, 1.6, batch)
    beta = params.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32)[:, None]
    return y0, (beta, params.sigma, params.gamma, params.omega), params.contact_matrix


CASES = [(kernel, shape, team, batch) for kernel in ("multistrain_tsit5", "multistrain_tsit5_2d")
         for shape in ms.INSTANTIATED for team in ms.teams(shape[0]) for batch in (17, 45)]


@pytest.mark.parametrize("kernel, shape, team, batch", CASES,
                         ids=[f"{k.removeprefix('multistrain_')}-{a}x{s}-team{t}-B{b}"
                              for k, (a, s), t, b in CASES])
def test_team_mapping_matches_plain_version(libs, kernel, shape, team, batch):
    """B = 17 and 45 end inside a warp at every team width (32, 16 or 10
    members a warp) and inside a 64-thread block; the output starts as NaN,
    so a row no lane writes shows."""
    n_age, n_strain = shape
    y0, rates, contact = _inputs(shape, batch)
    n_steps, stride = int(DAYS / 0.5), 2
    flat = contact.to(torch.float32).reshape(-1).contiguous()
    if kernel == "multistrain_tsit5":
        y, p = ms.pack_state(y0, batch, n_age, n_strain), ms.pack_params(*rates, batch, n_strain)
        want = ms.ensemble_solve_reference(y0, *rates, contact, batch=batch, duration=DAYS,
                                           n_age=n_age, n_strain=n_strain)
    else:
        y, p = ms.pack_state_2d(y0, batch, n_age, n_strain), ms.pack_rates_2d(*rates, batch, n_age, n_strain)
        want = ms._solve_2d_reference(y, p, duration=DAYS, dt=0.5, save_every=1.0,
                                      contact_tuple=ms._contact_tuple(contact), n_age=n_age, n_strain=n_strain)
    got = torch.full(want.shape, float("nan"))
    rc = libs[kernel](n_age, n_strain, team, 64, y.data_ptr(), p.data_ptr(), flat.data_ptr(),
                      got.data_ptr(), batch, 0.5, n_steps, stride, None)
    assert rc == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["multistrain_tsit5", "multistrain_tsit5_2d"])
def test_entry_rejects_other_teams_and_widths(libs, kernel):
    """The C entry returns cudaErrorInvalidValue (1) for a team or a block
    width it is not compiled for, before any launch."""
    y = torch.zeros(64, 4)
    for team, threads in ((3, 64), (2, 48), (2, 512), (1, 0)):
        rc = libs[kernel](2, 3, team, threads, y.data_ptr(), y.data_ptr(), y.data_ptr(), y.data_ptr(),
                          4, 0.5, 2, 1, None)
        assert rc == 1
