"""The multi-strain kernels #2 and #6 at shapes beyond the library's, against
the JAX package; and their shape builds run on the CPU under a host
emulation of CUDA.

The library instantiates the two kernels at (A, K) = (2, 3) and (3, 2).
Every other shape goes to a unit ``ops/_build.py`` generates: the
library's own templates, instantiated at the shape. On the CPU the entry
points run their plain versions, held here against
``dynode_tpu.ops.ensemble_solve_tsit5`` / ``_2d`` at (1, 1), (4, 2),
(4, 3), (5, 2) and (8, 4); the generated units are compiled for the host
(``cuda_emulation.py``) and held against the plain versions bit for bit at
each team width (one lane per member, one per age). On the card,
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 18 hold them again.
"""

import jax
import numpy as np
import pytest
import torch

import cuda_emulation
import dynode_tpu.ops.multistrain_pallas as jmp
from dynode_tpu_torch.ops import _build
from dynode_tpu_torch.ops import multistrain as tms

SHAPES = [(1, 1), (4, 2), (4, 3), (5, 2), (8, 4)]
IDS = [f"{a}x{k}" for a, k in SHAPES]


def _inputs(shape, batch, seed):
    """Per-member betas, per-strain rates, a contact matrix and a state of
    thousands per age, from numpy with a seed."""
    A, K = shape
    rng = np.random.default_rng(seed)
    f32 = np.float32
    y0 = (rng.uniform(5e3, 1e4, A).astype(f32), *(rng.uniform(0, 50, (A, K)).astype(f32) for _ in range(2)),
          rng.uniform(0, 500, (A, K)).astype(f32), np.zeros((A, K), f32))
    beta = rng.uniform(0.2, 0.6, (batch, K)).astype(f32)
    rates = tuple((1 / rng.uniform(lo, hi, K)).astype(f32) for lo, hi in ((2, 5), (5, 8), (60, 200)))
    contact = (rng.uniform(0.2, 1.5, (A, A)) / A).astype(f32)
    return y0, beta, rates, contact


def _torch(y0, beta, rates, contact):
    return (tuple(torch.as_tensor(x) for x in y0), torch.as_tensor(beta), *map(torch.as_tensor, rates),
            torch.as_tensor(contact))


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_row_solve_matches_jax(shape):
    """B = 16, 2 days at dt = 0.5, against ``ensemble_solve_tsit5`` (its
    plain version on the CPU, run eagerly: jitted, its unrolled rows take
    minutes to compile at (8, 4)). Tolerance: max |diff| <= 1e-5 * max |JAX|,
    that of ``test_torch_ops_multistrain.py``: float32 in the same
    expression order."""
    A, K = shape
    y0, beta, rates, contact = _inputs(shape, 16, seed=A * 10 + K)
    kw = dict(batch=16, duration=2.0, dt=0.5, n_age=A, n_strain=K)
    with jax.disable_jit():
        want = np.asarray(jmp.ensemble_solve_tsit5(y0, beta, *rates, contact, **kw), np.float64)
    got = tms.ensemble_solve_tsit5(*_torch(y0, beta, rates, contact), **kw)
    assert got.shape == want.shape == (3, A + 4 * A * K, 16) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_2d_solve_matches_jax(shape):
    """B = 16, 20 days at dt = 0.5, against ``ensemble_solve_tsit5_2d``.
    Tolerance: max |diff| <= 1e-5 * max |JAX|, that of
    ``test_torch_ops_multistrain_2d.py``. The padding rows are zero on both
    sides; at (4, 2) and (8, 4) no e / i / r / c group pads."""
    A, K = shape
    y0, beta, rates, contact = _inputs(shape, 16, seed=A * 10 + K + 1)
    kw = dict(batch=16, duration=20.0, dt=0.5, n_age=A, n_strain=K)
    want = np.asarray(jmp.ensemble_solve_tsit5_2d(y0, beta, *rates, contact, block_b=16, **kw), np.float64)
    got = tms.ensemble_solve_tsit5_2d(*_torch(y0, beta, rates, contact), **kw)
    _, d2 = tms._offsets_2d(A, K)
    assert got.shape == want.shape == (21, d2, 16) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    pad = sorted(set(range(d2)) - set(tms._live_rows_2d(A, K)))
    assert not got[:, pad].any() and not want[:, pad].any()


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """Each shape's two generated units, built for the host."""
    if cuda_emulation.shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host emulation")
    return cuda_emulation.build_family_units(
        [(kernel, shape) for kernel in ("multistrain_tsit5", "multistrain_tsit5_2d") for shape in SHAPES],
        tmp_path_factory)


CASES = [(kernel, shape, team) for kernel in ("multistrain_tsit5", "multistrain_tsit5_2d") for shape in SHAPES
         for team in tms.teams(shape[0])]


@pytest.mark.parametrize("kernel, shape, team", CASES,
                         ids=[f"{k.removeprefix('multistrain_')}-{a}x{s}-team{t}" for k, (a, s), t in CASES])
def test_shape_units_match_plain_versions(units, kernel, shape, team):
    """B = 17 (inside a warp at every team width: 32, 8, 6 or 4 members a
    warp) over 3 days, in 64-thread blocks (at one lane a member the
    block's second warp lies past the batch); the output starts as NaN, so
    a row no lane writes shows. Tolerance: bit for bit -- the emulation
    rounds every float32 operation, in the kernels' expression order,
    which is the plain versions'."""
    A, K = shape
    n = 17
    y0, beta, *rates, contact = _torch(*_inputs(shape, n, seed=3))
    flat = contact.reshape(-1).contiguous()
    if kernel == "multistrain_tsit5":
        y, p = tms.pack_state(y0, n, A, K), tms.pack_params(beta, *rates, n, K)
        want = tms.ensemble_solve_reference(y0, beta, *rates, contact, batch=n, duration=3.0, n_age=A, n_strain=K)
    else:
        y, p = tms.pack_state_2d(y0, n, A, K), tms.pack_rates_2d(beta, *rates, n, A, K)
        want = tms._solve_2d_reference(y, p, duration=3.0, dt=0.5, save_every=1.0,
                                       contact_tuple=tms._contact_tuple(contact), n_age=A, n_strain=K)
    got = torch.full(want.shape, float("nan"))
    entry = getattr(units[kernel, shape], f"dynode_{kernel}_shape")
    assert entry(A, K, team, 64, y.data_ptr(), p.data_ptr(), flat.data_ptr(), got.data_ptr(), n, 0.5, 6, 2,
                 None) == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["multistrain_tsit5", "multistrain_tsit5_2d"])
def test_shape_entry_rejects_other_shapes_teams_and_widths(units, kernel):
    """A unit's entry takes its own shape only, a team of 1 or A lanes and a
    block of a multiple of 32 threads up to 256: anything else returns
    cudaErrorInvalidValue (1) before any launch."""
    entry = getattr(units[kernel, (4, 3)], f"dynode_{kernel}_shape")
    y = torch.zeros(64, 4)
    for a, k, team, threads in ((2, 3, 1, 64), (4, 3, 2, 64), (4, 3, 4, 48), (4, 3, 1, 512)):
        assert entry(a, k, team, threads, *(y.data_ptr(),) * 4, 4, 0.5, 2, 1, None) == 1


def test_generated_units():
    """The units instantiate the library's templates at their shape: teams of
    1 and A lanes (one only at A = 1, and above a warp's 32 ages); the 2-D
    unit replaces the library's ``Layout`` only where no e / i / r / c group
    pads (A K a multiple of 8), which the library's asserts against."""
    for a, k in SHAPES + [(40, 1)]:
        row = _build.FAMILIES["multistrain_tsit5"].unit((a, k))
        assert '#include "multistrain_tsit5.cu"' in row
        assert f"launch_team<{a}, {k}, 1>(" in row
        assert row.count("launch_team<") == (2 if 1 < a <= tms.MAX_TEAM else 1)
        two_d = _build.FAMILIES["multistrain_tsit5_2d"].unit((a, k))
        assert ("struct Layout<" in two_d) == ((a * k) % 8 == 0)
    assert _build.shape_tag("multistrain_tsit5_2d", (4, 3)) == "multistrain_tsit5_2d_4_3"
    with pytest.raises(ValueError, match="unknown kernel family"):
        _build.shape_tag("rk_solve", (4, 3))


def test_team_choice_at_any_shape():
    """One lane per age up to ``TEAM_UP_TO`` members and ``MAX_TEAM`` ages
    (a team lies within a warp), else one lane per member; at one age the
    two are the same team."""
    assert tms.teams(4) == (1, 4) and tms.pick_team(9984, 4) == 4
    assert tms.teams(1) == (1,) and tms.pick_team(9984, 1) == 1
    assert tms.teams(tms.MAX_TEAM) == (1, tms.MAX_TEAM)
    assert tms.teams(tms.MAX_TEAM + 1) == (1,) and tms.pick_team(9984, tms.MAX_TEAM + 1) == 1
    assert tms.pick_team(tms.TEAM_UP_TO + 1, 4) == 1
    with pytest.raises(ValueError, match="team must be one of"):
        tms._launch_shape(17, 40, 40, None)


def test_shape_limit():
    """Every shape up to ``MAX_ROWS`` state rows passes the check, the first
    past it raises naming the limit, as does a shape with no age or strain."""
    tms._check_shape(8, 4)
    tms._check_shape(1, (tms.MAX_ROWS - 1) // 4)
    for a, k in ((1, (tms.MAX_ROWS - 1) // 4 + 1), (0, 3), (4, 0)):
        with pytest.raises(ValueError, match=f"at most {tms.MAX_ROWS} state rows"):
            tms._check_shape(a, k)
