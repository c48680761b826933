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
from dynode_tpu_torch.ops import seip as tsp

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


def _inputs(dev, n_age=2, batch=B):
    if n_age == 2:
        params = model.multistrain_default_params(device=dev)
        y0 = model.multistrain_initial_state(device=dev)
    else:
        r0s = (2.0, 2.5)
        params = model.multistrain_default_params(
            r0s, (7.0, 6.0), (3.0, 2.5), (60.0, 80.0), n_age=3, device=dev)
        y0 = model.multistrain_initial_state(r0s, (0.4, 0.4, 0.2), device=dev)
    scales = np.random.default_rng(7).uniform(0.6, 1.6, batch)
    beta = params.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32, device=dev)[:, None]
    return params, y0, beta


#: every (shape, lanes per member) the multi-strain launchers may use
TEAMS = [(shape, team) for shape in ms.INSTANTIATED for team in ms.teams(shape[0])]
TEAM_IDS = [f"{a}x{k}-team{t}" for (a, k), t in TEAMS]


def _launch(kernel, y0, beta, params, n, shape, team):
    """One launch of a multi-strain kernel ("row" or "2d") at ``team``,
    with the plain version's result on the same inputs."""
    n_age, n_strain = shape
    rates = (beta, params.sigma, params.gamma, params.omega)
    grid = dict(dt=0.5, n_steps=int(2 * DAYS), save_stride=2, n_age=n_age, n_strain=n_strain)
    if kernel == "row":
        y, p = ms.pack_state(y0, n, *shape), ms.pack_params(*rates, n, n_strain)
        got = ms.launch_multistrain_tsit5(y, p, params.contact_matrix, team=team, **grid)
        want = ms.ensemble_solve_reference(y0, *rates, params.contact_matrix, batch=n,
                                           duration=DAYS, dt=0.5, n_age=n_age, n_strain=n_strain)
    else:
        y, p = ms.pack_state_2d(y0, n, *shape), ms.pack_rates_2d(*rates, n, *shape)
        got = ms.launch_multistrain_tsit5_2d(y, p, params.contact_matrix, team=team, **grid)
        want = ms._solve_2d_reference(y, p, duration=DAYS, dt=0.5, save_every=1.0,
                                      contact_tuple=ms._contact_tuple(params.contact_matrix),
                                      n_age=n_age, n_strain=n_strain)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("shape, team", TEAMS, ids=TEAM_IDS)
def test_cuda_kernel_matches_plain_version(cuda, shape, team):
    """The row kernel at every team width, and through its entry point
    (the launcher's own choice of team)."""
    n_age, n_strain = shape
    params, y0, beta = _inputs(cuda, n_age)
    before = ms.launch_multistrain_tsit5.launches
    got, want = _launch("row", y0, beta, params, B, shape, team)
    assert ms.launch_multistrain_tsit5.launches == before + 1
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL
    args = (y0, beta, params.sigma, params.gamma, params.omega, params.contact_matrix)
    entry = ms.ensemble_solve_tsit5(*args, batch=B, duration=DAYS, dt=0.5, n_age=n_age,
                                    n_strain=n_strain)
    assert ms.launch_multistrain_tsit5.launches == before + 2
    assert _rel(entry, want) <= TOL


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


#: ragged batches of the multi-strain kernels: each ends inside a warp at
#: every team width (32, 16 or 10 members a warp) and inside a block
RAGGED_CASES = ([("triton", (2, 3), None, B - 1)]
                + [(kernel, shape, team, n) for kernel in ("cuda", "cuda_2d") for shape, team in TEAMS
                   for n in (17, B - 1, 9983)])
RAGGED_IDS = ["triton"] + [f"{kernel}-{a}x{k}-team{t}-B{n}" for kernel, (a, k), t, n in RAGGED_CASES[1:]]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, shape, team, n", RAGGED_CASES, ids=RAGGED_IDS)
def test_ragged_last_block_matches_plain_version(cuda, kernel, shape, team, n):
    """B = 4,095 is a multiple of neither the CUDA block nor the Triton BLOCK
    (64), so each kernel runs its masked last block; B = 17 and 9,983 end
    inside a warp of the CUDA kernels, whose idle lanes must store nothing
    and leave their neighbours' shuffles intact. The 2-D kernel's padding
    rows stay zero."""
    params, y0, beta = _inputs(cuda, shape[0], max(n, B))
    beta = beta[:n]
    if kernel != "triton":
        got, want = _launch("row" if kernel == "cuda" else "2d", y0, beta, params, n, shape, team)
        if kernel == "cuda_2d":
            pad = sorted(set(range(got.shape[1])) - set(ms._live_rows_2d(*shape)))
            assert not got[:, pad].any()
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


def _block_rel(got, want, block_b):
    """Per block: max |got - want| / max |want| over the block's members."""
    n = got.shape[-1]
    member = ((got.float() - want.float()).abs().amax(dim=(0, 1)) / want.float().abs().max())
    out = torch.zeros(-(-n // block_b), device=got.device)
    return out.scatter_reduce_(0, torch.arange(n, device=got.device) // block_b, member, "amax")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_adaptive_kernel_matches_plain_version(cuda, method):
    """B = 4,095 (a ragged last block), 200 days, rtol 1e-4, atol 1e-6, the
    same block width on both sides. The kernel rounds every product and sum
    of the solver as its plain version does, so every block takes the plain
    version's decisions; the saves agree to 1e-5, not exactly, because the
    multi-strain RHS divides with Triton's ``/``, which is not IEEE-rounded."""
    n = B - 1
    params, y0, beta = _inputs(cuda)
    rhs = ms.multistrain_rows_rhs(params.contact_matrix)
    y = ms.pack_state(y0, n)
    p = ms.pack_params(beta[:n], params.sigma, params.gamma, params.omega, n)
    kw = dict(duration=DAYS, rtol=1e-4, atol=1e-6, method=method)
    before = gtri.launch_rk_solve_adaptive.launches
    got, stats = gen.ensemble_solve_kernel_adaptive(rhs, y, p, **kw)
    assert gtri.launch_rk_solve_adaptive.launches == before + 1
    want, want_stats = gen.ensemble_solve_kernel_adaptive_reference(
        rhs, y, p, block_b=gen.ADAPTIVE_BLOCK, **kw)
    assert int(stats["exhausted_intervals"].sum()) == 0
    for key in stats:
        assert torch.equal(stats[key], want_stats[key]), key
    assert float(_block_rel(got, want, gen.ADAPTIVE_BLOCK).max()) <= TOL


def _sir_nan_rhs():
    """SIR whose members give NaN from their own time on: ``y = [s, i, r]``,
    ``p = [beta, gamma, t_nan]``; ds/dt is NaN once ``t >= t_nan``. No
    division, so the kernel's arithmetic is the plain version's throughout."""

    def torch_fn(y, p, t):
        inf = p[0] * y[0] * y[1]
        rec = p[1] * y[1]
        return [torch.where(t >= p[2], float("nan"), -inf), inf - rec, rec]

    def triton_factory():
        import triton
        import triton.language as tl

        @triton.jit
        def sir_nan(y, p, t, C):
            inf = p[0] * y[0] * y[1]
            rec = p[1] * y[1]
            return (tl.where(t >= p[2], float("nan"), -inf), inf - rec, rec)

        return sir_nan

    return gen.RowsRHS(torch_fn, triton_factory)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bosh3", "tsit5"])
def test_adaptive_kernel_non_finite_norm(cuda, method):
    """One member of block 1 turns NaN at t = 5.3: from then on every attempt
    of that block that reaches t = 5.3 has a NaN norm and is rejected at
    factor 0.2, so the block creeps towards 5.3 and runs out of budget in
    every later interval. The one block reduction of the kernel must give
    what the plain version's ``amax`` gives: statistics, NaN slots and saves
    equal exactly, in every block; the other blocks equal a solve in which no
    member turns NaN. B = 4,095 (a ragged last block), 20 days."""
    n, bad, t_nan = B - 1, 100, 5.3
    rng = np.random.default_rng(11)
    y = torch.tensor(np.stack([np.full(n, 0.99), np.full(n, 0.01), np.zeros(n)]),
                     dtype=torch.float32, device=cuda)
    t_row = np.full(n, np.inf)
    t_row[bad] = t_nan
    p = torch.tensor(np.stack([rng.uniform(0.2, 0.5, n), np.full(n, 0.1), t_row]),
                     dtype=torch.float32, device=cuda)
    rhs = _sir_nan_rhs()
    kw = dict(duration=20.0, rtol=1e-4, atol=1e-6, method=method)
    got, stats = gen.ensemble_solve_kernel_adaptive(rhs, y, p, **kw)
    want, want_stats = gen.ensemble_solve_kernel_adaptive_reference(
        rhs, y, p, block_b=gen.ADAPTIVE_BLOCK, **kw)
    for key in stats:
        assert torch.equal(stats[key], want_stats[key]), key
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    blk = bad // gen.ADAPTIVE_BLOCK
    nan_slots = torch.isnan(got[..., blk * gen.ADAPTIVE_BLOCK:(blk + 1) * gen.ADAPTIVE_BLOCK]).all(dim=(1, 2))
    n_bad = int(stats["exhausted_intervals"][blk])
    assert n_bad == 20 - int(t_nan) and int(nan_slots.sum()) == n_bad and not nan_slots[: int(t_nan) + 1].any()
    finite = p.clone()
    finite[2, bad] = float("inf")
    ref, ref_stats = gen.ensemble_solve_kernel_adaptive(rhs, y, finite, **kw)
    others = torch.arange(stats["n_accepted"].shape[0], device=cuda) != blk
    for key in stats:
        assert torch.equal(stats[key][others], ref_stats[key][others]), key
    cols = torch.arange(n, device=cuda) // gen.ADAPTIVE_BLOCK != blk
    assert torch.equal(got[..., cols], ref[..., cols])
    assert int(ref_stats["exhausted_intervals"].sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape, team", TEAMS, ids=TEAM_IDS)
def test_2d_kernel_matches_plain_version_and_row_kernel(cuda, shape, team):
    """B = 4,095 (a ragged last warp): the 2-D kernel at every team width
    against its plain version, with zero padding rows, through its entry
    point (the launcher's own team) as well, and against the row kernel
    after unpacking (the same model in another expression order)."""
    n_age, n_strain = shape
    params, y0, beta = _inputs(cuda, n_age)
    n = B - 1
    args = (y0, beta[:n], params.sigma, params.gamma, params.omega, params.contact_matrix)
    kw = dict(batch=n, duration=DAYS, dt=0.5, n_age=n_age, n_strain=n_strain)
    before = ms.launch_multistrain_tsit5_2d.launches
    got, want = _launch("2d", y0, beta[:n], params, n, shape, team)
    assert ms.launch_multistrain_tsit5_2d.launches == before + 1
    assert torch.isfinite(got).all() and _rel(got, want) <= TOL
    entry = ms.ensemble_solve_tsit5_2d(*args, **kw)
    assert ms.launch_multistrain_tsit5_2d.launches == before + 2
    assert _rel(entry, want) <= TOL
    pad = sorted(set(range(got.shape[1])) - set(ms._live_rows_2d(n_age, n_strain)))
    assert not got[:, pad].any()  # padding rows stay zero
    rows = ms.ensemble_solve_tsit5(*args, **kw)
    for a, b in zip(ms.unpack_saves_2d(got, n_age, n_strain), ms.unpack_saves(rows, n_age, n_strain)):
        assert _rel(a, b) <= TOL


@pytest.mark.cuda
def test_constructors_default_to_the_card(cuda):
    """With no device the constructors put their tensors on the card."""
    from dynode_tpu_torch import convert

    params = model.multistrain_default_params()
    state = model.multistrain_initial_state()
    assert params.beta.is_cuda and params.contact_matrix.is_cuda
    assert all(x.is_cuda for x in state)
    assert convert.params_from_numpy(
        {k: np.ones(3) for k in ("beta", "sigma", "gamma", "omega", "contact_matrix")}).beta.is_cuda
    assert all(x.is_cuda for x in convert.state_from_numpy((np.ones(2),) + (np.ones((2, 3)),) * 4))


def _seip_inputs(dev, n, per_strain=False):
    from dynode_tpu_torch.models import seip as seip_model

    params = seip_model.seip_default_params(True)
    y0 = seip_model.seip_initial_state(True)
    rng = np.random.default_rng(11)
    scales = rng.uniform(0.85, 1.2, (2, n) if per_strain else n)
    return params, y0, torch.as_tensor(scales, dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("per_strain", [False, True])
def test_seip_rk4_kernel_matches_plain_version(cuda, per_strain):
    """B = 2,047 (a ragged last CTA), 60 days at dt = 0.5, every compartment
    in float32; then bf16 C saves in the packed layout at B = 2,048 (one
    bf16 rounding of values that agree to 1e-5: tolerance 1e-2)."""
    from dynode_tpu_torch.ops import seip as tsp

    params, y0, scales = _seip_inputs(cuda, 2047, per_strain)
    before = tsp.launch_seip_rk4.launches
    got = tsp.seip_ensemble_solve(y0, params, scales, duration=60.0)
    assert tsp.launch_seip_rk4.launches == before + 1
    want = tsp.seip_solve_reference(y0, params, scales, duration=60.0)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all() and _rel(g, w) <= TOL
    params, y0, scales = _seip_inputs(cuda, 2048, per_strain)
    (c16,) = tsp.seip_ensemble_solve(y0, params, scales, duration=60.0, save=(3,),
                                     save_dtype=torch.bfloat16, packed=True)
    (c32,) = tsp.seip_solve_reference(y0, params, scales, duration=60.0, save=(3,))
    assert c16.dtype == torch.bfloat16 and c16.shape == c32.shape[:-1] + (8, 256)
    assert _rel(tsp.unpack_members(c16), c32) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("save_dtype", [torch.float32, torch.bfloat16])
def test_seip_rk4_variants_match_plain_version(cuda, save_dtype):
    """The RK4 kernel (16 members per CTA), 60 days, member-last, every
    compartment and then C alone, at B = 4,095 (no multiple of 8:
    member-by-member bf16 saves everywhere), 4,100 (a multiple of 4 but not
    of 8, and a ragged last CTA) and 4,104 (a multiple of 8: 16-byte bf16
    saves where a CTA is full, a ragged last CTA); then B = 4,096 in the
    packed layout. The plain version is solved once at 4,104 and sliced:
    members do not interact. Tolerance 1e-5 (float32), 1e-2 (bf16)."""
    params, y0, scales = _seip_inputs(cuda, 4104, per_strain=True)
    P = tsp.seip_static_params(params)
    kw = dict(dt=0.5, n_steps=120, save_stride=2, save_dtype=save_dtype)
    tol = TOL if save_dtype == torch.float32 else 1e-2
    want = tsp.seip_solve_reference(y0, params, scales, duration=60.0)
    for b in (4095, 4100, 4104):
        got = tsp.launch_seip_rk4(y0, P, scales[:, :b], save=(0, 1, 2, 3), packed=False, **kw)
        for g, w in zip(got, want):
            assert g.dtype == save_dtype and torch.isfinite(g).all() and _rel(g, w[..., :b]) <= tol
        (c,) = tsp.launch_seip_rk4(y0, P, scales[:, :b], save=(3,), packed=False, **kw)
        assert _rel(c, want[3][..., :b]) <= tol
    (c,) = tsp.launch_seip_rk4(y0, P, scales[:, :4096], save=(3,), packed=True, **kw)
    assert c.dtype == save_dtype and _rel(tsp.unpack_members(c), want[3][..., :4096]) <= tol


@pytest.mark.cuda
def test_seip_time_table_kernel_equals_plain_version(cuda):
    """The RK4 kernel's time table against its plain version, the time rows
    of ``_time_scalars`` at the kernel's stage times (``rk4_stage_times``),
    over 200 days at dt = 0.5 and 60 days at dt = 0.3 (stage times off the
    step grid). Tolerance: bit for bit -- every operation is rounded on its
    own on both sides."""
    params, _, _ = _seip_inputs(cuda, 1)
    P = tsp.seip_static_params(params)
    for dt, n_steps in ((0.5, 400), (0.3, 200)):
        before = tsp.launch_seip_time_table.launches
        got = tsp.launch_seip_time_table(P, dt=dt, n_steps=n_steps, device=cuda)
        assert tsp.launch_seip_time_table.launches == before + 1
        want = tsp.seip_time_table_reference(P, dt=dt, n_steps=n_steps, device=cuda)
        assert got.shape == want.shape == (3 * n_steps, tsp.TIME_HEAD + 16)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("block_b", [4, 8, 16])
def test_seip_bs3_kernel_matches_plain_version(cuda, block_b):
    """B = 2,047, 60 days, rtol 1e-4, atol 1e-3, the same block width on
    both sides: the kernel rounds as its plain version, so every block takes
    the plain version's decisions and its saves equal the plain version's
    exactly."""
    params, y0, scales = _seip_inputs(cuda, 2047)
    kw = dict(duration=60.0, rtol=1e-4, atol=1e-3, save=(0, 3), block_b=block_b)
    before = tsp.launch_seip_bs3.launches
    got, stats = tsp.seip_ensemble_solve_adaptive(y0, params, scales, **kw)
    assert tsp.launch_seip_bs3.launches == before + 1
    want, want_stats = tsp.seip_solve_adaptive_reference(y0, params, scales, **kw)
    assert int(stats["exhausted_intervals"].sum()) == 0
    for key in stats:
        assert torch.equal(stats[key], want_stats[key])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_seip_constructors_default_to_the_card(cuda):
    from dynode_tpu_torch import convert
    from dynode_tpu_torch.models import seip as seip_model

    assert seip_model.seip_default_params(True).beta.is_cuda
    assert all(x.is_cuda for x in seip_model.seip_initial_state(True))
    assert all(x.is_cuda for x in convert.seip_state_from_numpy((np.ones((4, 4, 4, 4)),) * 4))


def _batched(params, scales):
    """Every field of ``params`` with a leading member axis, beta scaled."""
    import torch.utils._pytree as tree

    batch = tree.tree_map(lambda leaf: leaf.expand((scales.shape[0],) + leaf.shape), params)
    return batch.replace(beta=params.beta[None, :] * (scales if scales.dim() == 2 else scales[:, None]))


@pytest.mark.cuda
def test_simulate_ensemble_matches_the_kernel_on_the_card(cuda):
    """``simulate_ensemble`` lane-major (the eager engine, Tsit5 at dt =
    0.5) against kernel #2 on 4,095 members, and batch-leading against
    lane-major: max |d| <= 1e-5 * max |ref| per compartment."""
    from dynode_tpu_torch import SolverParams, simulate_ensemble

    params, y0, beta = _inputs(cuda, batch=B - 1)
    scales = beta[:, 0] / params.beta[0]
    sp = SolverParams(constant_step_size=0.5)
    lane = simulate_ensemble(model.multistrain_ode, int(DAYS), y0, _batched(params, scales), sp,
                             layout="lane_major")
    kernel = ms.unpack_saves(ms.ensemble_solve_tsit5(
        y0, beta, params.sigma, params.gamma, params.omega, params.contact_matrix,
        batch=B - 1, duration=DAYS, dt=0.5))
    for got, want in zip(lane.ys, kernel):
        assert _rel(got.movedim(-1, 1), want) <= TOL
    lead = simulate_ensemble(model.multistrain_ode, int(DAYS), y0, _batched(params, scales[:256]), sp)
    for got, want in zip(lead.ys, lane.ys):
        assert _rel(got, want[..., :256].movedim(-1, 0)) <= TOL


@pytest.mark.cuda
def test_fit_gradient_matches_finite_differences_on_the_card(cuda):
    """The fit's gradient (``chip_smoke.py`` phase 13 (c)): the Poisson
    log-likelihood of the daily incidence over 100 days, float64 on 4
    chains, ``backward()`` against central differences within 1e-4."""
    from dynode_tpu_torch import SolverParams, simulate_ensemble

    params = model.multistrain_default_params(dtype=torch.float64, device=cuda)
    y0 = model.multistrain_initial_state(dtype=torch.float64, device=cuda)
    sp = SolverParams(constant_step_size=0.5)
    obs = torch.as_tensor(np.random.default_rng(5).poisson(3.0, (100, 2, 3)), dtype=torch.float64, device=cuda)

    def loglik(s):
        c = simulate_ensemble(model.multistrain_ode, 100, y0, _batched(params, s), sp,
                              layout="lane_major", sub_save_indices=(4,)).ys[4]
        lam = torch.clamp(torch.diff(c, dim=0), min=1e-6)
        return (obs[..., None] * torch.log(lam) - lam).sum(dim=(0, 1, 2))

    s = torch.as_tensor(np.random.default_rng(6).uniform(0.7, 1.3, (4, 3)), device=cuda).requires_grad_(True)
    loglik(s).sum().backward()
    h = 1e-6
    shifts = torch.eye(3, dtype=torch.float64, device=cuda) * h
    with torch.no_grad():
        per = loglik(torch.cat([s + sign * shifts[k] for k in range(3) for sign in (1.0, -1.0)]))
    per = per.reshape(3, 2, 4)
    fd = ((per[:, 0] - per[:, 1]) / (2 * h)).T
    assert torch.isfinite(s.grad).all()
    assert float((s.grad - fd).abs().max() / fd.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_generator_draws_are_reproducible_and_in_the_support(cuda):
    """Every family of ``dist`` drawn from a CUDA generator (2**16 draws,
    float32): on the card, equal bits from equal seeds, in the support,
    the mean (median for the Cauchy pair) within 5 standard errors
    (``chip_smoke.check_draws``)."""
    import chip_smoke

    gen = torch.Generator(device=cuda)
    for name, d, centre in chip_smoke.dist_families(torch.float32, cuda):
        gen.manual_seed(11)
        assert d.sample(gen, (4,)).is_cuda, name
        chip_smoke.check_draws(name, d, centre, gen, 11, 2**16)


@pytest.mark.cuda
def test_config_built_params_launch_kernels_2_and_4_with_the_default_bits(cuda):
    """``multistrain_odeparams(multistrain_config())`` and
    ``seip_odeparams(seip_config(seasonal_vaccination=True))`` (on the card
    by default) launch kernels #2 and #4 and give the saves of the
    config-free defaults, bit for bit."""
    from dynode_tpu_torch.models import seip as seip_model

    cfg = model.multistrain_config()
    params, y0 = model.multistrain_odeparams(cfg), model.multistrain_initial_state(cfg)
    assert params.beta.is_cuda and params.idx is cfg.idx
    defaults, y_def, beta = _inputs(cuda, batch=B - 1)
    scales = beta / defaults.beta[None, :]
    ms.launch_multistrain_tsit5.launches = 0
    got, want = (ms.ensemble_solve_tsit5(y, p.beta[None, :] * scales, p.sigma, p.gamma, p.omega, p.contact_matrix,
                                         batch=B - 1, duration=DAYS, dt=0.5)
                 for p, y in ((params, y0), (defaults, y_def)))
    assert ms.launch_multistrain_tsit5.launches == 2 and torch.equal(got, want)
    scfg = seip_model.seip_config(seasonal_vaccination=True)
    seip_scales = torch.as_tensor(np.random.default_rng(8).uniform(0.85, 1.2, B), dtype=torch.float32, device=cuda)
    tsp.launch_seip_rk4.launches = 0
    (c_cfg,) = tsp.seip_ensemble_solve(seip_model.seip_initial_state(scfg), seip_model.seip_odeparams(scfg),
                                       seip_scales, duration=DAYS, dt=0.5, save=(3,))
    (c_def,) = tsp.seip_ensemble_solve(seip_model.seip_initial_state(True, device=cuda),
                                       seip_model.seip_default_params(True, device=cuda), seip_scales,
                                       duration=DAYS, dt=0.5, save=(3,))
    assert tsp.launch_seip_rk4.launches == 2 and torch.equal(c_cfg, c_def)


@pytest.mark.cuda
def test_graphed_potential_equals_the_eager_one_bit_for_bit(cuda):
    """``bench_nuts.py``'s fit potential and gradient (its own data, 20
    days, 512 chains) replayed from a CUDA graph equal the eager call bit
    for bit, at the first replay and after the input buffer is refilled;
    a second lookup with the same key returns the same graph."""
    import chip_smoke
    from dynode_tpu_torch.infer.mcmc import batched_pot_and_grad, graphed_potential

    fit = chip_smoke.fit_potential(chip_smoke.bench_nuts_obs()[:20], days=20, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    eager = batched_pot_and_grad(fit.potential)
    graph = graphed_potential(fit.potential, 512, 3, torch.float32, cuda)
    assert graphed_potential(fit.potential, 512, 3, torch.float32, cuda) is graph
    for _ in range(2):
        z = fit.transform.inv(fit.prior.sample(gen, (512,)))
        (pe_g, g_g), (pe_e, g_e) = graph(z), eager(z)
        assert torch.equal(pe_g, pe_e) and torch.equal(g_g, g_e)
    assert graph.replays == 2


@pytest.mark.cuda
def test_replayed_transitions_on_the_card_equal_the_cpu(cuda):
    """A NUTS and a ChEES transition of the fit (4 chains, 10 days,
    float64, the card's potential graph-captured) with the draws recorded
    on the CPU and replayed on the card equal the CPU's within 1e-10;
    ``num_steps`` and ``diverging`` equal (``chip_smoke.card_vs_cpu``)."""
    import chip_smoke

    obs = chip_smoke.bench_nuts_obs()
    z4 = torch.as_tensor(np.random.default_rng(9).normal(0.0, 0.4, (4, 3)), device=cuda)
    worst, _, equal = chip_smoke.card_vs_cpu(cuda, obs, z4, days=10)
    assert equal and worst <= 1e-10


@pytest.mark.cuda
def test_capture_that_meets_a_host_sync_raises_and_never_runs_eagerly(cuda):
    """A potential that reads a device value on the host cannot be captured:
    the capture raises ``GraphCaptureError`` naming the line and the sync,
    no result comes back, and a second call raises again. So does a
    potential that copies a host tensor to the card."""
    from dynode_tpu_torch.infer.mcmc import GraphCaptureError, GraphedPotential, batched_pot_and_grad

    def reads_the_host(zb):
        scale = 2.0 if float(zb.detach().abs().max()) > 1e30 else 1.0
        return scale * (zb * zb).sum(-1)

    def copies_from_the_host(zb):
        return (zb * torch.tensor([1.0, 2.0, 3.0], device=zb.device)).sum(-1)

    z = torch.ones((8, 3), device=cuda)
    graph = GraphedPotential(batched_pot_and_grad(reads_the_host))
    for _ in range(2):
        with pytest.raises(GraphCaptureError, match=r"test_torch_cuda\.py:\d+ \(scale = 2\.0 if float\(zb.*synchroniz"):
            graph(z)
        assert graph.graph is None and graph.replays == 0
    with pytest.raises(GraphCaptureError, match=r"test_torch_cuda\.py"):
        GraphedPotential(batched_pot_and_grad(copies_from_the_host))(z)


def _generic_fit(label, dev, days):
    """(model, keyword arguments) of ``sir_infer_parameters``' adaptive SIR
    fit (the grid engine with masked step slots) or of the golden SEIP fit,
    float32 and float64, on ``dev`` over ``days``."""
    import chip_smoke
    import torch_golden_seip as golden

    if label == "golden_seip":
        _, base, y0, sp = golden.build_fit(dev)
        obs = torch.as_tensor(np.load(golden.GOLDEN)["obs"][:days], device=dev)
        return golden.make_model(base, y0, sp, days=days), {"obs_data": obs}
    mod = chip_smoke.example_module(label)
    ((_, model, kwargs),) = chip_smoke.fit_models(label, mod, dev, days, torch.float32)
    return model, kwargs


@pytest.mark.cuda
@pytest.mark.parametrize("label, days", [("sir_infer_parameters", 30), ("golden_seip", 50)])
def test_generic_potential_graph_replays_the_eager_call_bit_for_bit(cuda, label, days):
    """The generic potential and gradient of a bank of 8 chains, captured
    as ``MCMC`` captures it (``generic_pot_and_grad(flat, device)``) and
    replayed, equal the eager call bit for bit, at the first replay and
    after the input buffer is refilled; a released graph frees its
    buffers."""
    import chip_smoke
    from dynode_tpu_torch.infer.mcmc import GraphedPotential, generic_pot_and_grad

    model, kwargs = _generic_fit(label, cuda, days)
    flat, z = chip_smoke.bank_potential(model, kwargs, 8, cuda)
    eager, graph = generic_pot_and_grad(flat), generic_pot_and_grad(flat, cuda)
    assert isinstance(graph, GraphedPotential)
    for zb in (z, z.flip(0) * 0.9):
        (pe_g, g_g), (pe_e, g_e) = graph(zb), eager(zb)
        assert torch.isfinite(pe_e).all() and torch.equal(pe_g, pe_e) and torch.equal(g_g, g_e)
    assert graph.replays == 2 and graph.device.type == "cuda"
    graph.release()
    assert graph.graph is None and graph.static_z is None and graph.constants == {}


@pytest.mark.cuda
def test_mcmc_graphs_the_generic_potential_and_never_runs_a_failed_capture_eagerly(cuda):
    """``MCMC`` with no batched potential: vectorized NUTS and ChEES keep one
    graph that replayed every evaluation (kept in the cross-run cache),
    the sequential method none; a model that reads a card tensor on the
    host raises ``GraphCaptureError`` naming its line, and samples
    nothing."""
    from dynode_tpu_torch import dist
    from dynode_tpu_torch.infer import MCMC, NUTS, ChEES, handlers
    from dynode_tpu_torch.infer.mcmc import GraphCaptureError

    obs = torch.as_tensor(np.random.default_rng(2).normal(0.5, 1.0, 32), dtype=torch.float32, device=cuda)

    def mean_model(obs):
        mu = handlers.sample("mu", dist.Normal(torch.zeros((), device=obs.device), 1.0))
        handlers.sample("obs", dist.Normal(mu, 1.0), obs=obs)

    def reads_the_host(obs):
        mu = handlers.sample("mu", dist.Normal(torch.zeros((), device=obs.device), 1.0))
        scale = 2.0 if float(obs.abs().max()) > 1e30 else 1.0
        handlers.sample("obs", dist.Normal(mu, scale), obs=obs)

    for kernel, method in ((NUTS(mean_model, max_tree_depth=3), "vectorized"), (ChEES(mean_model), "vectorized"),
                           (NUTS(mean_model, max_tree_depth=3), "sequential")):
        mc = MCMC(kernel, num_warmup=10, num_samples=10, num_chains=8, chain_method=method)
        mc.run(torch.Generator(device=cuda).manual_seed(1), obs=obs)
        assert torch.isfinite(mc.get_samples()["mu"]).all()
        if method == "sequential":
            assert mc.graphs == [] and mc.graph is None
        else:
            assert mc.graphs == [mc.graph] and mc.graph.replays > 10 and mc.graph.graph is not None
    mc = MCMC(NUTS(reads_the_host, max_tree_depth=3), num_warmup=10, num_samples=10, num_chains=8)
    with pytest.raises(GraphCaptureError, match=r"test_torch_cuda\.py:\d+ \(scale = 2\.0 if float\(obs"):
        mc.run(torch.Generator(device=cuda).manual_seed(1), obs=obs)
    assert mc.last_state is None and mc._samples is None and mc.graph.replays == 0


@pytest.mark.cuda
def test_generic_bank_split_over_one_card_twice_graphs_each_shard(cuda):
    """The generic potential split over the card listed twice: one graph
    per shard, each replayed, and the draws equal the unsplit run's bit for
    bit (NUTS and ChEES)."""
    from dynode_tpu_torch.infer import MCMC, NUTS, ChEES

    args = (torch.zeros(3, device=cuda), torch.eye(3, device=cuda))
    for make in (lambda: NUTS(_unit_gaussian, max_tree_depth=4), lambda: ChEES(_unit_gaussian)):
        runs = []
        for mesh in (None, _split_mesh(cuda, "one_card_twice", "chain")):
            mc = MCMC(make(), num_warmup=10, num_samples=10, num_chains=16, mesh=mesh, chain_axis="chain")
            mc.run(torch.Generator(device=cuda).manual_seed(3), *args)
            runs.append(mc)
        assert len(runs[0].graphs) == 1 and len(runs[1].graphs) == 2
        assert all(g.replays > 0 and g.device.type == "cuda" for g in runs[1].graphs)
        assert torch.equal(runs[0].get_samples()["x"], runs[1].get_samples()["x"])


@pytest.mark.cuda
def test_member_quantiles_on_the_card_match_the_cpu(cuda):
    """``member_quantiles`` of float32 and bf16 saves on the card against the
    same call on the CPU: the same sort and interpolation, within 1e-6 of
    the largest band value."""
    from dynode_tpu_torch.infer import member_quantiles

    x = torch.as_tensor(np.random.default_rng(3).gamma(2.0, 10.0, (200, 2, 3, 8, 1248)), dtype=torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        cpu = member_quantiles(x.to(dtype), (0.05, 0.25, 0.5, 0.75, 0.95))
        card = member_quantiles(x.to(dtype).to(cuda), (0.05, 0.25, 0.5, 0.75, 0.95))
        assert card.device.type == "cuda" and card.dtype == torch.float32
        assert _rel(card.cpu(), cpu) <= 1e-6


@pytest.mark.cuda
def test_an_svi_step_on_the_card_matches_the_cpu(cuda):
    """One ``SVI.update`` of the fit's AutoMultivariateNormal guide (4 days,
    float64) given the same draws (recorded on the CPU, replayed on the
    card): the loss and every parameter within 1e-10."""
    import chip_smoke
    from dynode_tpu_torch.infer import SVI, Adam, AutoMultivariateNormal, Trace_ELBO, init_to_mean

    obs = chip_smoke.bench_nuts_obs()[:4]
    out, tape = {}, None
    for where in ("cpu", "cuda"):
        dev = torch.device(where)
        model_ = chip_smoke.fit_model(days=4, dtype=torch.float64, device=dev)
        draws = (chip_smoke.DrawTape(torch.Generator().manual_seed(0)) if where == "cpu"
                 else chip_smoke.DrawTape(tape=tape, device=dev))
        svi = SVI(model_, AutoMultivariateNormal(model_, init_loc_fn=init_to_mean), Adam(0.1), Trace_ELBO())
        state = svi.init(draws, obs=obs.to(dev))
        state, loss = svi.update(state, obs=obs.to(dev))
        out[where] = (loss, state.params)
        tape = draws.tape
    assert _rel(out["cuda"][0].cpu(), out["cpu"][0]) <= 1e-10
    for k, v in out["cpu"][1].items():
        assert _rel(out["cuda"][1][k].cpu(), v) <= 1e-10


def _svi_runs(dev, graphed: bool, mesh=None, model=None, obs=None, guide=None):
    """``SVI.run`` (3 steps) and ``SVI.run_multistart`` (8 starts, 3 steps,
    2 final particles) of the fit at 4 days on ``dev``, replayed from their
    CUDA graphs or (``graphed`` False) through the eager loop: (run result,
    its graphs, bank result, the bank's last optimizer state, its graphs)."""
    from torch.utils._pytree import tree_map

    import chip_smoke
    from dynode_tpu_torch.infer import SVI, Adam, AutoMultivariateNormal, Trace_ELBO

    if model is None:
        obs = torch.as_tensor(chip_smoke.bench_nuts_obs()[:4], device=dev)
        model = chip_smoke.fit_model(days=4, device=dev)
    svi = SVI(model, (guide or AutoMultivariateNormal)(model), Adam(0.1), Trace_ELBO())
    svi._graphed = lambda device: graphed
    one = svi.run(torch.Generator(device=dev).manual_seed(0), 3, obs=obs)
    one_graphs = svi.graphs
    opt, plain = [], svi._bank_fns

    def recording(*args, **kwargs):
        step, elbo = plain(*args, **kwargs)

        def step_seen(state, noise):
            new, loss = step(state, noise)
            opt.append(new[1])
            return new, loss

        return step_seen, elbo

    svi._bank_fns = recording
    bank = svi.run_multistart(torch.Generator(device=dev).manual_seed(1), num_steps=3, num_starts=8,
                              final_particles=2, mesh=mesh, obs=obs)
    shards = 1 if mesh is None else 2
    last = opt[-shards:] if not graphed else [g.state[1] for g in svi.graphs]
    return one, one_graphs, bank, tree_map(lambda *x: torch.cat(x), *last), svi.graphs


def _same(a, b) -> bool:
    from torch.utils._pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.cuda
def test_replayed_svi_runs_equal_the_eager_loop_bit_for_bit(cuda):
    """``SVI.run`` and ``SVI.run_multistart`` of the fit (4 days, float32)
    replay one CUDA graph a run, captured at the first step, and equal the
    eager loop on the card bit for bit over 3 steps: losses, parameters,
    Adam state and final ELBOs; each graph replayed every step. ``SVI.run``
    released its graph when the run ended, ``run_multistart`` kept its
    bank's."""
    one_e, graphs_e, bank_e, opt_e, bank_graphs_e = _svi_runs(cuda, False)
    one_g, graphs_g, bank_g, opt_g, bank_graphs_g = _svi_runs(cuda, True)
    assert graphs_e == [] and bank_graphs_e == []
    assert torch.equal(one_g.losses, one_e.losses) and one_g.losses.device.type == "cuda"
    assert _same(one_g.params, one_e.params) and _same(one_g.state.opt_state, one_e.state.opt_state)
    assert int(one_g.state.opt_state.count) == 3
    assert torch.equal(bank_g.all_losses, bank_e.all_losses) and bank_g.all_losses.shape == (8, 3)
    assert _same(bank_g.all_params, bank_e.all_params) and _same(opt_g, opt_e)
    assert torch.equal(bank_g.final_elbos, bank_e.final_elbos) and bool(torch.isfinite(bank_g.final_elbos).all())
    for graph in graphs_g + bank_graphs_g:
        assert graph.replays == 3 and graph.device.type == "cuda" and graph.capture_s is not None
    for graph in graphs_g:
        assert graph.graph is None and graph.draws is None and graph.constants == {}  # released
    for graph in bank_graphs_g:
        assert graph.graph is not None and graph.captures == 1  # kept


@pytest.mark.cuda
def test_svi_bank_split_over_one_card_twice_graphs_each_shard(cuda):
    """``run_multistart(mesh=)`` over the card listed twice: one graph a
    shard, each replayed every step, equal to the eager split and to the
    unsplit bank bit for bit."""
    mesh = _split_mesh(cuda, "one_card_twice", "start")
    _, _, whole, whole_opt, whole_graphs = _svi_runs(cuda, True)
    _, _, eager, eager_opt, _ = _svi_runs(cuda, False, mesh=mesh)
    _, _, split, split_opt, graphs = _svi_runs(cuda, True, mesh=mesh)
    assert len(whole_graphs) == 1 and len(graphs) == 2 and all(g.replays == 3 for g in graphs)
    for ref, ref_opt in ((eager, eager_opt), (whole, whole_opt)):
        assert torch.equal(split.all_losses, ref.all_losses) and _same(split.all_params, ref.all_params)
        assert torch.equal(split.final_elbos, ref.final_elbos) and _same(split_opt, ref_opt)


def _mean_model(obs):
    from dynode_tpu_torch import dist
    from dynode_tpu_torch.infer import handlers

    mu = handlers.sample("mu", dist.Normal(torch.zeros((), dtype=obs.dtype, device=obs.device), 10.0))
    handlers.sample("obs", dist.Normal(mu, 1.0), obs=obs)


@pytest.mark.cuda
@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("kernel", ["nuts", "chees"])
def test_a_repeated_mcmc_run_captures_nothing_and_draws_as_a_fresh_cache_run(cuda, kernel, center):
    """A second ``MCMC.run`` with the same model and argument objects is
    served the first run's graph: the same ``GraphedPotential``, no new
    capture (``captures`` and ``capture_s`` unchanged), its replays going
    on. Its draws (float64) equal a run at the same seed after the cache
    was cleared: bit for bit uncentred; centred within 1e-5, since the
    kept centres come from the first run's trace and shift the potential
    by a constant whose rounding the warmup's adaptation carries."""
    from dynode_tpu_torch.infer import MCMC, NUTS, ChEES
    from dynode_tpu_torch.infer.mcmc import clear_exec_cache

    obs = torch.as_tensor(np.random.default_rng(2).normal(3.0, 1.0, 32), dtype=torch.float64, device=cuda)

    def make():
        kern = (NUTS(_mean_model, max_tree_depth=5, center_potential=center) if kernel == "nuts"
                else ChEES(_mean_model, max_num_steps=32, center_potential=center))
        return MCMC(kern, num_warmup=30, num_samples=30, num_chains=64)

    clear_exec_cache()
    first = make()
    first.run(torch.Generator(device=cuda).manual_seed(1), obs=obs)
    graph = first.graph
    assert graph.captures == 1 and graph.graph is not None
    capture_s, replays = graph.capture_s, graph.replays
    hit = make()
    hit.run(torch.Generator(device=cuda).manual_seed(2), obs=obs)
    assert hit.graph is graph and graph.captures == 1 and graph.capture_s == capture_s and graph.replays > replays
    clear_exec_cache()
    assert graph.graph is None  # released with its entry
    miss = make()
    miss.run(torch.Generator(device=cuda).manual_seed(2), obs=obs)
    assert miss.graph is not graph and miss.graph.captures == 1
    a, b = hit.get_samples(group_by_chain=True)["mu"], miss.get_samples(group_by_chain=True)["mu"]
    assert a.shape == (64, 30) and bool(torch.isfinite(a).all())
    if center:
        assert float((a - b).abs().max()) <= 1e-5
    else:
        assert torch.equal(a, b)
    clear_exec_cache()


@pytest.mark.cuda
def test_a_repeated_run_multistart_captures_nothing_and_equals_a_fresh_instance(cuda):
    """A second ``run_multistart`` on one ``SVI`` with the same ``obs``
    replays the kept bank's graph (the same ``GraphedStep``, one capture),
    equals a fresh instance's run at its seed bit for bit (losses,
    parameters, final ELBOs), and leaves the first result's parameters as
    they were."""
    import chip_smoke
    from dynode_tpu_torch.infer import SVI, Adam, AutoMultivariateNormal, Trace_ELBO

    obs = torch.as_tensor(chip_smoke.bench_nuts_obs()[:4], device=cuda)
    model_ = chip_smoke.fit_model(days=4, device=cuda)

    def svi():
        return SVI(model_, AutoMultivariateNormal(model_), Adam(0.1), Trace_ELBO())

    def fit(inst, seed):
        return inst.run_multistart(torch.Generator(device=cuda).manual_seed(seed), num_steps=5, num_starts=64,
                                   final_particles=2, obs=obs)

    kept = svi()
    r1 = fit(kept, 1)
    (graph,) = kept.graphs
    params1 = {k: v.clone() for k, v in r1.all_params.items()}
    assert graph.captures == 1 and graph.replays == 5
    r2 = fit(kept, 2)
    assert kept.graphs == [graph] and graph.captures == 1 and graph.replays == 10
    assert _same(r1.all_params, params1)  # not overwritten by the second run
    fresh = fit(svi(), 2)
    assert torch.equal(r2.all_losses, fresh.all_losses) and torch.equal(r2.final_elbos, fresh.final_elbos)
    assert _same(r2.all_params, fresh.all_params) and bool(torch.isfinite(r2.all_losses).all())


@pytest.mark.cuda
def test_clearing_the_cache_frees_the_graphs_memory(cuda):
    """The kept entries of generic-potential runs hold their graphs' memory
    on the card; ``clear_exec_cache`` releases them, and the reserved
    memory falls once the allocator's free blocks go back to the card."""
    import gc

    from dynode_tpu_torch.infer import MCMC, NUTS
    from dynode_tpu_torch.infer.mcmc import _EXEC_CACHE, clear_exec_cache

    clear_exec_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(cuda)
    runs = []
    for value in (3.0, -4.0):
        obs = torch.full((4096,), value, dtype=torch.float32, device=cuda)
        mc = MCMC(NUTS(_mean_model, max_tree_depth=3), num_warmup=2, num_samples=2, num_chains=4096)
        mc.run(torch.Generator(device=cuda).manual_seed(0), obs=obs)
        runs.append(mc.graph)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_reserved(cuda)
    assert len(_EXEC_CACHE) == 2 and all(g.graph is not None for g in runs)
    clear_exec_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved(cuda)
    print(f"reserved: {before} before, {kept} with 2 kept entries, {after} after clear_exec_cache")
    assert all(g.graph is None and g.static_z is None for g in runs)
    assert after < kept


@pytest.mark.cuda
def test_svi_model_that_reads_the_host_raises_and_never_steps_eagerly(cuda):
    """An SVI model that reads a card tensor on the host cannot be captured:
    ``run``, ``run_multistart`` and ``SVIProcess.infer`` raise
    ``GraphCaptureError`` naming its line, and no step is taken."""
    from dynode_tpu_torch import dist
    from dynode_tpu_torch.infer import SVIProcess, handlers
    from dynode_tpu_torch.infer.graphs import GraphCaptureError

    def reads_the_host(obs):
        mu = handlers.sample("mu", dist.Normal(torch.zeros((), device=obs.device), 1.0))
        scale = 2.0 if float(obs.abs().max()) > 1e30 else 1.0
        handlers.sample("obs", dist.Normal(mu, scale), obs=obs)

    obs = torch.as_tensor(np.random.default_rng(2).normal(0.5, 1.0, 32), dtype=torch.float32, device=cuda)
    match = r"test_torch_cuda\.py:\d+ \(scale = 2\.0 if float\(obs"
    for starts in (1, 4):
        proc = SVIProcess(numpyro_model=reads_the_host, num_iterations=3, num_samples=4, num_starts=starts,
                          progress_bar=False)
        with pytest.raises(GraphCaptureError, match=match):
            proc.infer(obs=obs)
        assert proc._inference_state is None
    from dynode_tpu_torch.infer import SVI, Adam, AutoNormal, Trace_ELBO

    svi = SVI(reads_the_host, AutoNormal(reads_the_host), Adam(0.1), Trace_ELBO())
    for run in (lambda: svi.run(0, 3, obs=obs), lambda: svi.run_multistart(0, 3, 4, obs=obs)):
        with pytest.raises(GraphCaptureError, match=match):
            run()
        assert [g.replays for g in svi.graphs] == [0] and svi.graphs[0].graph is None


def _split_mesh(dev, where, axis="ensemble"):
    """``[cuda:0] * 2`` (``"one_card_twice"``) or every visible card
    (``"every_card"``, skipped below two cards)."""
    from dynode_tpu_torch.parallel import create_mesh

    if where == "one_card_twice":
        return create_mesh((axis,), devices=[dev, dev])
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    return create_mesh((axis,))


SPLITS = ["one_card_twice", "every_card"]


def _on_first_card(x, mesh) -> bool:
    """Whether ``x`` lies on the mesh's first card (``cuda`` without an
    index names the current one)."""
    first = mesh.first_device
    return x.device == (first if first.index is not None else torch.device("cuda", torch.cuda.current_device()))


@pytest.mark.cuda
@pytest.mark.parametrize("where", SPLITS)
def test_split_generic_entries(cuda, where):
    """The split entries of kernels #1 and #3 over one card listed twice
    and over every card: one launch per shard, the result on the first
    card; the constant step bit for bit, the adaptive one bit for bit with
    its stats when ``block_b`` divides the shard (64 of 4,096 / shards),
    and within 1e-4 when it does not (24 members a shard)."""
    from dynode_tpu_torch.ops import sharded as sh

    mesh = _split_mesh(cuda, where)
    n = mesh.shape["ensemble"]
    params, y0, beta = _inputs(cuda)
    rhs = ms.multistrain_rows_rhs(params.contact_matrix)
    y = ms.pack_state(y0, B)
    p = ms.pack_params(beta, params.sigma, params.gamma, params.omega, B)
    before = gtri.launch_rk_solve.launches
    got = sh.ensemble_solve_kernel_sharded(rhs, y, p, mesh=mesh, duration=DAYS, dt=0.5)
    assert gtri.launch_rk_solve.launches == before + n and _on_first_card(got, mesh)
    assert torch.equal(got, gen.ensemble_solve_kernel(rhs, y, p, duration=DAYS, dt=0.5))
    kw = dict(duration=DAYS, rtol=1e-4, atol=1e-6, block_b=64)
    before = gtri.launch_rk_solve_adaptive.launches
    got, st = sh.ensemble_solve_kernel_adaptive_sharded(rhs, y, p, mesh=mesh, **kw)
    assert gtri.launch_rk_solve_adaptive.launches == before + n
    want, want_st = gen.ensemble_solve_kernel_adaptive(rhs, y, p, **kw)
    assert torch.equal(got, want) and all(torch.equal(st[k], want_st[k]) for k in st)
    y_r, p_r = y[:, :24 * n].contiguous(), p[:, :24 * n].contiguous()
    got, st = sh.ensemble_solve_kernel_adaptive_sharded(rhs, y_r, p_r, mesh=mesh, **kw)
    want, _ = gen.ensemble_solve_kernel_adaptive(rhs, y_r, p_r, **kw)
    assert st["exhausted_intervals"].shape == (n,) and _rel(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("where", SPLITS)
def test_split_seip_entries(cuda, where):
    """The split entries of kernels #4 and #5 over one card listed twice
    and over every card at B = 2,048: one launch per shard, bit for bit
    with the unsplit entries (``block_b`` 4 divides each shard), the stats
    concatenated."""
    from dynode_tpu_torch.ops import sharded as sh

    mesh = _split_mesh(cuda, where)
    n = mesh.shape["ensemble"]
    params, y0, scales = _seip_inputs(cuda, 2048)
    before = tsp.launch_seip_rk4.launches
    got = sh.seip_ensemble_solve_sharded(y0, params, scales, mesh=mesh, duration=60.0, save=(3,))
    assert tsp.launch_seip_rk4.launches == before + n and _on_first_card(got[0], mesh)
    assert torch.equal(got[0], tsp.seip_ensemble_solve(y0, params, scales, duration=60.0, save=(3,))[0])
    kw = dict(duration=60.0, rtol=1e-4, atol=1e-3, save=(3,), block_b=4)
    before = tsp.launch_seip_bs3.launches
    got, st = sh.seip_ensemble_solve_adaptive_sharded(y0, params, scales, mesh=mesh, **kw)
    assert tsp.launch_seip_bs3.launches == before + n
    want, want_st = tsp.seip_ensemble_solve_adaptive(y0, params, scales, **kw)
    assert torch.equal(got[0], want[0]) and all(torch.equal(st[k], want_st[k]) for k in st)


def _unit_gaussian(mu, scale_tril):
    from dynode_tpu_torch import dist
    from dynode_tpu_torch.infer import handlers

    handlers.sample("x", dist.MultivariateNormal(mu, scale_tril))


def _unit_potential(zb):
    """``_unit_gaussian``'s potential less its constant, elementwise over
    the chains, on the device of ``zb``."""
    return 0.5 * (zb[:, 0] * zb[:, 0] + zb[:, 1] * zb[:, 1] + zb[:, 2] * zb[:, 2])


@pytest.mark.cuda
def test_engine_and_inference_split_over_every_card(cuda):
    """``mesh=`` over every card (two or more): ``simulate_ensemble`` of the
    stiff SEIRS (TRBDF2, batch-leading, 256 members a card) and of the
    multi-strain model (lane-major, constant step) bit for bit with the
    unsplit solve on the first card; ``MCMC`` with a batched potential,
    its shard graph captured on each card one after another, and with the
    model's generic potential, its draws equal to the unsplit bank's, also
    under ``chain_method="parallel"`` with that mesh and with the one it
    builds itself; and
    ``SVI.run_multistart`` over every card equal to the unsplit bank."""
    import chip_smoke

    from dynode_tpu_torch import SolverParams, dist, simulate_ensemble
    from dynode_tpu_torch.infer import MCMC, NUTS, SVI, Adam, AutoNormal, ChEES, Trace_ELBO, handlers
    from dynode_tpu_torch.ode import TRBDF2

    mesh = _split_mesh(cuda, "every_card")
    n = mesh.shape["ensemble"]
    ode, _ = chip_smoke.stiff_seirs()
    y32, p32 = chip_smoke.stiff_inputs(torch.float32, cuda, beta=torch.linspace(0.2, 0.4, 256 * n, device=cuda))
    sp = SolverParams(solver_method=TRBDF2(), ode_solver_rel_tolerance=1e-6, ode_solver_abs_tolerance=1e-4,
                      step_budget=512)
    params, y0, beta = _inputs(cuda, batch=16 * n)
    lane_p = _batched(params, beta[:, 0] / params.beta[0])
    sp_c = SolverParams(constant_step_size=0.5)
    for solve in (lambda m: simulate_ensemble(ode, 100, y32, p32, sp, mesh=m),
                  lambda m: simulate_ensemble(model.multistrain_ode, 60, y0, lane_p, sp_c, layout="lane_major",
                                              mesh=m)):
        got, want = solve(mesh), solve(None)
        assert all(_on_first_card(a, mesh) and torch.equal(a, b) for a, b in zip(got.ys, want.ys))
        assert all(torch.equal(got.stats[k], want.stats[k]) for k in want.stats)
        assert torch.equal(got.result, want.result)

    chains = 8 * n
    args = (torch.zeros(3, device=cuda), torch.eye(3, device=cuda))
    kernels = (lambda: NUTS(_unit_gaussian, max_tree_depth=4, batched_potential_fn=_unit_potential),
               lambda: ChEES(_unit_gaussian, batched_potential_fn=_unit_potential),
               lambda: NUTS(_unit_gaussian, max_tree_depth=4))
    whole = []
    for make in kernels:
        runs = []
        for m in (None, _split_mesh(cuda, "every_card", "chain")):
            mc = MCMC(make(), num_warmup=10, num_samples=10, num_chains=chains, mesh=m, chain_axis="chain")
            mc.run(torch.Generator(device=cuda).manual_seed(3), *args)
            runs.append(mc)
        whole.append(runs[0].get_samples()["x"])
        assert torch.equal(whole[-1], runs[1].get_samples()["x"])
        if make().batched_potential_fn is not None:
            assert sorted(str(g.static_z.device) for g in runs[1].graphs) == [f"cuda:{i}" for i in range(n)]
            assert all(g.replays > 0 for g in runs[1].graphs)
    for given in (_split_mesh(cuda, "every_card", "chain"), None):  # None: the mesh over every card built by MCMC
        mc = MCMC(kernels[0](), num_warmup=10, num_samples=10, num_chains=chains, chain_method="parallel",
                  mesh=given)
        with pytest.warns(UserWarning, match="mesh-sharded vectorized"):
            mc.run(torch.Generator(device=cuda).manual_seed(3), *args)
        assert mc.mesh.shape == {"chain": n} and torch.equal(mc.get_samples()["x"], whole[0])

    def mean_model(obs):
        mu = handlers.sample("mu", dist.Normal(torch.zeros((), device=obs.device), 1.0))
        handlers.sample("obs", dist.Normal(mu, 1.0), obs=obs)

    obs = torch.as_tensor(np.random.default_rng(0).normal(0.5, 1.0, 32), dtype=torch.float32, device=cuda)
    svi = SVI(mean_model, AutoNormal(mean_model), Adam(0.1), Trace_ELBO())
    fits = [svi.run_multistart(0, num_steps=3, num_starts=4 * n, mesh=m, obs=obs)
            for m in (None, _split_mesh(cuda, "every_card", "start"))]
    assert int(fits[0].best_idx) == int(fits[1].best_idx)
    assert torch.equal(fits[0].final_elbos, fits[1].final_elbos)
    assert all(torch.equal(fits[0].all_params[k], fits[1].all_params[k]) for k in fits[0].all_params)


# ---------------------------------------------------------------------------
# the kernels' other shapes: shape builds of #2 and #6, the general SEIP kernels
# ---------------------------------------------------------------------------

#: shapes of #2 and #6 beyond the library's (2, 3) and (3, 2)
MS_SHAPES = [(4, 3), (4, 2), (8, 4), (1, 1), (5, 2)]
MS_CASES = [(kernel, shape, team) for kernel in ("row", "2d") for shape in MS_SHAPES for team in ms.teams(shape[0])]
SEIP_SHAPES = {"default": (4, 4, 3, 4, 2, 0), "second": (2, 2, 3, 3, 1, 1), "three": (4, 8, 3, 4, 3, 0)}


@pytest.fixture(scope="module")
def shape_builds():
    """Every shape build these tests run, compiled in one round of nvcc."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an H100 (CUDA compute capability 9.0)")
    from dynode_tpu_torch.ops import _build

    units = [(kernel, shape) for kernel in ("multistrain_tsit5", "multistrain_tsit5_2d")
             for shape in MS_SHAPES + [(2, 3)]]
    units += [(family, shape) for shape in SEIP_SHAPES.values() for family in ("seip_rk4", "seip_bs3")]
    return _build.prebuild(units)


def _ms_shape_inputs(dev, shape, batch, seed=5):
    """The multi-strain model at ``shape``: ``multistrain_default_params``
    with per-strain periods cycled from the defaults', per-member betas."""
    a, k = shape
    r0s = tuple(2.0 + 0.25 * i for i in range(k))
    params = model.multistrain_default_params(
        r0s, tuple(6.0 + i for i in range(k)), tuple(2.5 + 0.5 * i for i in range(k)),
        tuple(60.0 + 10 * i for i in range(k)), n_age=a, device=dev)
    y0 = model.multistrain_initial_state(r0s, tuple(np.full(a, 1.0 / a)), device=dev)
    scales = np.random.default_rng(seed).uniform(0.6, 1.6, batch)
    return params, y0, params.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32, device=dev)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, shape, team", MS_CASES,
                         ids=[f"{k}-{a}x{s}-team{t}" for k, (a, s), t in MS_CASES])
def test_shape_builds_match_plain_version(cuda, shape_builds, kernel, shape, team):
    """#2 and #6 at shapes the library does not instantiate, at each team
    width, on a ragged batch (4,095: inside a warp at every team width), 200
    days; the 2-D kernel's padding rows zero. Tolerance 1e-5."""
    params, y0, beta = _ms_shape_inputs(cuda, shape, B - 1)
    counter = ms.launch_multistrain_tsit5 if kernel == "row" else ms.launch_multistrain_tsit5_2d
    before = counter.launches
    got, want = _launch(kernel, y0, beta, params, B - 1, shape, team)
    assert counter.launches == before + 1
    assert torch.isfinite(got).all() and _rel(got, want) <= TOL
    if kernel == "2d":
        d2 = got.shape[1]
        pad = sorted(set(range(d2)) - set(ms._live_rows_2d(*shape)))
        assert not got[:, pad].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["multistrain_tsit5", "multistrain_tsit5_2d"])
def test_shape_build_of_a_library_shape_is_bit_for_bit(cuda, shape_builds, kernel):
    """A shape build at the library's (2, 3) runs the same templates with the
    same flags: its saves equal the library's bit for bit at each team
    width, and the entry point at (2, 3) takes the library."""
    from dynode_tpu_torch.ops import _build

    params, y0, beta = _inputs(cuda)
    rates = (beta, params.sigma, params.gamma, params.omega)
    if kernel == "multistrain_tsit5":
        y, p, launch = ms.pack_state(y0, B), ms.pack_params(*rates, B), ms.launch_multistrain_tsit5
    else:
        y, p, launch = ms.pack_state_2d(y0, B), ms.pack_rates_2d(*rates, B), ms.launch_multistrain_tsit5_2d
    flat = params.contact_matrix.to(torch.float32).reshape(-1).contiguous()
    entry = getattr(_build.shape_library(kernel, (2, 3)), f"dynode_{kernel}_shape")
    for team in ms.teams(2):
        lib_out = launch(y, p, params.contact_matrix, dt=0.5, n_steps=400, save_stride=2, n_age=2, n_strain=3,
                         team=team)
        shape_out = torch.empty_like(lib_out)
        rc = entry(2, 3, team, ms.THREADS, y.data_ptr(), p.data_ptr(), flat.data_ptr(), shape_out.data_ptr(), B,
                   0.5, 400, 2, torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        assert torch.equal(shape_out, lib_out)


@pytest.mark.cuda
def test_triton_kernels_at_four_ages_three_strains(cuda):
    """Kernels #1 (Tsit5) and #3 (bosh3) on ``multistrain_rows_rhs(contact,
    4, 3)`` at B = 4,095, 200 days: #1 within 1e-5 of its plain version, #3
    with every block's decisions equal and its saves within 1e-5."""
    params, y0, beta = _ms_shape_inputs(cuda, (4, 3), B - 1)
    rhs = ms.multistrain_rows_rhs(params.contact_matrix, 4, 3)
    y = ms.pack_state(y0, B - 1, 4, 3)
    p = ms.pack_params(beta, params.sigma, params.gamma, params.omega, B - 1, 3)
    before = gtri.launch_rk_solve.launches
    got = gen.ensemble_solve_kernel(rhs, y, p, duration=DAYS, dt=0.5, method="tsit5")
    assert gtri.launch_rk_solve.launches == before + 1
    want = gen.ensemble_solve_kernel_reference(rhs, y, p, duration=DAYS, dt=0.5, method="tsit5")
    assert _rel(got, want) <= TOL
    kw = dict(duration=DAYS, rtol=1e-4, atol=1e-6, method="bosh3")
    before = gtri.launch_rk_solve_adaptive.launches
    got, stats = gen.ensemble_solve_kernel_adaptive(rhs, y, p, **kw)
    assert gtri.launch_rk_solve_adaptive.launches == before + 1
    want, want_stats = gen.ensemble_solve_kernel_adaptive_reference(rhs, y, p, block_b=gen.ADAPTIVE_BLOCK, **kw)
    assert int(stats["exhausted_intervals"].sum()) == 0
    for key in stats:
        assert torch.equal(stats[key], want_stats[key]), key
    assert float(_block_rel(got, want, gen.ADAPTIVE_BLOCK).max()) <= TOL


def _seip_shape_inputs(dev, name, n):
    import chip_smoke
    from dynode_tpu_torch.config import Strain
    from dynode_tpu_torch.models import seip as seip_model

    cfg = chip_smoke.seip_shape_config(seip_model, Strain, name)
    params, y0 = seip_model.seip_odeparams(cfg, device=dev), seip_model.seip_initial_state(cfg, device=dev)
    L = SEIP_SHAPES[name][4]
    scales = np.random.default_rng(13).uniform(0.85, 1.2, (L, n))
    return params, y0, torch.as_tensor(scales, dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SEIP_SHAPES))
def test_general_seip_rk4_matches_plain_version(cuda, shape_builds, name):
    """The general RK4 kernel at a shape ``seip_config`` builds: its time
    table bit for bit, B = 2,047 (a ragged last CTA of 8) over 60 days with
    every compartment in float32 (tolerance 1e-5), C in bf16 (1e-2), and
    the packed layout at B = 2,048."""
    params, y0, scales = _seip_shape_inputs(cuda, name, 2048)
    P = tsp.seip_static_params(params)
    assert (*P.dims, int(P.seasonal)) == SEIP_SHAPES[name]
    table = tsp.launch_seip_time_table(P, dt=0.5, n_steps=120, device=cuda)
    assert torch.equal(table, tsp.seip_time_table_reference(P, dt=0.5, n_steps=120, device=cuda))
    before = tsp.launch_seip_rk4.launches
    got = tsp.seip_ensemble_solve(y0, params, scales[:, :2047], duration=60.0)
    assert tsp.launch_seip_rk4.launches == before + 1
    want = tsp.seip_solve_reference(y0, params, scales, duration=60.0)
    for g, w in zip(got, want):
        assert g.shape == w[..., :2047].shape and torch.isfinite(g).all() and _rel(g, w[..., :2047]) <= TOL
    (c16,) = tsp.seip_ensemble_solve(y0, params, scales[:, :2047], duration=60.0, save=(3,),
                                     save_dtype=torch.bfloat16)
    assert c16.dtype == torch.bfloat16 and _rel(c16, want[3][..., :2047]) <= 1e-2
    (cp,) = tsp.seip_ensemble_solve(y0, params, scales, duration=60.0, save=(3,), packed=True)
    assert _rel(tsp.unpack_members(cp), want[3]) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("block_b", [4, 16])
@pytest.mark.parametrize("name", list(SEIP_SHAPES))
def test_general_seip_bs3_matches_plain_version(cuda, shape_builds, name, block_b):
    """The general BS3 kernel, B = 2,047 (a ragged last block), 60 days,
    rtol 1e-4, atol 1e-3, the same block width on both sides: compiled
    without contraction and summing as its plain version does, every block
    takes the plain version's decisions and the saves equal it exactly."""
    params, y0, scales = _seip_shape_inputs(cuda, name, 2047)
    kw = dict(duration=60.0, rtol=1e-4, atol=1e-3, save=(0, 3), block_b=block_b)
    before = tsp.launch_seip_bs3.launches
    got, stats = tsp.seip_ensemble_solve_adaptive(y0, params, scales, **kw)
    assert tsp.launch_seip_bs3.launches == before + 1
    want, want_stats = tsp.seip_solve_adaptive_reference(y0, params, scales, **kw)
    assert int(stats["exhausted_intervals"].sum()) == 0
    for key in stats:
        assert torch.equal(stats[key], want_stats[key]), key
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_over_limit_shapes_raise_and_launch_nothing(cuda):
    """Past the kernels' limits -- ``MAX_ROWS`` multi-strain state rows, a
    general SEIP CTA over the card's shared memory -- the launchers raise
    ``ValueError`` naming the limit and launch nothing."""
    import dataclasses

    counters = (ms.launch_multistrain_tsit5, ms.launch_multistrain_tsit5_2d, tsp.launch_seip_rk4,
                tsp.launch_seip_bs3, tsp.launch_seip_time_table)
    before = [c.launches for c in counters]
    a, k = 40, 7
    z = torch.zeros(a + 4 * a * k, 8, device=cuda)
    for launch in (ms.launch_multistrain_tsit5, ms.launch_multistrain_tsit5_2d):
        with pytest.raises(ValueError, match="state rows"):
            launch(z, torch.zeros(4 * k, 8, device=cuda), torch.ones(a, a, device=cuda), dt=0.5, n_steps=2,
                   save_stride=1, n_age=a, n_strain=k)
    params, y0, scales = _seip_shape_inputs(cuda, "default", 8)
    big = dataclasses.replace(tsp.seip_static_params(params), dims=(8, 16, 6, 8, 4))
    with pytest.raises(ValueError, match="shared memory"):
        tsp.launch_seip_rk4(y0, big, scales, dt=0.5, n_steps=2, save_stride=2, save=(3,),
                            save_dtype=torch.float32, packed=False)
    with pytest.raises(ValueError, match="shared memory"):
        tsp.launch_seip_bs3(y0, big, scales, n_saves=2, save_every=1.0, rtol=1e-4, atol=1e-3, dt0=0.125,
                            steps_per_save=8, block_b=16, save=(3,), save_dtype=torch.float32, packed=False)
    assert [c.launches for c in counters] == before
