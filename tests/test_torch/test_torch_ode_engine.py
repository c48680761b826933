"""The port's ODE engine against the JAX package's, on the CPU.

The same float64 inputs, made from a numpy seed, go through
``dynode_tpu.ode`` and ``dynode_tpu_torch.ode``: the RK steps, the
controllers' pieces, and each of ``diffeqsolve``'s three engines (constant
direct, adaptive save-grid, buffered two-phase), each reached by a case
that checks its route. Tolerances are stated per test: the arithmetic is
the same in the same order, so saves agree to rounding (1e-12 for one
step, 1e-10 for a solve) and adaptive solves take the same number of
accepted and rejected steps.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.ode as jode
from dynode_tpu.ode.controllers import rms_error_norm as j_rms
from dynode_tpu.ode.controllers import select_initial_step as j_initial_step
from dynode_tpu_torch.ode import controllers as tctl
from dynode_tpu_torch.ode import integrate as tint
import dynode_tpu_torch.ode as tode

REPO = Path(__file__).resolve().parents[2]
SOLVERS = ["Euler", "Heun", "Bosh3", "Tsit5", "Dopri5"]


def _rhs(xp):
    """A nonlinear RHS over a two-leaf state, ``u (3,)`` and ``v (2, 2)``,
    with a scalar argument ``k``."""

    def rhs(t, y, k):
        u, v = y
        return (-k * u * v.sum() + 0.1 * xp.sin(t) * u, k * u.sum() * v - 0.3 * v)

    return rhs


def _sir(xp):
    def rhs(t, y, p):
        s, i, r = y
        inf = p[0] * s * i
        return (-inf, inf - p[1] * i, p[1] * i)

    return rhs


J_RHS, T_RHS = _rhs(jnp), _rhs(torch)
J_SIR, T_SIR = _sir(jnp), _sir(torch)
SIR0 = (np.array([0.98]), np.array([0.02]), np.array([0.0]))
SIR_P = np.array([0.4, 0.15])


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 1.5, 3), rng.uniform(0.5, 1.5, (2, 2)))


def _jax(tree):
    return tuple(jnp.asarray(x) for x in tree)


def _torch(tree):
    return tuple(torch.as_tensor(x) for x in tree)


def _close(got, want, rtol, atol=0.0):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", SOLVERS)
def test_solver_step_and_step_inc_match_jax(name):
    """One step of every solver, with and without an FSAL carry: ``y1``,
    ``inc``, ``err`` and ``f1`` within 1e-12 relative (float64)."""
    y = _state()
    jsolver, tsolver = getattr(jode, name)(), getattr(tode, name)()
    assert tsolver == getattr(tode, name)() and hash(tsolver) == hash(getattr(tode, name)())
    jterm, tterm = jode.ODETerm(J_RHS), tode.ODETerm(T_RHS)
    t, dt, k = 0.7, 0.3, 0.8
    jt, jdt = jnp.asarray(t), jnp.asarray(dt)
    tt, tdt = torch.tensor(t, dtype=torch.float64), torch.tensor(dt, dtype=torch.float64)
    f0 = T_RHS(tt, _torch(y), k)
    for carry in (None, f0):
        jf0 = None if carry is None else _jax([x.numpy() for x in carry])
        for method in ("step", "step_inc"):
            want = getattr(jsolver, method)(jterm, jt, jdt, _jax(y), k, f0=jf0)
            got = getattr(tsolver, method)(tterm, tt, tdt, _torch(y), k, f0=carry)
            _close(got[0], want[0], 1e-12)
            assert (got[1] is None) == (want[1] is None)
            if want[1] is not None:
                _close(got[1], want[1], 1e-12, 1e-15)
            assert (got[2] is None) == (want[2] is None)
            if want[2] is not None:
                _close(got[2], want[2], 1e-12)


def test_select_initial_step_matches_jax():
    """The Hairer initial step, one solve and per member of a batch: 1e-12."""
    y = _state(1)
    for order in (3, 5):
        want = j_initial_step(jode.ODETerm(J_RHS), jnp.asarray(0.5), _jax(y),
                              J_RHS(0.5, _jax(y), 0.8), 0.8, order, 1e-5, 1e-6)
        t0 = torch.tensor(0.5, dtype=torch.float64)
        got = tctl.select_initial_step(tode.ODETerm(T_RHS), t0, _torch(y),
                                       T_RHS(t0, _torch(y), 0.8), 0.8, order, 1e-5, 1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    # batch-leading: each member its own step
    ys = [_state(s) for s in (2, 3)]
    yb = tuple(torch.as_tensor(np.stack(leaves)) for leaves in zip(*ys))
    tb = torch.full((2,), 0.5, dtype=torch.float64)
    rhs_b = tint._member_map(T_RHS, torch.tensor([0.8, 0.8], dtype=torch.float64))
    k = torch.tensor([0.8, 0.8], dtype=torch.float64)
    got = tctl.select_initial_step(tode.ODETerm(rhs_b), tb, yb, rhs_b(tb, yb, k), k, 5, 1e-5, 1e-6)
    for m, y in enumerate(ys):
        want = j_initial_step(jode.ODETerm(J_RHS), jnp.asarray(0.5), _jax(y),
                              J_RHS(0.5, _jax(y), 0.8), 0.8, 5, 1e-5, 1e-6)
        np.testing.assert_allclose(float(got[m]), float(want), rtol=1e-12)


def test_rms_error_norm_matches_jax():
    """The scaled RMS norm over the whole state, and per member: 1e-12."""
    rng = np.random.default_rng(4)
    trees = [tuple(rng.normal(size=s) for s in ((4, 3), (4, 2, 2))) for _ in range(3)]
    err, y0, y1 = trees
    got = tctl.rms_error_norm(_torch(err), _torch(y0), _torch(y1), 1e-5, 1e-6)
    want = j_rms(_jax(err), _jax(y0), _jax(y1), 1e-5, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    got_b = tctl.rms_error_norm(_torch(err), _torch(y0), _torch(y1), 1e-5, 1e-6, batch_dims=1)
    want_b = jax.vmap(lambda e, a, b: j_rms(e, a, b, 1e-5, 1e-6))(_jax(err), _jax(y0), _jax(y1))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-12)


def _pid(rtol=1e-6, atol=1e-8, jumps=None):
    return (jode.ClipStepSizeController(jode.PIDController(rtol, atol), jump_ts=jumps),
            tode.ClipStepSizeController(tode.PIDController(rtol, atol), jump_ts=jumps))


UNIFORM = np.linspace(0.0, 20.0, 21)
#: save times off any step grid, two of them inside one day
UNEVEN = np.array([0.0, 0.3, 1.7, 1.75, 5.0, 9.99, 14.2, 20.0])

#: (case id, engine it must reach, solver, constant dt or None, save grid,
#:  diffeqsolve keywords)
ROUTES = [
    ("constant-direct", "_solve_constant_direct", "Tsit5", 0.25, UNIFORM, {}),
    ("constant-direct-kahan", "_solve_constant_direct", "Bosh3", 0.5, UNIFORM,
     {"compensated_summation": True}),
    ("constant-off-grid", "_solve", "Tsit5", 0.3, UNIFORM, {}),
    ("adaptive-grid", "_solve_adaptive_grid", "Tsit5", None, UNIFORM, {}),
    ("adaptive-grid-kahan", "_solve_adaptive_grid", "Dopri5", None, UNIFORM,
     {"compensated_summation": True}),
    ("adaptive-uneven-dense", "_solve", "Tsit5", None, UNEVEN, {}),
    ("adaptive-two-point", "_solve", "Bosh3", None, np.array([0.0, 20.0]), {}),
    ("adaptive-small-budget", "_solve", "Tsit5", None, UNIFORM, {"step_budget": 30}),
    ("adaptive-uneven-kahan", "_solve", "Heun", None, UNEVEN,
     {"compensated_summation": True, "checkpoint_every": 8}),
]


@pytest.mark.parametrize("case, engine, solver, dt, grid, kw", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_engine_route_matches_jax(monkeypatch, case, engine, solver, dt, grid, kw):
    """Each case reaches the engine named and agrees with JAX: saves within
    1e-10 relative (atol 1e-14), equal accepted, rejected and budget
    statistics and result (float64)."""
    reached = []
    for name in ("_solve", "_solve_adaptive_grid", "_solve_constant_direct"):
        real = getattr(tint, name)
        monkeypatch.setattr(tint, name, lambda *a, _n=name, _r=real, **k: reached.append(_n) or _r(*a, **k))
    jctl, tctl_ = (jode.ConstantStepSize(), tode.ConstantStepSize()) if dt else _pid()
    common = dict(t0=0.0, t1=20.0, dt0=dt, **kw)
    want = jode.diffeqsolve(J_SIR, getattr(jode, solver)(), y0=_jax(SIR0), args=jnp.asarray(SIR_P),
                            saveat=jode.SaveAt(ts=jnp.asarray(grid)), stepsize_controller=jctl, **common)
    got = tode.diffeqsolve(T_SIR, getattr(tode, solver)(), y0=_torch(SIR0), args=torch.as_tensor(SIR_P),
                           saveat=tode.SaveAt(ts=grid), stepsize_controller=tctl_, **common)
    assert reached == [engine]
    _close(got.ys, want.ys, 1e-10, 1e-14)
    np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))
    for key in want.stats:
        assert int(got.stats[key]) == int(want.stats[key]), key
    assert int(got.result) == int(want.result) == 0


def test_buffered_engine_exhaustion_and_jumps_match_jax():
    """The buffered engine out of budget (NaN tail, result 1) and landing
    on a jump between two save times: NaN pattern, saves (1e-10) and
    statistics equal to JAX's."""
    def decay(xp):
        def rhs(t, y, a):
            # torch.where of two Python numbers would give the default float32
            k = xp.where(t < 7.3, xp.full_like(t, 0.1), xp.full_like(t, 0.5))
            return (-k * y[0],)
        return rhs

    y0 = (np.array([1.0, 2.0]),)
    for budget, jumps in ((6, None), (256, [7.3])):
        jctl, tctl_ = _pid(1e-7, 1e-9, jumps)
        kw = dict(t0=0.0, t1=20.0, dt0=None, step_budget=budget)
        want = jode.diffeqsolve(decay(jnp), jode.Tsit5(), y0=_jax(y0), saveat=jode.SaveAt(ts=jnp.asarray(UNEVEN)),
                                stepsize_controller=jctl, **kw)
        got = tode.diffeqsolve(decay(torch), tode.Tsit5(), y0=_torch(y0), saveat=tode.SaveAt(ts=UNEVEN),
                               stepsize_controller=tctl_, **kw)
        np.testing.assert_array_equal(np.isnan(got.ys[0].numpy()), np.isnan(np.asarray(want.ys[0])))
        _close(got.ys, want.ys, 1e-10, 1e-14)
        assert {k: int(v) for k, v in got.stats.items()} == {k: int(v) for k, v in want.stats.items()}
        assert int(got.result) == int(want.result) == (1 if budget == 6 else 0)


def test_grid_engine_jump_inside_an_interval_matches_jax(monkeypatch):
    """``test_grid_engine.py`` TestJumpTs: the decay rate switches at
    t = 10.35, inside a save interval, on the save-grid engine. Within
    1e-4 of the exact solution (the JAX test's bound) and equal to JAX's
    solve (saves 1e-10, statistics)."""
    reached = []
    real = tint._solve_adaptive_grid
    monkeypatch.setattr(tint, "_solve_adaptive_grid", lambda *a, **k: reached.append(1) or real(*a, **k))

    def decay(xp):
        def rhs(t, y, a):
            k = xp.where(t < 10.35, xp.full_like(t, 0.1), xp.full_like(t, 0.5))
            return (-k * y[0],)
        return rhs

    jctl, tctl_ = _pid(1e-5, 1e-6, [10.35])
    grid = np.linspace(0.0, 30.0, 31)
    kw = dict(t0=0.0, t1=30.0, dt0=None)
    want = jode.diffeqsolve(decay(jnp), jode.Tsit5(), y0=(jnp.ones(1),), saveat=jode.SaveAt(ts=jnp.asarray(grid)),
                            stepsize_controller=jctl, **kw)
    got = tode.diffeqsolve(decay(torch), tode.Tsit5(), y0=(torch.ones(1, dtype=torch.float64),),
                           saveat=tode.SaveAt(ts=grid), stepsize_controller=tctl_, **kw)
    assert reached == [1] and int(got.result) == int(want.result) == 0
    _close(got.ys, want.ys, 1e-10, 1e-14)
    assert {k: int(v) for k, v in got.stats.items()} == {k: int(v) for k, v in want.stats.items()}
    exact = np.where(grid < 10.35, np.exp(-0.1 * grid), np.exp(-0.1 * 10.35) * np.exp(-0.5 * (grid - 10.35)))
    np.testing.assert_allclose(got.ys[0].numpy()[:, 0], exact, rtol=1e-4)


#: ``tests/test_ode/test_grid_engine.py`` TestPerIntervalBudget: (case,
#: rtol, atol, steps_per_save, days); the catch-up case takes a tolerance
#: at which an interval of this SIR runs out and a later one recovers
BUDGETS = [("exhausted", 1e-10, 1e-12, 2, 50), ("generous", 1e-5, 1e-6, 16, 50),
           ("catches-up", 1e-9, 1e-11, 3, 80)]


@pytest.mark.parametrize("case, rtol, atol, steps_per_save, days", BUDGETS, ids=[b[0] for b in BUDGETS])
def test_grid_engine_budget_per_interval_matches_jax(case, rtol, atol, steps_per_save, days):
    """An interval out of steps leaves NaN saves until the member catches
    up, and flags ``result``. NaN pattern, statistics and the other saves
    (1e-10) equal to JAX's; in the catch-up case the saves that are not
    NaN are within 1e-3 of a generous run's, the JAX test's bound."""
    jctl, tctl_ = _pid(rtol, atol)
    grid = np.linspace(0.0, days, days + 1)

    def solve(k):
        kw = dict(t0=0.0, t1=float(days), dt0=None, steps_per_save=k)
        want = jode.diffeqsolve(J_SIR, jode.Tsit5(), y0=_jax(SIR0), args=jnp.asarray(SIR_P),
                                saveat=jode.SaveAt(ts=jnp.asarray(grid)), stepsize_controller=jctl, **kw)
        got = tode.diffeqsolve(T_SIR, tode.Tsit5(), y0=_torch(SIR0), args=torch.as_tensor(SIR_P),
                               saveat=tode.SaveAt(ts=grid), stepsize_controller=tctl_, **kw)
        return got, want

    got, want = solve(steps_per_save)
    nan = np.isnan(got.ys[1].numpy()[:, 0])
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(want.ys[1])[:, 0]))
    _close(got.ys, want.ys, 1e-10, 1e-14)
    assert {k: int(v) for k, v in got.stats.items()} == {k: int(v) for k, v in want.stats.items()}
    assert int(got.result) == int(want.result) == (0 if case == "generous" else 1)
    assert not nan[0]
    if case == "exhausted":
        assert nan.any()
    elif case == "generous":
        assert int(got.stats["step_budget"]) == 2 * 16 + 16 * 49
    else:
        assert (~nan[1:] & nan[:-1]).any(), "no save after an exhausted interval caught up"
        ok, _ = solve(16)
        np.testing.assert_allclose(got.ys[1].numpy()[~nan], ok.ys[1].numpy()[~nan], rtol=1e-3, atol=1e-7)


def test_finished_steps_are_no_ops_without_host_checks(monkeypatch):
    """On the card the engines never ask the host inside a chunk or an
    interval whether a solve is done; the CPU asks after every step. Both
    give the same bits, batch-leading and alone, for the grid and the
    buffered engine."""
    _, ctl = _pid()
    p = torch.tensor([[0.4, 0.15], [0.6, 0.1], [0.3, 0.2]], dtype=torch.float64)
    y0 = tuple(torch.as_tensor(x).expand(3, 1) for x in SIR0)
    cases = [dict(y0=_torch(SIR0), args=p[0], saveat=tode.SaveAt(ts=UNIFORM)),
             dict(y0=_torch(SIR0), args=p[0], saveat=tode.SaveAt(ts=UNEVEN)),
             dict(y0=y0, args=p, saveat=tode.SaveAt(ts=UNEVEN), batched=True)]

    def solve(case):
        return tode.diffeqsolve(T_SIR, tode.Tsit5(), 0.0, 20.0, None, stepsize_controller=ctl,
                                step_budget=64, **case)

    with_checks = [solve(c) for c in cases]
    monkeypatch.setattr(tint, "_host_skips", lambda device: False)
    for case, want in zip(cases, with_checks):
        got = solve(case)
        for g, w in zip(got.ys, want.ys):
            assert torch.equal(g, w)
        for key in want.stats:
            assert torch.equal(got.stats[key], want.stats[key])


def test_compensated_summation_in_float32():
    """``tests/test_ode/test_compensated.py``: on the same step grid, plain
    float32 accumulates O(n eps) roundoff against float64 and Kahan
    compensation recovers at least 10 times of it."""
    grid = np.linspace(0.0, 16.0, 9)

    def run(dtype, compensated):
        y0 = tuple(torch.tensor([v], dtype=dtype) for v in (0.99, 0.01, 0.0))
        sol = tode.diffeqsolve(T_SIR, tode.Euler(), 0.0, 16.0, 0.002, y0,
                               args=torch.tensor([0.4, 0.1], dtype=dtype),
                               saveat=tode.SaveAt(ts=grid), compensated_summation=compensated)
        return torch.cat(sol.ys, -1).double()

    ref = run(torch.float64, False)
    err_plain = float((run(torch.float32, False) - ref).abs().max())
    err_comp = float((run(torch.float32, True) - ref).abs().max())
    assert err_comp < err_plain / 10.0, (err_plain, err_comp)


def test_uniform_grid_detection_matches_jax():
    """``_uniform_grid_info`` on the grids of ``test_grid_engine.py``."""
    from dynode_tpu.ode.integrate import _uniform_grid_info as j_grid

    shifted = np.linspace(0.0, 200.0, 201)
    shifted[5] += 0.01
    for ts, t0, t1 in ((np.linspace(0.0, 200.0, 201), 0, 200), (np.linspace(0.0, 10.0, 6), 0.0, 10.0),
                       (shifted, 0, 200), (np.linspace(0.0, 100.0, 101), 0, 200),
                       (np.array([0.0, 200.0]), 0, 200)):
        assert tint._uniform_grid_info(ts, t0, t1) == j_grid(jnp.asarray(ts), t0, t1)


def test_inputs_on_two_devices_raise():
    """A solve runs on the device of its tensors and never moves them: a
    mix of devices raises."""
    meta = tuple(torch.empty(1, device="meta") for _ in SIR0)
    with pytest.raises(ValueError, match="several devices"):
        tode.diffeqsolve(T_SIR, tode.Tsit5(), 0.0, 1.0, 0.5, meta, args=torch.as_tensor(SIR_P))


def test_import_without_jax_pydantic_or_the_jax_package():
    """``import dynode_tpu_torch`` works with ``jax``, ``pydantic``,
    ``annotated_types`` and ``dynode_tpu`` blocked, as on a machine that has
    none of them, and ``simulate``, the config layer (both model configs,
    their parameters and initial states, a refused value), ``dist``
    (a draw, ``biject_to``, a ``log_prob``) and a tiny ``infer.MCMC``
    (NUTS, 2 chains) run there."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'pydantic', 'annotated_types', 'dynode_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import torch, dynode_tpu_torch as d\n"
        "p = d.multistrain_default_params(dtype=torch.float64, device='cpu')\n"
        "y0 = d.multistrain_initial_state(dtype=torch.float64, device='cpu')\n"
        "sol = d.simulate(d.multistrain_ode, 4, y0, p, d.SolverParams(constant_step_size=0.5))\n"
        "assert int(sol.result) == 0 and sol.ys[4].shape == (5, 2, 3)\n"
        "cfg = d.multistrain_config(solver_params=d.SolverParams(constant_step_size=0.5))\n"
        "assert torch.equal(d.multistrain_odeparams(cfg, device='cpu').beta, d.multistrain_default_params(device='cpu').beta)\n"
        "assert d.multistrain_initial_state(cfg, device='cpu')[2].shape == (2, 3)\n"
        "s = d.seip_config(seasonal_vaccination=True)\n"
        "assert d.seip_odeparams(s, device='cpu').seasonal_vaccination and d.seip_initial_state(s, device='cpu')[0].shape == (4, 4, 4, 4)\n"
        "try:\n"
        "    d.Strain(strain_name='a', r0=1.0, infectious_period=1.0, exposed_to_infectious=0.0)\n"
        "    raise SystemExit('a refused value was taken')\n"
        "except ValueError:\n"
        "    pass\n"
        "prior = d.dist.TruncatedNormal(torch.ones(3), 0.3, low=0.5, high=2.0)\n"
        "x = prior.sample(torch.Generator().manual_seed(0), (4,))\n"
        "t = d.dist.biject_to(prior.support)\n"
        "assert torch.allclose(t(t.inv(x)), x) and bool(torch.isfinite(prior.log_prob(x)).all())\n"
        "from dynode_tpu_torch.infer import MCMC, NUTS, handlers\n"
        "def m():\n"
        "    handlers.sample('x', d.dist.Normal(torch.zeros(2, dtype=torch.float64), 1.0))\n"
        "mc = MCMC(NUTS(m, max_tree_depth=2), num_warmup=3, num_samples=3, num_chains=2)\n"
        "mc.run(torch.Generator().manual_seed(0))\n"
        "assert mc.get_samples()['x'].shape == (6, 2) and bool(torch.isfinite(mc.get_samples()['x']).all())\n"
        "assert 'pydantic' not in sys.modules or sys.modules['pydantic'] is None\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
