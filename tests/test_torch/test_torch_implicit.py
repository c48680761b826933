"""The port's implicit (ESDIRK) solvers against the JAX package's, on the CPU.

Mirrors ``tests/test_ode/test_implicit.py`` case by case: L-stability at a
large step, the convergence orders, Robertson against scipy's Radau, a
gradient through the Newton iterations, a batch of solves, the public
``simulate``, discontinuity points and NUTS through a TRBDF2 solve. Every
solve also goes through the JAX package on the same float64 inputs: the
port takes the same accepted and rejected steps, and its saves agree
within 1e-10 relative (the arithmetic is the same in the same order; the
Jacobian and the LU come from other libraries, which Newton's fixed point
forgives); gradients within 1e-8 of ``jax.grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

import dynode_tpu.ode as jode
import dynode_tpu_torch.ode as tode
from dynode_tpu.config import SolverParams as JSolverParams
from dynode_tpu.simulation import simulate as j_simulate
from dynode_tpu.simulation import simulate_ensemble as j_simulate_ensemble
from dynode_tpu_torch.config import SolverParams as TSolverParams
from dynode_tpu_torch.simulation import simulate as t_simulate
from dynode_tpu_torch.simulation import simulate_ensemble as t_simulate_ensemble

F64 = torch.float64
SOLVERS = ["ImplicitEuler", "TRBDF2"]
TOL = 1e-10


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _same_solve(got, want, rtol=TOL):
    """Equal step statistics and results, saves within ``rtol``."""
    for key in ("num_accepted", "num_rejected"):
        np.testing.assert_array_equal(got.stats[key].numpy(), np.asarray(want.stats[key]), err_msg=key)
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(want.result))
    for g, w in zip(got.ys, want.ys):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=1e-300)


def _both(rhs, solver, t0, t1, dt0, y0, args=None, *, ts, controller, max_steps, batched=False, targs=None):
    """The same ``diffeqsolve`` through both packages (JAX's under ``vmap``
    when ``batched``)."""
    jc, tc = controller

    def one(y, a):
        return jode.diffeqsolve(jode.ODETerm(rhs(jnp)), getattr(jode, solver)(), t0, t1, dt0, y, a,
                                saveat=jode.SaveAt(ts=jnp.asarray(ts)), stepsize_controller=jc,
                                max_steps=max_steps)

    jy0 = tuple(jnp.asarray(x) for x in y0)
    want = jax.jit(jax.vmap(one))(jy0, jnp.asarray(args)) if batched else one(jy0, args)
    got = tode.diffeqsolve(tode.ODETerm(rhs(torch)), getattr(tode, solver)(), t0, t1, dt0,
                           tuple(_t(x) for x in y0), targs if targs is not None else args,
                           saveat=tode.SaveAt(ts=np.asarray(ts)), stepsize_controller=tc,
                           max_steps=max_steps, batched=batched)
    return got, want


def _lin50(xp):
    return lambda t, y, args: (-50.0 * y[0],)


def _constant():
    return jode.ConstantStepSize(), tode.ConstantStepSize()


def _pid(rtol, atol):
    return jode.PIDController(rtol=rtol, atol=atol), tode.PIDController(rtol=rtol, atol=atol)


def test_tableaus_are_the_jax_floats():
    for name in SOLVERS:
        j, t = getattr(jode, name), getattr(tode, name)
        assert tuple(float(x) for x in j.c) == t.c
        for attr in ("a", "diag", "b", "e", "order", "err_order", "fsal", "newton_iters"):
            assert getattr(j, attr) == getattr(t, attr), attr
        assert issubclass(t, tode.AbstractImplicitSolver) and not issubclass(tode.Tsit5, tode.AbstractImplicitSolver)


@pytest.mark.parametrize("name", SOLVERS)
@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batch_of_3"])
def test_step_and_step_inc_match_jax(name, batch):
    """One step of a two-leaf nonlinear system, with and without the FSAL
    carry, alone and for a batch (each member its own Jacobian, as under
    ``jax.vmap``): ``y1``, ``inc``, ``err`` and ``f1`` within 1e-12."""
    rng = np.random.default_rng(3)

    def rhs(xp):
        return lambda t, y, k: (-k * y[0] * y[1].sum() + xp.sin(t) * y[0], k * y[0].sum() * y[1] - 2.0 * y[1] ** 2)

    y = (rng.uniform(0.5, 1.5, batch + (2,)), rng.uniform(0.5, 1.5, batch + (2, 2)))
    t, dt = np.full(batch, 0.3), rng.uniform(0.2, 0.6, batch)
    k = 3.0
    jsolver, tsolver = getattr(jode, name)(), getattr(tode, name)()
    jterm = jode.ODETerm(rhs(jnp))
    tterm = tode.ODETerm(rhs(torch))
    if batch:
        # the engine's batch-leading term, which carries the member's RHS
        tterm = tode.ODETerm(tode.integrate._member_map(rhs(torch), _t(np.full(batch, k))), member_fn=rhs(torch))
    for carry in (False, True):
        def jstep(yy, tt, dd):
            f0 = rhs(jnp)(tt, yy, k) if carry else None
            return jsolver.step(jterm, tt, dd, yy, k, f0=f0)

        jy, jt, jdt = tuple(jnp.asarray(x) for x in y), jnp.asarray(t), jnp.asarray(dt)
        want = jax.jit(jax.vmap(jstep) if batch else jstep)(jy, jt, jdt)
        # JAX's step_inc is its step's y1 - y
        want_inc = (tuple(a - b for a, b in zip(want[0], jy)),) + tuple(want[1:])
        ty = tuple(_t(x) for x in y)
        targ = _t(np.full(batch, k)) if batch else k
        f0 = tterm.vf(_t(t), ty, targ) if carry else None
        for method, w in (("step", want), ("step_inc", want_inc)):
            got = getattr(tsolver, method)(tterm, _t(t), _t(dt), ty, targ, f0=f0)
            for part in range(3):
                for g, x in zip(got[part], w[part]):
                    np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-12, atol=1e-15)
        assert tsolver.step(tterm, _t(t), _t(dt), ty, targ, error=False)[1] is None


@pytest.mark.parametrize("name", SOLVERS)
def test_l_stable_decay_at_large_dt(name):
    """dt * |lambda| = 25: far outside any explicit stability region."""
    got, want = _both(_lin50, name, 0.0, 10.0, 0.5, (np.ones(1),), ts=np.linspace(0, 10, 21),
                      controller=_constant(), max_steps=64)
    _same_solve(got, want)
    y = got.ys[0].numpy().ravel()
    assert np.all(np.abs(y) <= 1.0)
    assert abs(y[-1]) < 1e-6


def test_explicit_euler_analogue_would_explode():
    """The control of the test above: the same dt with forward Euler leaves
    the stability region (|1 + dt*lambda| = 24 a step)."""
    sol = tode.diffeqsolve(tode.ODETerm(_lin50(torch)), tode.Euler(), 0.0, 5.0, 0.5, (torch.ones(1, dtype=F64),),
                           saveat=tode.SaveAt(ts=np.array([5.0])), stepsize_controller=tode.ConstantStepSize(),
                           max_steps=32)
    assert abs(float(sol.ys[0][-1, 0])) > 1e6


@pytest.mark.parametrize("name, order", [("ImplicitEuler", 1), ("TRBDF2", 2)])
def test_convergence_order(name, order):
    def logistic(xp):
        return lambda t, y, args: (y[0] * (1.0 - y[0]),)

    exact = 1.0 / (1.0 + 9.0 * np.exp(-2.0))
    errs = []
    for dt in (0.2, 0.1, 0.05):
        got, want = _both(logistic, name, 0.0, 2.0, dt, (np.array([0.1]),), ts=np.array([2.0]),
                          controller=_constant(), max_steps=256)
        _same_solve(got, want)
        errs.append(abs(float(got.ys[0][-1, 0]) - exact))
    rate = np.log2(errs[0] / errs[2]) / 2.0
    assert rate > order - 0.25, (errs, rate)


def _rober_np(t, y):
    return np.array([
        -0.04 * y[0] + 1e4 * y[1] * y[2],
        0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2,
        3e7 * y[1] ** 2,
    ])


def test_robertson_vs_scipy_radau():
    """The canonical stiff benchmark (rates over 9 orders of magnitude):
    adaptive TRBDF2 against a tight Radau solve (rtol 5e-4, atol 1e-9),
    mass conserved to 1e-9, and JAX's steps."""

    def rober(xp):
        def f(t, y, args):
            y1, y2, y3 = y[0][0], y[0][1], y[0][2]
            return (xp.stack([-0.04 * y1 + 1e4 * y2 * y3, 0.04 * y1 - 1e4 * y2 * y3 - 3e7 * y2**2, 3e7 * y2**2]),)

        return f

    got, want = _both(rober, "TRBDF2", 0.0, 100.0, None, (np.array([1.0, 0.0, 0.0]),),
                      ts=np.array([1.0, 10.0, 100.0]), controller=_pid(1e-6, 1e-10), max_steps=4096)
    assert int(got.result) == 0
    _same_solve(got, want)
    ref = solve_ivp(_rober_np, (0, 100), [1.0, 0.0, 0.0], method="Radau", t_eval=[1.0, 10.0, 100.0],
                    rtol=1e-10, atol=1e-12).y.T
    np.testing.assert_allclose(got.ys[0].numpy(), ref, rtol=5e-4, atol=1e-9)
    np.testing.assert_allclose(got.ys[0].numpy().sum(axis=-1), 1.0, rtol=1e-9)


def test_grad_through_implicit_solve():
    """Autograd through the Newton iterations, under the buffered engine's
    checkpoint: within 1e-8 of ``jax.grad`` and 1e-5 of d/dk exp(-k)."""

    def j_loss(k):
        s = jode.diffeqsolve(jode.ODETerm(lambda t, y, a: (-k * y[0],)), jode.TRBDF2(), 0.0, 1.0, None,
                             (jnp.ones(1),), saveat=jode.SaveAt(ts=jnp.asarray([1.0])),
                             stepsize_controller=jode.PIDController(rtol=1e-8, atol=1e-10), max_steps=512)
        return s.ys[0][-1, 0]

    want = float(jax.grad(j_loss)(2.0))
    k = torch.tensor(2.0, dtype=F64, requires_grad=True)
    s = tode.diffeqsolve(tode.ODETerm(lambda t, y, a: (-k * y[0],)), tode.TRBDF2(), 0.0, 1.0, None,
                         (torch.ones(1, dtype=F64),), saveat=tode.SaveAt(ts=np.array([1.0])),
                         stepsize_controller=tode.PIDController(rtol=1e-8, atol=1e-10), max_steps=512)
    s.ys[0][-1, 0].backward()
    assert abs(float(k.grad) - want) <= 1e-8 * abs(want)
    assert abs(float(k.grad) + np.exp(-2.0)) < 1e-5


@pytest.mark.parametrize("adaptive", [False, True], ids=["constant", "adaptive"])
def test_vmap_ensemble_of_implicit_solves(adaptive):
    """A batch-leading ensemble (``diffeqsolve(batched=True)``): each
    member its own Jacobian, LU and dt chain, as JAX's ``vmap``."""

    def f(xp):
        return lambda t, y, a: (-a * y[0] * (1.0 + 0.1 * xp.sin(y[0])),)

    ks = np.linspace(0.5, 3.0, 8)
    controller = _pid(1e-7, 1e-9) if adaptive else _constant()
    got, want = _both(f, "TRBDF2", 0.0, 1.0, None if adaptive else 0.02, (np.ones((8, 2)),), ks,
                      ts=np.array([0.5, 1.0]), controller=controller, max_steps=256, batched=True, targs=_t(ks))
    _same_solve(got, want)
    assert np.all(np.diff(got.ys[0][:, -1, 0].numpy()) < 0)  # faster decay, less left


def _sir_age():
    from dynode_tpu.infer import sample_then_resolve as j_resolve
    from dynode_tpu.models import sir as jsir
    from dynode_tpu_torch.infer import sample_then_resolve as t_resolve
    from dynode_tpu_torch.models import sir as tsir

    j_cfg, t_cfg = jsir.sir_age_config(), tsir.sir_age_config()
    jtp, ttp = j_resolve(j_cfg.parameters.transmission_params), t_resolve(t_cfg.parameters.transmission_params)
    js, ts = jtp.strains[0], ttp.strains[0]
    jp = jsir.SIRParams(beta=jnp.asarray(js.r0 / js.infectious_period), gamma=jnp.asarray(1.0 / js.infectious_period),
                        contact_matrix=jnp.asarray(jtp.contact_matrix))
    tp = tsir.SIRParams(beta=torch.tensor(ts.r0 / ts.infectious_period, dtype=F64),
                        gamma=torch.tensor(1.0 / ts.infectious_period, dtype=F64),
                        contact_matrix=torch.as_tensor(ttp.contact_matrix).to(F64))
    return (jsir, j_cfg.initializer.get_initial_state(), jp), (tsir, t_cfg.initializer.get_initial_state(
        dtype=F64, device="cpu"), tp)


def test_implicit_through_public_simulate():
    """``SolverParams(solver_method=TRBDF2())`` through ``simulate`` (the
    adaptive save-grid engine): JAX's steps and saves, and Tsit5 at tight
    tolerances within 2e-5 relative, 1e-7 absolute."""
    (jsir, jy0, jp), (tsir, ty0, tp) = _sir_age()
    kw = dict(ode_solver_rel_tolerance=1e-7, ode_solver_abs_tolerance=1e-9)
    want = j_simulate(jsir.sir_ode, 50, jy0, jp, JSolverParams(solver_method=jode.TRBDF2(), **kw))
    got = t_simulate(tsir.sir_ode, 50, ty0, tp, TSolverParams(solver_method=tode.TRBDF2(), **kw))
    assert int(got.result) == 0
    _same_solve(got, want)
    ref = t_simulate(tsir.sir_ode, 50, ty0, tp, TSolverParams(ode_solver_rel_tolerance=1e-9,
                                                              ode_solver_abs_tolerance=1e-11))
    for a, b in zip(got.ys, ref.ys):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("layout", ["batch_leading", "lane_major"])
def test_implicit_through_simulate_ensemble(layout):
    """``simulate_ensemble`` with TRBDF2 in both layouts against JAX's:
    the batch-leading members each take their own steps; the lane-major
    ensemble is one system (a Jacobian dense in the members)."""
    (jsir, jy0, jp), (tsir, ty0, tp) = _sir_age()
    scales = np.linspace(0.8, 1.2, 4)
    jpb = jp.replace(beta=jp.beta * jnp.asarray(scales))
    tpb = tsir.SIRParams(beta=tp.beta * _t(scales), gamma=tp.gamma.expand(4).clone(),
                         contact_matrix=tp.contact_matrix.expand(4, -1, -1).clone())
    jpb = jpb.replace(gamma=jnp.broadcast_to(jp.gamma, (4,)),
                      contact_matrix=jnp.broadcast_to(jp.contact_matrix, (4,) + jp.contact_matrix.shape))
    kw = dict(solver_method=None, ode_solver_rel_tolerance=1e-6, ode_solver_abs_tolerance=1e-8, step_budget=256)
    want = j_simulate_ensemble(jsir.sir_ode, 20, jy0, jpb, JSolverParams(**{**kw, "solver_method": jode.TRBDF2()}),
                               layout=layout)
    got = t_simulate_ensemble(tsir.sir_ode, 20, ty0, tpb, TSolverParams(**{**kw, "solver_method": tode.TRBDF2()}),
                              layout=layout)
    _same_solve(got, want)
    assert int(got.result.max()) == 0


def test_implicit_with_discontinuity_points():
    """``jump_ts`` clipping with the implicit stepper: -2y before t = 1,
    -y/2 after, against the exact piecewise solution (1e-5) and JAX."""

    def f(xp):
        return lambda t, y, args: (-xp.where(t < 1.0, 2.0, 0.5) * y[0],)

    def tf(t, y, args):
        lam = torch.where(t < 1.0, torch.tensor(2.0, dtype=F64), torch.tensor(0.5, dtype=F64))
        return (-lam * y[0],)

    jc = jode.ClipStepSizeController(jode.PIDController(rtol=1e-8, atol=1e-10), jump_ts=[1.0])
    tc = tode.ClipStepSizeController(tode.PIDController(rtol=1e-8, atol=1e-10), jump_ts=[1.0])
    ts = np.array([0.5, 1.0, 1.5, 2.0])
    got, want = _both(lambda xp: f(jnp) if xp is jnp else tf, "TRBDF2", 0.0, 2.0, None, (np.ones(1),),
                      ts=ts, controller=(jc, tc), max_steps=1024)
    _same_solve(got, want)
    exact = np.array([np.exp(-1.0), np.exp(-2.0), np.exp(-2.0) * np.exp(-0.25), np.exp(-2.0) * np.exp(-0.5)])
    np.testing.assert_allclose(got.ys[0].numpy().ravel(), exact, rtol=1e-5)


def test_nuts_through_implicit_solve(monkeypatch):
    """NUTS gradients through the TRBDF2 Newton iterations inside the
    checkpointed engine: two transitions of a decay-rate fit (rate
    exp(u), prior u ~ N(0, 0.5), five noisy observations), the port given
    JAX's recorded draws. Each transition's position, potential and
    gradient within 1e-8 relative of JAX's, the same leapfrog counts.

    The solve takes a constant step (dt = 0.1): XLA's compilation of the
    whole potential rounds otherwise than JAX op by op and moves an
    adaptive solve's step decisions (the port takes the op-by-op steps),
    while op by op a JAX gradient costs seconds. The adaptive gradient is
    held to ``jax.grad`` by :func:`test_grad_through_implicit_solve`."""
    from dynode_tpu.infer import hmc as jh
    from dynode_tpu_torch.infer import hmc as th
    from torch_infer_draws import Replay, record

    obs = 100.0 * np.exp(-1.3 * np.arange(5.0)) + np.random.default_rng(0).normal(0, 0.1, 5)

    def j_pot(z):
        sol = j_simulate(lambda t, y, a: (-a * y[0],), 4, (jnp.asarray([100.0]),), jnp.exp(z[0]),
                         JSolverParams(solver_method=jode.TRBDF2(), constant_step_size=0.1))
        return 2.0 * z[0] ** 2 + 50.0 * jnp.sum((jnp.asarray(obs) - sol.ys[0][:, 0]) ** 2)

    j_vg = jax.jit(jax.value_and_grad(j_pot))

    def j_pag(z):
        with jax.disable_jit(False):
            return j_vg(z)

    def t_pag(zb):
        pes, grads = [], []
        for z in zb:
            u = z.detach().clone().requires_grad_()
            sol = t_simulate(lambda t, y, a: (-a * y[0],), 4, (torch.tensor([100.0], dtype=F64),), torch.exp(u[0]),
                             TSolverParams(solver_method=tode.TRBDF2(), constant_step_size=0.1))
            pe = 2.0 * u[0] ** 2 + 50.0 * torch.sum((_t(obs) - sol.ys[0][:, 0]) ** 2)
            (g,) = torch.autograd.grad(pe, u)
            pes.append(pe.detach())
            grads.append(g)
        return torch.stack(pes), torch.stack(grads)

    # a stable step: the potential's curvature near the mode is about 1.6e5
    inv, eps, depth = np.eye(1), 0.002, 2
    jstate = jh.init_state(j_pag, jnp.asarray([0.3]), jax.random.PRNGKey(0))
    tstate = th.init_state(t_pag, _t([[0.3]]))
    chol_t = th.chol_of_inv(_t(inv[None]), True)
    for _ in range(2):
        jstate, draws = record(monkeypatch, jh.nuts_transition, j_pag, jnp.asarray(inv),
                               jh.chol_of_inv(jnp.asarray(inv)), eps, depth, jstate)
        replay = Replay([draws])
        tstate = th.nuts_transition(t_pag, _t(inv[None]), chol_t, _t([eps]), depth, tstate, replay)
        assert replay.done()
        for field in ("z", "potential", "grad"):
            np.testing.assert_allclose(getattr(tstate, field)[0].numpy(), np.asarray(getattr(jstate, field)),
                                       rtol=1e-8, atol=1e-300)
        assert int(tstate.num_steps[0]) == int(jstate.num_steps)
    assert abs(float(tstate.z[0, 0]) - np.log(1.3)) < 0.2
