"""The kept solves of ``diffeqsolve`` (the port of JAX's jit cache on its
engines), checked on the CPU.

On a card a solve without gradients is kept: a key's first call runs
eagerly, its second captures the engine into a CUDA graph on static
buffers, later calls copy their tensors in and replay. Here the route is
forced on CPU tensors (``integrate._graphed``), where the same static
buffers are solved by calling the engine (no graph), so:

- (a) each engine (the grid engine, the buffered engine with a budget many
  chunks past the finish, the constant-direct engine, TRBDF2 on the grid
  engine) over three calls with new parameters takes the eager, capture
  and replay routes, equals the eager solve bit for bit (saves, grid,
  statistics, result; the buffered engine's kept route runs the chunks
  the eager loop runs and stops where it stops) and the JAX package's
  ``simulate`` /
  ``simulate_ensemble`` on the same float64 inputs (equal accepted and
  rejected steps, saves within 1e-10 relative);
- (b) the key: a first call builds no entry, a second with new values
  one, a third reuses it; another ``t1``, dtype, batch size, rtol,
  ``sub_save_indices`` or non-tensor argument misses; at most 8 entries,
  a dropped one released; ``clear_solve_cache`` empties the cache;
- (c) gradients, calls under ``torch.func.vmap`` and the CPU's own route
  stay eager and record nothing; so does a RHS that closes over a tensor
  that requires grad, whose gradient each call carries; a function made
  for one call is not kept alive;
- (d) each engine's graph bodies (its phases) run under ``test_torch_infer_graph``'s
  ``NoHostTraffic`` with ``_host_skips`` on the card's route: no host
  read, no tensor made from host data;
- (e) a returned result is a copy: a later call leaves it as it was.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import dynode_tpu.ode as jode
from dynode_tpu import simulate as j_simulate
from dynode_tpu.config import SolverParams as JSolverParams
from dynode_tpu.simulation import AbstractODEParams as JAbstractODEParams
from dynode_tpu.simulation import simulate_ensemble as j_simulate_ensemble
from dynode_tpu.struct import pytree_dataclass as j_dataclass
import dynode_tpu_torch.ode as tode
from dynode_tpu_torch import SolverParams, simulate, simulate_ensemble
from dynode_tpu_torch.ode import integrate
from dynode_tpu_torch.simulation import AbstractODEParams
from dynode_tpu_torch.struct import pytree_dataclass
from test_torch_infer_graph import NoHostTraffic

F64 = torch.float64
Y0 = (np.array([0.99]), np.array([0.01]), np.array([0.0]))
#: (beta, gamma) of the three calls of each case, from a numpy seed
CALLS = np.random.default_rng(18).uniform((0.25, 0.08), (0.45, 0.16), (3, 2))


@j_dataclass
class JP(JAbstractODEParams):
    beta: jnp.ndarray
    gamma: jnp.ndarray


@pytree_dataclass
class TP(AbstractODEParams):
    beta: torch.Tensor
    gamma: torch.Tensor


def j_sir(t, state, p: JP):
    s, i, r = state
    flow = p.beta * s * i / (s + i + r)
    return (-flow, flow - p.gamma * i, p.gamma * i)


def t_sir(t, state, p: TP):
    s, i, r = state
    flow = p.beta * s * i / (s + i + r)
    return (-flow, flow - p.gamma * i, p.gamma * i)


def _members(bg, n):
    """``n`` members around ``(beta, gamma)``: beta scaled from 0.8 to 1.2."""
    return np.linspace(0.8, 1.2, n) * bg[0], np.full(n, bg[1])


#: (case, engine, duration, SolverParams keywords, members or None for simulate)
CASES = [
    ("grid", "_solve_adaptive_grid", 20, {"step_budget": 128}, None),
    ("buffered", "_buffered", 10, {"step_budget": 512}, 3),
    ("constant", "_solve_constant_direct", 10, {"constant_step_size": 0.25}, None),
    ("trbdf2", "_solve_adaptive_grid", 4, {"step_budget": 128, "solver_method": "TRBDF2",
                                           "ode_solver_rel_tolerance": 1e-5, "ode_solver_abs_tolerance": 1e-8}, None),
]
#: (d)'s cases: each engine at 5 days (every step slot of the card's route runs under the mode)
HOST_CASES = [(case, engine, 5, {**sp, "step_budget": 64} if "step_budget" in sp else sp, members)
              for case, engine, _, sp, members in CASES]


def _solver_params(sp, xp):
    kw = dict(sp)
    if kw.get("solver_method") == "TRBDF2":
        kw["solver_method"] = jode.TRBDF2() if xp is jnp else tode.TRBDF2()
    return (JSolverParams if xp is jnp else SolverParams)(**kw)


def _torch_call(days, sp, members, bg):
    y0 = tuple(torch.as_tensor(x) for x in Y0)
    if members is None:
        return simulate(t_sir, days, y0, TP(torch.tensor(bg[0], dtype=F64), torch.tensor(bg[1], dtype=F64)),
                        _solver_params(sp, torch))
    beta, gamma = _members(bg, members)
    return simulate_ensemble(t_sir, days, y0, TP(torch.as_tensor(beta), torch.as_tensor(gamma)),
                             _solver_params(sp, torch))


def _jax_calls(days, sp, members):
    """JAX's solve of each call of ``CALLS``; the ensembles' members in one
    call (each member has its own dt chain, so they are independent)."""
    y0 = tuple(jnp.asarray(x) for x in Y0)
    if members is None:
        return [j_simulate(j_sir, days, y0, JP(jnp.asarray(bg[0]), jnp.asarray(bg[1])), _solver_params(sp, jnp))
                for bg in CALLS]
    beta, gamma = (np.concatenate(x) for x in zip(*(_members(bg, members) for bg in CALLS)))
    sol = j_simulate_ensemble(j_sir, days, y0, JP(jnp.asarray(beta), jnp.asarray(gamma)), _solver_params(sp, jnp))
    return [jax.tree_util.tree_map(lambda x, k=k: x[k * members:(k + 1) * members], sol) for k in range(len(CALLS))]


def _leaves(sol):
    return pytree.tree_leaves(sol)


def _bitwise(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
                                      and torch.equal(x.isnan(), y.isnan()) for x, y in zip(la, lb))


@pytest.fixture
def kept(monkeypatch):
    """The kept-graph route forced on CPU tensors, from an empty cache."""
    integrate.clear_solve_cache()
    integrate._ROUTES.clear()
    monkeypatch.setattr(integrate, "_graphed", lambda device: True)
    yield integrate
    integrate.clear_solve_cache()


@pytest.mark.parametrize("case, engine, days, sp, members", CASES, ids=[c[0] for c in CASES])
def test_each_engine_kept_equals_eager_and_jax(monkeypatch, case, engine, days, sp, members):
    eager = [_torch_call(days, sp, members, bg) for bg in CALLS]
    reached, phases = [], []
    real, real_phase = getattr(integrate, engine), integrate._phase
    monkeypatch.setattr(integrate, engine, lambda *a, **k: reached.append(engine) or real(*a, **k))
    monkeypatch.setattr(integrate, "_phase", lambda entry, name, fn: phases.append(name) or real_phase(entry, name, fn))
    integrate.clear_solve_cache()
    integrate._ROUTES.clear()
    monkeypatch.setattr(integrate, "_graphed", lambda device: True)
    got = [_torch_call(days, sp, members, bg) for bg in CALLS]
    assert dict(integrate._ROUTES) == {"eager": 1, "capture": 1, "replay": 1}
    assert len(integrate._SOLVE_CACHE) == 1
    if case == "buffered":  # the parts are built by the eager call and once for the kept solve
        assert reached == [engine] * 2
        chunks = [-(-int(g.stats["num_steps"].max()) // 32) for g in got[1:]]  # 16 chunks of 32 steps
        assert phases == [p for n in chunks for p in ["start"] + ["chunk"] * n + ["finish"]]
        assert max(chunks) < 16
    else:
        assert reached == [engine] * 3 and phases == ["solve"] * 2
    for g, e, want in zip(got, eager, _jax_calls(days, sp, members)):
        assert _bitwise(g, e)
        for key in ("num_accepted", "num_rejected"):
            np.testing.assert_array_equal(g.stats[key].numpy(), np.asarray(want.stats[key]), err_msg=key)
        np.testing.assert_array_equal(g.result.numpy(), np.asarray(want.result))
        assert int(g.result.max()) == 0
        for a, b in zip(g.ys, want.ys):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-14)
    assert not _bitwise(got[0], got[2])  # the replay solved its own parameters
    if case == "buffered":  # the budget runs many chunks (of 32 steps) past the finish
        assert int(got[0].stats["num_steps"].max()) * 4 < 512


def _constant(days=20, dtype=F64, beta=0.3, gamma=0.1, subs=None, dt=0.25):
    y0 = tuple(torch.as_tensor(x, dtype=dtype) for x in Y0)
    return simulate(t_sir, days, y0, TP(torch.tensor(beta, dtype=dtype), torch.tensor(gamma, dtype=dtype)),
                    SolverParams(constant_step_size=dt), sub_save_indices=subs)


def _adaptive(rtol=1e-5, members=None):
    y0 = tuple(torch.as_tensor(x) for x in Y0)
    sp = SolverParams(ode_solver_rel_tolerance=rtol, step_budget=256)
    if members is None:
        return simulate(t_sir, 10, y0, TP(torch.tensor(0.3, dtype=F64), torch.tensor(0.1, dtype=F64)), sp)
    beta, gamma = _members((0.3, 0.1), members)
    return simulate_ensemble(t_sir, 10, y0, TP(torch.as_tensor(beta), torch.as_tensor(gamma)), sp)


def _tuple_sir(t, state, p):
    beta, gamma = p
    s, i, r = state
    flow = beta * s * i
    return (-flow, flow - gamma * i, gamma * i)


def _with_float_arg(gamma):
    y0 = tuple(torch.as_tensor(x) for x in Y0)
    return tode.diffeqsolve(_tuple_sir, tode.Tsit5(), 0.0, 5.0, 0.5, y0, (torch.tensor(0.3, dtype=F64), gamma),
                            saveat=tode.SaveAt(ts=np.linspace(0.0, 5.0, 6)))


def test_a_key_is_kept_on_its_second_call_and_reused(kept):
    first = _constant(beta=0.3)
    assert len(kept._SOLVE_CACHE) == 0 and len(kept._SEEN) == 1
    second = _constant(beta=0.35)
    assert len(kept._SOLVE_CACHE) == 1 and len(kept._SEEN) == 0
    (entry,) = kept._SOLVE_CACHE.values()
    third = _constant(beta=0.4)
    assert len(kept._SOLVE_CACHE) == 1 and entry["replays"] == 2 and kept._SOLVE_CACHE[next(iter(kept._SOLVE_CACHE))] is entry
    assert dict(kept._ROUTES) == {"eager": 1, "capture": 1, "replay": 1}
    assert not _bitwise(first, second) and not _bitwise(second, third)


MISSES = {
    "t1": lambda: _constant(days=21),
    "dtype": lambda: _constant(dtype=torch.float32),
    "sub_save_indices": lambda: _constant(subs=(0, 2)),
    "batch": lambda: _adaptive(members=4),
    "rtol": lambda: _adaptive(rtol=1e-6),
    "non-tensor argument": lambda: _with_float_arg(0.12),
}
BASES = {"t1": _constant, "dtype": _constant, "sub_save_indices": _constant, "batch": lambda: _adaptive(members=3),
         "rtol": _adaptive, "non-tensor argument": lambda: _with_float_arg(0.1)}


@pytest.mark.parametrize("what", list(MISSES))
def test_another_static_part_misses(kept, what):
    """The base key kept after two calls; the changed call is a first call
    of its own key (eager, no entry), its second call a capture."""
    BASES[what]()
    BASES[what]()
    assert len(kept._SOLVE_CACHE) == 1
    MISSES[what]()
    assert len(kept._SOLVE_CACHE) == 1 and kept._ROUTES["eager"] == 2
    MISSES[what]()
    assert len(kept._SOLVE_CACHE) == 2 and kept._ROUTES["capture"] == 2


def test_at_most_eight_entries_and_clearing(kept):
    """Nine keys (durations 11 to 19), each called twice: the first key's
    entry is dropped and released; ``clear_solve_cache`` empties both the
    cache and the record of first calls."""
    entries = []
    for days in range(11, 20):
        _constant(days=days)
        _constant(days=days, beta=0.31)
        entries.append(next(reversed(kept._SOLVE_CACHE.values())))
    assert len(kept._SOLVE_CACHE) == 8 == integrate._graphs.EXEC_CACHE_SIZE
    assert entries[0] not in kept._SOLVE_CACHE.values() and entries[0]["bufs"] is None and entries[0]["run"] is None
    assert all(e["bufs"] is not None for e in entries[1:])
    _constant(days=30)
    assert len(kept._SEEN) == 1
    kept.clear_solve_cache()
    assert len(kept._SOLVE_CACHE) == 0 and len(kept._SEEN) == 0
    assert all(e["bufs"] is None and e["graphs"] == {} for e in entries)


def test_gradients_vmap_and_the_cpu_route_stay_eager(monkeypatch):
    integrate.clear_solve_cache()
    integrate._ROUTES.clear()
    _constant()
    _constant()  # the CPU's own route: nothing recorded
    assert len(integrate._SEEN) == 0 and len(integrate._SOLVE_CACHE) == 0
    monkeypatch.setattr(integrate, "_graphed", lambda device: True)
    y0 = tuple(torch.as_tensor(x) for x in Y0)
    sp = SolverParams(constant_step_size=0.25)
    for _ in range(3):
        beta = torch.tensor(0.3, dtype=F64, requires_grad=True)
        simulate(t_sir, 10, y0, TP(beta, torch.tensor(0.1, dtype=F64)), sp).ys[1].sum().backward()
        assert beta.grad is not None
    betas = torch.tensor([0.3, 0.4], dtype=F64)
    for _ in range(3):
        torch.func.vmap(lambda b: simulate(t_sir, 10, y0, TP(b, torch.tensor(0.1, dtype=F64)), sp).ys[1])(betas)
    assert len(integrate._SEEN) == 0 and len(integrate._SOLVE_CACHE) == 0 and not integrate._ROUTES


@pytest.mark.parametrize("case, engine, days, sp, members", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_each_engines_graph_body_makes_no_host_read_or_copy(kept, monkeypatch, case, engine, days, sp, members):
    monkeypatch.setattr(integrate, "_host_skips", lambda device: False)
    real = integrate._phase
    bodies = []

    def checked(entry, name, fn):
        def body():
            bodies.append(name)
            with NoHostTraffic():
                return fn()

        return real(entry, name, body)

    monkeypatch.setattr(integrate, "_phase", checked)
    sols = [_torch_call(days, sp, members, bg) for bg in CALLS[:2]]
    assert set(bodies) == ({"start", "chunk", "finish"} if case == "buffered" else {"solve"})
    assert all(int(s.result.max()) == 0 for s in sols)


def test_a_returned_result_is_a_copy(kept):
    _constant(beta=0.3)
    second = _constant(beta=0.35)
    kept_copy = [x.clone() for x in _leaves(second)]
    third = _constant(beta=0.4)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(second), kept_copy))
    (entry,) = kept._SOLVE_CACHE.values()
    assert all(x.data_ptr() not in {y.data_ptr() for y in _leaves(entry["y0"])} for x in _leaves(third))


def _decay(scale):
    """A RHS made for one call, closing over ``scale``."""
    def rhs(t, y, a):
        return (-scale * a * y[0],)

    return rhs


def _decay_call(rhs):
    y0 = (torch.tensor([1.0], dtype=F64),)
    return tode.diffeqsolve(rhs, tode.Tsit5(), 0.0, 2.0, 0.25, y0, torch.tensor(0.5, dtype=F64),
                            saveat=tode.SaveAt(ts=np.linspace(0.0, 2.0, 3)))


def test_a_rhs_closing_over_a_grad_tensor_keeps_its_gradient(kept):
    """A RHS closes over ``scale``. Three calls with ``scale`` requiring
    grad each carry its gradient and keep nothing; a key kept while
    ``scale`` required none (two calls) stays eager, with the gradient,
    once it requires grad."""
    scale = torch.tensor(1.5, dtype=F64, requires_grad=True)
    rhs = _decay(scale)
    grads = []
    for _ in range(3):
        scale.grad = None
        _decay_call(rhs).ys[0][-1].sum().backward()
        grads.append(scale.grad)
    # d/ds exp(-s a t) at a = 0.5, t = 2 is -exp(-1.5), to the solver's error
    assert abs(float(grads[0]) + np.exp(-1.5)) < 1e-3 and all(torch.equal(g, grads[0]) for g in grads)
    assert len(kept._SEEN) == 0 and len(kept._SOLVE_CACHE) == 0 and not kept._ROUTES
    got = grads[0]
    scale.requires_grad_(False)
    _decay_call(rhs)
    _decay_call(rhs)
    assert dict(kept._ROUTES) == {"eager": 1, "capture": 1}
    scale.requires_grad_(True)
    scale.grad = None
    _decay_call(rhs).ys[0][-1].sum().backward()
    assert torch.equal(scale.grad, got) and dict(kept._ROUTES) == {"eager": 1, "capture": 1}


def test_a_function_made_for_one_call_is_not_kept_alive(kept):
    """64 calls, each of a RHS made for it and closing over a tensor of its
    own: none is captured, and once each call returns nothing of it is
    held, the record of its first call gone with it."""
    held = []
    for k in range(64):
        scale = torch.tensor(1.0 + k, dtype=F64)
        rhs = _decay(scale)
        held += [weakref.ref(rhs), weakref.ref(scale)]
        _decay_call(rhs)
        del rhs, scale
    gc.collect()
    assert all(ref() is None for ref in held)
    assert len(kept._SEEN) == 0 and len(kept._SOLVE_CACHE) == 0 and dict(kept._ROUTES) == {"eager": 64}
