"""``simulate``, ``simulate_ensemble``, ``SolverParams`` and the pytree
dataclasses of the port against the JAX package, on the CPU.

The contracts of ``tests/test_simulation/test_odes.py`` and
``test_ensemble_layouts.py``, each held against the JAX function on the
same float64 inputs: saves within 1e-10 relative (the arithmetic is the
same, in the same order), equal statistics (accepted and rejected steps
included) and results, frozen-grid gradients within 1e-8 of ``jax.grad``'s.
The golden test uses the bound of ``tests/test_dynamics/test_golden.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as tree

from dynode_tpu import simulate as j_simulate
from dynode_tpu.config import SolverParams as JSolverParams
from dynode_tpu.models.multistrain import multistrain_config, multistrain_initial_state as j_ms_state
from dynode_tpu.models.multistrain import multistrain_ode as j_ms_ode
from dynode_tpu.models.multistrain import multistrain_odeparams
from dynode_tpu.simulation import AbstractODEParams as JAbstractODEParams
from dynode_tpu.simulation import build_saveat as j_build_saveat
from dynode_tpu.simulation import ensemble_rhs as j_ensemble_rhs
from dynode_tpu.simulation import ensemble_state as j_ensemble_state
from dynode_tpu.simulation import simulate_ensemble as j_simulate_ensemble
from dynode_tpu.simulation import tune_step_budget as j_tune
from dynode_tpu.struct import pytree_dataclass as j_dataclass
import dynode_tpu_torch
from dynode_tpu_torch import SolverParams, convert, simulate, simulate_ensemble
from dynode_tpu_torch.models import multistrain as tms
from dynode_tpu_torch.models import seip as tseip
from dynode_tpu_torch.simulation import (
    AbstractODEParams,
    build_saveat,
    ensemble_rhs,
    ensemble_state,
    tune_step_budget,
)
from dynode_tpu_torch.struct import pytree_dataclass

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden", "trajectories.npz")
RTOL, ATOL = 1e-10, 1e-14


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


Y0 = (np.array([0.99]), np.array([0.01]), np.array([0.0]))


def _jp(beta=0.3, gamma=0.1):
    return JP(beta=jnp.asarray(beta), gamma=jnp.asarray(gamma))


def _tp(beta=0.3, gamma=0.1):
    return TP(beta=torch.as_tensor(beta, dtype=torch.float64), gamma=torch.as_tensor(gamma, dtype=torch.float64))


def _y0(xp):
    return tuple(xp.asarray(x) for x in Y0) if xp is jnp else tuple(torch.as_tensor(x) for x in Y0)


def _same(got, want, rtol=RTOL, atol=ATOL):
    """Saves, save times, statistics and result of two solutions."""
    for g, w in zip(got.ys, want.ys):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(w)))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.ts.numpy(), np.asarray(want.ts), rtol=1e-15)
    for key, value in want.stats.items():
        np.testing.assert_array_equal(got.stats[key].numpy(), np.asarray(value), err_msg=key)
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(want.result))


#: (case, duration, SolverParams keywords, simulate keywords, expected save shape)
CONTRACTS = [
    ("int-duration", 100, {"step_budget": 256}, {}, (101, 1)),
    ("float-duration", 100.0, {"step_budget": 256}, {}, (101, 1)),
    ("save-step", 100, {"step_budget": 256}, {"save_step": 7}, (15, 1)),
    ("sub-save", 20, {"step_budget": 256}, {"sub_save_indices": (0, 2)}, (21, 1)),
    ("sub-save-step", 100, {"step_budget": 256}, {"sub_save_indices": (1,), "save_step": 7}, (15, 0)),
    ("constant", 20, {"constant_step_size": 0.25}, {}, (21, 1)),
    ("exhausted", 100, {"step_budget": 4}, {}, (101, 1)),
    ("kahan", 50, {"step_budget": 256, "compensated_summation": True}, {}, (51, 1)),
]


@pytest.mark.parametrize("case, days, sp, kw, shape", CONTRACTS, ids=[c[0] for c in CONTRACTS])
def test_simulate_contracts_match_jax(case, days, sp, kw, shape):
    """``test_odes.py``: shapes with an int and a float duration, the t = 0
    state kept, ``save_step``, ``sub_save_indices`` (empty ``(T, 0)``
    compartments), a constant step (80 accepted steps over 20 days at
    0.25), budget exhaustion (result 1, NaN tail) and compensation; each
    equal to JAX's solve (saves 1e-10, statistics exactly)."""
    got = simulate(t_sir, days, _y0(torch), _tp(), SolverParams(**sp), **kw)
    want = j_simulate(j_sir, days, _y0(jnp), _jp(), JSolverParams(**sp), **kw)
    _same(got, want)
    assert tuple(got.ys[0].shape) == shape
    if case == "int-duration":
        for saved, init in zip(got.ys, _y0(torch)):
            assert torch.equal(saved[0], init)
    if case == "save-step":
        np.testing.assert_allclose(got.ts[:2].numpy(), [0.0, 100.0 / 14], rtol=1e-15)
    if case in ("sub-save", "sub-save-step"):
        kept = kw["sub_save_indices"]
        assert [tuple(y.shape)[1] for y in got.ys] == [1 if i in kept else 0 for i in range(3)]
    if case == "constant":
        assert int(got.result) == 0 and int(got.stats["num_accepted"]) == 80
    if case == "exhausted":
        assert int(got.result) == 1 and bool(torch.isnan(got.ys[0][-1]).all())


def test_simulate_rejects_what_jax_rejects():
    """A numpy initial state raises ``TypeError``; parameters of another type
    than the RHS's hint, and a duration that is no number, raise
    ``AssertionError``."""
    sp = SolverParams(step_budget=256)
    with pytest.raises(TypeError):
        simulate(t_sir, 10, Y0, _tp(), sp)

    @pytree_dataclass
    class Other(AbstractODEParams):
        beta: torch.Tensor

    with pytest.raises(AssertionError, match="expects"):
        simulate(t_sir, 10, _y0(torch), Other(beta=torch.tensor(0.3)), sp)
    with pytest.raises(AssertionError, match="tf must be"):
        simulate(t_sir, "10", _y0(torch), _tp(), sp)


def test_discontinuity_points_land_exactly():
    """A growth-rate jump at t = 30 with a known solution: within 3e-4 of
    it (``test_odes.py``), and equal to JAX's solve (1e-10, statistics)."""
    sp = dict(step_budget=256, discontinuity_points=[30.0])

    def j_forced(t, state, q: JP):
        x, a, b = state
        return (jnp.where(t >= 30.0, 0.9, 0.3) * x, jnp.zeros_like(a), jnp.zeros_like(b))

    def t_forced(t, state, q: TP):
        x, a, b = state
        # torch.where of two Python numbers would give the default float32
        rate = torch.where(t >= 30.0, torch.full_like(t, 0.9), torch.full_like(t, 0.3))
        return (rate * x, torch.zeros_like(a), torch.zeros_like(b))

    y0 = (np.array([1.0]), np.array([0.0]), np.array([0.0]))
    got = simulate(t_forced, 60, tuple(map(torch.as_tensor, y0)), _tp(), SolverParams(**sp))
    want = j_simulate(j_forced, 60, tuple(map(jnp.asarray, y0)), _jp(), JSolverParams(**sp))
    _same(got, want)
    t = got.ts.numpy()
    exact = np.where(t < 30, np.exp(0.3 * t), np.exp(0.3 * 30) * np.exp(0.9 * (t - 30)))
    np.testing.assert_allclose(got.ys[0].numpy().squeeze(), exact, rtol=3e-4)


def test_build_saveat_and_tune_step_budget_match_jax():
    """The save grid (float64 numpy, ``step <= 0`` read as 1; within one
    float64 ulp of ``jnp.linspace``'s) and the budget ``tune_step_budget``
    picks from a pilot solve (equal to JAX's)."""
    for start, stop, step in ((0, 100, 7), (0, 100, 0), (0, 30, 1)):
        np.testing.assert_allclose(build_saveat(start, stop, step).ts,
                                   np.asarray(j_build_saveat(start, stop, step).ts), rtol=2.3e-16)
    tuned = tune_step_budget(t_sir, 100, _y0(torch), _tp(), SolverParams(step_budget=256))
    want = j_tune(j_sir, 100, _y0(jnp), _jp(), JSolverParams(step_budget=256))
    assert tuned.step_budget == want.step_budget and tuned.step_budget % 64 == 0
    assert int(simulate(t_sir, 100, _y0(torch), _tp(), tuned).result) == 0


@pytest.fixture(scope="module")
def multistrain():
    """The multi-strain model at (A, K) = (2, 3) in both packages, 8 members
    with R0 scales from 0.85 to 1.2 (``test_ensemble_layouts.py``)."""
    cfg = multistrain_config()
    jbase = multistrain_odeparams(cfg)
    jy0 = j_ms_state(cfg)
    scales = np.linspace(0.85, 1.2, 8)
    jbatch = jax.vmap(lambda s: jbase.replace(beta=jbase.beta * s))(jnp.asarray(scales))
    tbase = convert.params_from_numpy({k: np.asarray(getattr(jbase, k)) for k in
                                       ("beta", "sigma", "gamma", "omega", "contact_matrix")},
                                      dtype=torch.float64, device="cpu")
    ty0 = convert.state_from_numpy([np.asarray(x) for x in jy0], dtype=torch.float64, device="cpu")
    tbatch = tree.tree_map(lambda leaf: leaf.expand((8,) + leaf.shape), tbase)
    tbatch = tbatch.replace(beta=tbase.beta * torch.as_tensor(scales)[:, None])
    return jbase, jy0, jbatch, tbase, ty0, tbatch


@pytest.mark.parametrize("layout", ["batch_leading", "lane_major"])
@pytest.mark.parametrize("sp", [{"constant_step_size": 0.5}, {"step_budget": 512}], ids=["constant", "adaptive"])
def test_simulate_ensemble_layouts_match_jax(multistrain, layout, sp):
    """Both layouts, constant and adaptive, against JAX's (saves 1e-10,
    statistics and result exactly: a batch-leading member has its own dt
    chain, lane-major shares one), then the two layouts against each other:
    equal at a constant step (1e-12), within the adaptive tolerance (5e-4
    relative, 1e-5 absolute, as ``test_ensemble_layouts.py``) otherwise."""
    _, jy0, jbatch, _, ty0, tbatch = multistrain
    got = simulate_ensemble(tms.multistrain_ode, 30, ty0, tbatch, SolverParams(**sp), layout=layout)
    want = j_simulate_ensemble(j_ms_ode, 30, jy0, jbatch, JSolverParams(**sp), layout=layout)
    _same(got, want)
    other = simulate_ensemble(tms.multistrain_ode, 30, ty0, tbatch, SolverParams(**sp),
                              layout="lane_major" if layout == "batch_leading" else "batch_leading",
                              donate=True)
    lead, lane = (got, other) if layout == "batch_leading" else (other, got)
    for a, b in zip(lead.ys, lane.ys):
        np.testing.assert_allclose(np.moveaxis(b.numpy(), -1, 0), a.numpy(),
                                   **({"rtol": 1e-12} if "constant_step_size" in sp else
                                      {"rtol": 5e-4, "atol": 1e-5}))


def test_ensemble_rhs_param_axes_match_jax(multistrain):
    """``ensemble_rhs`` with ``param_axes`` a dataclass of axes that shares
    every field but ``beta`` (``None`` inside a registered dataclass), and
    with ``None`` for all: equal to JAX's at 1e-12."""
    jbase, jy0, jbatch, tbase, ty0, tbatch = multistrain
    jy0b, ty0b = j_ensemble_state(jy0, 8), ensemble_state(ty0, 8)
    for a, b in zip(ty0b, jy0b):
        assert tuple(a.shape) == b.shape and torch.equal(a[..., 3], a[..., 0])
    t_axes = tms.MultiStrainParams(beta=0, sigma=None, gamma=None, omega=None, contact_matrix=None)
    j_axes = jbase.replace(beta=0, sigma=None, gamma=None, omega=None, contact_matrix=None)
    t_mixed = tbase.replace(beta=tbatch.beta)
    j_mixed = jbase.replace(beta=jbatch.beta)
    cases = (((t_axes, t_mixed), (j_axes, j_mixed)), ((None, tbase), (None, jbase)),
             ((0, tbatch), (0, jbatch)))
    for (t_ax, tp), (j_ax, jp) in cases:
        got = ensemble_rhs(tms.multistrain_ode, param_axes=t_ax)(0.0, ty0b, tp)
        want = j_ensemble_rhs(j_ms_ode, param_axes=j_ax)(0.0, jy0b, jp)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-15)


def test_simulate_ensemble_arguments(multistrain):
    """An unknown layout raises ``ValueError``, a mesh that is not the
    port's ``Mesh`` ``TypeError`` (the split itself is held by
    ``test_torch_parallel.py``), a numpy state ``TypeError``; the params
    type check survives ``ensemble_rhs``."""
    _, _, _, _, ty0, tbatch = multistrain
    sp = SolverParams(constant_step_size=0.5)
    with pytest.raises(ValueError, match="unknown ensemble layout"):
        simulate_ensemble(tms.multistrain_ode, 5, ty0, tbatch, sp, layout="column_major")
    with pytest.raises(TypeError, match="Mesh"):
        simulate_ensemble(tms.multistrain_ode, 5, ty0, tbatch, sp, mesh=object())
    with pytest.raises(TypeError):
        simulate_ensemble(tms.multistrain_ode, 5, [y.numpy() for y in ty0], tbatch, sp)

    class WrongParams:
        pass

    with pytest.raises(AssertionError, match="expects"):
        simulate(ensemble_rhs(tms.multistrain_ode), 5, ensemble_state(ty0, 8), WrongParams(), sp)


#: (case, SolverParams keywords): the three routes of the engine
GRADS = [("constant", {"constant_step_size": 0.5}), ("adaptive-grid", {"step_budget": 256}),
         ("adaptive-buffered", {"step_budget": 40})]


@pytest.mark.parametrize("case, sp", GRADS, ids=[g[0] for g in GRADS])
def test_frozen_grid_gradient_matches_jax_grad(case, sp):
    """d(final R)/d(beta, gamma) by ``backward()`` through each route,
    within 1e-8 relative of ``jax.grad`` (float64); the chunks and
    intervals run under ``torch.utils.checkpoint``."""
    def j_loss(beta, gamma):
        return jnp.sum(j_simulate(j_sir, 40, _y0(jnp), _jp(beta, gamma), JSolverParams(**sp)).ys[2][-1])

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(0.4), jnp.asarray(0.1))
    beta = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    gamma = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    sol = simulate(t_sir, 40, _y0(torch), TP(beta=beta, gamma=gamma), SolverParams(**sp))
    sol.ys[2][-1].sum().backward()
    np.testing.assert_allclose([float(beta.grad), float(gamma.grad)], [float(w) for w in want], rtol=1e-8)


def test_lane_major_fit_gradient_matches_jax_grad(multistrain):
    """The fit's forward on 4 members: lane-major, 20 days at dt = 0.5, a
    Poisson log-likelihood of the daily incidence; the gradient with
    respect to the (4, 3) R0 scales within 1e-8 of ``jax.grad``'s."""
    jbase, jy0, _, tbase, ty0, _ = multistrain
    scales = np.random.default_rng(3).uniform(0.8, 1.2, (4, 3))
    obs = np.random.default_rng(4).poisson(2.0, (20, 2, 3, 4)).astype(np.float64)
    sp = dict(constant_step_size=0.5)

    def j_loglik(s):
        p = jax.tree_util.tree_map(lambda leaf: jnp.broadcast_to(leaf, (4,) + leaf.shape), jbase)
        p = p.replace(beta=jbase.beta[None, :] * s)
        c = j_simulate_ensemble(j_ms_ode, 20, jy0, p, JSolverParams(**sp), layout="lane_major").ys[4]
        rate = jnp.maximum(jnp.diff(c, axis=0), 1e-6)
        return jnp.sum(obs * jnp.log(rate) - rate)

    want = jax.grad(j_loglik)(jnp.asarray(scales))
    s = torch.tensor(scales, requires_grad=True)
    p = tree.tree_map(lambda leaf: leaf.expand((4,) + leaf.shape), tbase)
    c = simulate_ensemble(tms.multistrain_ode, 20, ty0, p.replace(beta=tbase.beta[None, :] * s),
                          SolverParams(**sp), layout="lane_major").ys[4]
    rate = torch.clamp(torch.diff(c, dim=0), min=1e-6)
    (torch.as_tensor(obs) * torch.log(rate) - rate).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), rtol=1e-8)


def test_multistrain_matches_golden():
    """``simulate(multistrain_ode, 300, ...)`` adaptive in float64 against
    ``tests/golden/trajectories.npz``, at ``test_golden.py``'s bound (rtol
    1e-5, atol 1e-6)."""
    p = tms.multistrain_default_params(dtype=torch.float64, device="cpu")
    y0 = tms.multistrain_initial_state(dtype=torch.float64, device="cpu")
    sol = dynode_tpu_torch.simulate(tms.multistrain_ode, 300, y0, p,
                                    dynode_tpu_torch.SolverParams(step_budget=512))
    assert int(sol.result) == 0
    np.testing.assert_allclose(sol.ys[4].numpy(), np.load(GOLDEN)["multistrain_c"], rtol=1e-5, atol=1e-6)


def test_solver_params_defaults_match_jax():
    """Every field's default, and ``model_copy(update=...)``."""
    got, want = SolverParams(), JSolverParams()
    for name in JSolverParams.model_fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "solver_method":
            assert type(g).__name__ == type(w).__name__ == "Tsit5"
        else:  # pydantic keeps the int default 0 of constant_step_size unvalidated
            assert g == w, name
    copy = got.model_copy(update={"step_budget": 128})
    assert copy.step_budget == 128 and got.step_budget is None and copy.solver_method == got.solver_method


#: values that pydantic takes (and coerces) or refuses, per field
VALUES = {
    "ode_solver_rel_tolerance": [1e-5, 1, 0, -1, True, "1e-5", "x", float("nan"), float("inf"),
                                 np.float32(1e-3), None],
    "ode_solver_abs_tolerance": [1e-6, 0.0, -1e-6],
    "max_steps": [10, 0, -3, 2.0, 2.5, True, "7", 1e6, None, np.int64(5)],
    "constant_step_size": [0, 0.5, -0.1, 1, False, None, float("nan")],
    "step_budget": [None, 1, 0, 4.0, 4.5, True],
    "steps_per_save": [None, 3, 0, -2],
    "compensated_summation": [True, 0, 1, "yes", "off", 2, None],
    "discontinuity_points": [[1, 2.5], (3,), [], [True], "x", None, np.array([1.0, 2.0])],
}
CHECKS = [(name, v) for name, values in VALUES.items() for v in values]


@pytest.mark.parametrize("name, value", CHECKS, ids=[f"{n}={v!r}" for n, v in CHECKS])
def test_solver_params_checks_match_pydantic(name, value):
    """Each value: refused with ``ValueError`` by both, or taken by both
    with the same coerced value and type."""
    try:
        want = getattr(JSolverParams(**{name: value}), name)
    except ValueError:
        with pytest.raises(ValueError):
            SolverParams(**{name: value})
        return
    got = getattr(SolverParams(**{name: value}), name)
    assert got == want and type(got) is type(want)


def test_solver_params_takes_solver_instances_only():
    assert isinstance(SolverParams(solver_method=dynode_tpu_torch.ode.Bosh3()).solver_method,
                      dynode_tpu_torch.ode.Bosh3)
    for bad in (dynode_tpu_torch.ode.Tsit5, None, 3):
        with pytest.raises(ValueError):
            SolverParams(solver_method=bad)


def test_params_dataclasses_are_pytrees():
    """``MultiStrainParams`` flattens to its five tensors and maps under
    ``torch.func.vmap``; ``SEIPParams`` keeps ``seasonal_vaccination`` in
    the tree's context; both keep ``replace``."""
    p = tms.multistrain_default_params(device="cpu")
    leaves, spec = tree.tree_flatten(p)
    assert len(leaves) == 5 and tree.tree_unflatten(leaves, spec).beta is p.beta
    batch = p.replace(beta=p.beta * torch.linspace(0.5, 1.5, 4)[:, None])
    out = torch.func.vmap(lambda q: q.beta.sum() * q.gamma, in_dims=(
        tms.MultiStrainParams(beta=0, sigma=None, gamma=None, omega=None, contact_matrix=None),))(batch)
    assert tuple(out.shape) == (4, 3)
    sp = tseip.seip_default_params(True, device="cpu")
    leaves, spec = tree.tree_flatten(sp)
    assert all(isinstance(x, torch.Tensor) for x in leaves)
    back = tree.tree_unflatten(leaves, spec)
    assert back.seasonal_vaccination is True and back.replace(pop=back.pop * 2).seasonal_vaccination
