"""``simulate()``: the forward-integration entry point of the port.

Port of ``dynode_tpu/simulation/odes.py``: the same checks of the initial
state, the parameters' type and the duration; a constant or a PID
controller from ``SolverParams``, with discontinuities to land on; a daily
(or ``save_step``-strided) save grid that includes t = 0 and t = tf; and
``sub_save_indices``, which replaces the compartments not kept by empty
``(T, 0)`` tensors. The backend is
:func:`~dynode_tpu_torch.ode.integrate.diffeqsolve`, on the device of the
initial state (the CPU in the tests, the card in ``chip_smoke.py``).
"""

from __future__ import annotations

from functools import lru_cache
from inspect import getfullargspec
from typing import Optional, Tuple, get_type_hints

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from ..config import SolverParams
from ..ode.controllers import ClipStepSizeController, ConstantStepSize, PIDController
from ..ode.integrate import diffeqsolve
from ..ode.saveat import SaveAt, SubSaveAt
from ..ode.solution import Solution
from ..struct import pytree_dataclass
from ..typing import CompartmentState, ODE_Eqns


@pytree_dataclass
class AbstractODEParams:
    """Base of the RHS parameter dataclasses. Models subclass it with
    ``@pytree_dataclass``; index namespaces go in ``static_fieldnames``."""


def _check_state(initial_state) -> None:
    if any(not isinstance(c, torch.Tensor) for c in initial_state):
        raise TypeError("Please pass torch.Tensor instead of np.array to ODEs")


def simulate(
    ode: ODE_Eqns,
    duration_days: int,
    initial_state: CompartmentState,
    ode_parameters: AbstractODEParams,
    solver_parameters: SolverParams,
    sub_save_indices: Optional[Tuple[int, ...]] = None,
    save_step: int = 1,
) -> Solution:
    """Solve ``ode`` for ``duration_days`` and return the daily saved states.

    Parameters
    ----------
    ode : callable(t, state, params) -> gradients
        The RHS, called with tensors.
    duration_days : int | float
        Final integration time (t0 is always 0).
    initial_state : CompartmentState
        Tuple of tensors, one per compartment, all on one device.
    ode_parameters
        Parameter dataclass; its type must be the RHS's third-argument type
        hint, where the RHS has one.
    solver_parameters : SolverParams
        Solver, tolerances, step policy, discontinuities.
    sub_save_indices : tuple[int, ...], optional
        Compartments to keep; the others come back as ``(T, 0)`` tensors.
    save_step : int
        Save every ``save_step`` days (1 = daily).

    Returns
    -------
    Solution
        ``sol.ys``: tuple of ``(duration // save_step + 1, *shape)`` tensors
        including t = 0 and t = duration; ``sol.ts``: the save times.
    """
    return _simulate(ode, duration_days, initial_state, ode_parameters, solver_parameters,
                     sub_save_indices, save_step, batch=None)


def _simulate(ode, duration_days, initial_state, ode_parameters, solver_parameters,
              sub_save_indices, save_step, batch: Optional[int]) -> Solution:
    """:func:`simulate`; with ``batch``, of a batch-leading ensemble whose
    parameters carry a leading member axis (the shared initial state is
    broadcast to it)."""
    _check_state(initial_state)
    # the params object must be the type the RHS was written for
    hints = get_type_hints(ode)
    params_arg = getfullargspec(ode).args[2]
    expected = hints.get(params_arg)
    if expected is not None:
        assert type(ode_parameters) is expected, (
            f"passed {type(ode_parameters)} ode parameters, but your ODE "
            f"model expects {expected}"
        )
    assert isinstance(duration_days, (int, float)), "tf must be of type int or float"

    t0 = 0.0
    if solver_parameters.constant_step_size > 0.0:
        controller = ConstantStepSize()
        dt0 = solver_parameters.constant_step_size
    else:
        jumps = solver_parameters.discontinuity_points or None
        controller = ClipStepSizeController(
            PIDController(
                rtol=solver_parameters.ode_solver_rel_tolerance,
                atol=solver_parameters.ode_solver_abs_tolerance,
            ),
            jump_ts=jumps,
        )
        dt0 = None

    y0 = tuple(initial_state)
    if batch is not None:
        y0 = tuple(c.expand((batch,) + c.shape) for c in y0)
    return diffeqsolve(
        ode,
        solver_parameters.solver_method,
        t0,
        duration_days,
        dt0,
        y0,
        args=ode_parameters,
        stepsize_controller=controller,
        saveat=build_saveat(t0, duration_days, save_step, sub_save_indices),
        max_steps=int(solver_parameters.max_steps),
        step_budget=solver_parameters.step_budget,
        steps_per_save=solver_parameters.steps_per_save,
        compensated_summation=solver_parameters.compensated_summation,
        batched=batch is not None,
    )


def build_saveat(
    start: float,
    stop: int,
    step: int = 1,
    sub_save_indices: Optional[Tuple[int, ...]] = None,
) -> SaveAt:
    """Daily (or strided) save grid, optionally masking compartments.

    ``linspace(start, stop, stop // step + 1)`` in float64 numpy (the
    engine casts it to the state's dtype; off an integer grid a time may
    differ from ``jnp.linspace``'s by one float64 ulp); with
    ``sub_save_indices``, the compartments not kept become empty tensors,
    so ``sol.ys`` keeps its tuple arity.
    """
    if step <= 0:
        step = 1
    save_times = np.linspace(start, stop, int(stop // step) + 1)
    if sub_save_indices is None:
        return SaveAt(ts=save_times)
    mask = _sub_save_mask(tuple(int(i) for i in sub_save_indices))
    return SaveAt(subs=SubSaveAt(ts=save_times, fn=mask))


@lru_cache(maxsize=None)
def _sub_save_mask(sub_save_indices: Tuple[int, ...]):
    """The mask function of ``sub_save_indices`` (one per index tuple)."""

    def mask(t, y, args):
        return tuple(
            y[i] if i in sub_save_indices else torch.zeros((0,), dtype=y[i].dtype, device=y[i].device)
            for i in range(len(y))
        )

    return mask


def ensemble_state(initial_state: CompartmentState, batch: int) -> CompartmentState:
    """Broadcast one initial state to the lane-major layout: each
    compartment gains a trailing ensemble axis, ``(*dims, batch)`` (views)."""
    return tuple(a[..., None].expand(*a.shape, batch) for a in initial_state)


def ensemble_rhs(ode: ODE_Eqns, param_axes=0) -> ODE_Eqns:
    """Rewrite a single-trajectory RHS for the lane-major (batch-last) layout.

    ``ensemble_rhs(ode)(t, state_b, params_b)``: every compartment of
    ``state_b`` carries a trailing ensemble axis (:func:`ensemble_state`)
    and every tensor of ``params_b`` the axis given by ``param_axes``
    (default 0, :func:`simulate_ensemble`'s convention; a tree of axes
    shaped like the parameters mixes shared, ``None``, and per-member
    fields). The parameters are mapped as their flat tuple of leaves, so
    a ``None`` inside a dataclass of axes lines up with its field.

    Under one :func:`simulate` call the ensemble shares one adaptive dt
    chain (the error norm spans the batch); with ``constant_step_size``
    the result is member for member the batch-leading layout's.
    """
    if param_axes == 0:
        return _ensemble_rhs_cached(ode)
    return _build_ensemble_rhs(ode, param_axes)


@lru_cache(maxsize=128)
def _ensemble_rhs_cached(ode):
    return _build_ensemble_rhs(ode, 0)


def _build_ensemble_rhs(ode, param_axes):
    def rhs(t, state, params):
        leaves, spec = pytree.tree_flatten(params)
        axes = pytree._broadcast_to_and_flatten(param_axes, spec)
        if axes is None:
            raise ValueError(f"param_axes {param_axes!r} do not match the parameters' structure")
        axes = tuple(a if isinstance(x, torch.Tensor) else None for a, x in zip(axes, leaves))

        def flat(y, *flat_params):
            return ode(t, y, pytree.tree_unflatten(list(flat_params), spec))

        return vmap(flat, in_dims=(-1,) + axes, out_dims=-1)(tuple(state), *leaves)

    # keep the params type hint, so that simulate()'s check still applies
    try:
        hints = get_type_hints(ode)
        spec = getfullargspec(ode)
    except (NameError, TypeError):  # unresolvable hints, or not a plain function
        return rhs
    if len(spec.args) >= 3 and spec.args[2] in hints:
        rhs.__annotations__["params"] = hints[spec.args[2]]
    return rhs


def simulate_ensemble(
    ode: ODE_Eqns,
    duration_days: int,
    initial_state: CompartmentState,
    ode_parameters_batch: AbstractODEParams,
    solver_parameters: SolverParams,
    sub_save_indices: Optional[Tuple[int, ...]] = None,
    save_step: int = 1,
    mesh=None,
    axis_name: str = "ensemble",
    layout: str = "batch_leading",
    donate: bool = False,
) -> Solution:
    """:func:`simulate` over a batch of parameters.

    ``ode_parameters_batch`` carries a leading member axis on every tensor
    (static fields stay unbatched); the solve runs on their device.
    ``layout`` picks the data layout:

    - ``"batch_leading"`` (default): every member has its own adaptive dt
      chain, as JAX's ``vmap(simulate)``; ``ys``, ``ts``, ``stats`` and
      ``result`` gain a leading member axis. An adaptive solve takes the
      buffered engine here, as under JAX's jitted ``vmap``.
    - ``"lane_major"``: the member axis goes last on the state
      (:func:`ensemble_rhs`); one shared dt chain, ``ys`` gain a trailing
      member axis and ``result`` and ``stats`` are ensemble-wide scalars.

    ``mesh`` (a :class:`~dynode_tpu_torch.parallel.Mesh`) splits the
    members over its axis ``axis_name`` (a name or a tuple of names): each
    device solves its shard, and the whole solution comes back on the
    mesh's first device, the shards concatenated along the member axis in
    mesh order (on every process, where the mesh spans several:
    :func:`~dynode_tpu_torch.parallel.mesh.gather_shards`). The members
    are independent in the batch-leading layout, and a constant step keeps
    a lane-major ensemble's members apart too, so both equal the unsplit
    solve bit for bit. An adaptive lane-major ensemble shares one dt chain
    over every member, as JAX's GSPMD program keeps it: there one solve
    runs on the mesh's first device, and only its RHS is split, each
    evaluation sending the members' slices to their devices and gathering
    the derivatives along the member axis (:func:`_sharded_lane_rhs`), so
    the error norm, the accept/reject decision and dt are the unsplit
    solve's. The member count must divide over the axis (``ValueError``
    otherwise, before any solve).

    ``donate`` is accepted for the JAX call form and does nothing: the
    solve makes no copy of the parameters that donation would save.
    """
    _check_state(initial_state)
    if layout not in ("batch_leading", "lane_major"):
        raise ValueError(f"unknown ensemble layout: {layout!r}")
    batch = next(x for x in pytree.tree_leaves(ode_parameters_batch)
                 if isinstance(x, torch.Tensor)).shape[0]
    if mesh is not None:
        return _split_ensemble(ode, duration_days, initial_state, ode_parameters_batch, solver_parameters,
                               sub_save_indices, save_step, mesh, axis_name, layout, batch)
    if layout == "lane_major":
        return simulate(ensemble_rhs(ode), duration_days, ensemble_state(initial_state, batch),
                        ode_parameters_batch, solver_parameters,
                        sub_save_indices=sub_save_indices, save_step=save_step)
    return _simulate(ode, duration_days, initial_state, ode_parameters_batch, solver_parameters,
                     sub_save_indices, save_step, batch=batch)


def _split_ensemble(ode, duration_days, initial_state, params, solver_parameters, sub_save_indices,
                    save_step, mesh, axis_name, layout, batch) -> Solution:
    """:func:`simulate_ensemble` with its members split over a mesh axis."""
    from ..parallel.mesh import gather_shards, run_shards, shard_plan, split

    plan = shard_plan(mesh, axis_name, batch, "ensemble")
    if layout == "lane_major" and not solver_parameters.constant_step_size > 0.0:
        # one dt chain over every member: one solve on the first device,
        # its RHS split over the mesh
        y0 = tuple(c.to(plan.home) for c in initial_state)
        return simulate(_sharded_lane_rhs(ode, plan), duration_days, ensemble_state(y0, batch), params,
                        solver_parameters, sub_save_indices=sub_save_indices, save_step=save_step)

    def solve(s):
        dev = plan.place(s)
        p = pytree.tree_map(lambda x: split(x, plan, s) if isinstance(x, torch.Tensor) else x, params)
        y0 = tuple(c.to(dev, non_blocking=True) for c in initial_state)
        return simulate_ensemble(ode, duration_days, y0, p, solver_parameters, sub_save_indices, save_step,
                                 layout=layout)

    outs = run_shards(plan, solve)
    if layout == "batch_leading":
        return gather_shards(plan, outs, dim=0)
    # lane-major at a constant step: the member axis trails the saves; the
    # grid, the step counts and the result are every shard's
    ys = gather_shards(plan, {s: o.ys for s, o in outs.items()}, dim=-1)
    first = outs[plan.local[0]]
    return pytree.tree_map(lambda x: x.to(plan.home), first).replace(ys=ys)


def _sharded_lane_rhs(ode: ODE_Eqns, plan) -> ODE_Eqns:
    """The lane-major RHS of ``ode`` (:func:`ensemble_rhs`) evaluated over
    the shards of ``plan``: each call cuts the state along its trailing
    member axis and the parameters along their leading one, evaluates each
    shard on its device (:func:`~dynode_tpu_torch.parallel.mesh.run_shards`)
    and returns the derivatives concatenated along the member axis on
    ``plan.home``."""
    from ..parallel.mesh import gather_shards, run_shards, split

    lane = ensemble_rhs(ode)

    def rhs(t, state, params):
        def shard(s):
            y = tuple(split(c, plan, s, dim=-1) for c in state)
            p = pytree.tree_map(lambda x: split(x, plan, s) if isinstance(x, torch.Tensor) else x, params)
            ts = t.to(plan.place(s), non_blocking=True) if isinstance(t, torch.Tensor) else t
            return tuple(lane(ts, y, p))

        return gather_shards(plan, run_shards(plan, shard), dim=-1)

    rhs.__annotations__.update(getattr(lane, "__annotations__", {}))  # simulate()'s params check
    return rhs


def tune_step_budget(
    ode: ODE_Eqns,
    duration_days: int,
    initial_state: CompartmentState,
    ode_parameters: AbstractODEParams,
    solver_parameters: SolverParams,
    *,
    headroom: float = 1.5,
    probe_budget: int = 4096,
) -> SolverParams:
    """Pilot-solve to measure the real step count, then shrink ``step_budget``.

    Returns a copy of ``solver_parameters`` with ``step_budget`` set to
    ``headroom`` times the measured (accepted + rejected) step count,
    rounded up to a multiple of 64.
    """
    probe = solver_parameters.model_copy(update={"step_budget": probe_budget})
    sol = simulate(ode, duration_days, initial_state, ode_parameters, probe)
    steps = int(sol.stats["num_steps"].max())
    budget = max(64, int(-(-int(steps * headroom) // 64) * 64))
    return solver_parameters.model_copy(update={"step_budget": budget})


__all__ = [
    "AbstractODEParams",
    "simulate",
    "simulate_ensemble",
    "ensemble_rhs",
    "ensemble_state",
    "build_saveat",
    "tune_step_budget",
]
