"""The ODE engine of the port: :func:`diffeqsolve` and its three engines.

Port of ``dynode_tpu/ode/integrate.py``. The JAX engine compiles a solve
into one XLA program (a ``lax.scan`` with ``lax.cond`` skips); here each
engine is a Python loop of tensor operations on the device of the state:

- :func:`_solve_constant_direct`: a constant ``dt`` that tiles a uniform
  save grid; saves straight from the loop.
- :func:`_solve_adaptive_grid`: adaptive PID steps on a uniform grid that
  spans ``[t0, t1]``; the steps land on every save point and are bounded
  per save interval.
- :func:`_solve`: everything else. Steps are buffered in chunks; the dense
  output re-steps from the start of each save time's segment.

Semantics kept from JAX:

- **Frozen-grid gradients.** The step actually taken and the controller's
  factor are detached (``stop_gradient`` in JAX), so autograd gives the
  gradient of the discrete solution on the accepted step sequence. Each
  chunk of :func:`_solve` and each save interval of the other two engines
  runs under ``torch.utils.checkpoint`` where JAX checkpoints it, so the
  backward pass holds O(sqrt(budget)) states.
- **A finished step is a no-op.** A solve (or a member of a batch-leading
  ensemble) that is done keeps its carry, member by member, through
  ``torch.where``, as JAX's ``lax.cond`` does under ``vmap``. On the card
  the host never asks inside a chunk or a save interval whether the solve
  is done; ``_solve`` asks once per chunk and stops when every member is,
  which gives the same bits as running on. CPU tensors have no device to
  keep busy, so there the engines also ask after every step and skip the
  no-op steps, as ``lax.cond`` does outside ``vmap``.
- **Batch-leading ensembles** (``batched=True``): ``y0`` and every tensor of
  ``args`` carry a leading member axis, and ``t``, ``dt``, the counts and
  the done mask carry it too: each member has its own dt chain, as under
  JAX's ``vmap(diffeqsolve)``. The RHS and the ``SubSaveAt`` function are
  mapped over the members with ``torch.func.vmap``. ``ys``, ``ts``,
  ``stats`` and ``result`` gain a leading member axis.
- **Kept solves** (JAX's jit cache on its engines). On a card, a call
  without gradients takes the kept-graph route (:func:`_kept_solve`): the
  first call of a key runs eagerly and records the key; the second copies
  its tensors into static buffers, captures the engine call on them into
  a CUDA graph and replays it; every later call copies its tensors in and
  replays. The key is what JAX's jit keys on plus what the port bakes:
  the engine and its static sizes, the RHS and ``SubSaveAt`` functions by
  identity, the solver and controller by class and fields, the host
  values of ``t0``, ``t1``, ``dt0`` and the save grid, the arguments' tree
  structure and non-tensor leaves by value, each tensor's shape, strides,
  dtype and device, and the default dtype; never a tensor's values, which
  are copied in as JAX traces arrays. Tensors that the RHS closes over are
  read by the graph at their addresses, as JAX bakes closed-over arrays
  into its program: change them by making a new function, not in place.
  The grid and constant-direct engines are one graph each; the buffered
  engine is three (first carry, one chunk, dense output), its chunk
  replayed from the host until every member is done, where the eager
  loop stops too. A replay equals the eager call bit for bit. Gradients
  (of the arguments, or, by a probe of the RHS at ``t0``, of a tensor it
  closes over), ``torch.func`` transforms, a call inside another capture,
  and times or grids on the card stay eager. A key seen once holds its
  functions weakly: a function made for one call (the adaptive
  lane-major split over a mesh makes one) is forgotten with it, never
  captured. A capture that meets a host sync raises ``GraphCaptureError``
  naming the line; it never runs eagerly instead.
  :func:`clear_solve_cache` drops the kept solves.
"""

from __future__ import annotations

import functools
import math
import types
import weakref
from collections import Counter, OrderedDict
from typing import Any, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import vmap
from torch.utils.checkpoint import checkpoint

from .. import _device, _graphs
from .controllers import (
    AbstractStepSizeController,
    ConstantStepSize,
    PIDController,
    rms_error_norm,
)
from .saveat import SaveAt
from .solution import RESULT_MAX_STEPS, RESULT_SUCCESS, Solution
from .solvers import AbstractSolver, ODETerm, _bcast

#: cap on the step budget when the caller passes a huge ``max_steps`` (an
#: error cap, not an expected step count)
DEFAULT_STEP_BUDGET = 4096


def _select(pred, a, b):
    """Leaf by leaf ``where(pred, a, b)`` over two trees of one structure;
    ``pred`` has the batch shape that leads every leaf."""
    return pytree.tree_map(lambda x, y: torch.where(_bcast(pred, x), x, y), a, b)


def _advance(carry, done, step, host_skips: bool):
    """``step(carry)`` where ``done`` is False, ``carry`` where it is True.

    With ``host_skips`` (CPU tensors) the host reads ``done`` and skips the
    step, or the selection, where it can; the result is the same.
    """
    if host_skips:
        if bool(done.all()):
            return carry
        if not bool(done.any()):
            return step(carry)
    return _select(done, carry, step(carry))


def _under_functorch() -> bool:
    """Whether a ``torch.func`` transform (``vmap``, ``grad``) is active."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def _host_skips(device: torch.device) -> bool:
    """Whether the host reads the done mask after every step: on CPU tensors
    only, which keep no device busy, and never under ``torch.func`` (whose
    batched tensors the host cannot read)."""
    return device.type == "cpu" and not _under_functorch()


def _kahan_update(y, comp, inc):
    """Compensated ``y += inc`` with the carried per-leaf compensation
    ``comp``: the increment takes the compensation first, then the bits
    ``y + inc`` dropped are recovered (``SolverParams.compensated_summation``)."""
    inc_c = tuple(i + c for i, c in zip(inc, comp))
    y_new = tuple(a + b for a, b in zip(y, inc_c))
    comp_new = tuple((a - an) + b for a, an, b in zip(y, y_new, inc_c))
    return y_new, comp_new


def _unwrap_pid(controller) -> Optional[PIDController]:
    inner = controller
    while hasattr(inner, "controller"):
        inner = inner.controller
    return inner if isinstance(inner, PIDController) else None


def _static_float(x):
    """``x`` as a host float, or None where its value is not on the host: a
    tensor inside a ``torch.func`` transform, or one on a device, whose
    read would make the host wait for it (a CUDA-graph capture forbids
    that). Such a value is dynamic, as a traced one is under JAX's jit."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return None
    try:
        return float(x)
    except (TypeError, ValueError, RuntimeError):
        return None


def _uniform_grid_info(save_ts, t0, t1):
    """``n_intervals`` when ``save_ts`` (host values) is a uniform grid
    spanning ``[t0, t1]``, else None."""
    st0, st1 = _static_float(t0), _static_float(t1)
    if st0 is None or st1 is None:
        return None
    ts = np.asarray(save_ts, dtype=np.float64)
    if ts.ndim != 1 or ts.shape[0] < 2:
        return None
    n_int = ts.shape[0] - 1
    span = st1 - st0
    if span <= 0:
        return None
    expected = st0 + span * np.arange(ts.shape[0]) / n_int
    tol = 1e-6 * max(abs(span), 1.0)
    if (
        abs(ts[0] - st0) > tol
        or abs(ts[-1] - st1) > tol
        or np.max(np.abs(ts - expected)) > tol
    ):
        return None
    return n_int


def _member_map(fn, args):
    """``fn(t, y, args)`` mapped over the leading member axis of every leaf
    of ``y`` and every tensor of ``args``; ``t`` is mapped too when it is
    not 0-d.

    ``args`` goes in as its flat tuple of leaves and is rebuilt inside, so
    that any pytree of parameters maps, whatever its ``None`` fields. The
    state's leaves go in side by side with them, every input a leaf of the
    call, which keeps ``vmap``'s handling of its inputs short.
    """
    leaves, spec = pytree.tree_flatten(args)
    dims = tuple(0 if isinstance(x, torch.Tensor) else None for x in leaves)
    mapped = {}

    def mapped_for(t_dim, n_y):
        if (t_dim, n_y) not in mapped:
            def flat(t, *ys_and_args):
                ys, flat_args = ys_and_args[:n_y], ys_and_args[n_y:]
                return fn(t, ys, pytree.tree_unflatten(list(flat_args), spec))

            mapped[t_dim, n_y] = vmap(flat, in_dims=(t_dim,) + (0,) * n_y + dims)
        return mapped[t_dim, n_y]

    def call(t, y, a):
        a_leaves = leaves if a is args else pytree.tree_leaves(a)
        y = tuple(y)
        return mapped_for(0 if torch.is_tensor(t) and t.dim() > 0 else None, len(y))(t, *y, *a_leaves)

    return call


def _checkpointed(fn, enabled: bool):
    """``fn`` under ``torch.utils.checkpoint`` when ``enabled``.

    The engine draws no random numbers, so the checkpoint keeps no RNG
    state: reading a CUDA generator's state is a host call that CUDA-graph
    capture forbids. ``torch.func`` transforms do not support the saved
    tensor hooks of a checkpoint; under them the solve keeps every state.
    """
    if not enabled or _under_functorch():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)


def _jump_grid(controller, like: torch.Tensor):
    """The controller's jump times and a closing ``inf`` on ``like``'s
    device, in its dtype; built on the host (:func:`_device.from_host`)."""
    jump_ts = getattr(controller, "jump_ts", None)
    if jump_ts is None or len(jump_ts) == 0:
        return None
    return _device.from_host(tuple(jump_ts) + (float("inf"),), like.device, like.dtype)


def _init_dt(controller, term, solver, t0, t1, y0, f0, args, dt0):
    dt = controller.init_dt(term, solver, t0, t1, y0, f0, args, dt0)
    return _device.scalar(dt, t0.dtype, t0.device).detach().expand(t0.shape)


def _stack(emits, dim: int):
    """A list of per-save tuples -> a tuple of tensors stacked on ``dim``."""
    return tuple(torch.stack(leaves, dim=dim) for leaves in zip(*emits))


def _stats(na, nr, budget: int):
    return {
        "num_accepted": na,
        "num_rejected": nr,
        "num_steps": na + nr,
        "step_budget": torch.full_like(na, budget),
    }


def _buffered(
    term: ODETerm,
    solver: AbstractSolver,
    controller: AbstractStepSizeController,
    subs,
    budget: int,
    chunk: int,
    compensated: bool,
    t0,
    t1,
    dt0,
    y0,
    args,
    save_ts,
    bshape: tuple,
    grad: bool,
):
    """The parts of the buffered two-phase engine (JAX ``_solve``):
    ``(start, run_chunk, done, finish)``.

    ``t0`` and ``t1`` are 0-d, ``bshape`` the batch shape. ``start()``
    makes the first carry; ``run_chunk(carry)`` takes ``chunk`` steps,
    each emitting its segment ``(t_start, t_end before a hop, y_end)``;
    ``done(carry)`` tells, on the device, whether every member is done;
    ``finish(carry, t_starts, t_ends, y_ends)`` takes the ``(budget, ...)``
    segments, locates each save time with ``searchsorted`` and evaluates
    it by one fresh RK step from the start of its segment, all save times
    at once. :func:`_solve` drives them eagerly, :func:`_kept_buffered` as
    graphs.
    """
    nb = len(bshape)
    n_chunks = budget // chunk
    adaptive = controller.adaptive
    host_skips = _host_skips(t0.device)
    t0, t1 = t0.expand(bshape), t1.expand(bshape)
    pid = _unwrap_pid(controller)
    jump_grid = _jump_grid(controller, t0)
    clamp = getattr(controller, "clamp_dt", None)
    t1_eps = 1e-8 * torch.clamp((t1 - t0).abs(), min=1.0)
    t_done = t1 - t1_eps

    def do_step(ext):
        t, t_comp, y, yc, f, dt_next, na, nr, _ = ext
        dt_allowed = t1 - t
        if jump_grid is not None:
            nj = jump_grid[torch.searchsorted(jump_grid[:-1], t, right=True)]
            # step to just below the jump so that no RK stage evaluates on
            # the far side of the discontinuity
            dt_to_jump = torch.nextafter(nj, torch.full_like(nj, -math.inf)) - t
            dt_allowed = torch.minimum(dt_allowed, dt_to_jump)
        # the step sequence is frozen for autograd
        dt_used = torch.minimum(dt_next, dt_allowed).detach()

        with_err = adaptive and pid is not None
        if compensated:
            inc, err, f1 = solver.step_inc(term, t, dt_used, y, args, f0=f, error=with_err)
            y1, yc1 = _kahan_update(y, yc, inc)
        else:
            y1, err, f1 = solver.step(term, t, dt_used, y, args, f0=f, error=with_err)
            yc1 = yc

        if with_err:
            norm = rms_error_norm(err, y, y1, pid.rtol, pid.atol, batch_dims=nb)
            accept, factor = controller.adapt(norm, dt_used, solver)
            dt_new = dt_used * factor.detach()
            if clamp is not None:
                dt_new = clamp(dt_new)
        else:
            accept = torch.ones_like(t, dtype=torch.bool)
            dt_new = dt_next

        # Kahan-compensated t += dt_used on acceptance
        yk = torch.where(accept, dt_used, torch.zeros_like(dt_used)) - t_comp
        t_new = t + yk
        t_comp_new = (t_new - t) - yk
        t_end_prehop = t_new  # the segment's end as the save grid sees it
        if jump_grid is not None:
            # hop the discontinuity: resume just after the jump
            made_jump = (dt_used >= dt_to_jump) & accept
            t_new = torch.where(made_jump, torch.nextafter(nj, torch.full_like(nj, math.inf)), t_new)
            t_comp_new = torch.where(made_jump, torch.zeros_like(t_comp_new), t_comp_new)

        y_next = _select(accept, y1, y)
        yc_next = _select(accept, yc1, yc)
        if solver.fsal:
            f_next = _select(accept, f1, f)
            if jump_grid is not None:
                # the FSAL stage was evaluated before the jump: refresh it
                f_next = _select(made_jump, term.vf(t_new, y_next, args), f_next)
        else:
            f_next = f
        na = na + accept.to(na.dtype)
        nr = nr + (~accept).to(nr.dtype)
        return (t_new, t_comp_new, y_next, yc_next, f_next, dt_new, na, nr, t_end_prehop)

    def run_chunk(carry):
        outs = []
        for _ in range(chunk):
            t = carry[0]
            # a done step emits (t, t, y): its extra slot holds t itself
            ext = _advance(carry + (t,), t >= t_done, do_step, host_skips)
            carry = ext[:-1]
            outs.append((t, ext[-1], ext[2]))
        return carry, (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
                       _stack([o[2] for o in outs], 0))

    def start():
        f0 = term.vf(t0, y0, args)
        dt_init = _init_dt(controller, term, solver, t0, t1, y0, f0, args, dt0)
        zero_i = torch.zeros(t0.shape, dtype=torch.int32, device=t0.device)
        yc0 = tuple(torch.zeros_like(leaf) for leaf in y0) if compensated else ()
        return (t0, torch.zeros_like(t0), y0, yc0, f0, dt_init, zero_i, zero_i)

    def done(carry):
        return (carry[0] >= t_done).all()

    def finish(carry, t_starts, t_ends, y_ends) -> Solution:
        t_final, na, nr = carry[0], carry[6], carry[7]
        result = torch.where(t_final >= t_done, RESULT_SUCCESS, RESULT_MAX_STEPS).to(torch.int32)

        # ---- dense output: locate each save time's segment, then re-step ------
        # one fresh RK step of size (s - t_start) from the segment's start: the
        # solver's own order, linear invariants kept, segment ends bit for bit
        y_starts = tuple(torch.cat([first[None], ends_[:-1]]) for ends_, first in zip(y_ends, y0))
        save_q = save_ts.expand(t0.shape + save_ts.shape).contiguous()
        seg = torch.searchsorted(t_ends.movedim(0, -1).contiguous(), save_q, side="left")
        seg = seg.clamp(0, budget - 1)
        ta = torch.gather(t_starts.movedim(0, -1), -1, seg)
        if nb:
            rows = torch.arange(seg.shape[0], device=seg.device)[:, None]
            ya = tuple(leaf.movedim(0, 1)[rows, seg] for leaf in y_starts)
        else:
            ya = tuple(leaf[seg] for leaf in y_starts)
        over_saves = ODETerm(vmap(term.vf, in_dims=(nb, nb, None), out_dims=nb))
        dt_q = torch.clamp(save_q - ta, min=0.0)
        ys, _, _ = solver.step(over_saves, ta, dt_q, ya, args, f0=None, error=False)

        unreached = save_q > (t_final + t1_eps).unsqueeze(-1)
        ys = tuple(torch.where(_bcast(unreached, leaf), torch.full_like(leaf, math.nan), leaf) for leaf in ys)
        if subs is not None:
            ys = vmap(lambda t, y: subs(t, y, args), in_dims=(0, nb), out_dims=nb)(save_ts, ys)

        return Solution(t0=t0, t1=t1, ts=save_q, ys=ys, stats=_stats(na, nr, budget), result=result)

    return start, _checkpointed(run_chunk, grad and n_chunks > 1), done, finish


def _solve(term, solver, controller, subs, budget: int, chunk: int, compensated: bool, t0, t1, dt0, y0, args,
           save_ts, bshape: tuple, grad: bool) -> Solution:
    """The buffered two-phase engine (JAX ``_solve``), driven eagerly
    (:func:`_buffered`): the step buffers are the chunks' segments,
    concatenated. Once per chunk the host asks whether every member is
    done, and then fills the rest of the buffers itself: every later step
    of a finished solve emits ``(t, t, y)``, which is what JAX's
    ``lax.scan`` over the remaining chunks emits."""
    start, chunk_fn, done, finish = _buffered(term, solver, controller, subs, budget, chunk, compensated,
                                              t0, t1, dt0, y0, args, save_ts, bshape, grad)
    n_chunks = budget // chunk
    carry = start()
    starts, ends, y_ends = [], [], []
    for c in range(n_chunks):
        carry, (ts_c, te_c, ye_c) = chunk_fn(carry)
        starts.append(ts_c)
        ends.append(te_c)
        y_ends.append(ye_c)
        left = (n_chunks - c - 1) * chunk
        if left and not _under_functorch() and bool(done(carry)):
            t = carry[0]
            starts.append(t.expand((left,) + t.shape))
            ends.append(t.expand((left,) + t.shape))
            y_ends.append(tuple(leaf.expand((left,) + leaf.shape) for leaf in carry[2]))
            break
    y_ends = tuple(torch.cat(leaves) for leaves in zip(*y_ends))
    return finish(carry, torch.cat(starts), torch.cat(ends), y_ends)


def _kept_buffered(parts, budget: int, chunk: int, phase):
    """The buffered engine's kept solve (:func:`_buffered`'s ``parts``): a
    function that runs it through ``phase`` (:func:`_phase`) as three
    graphs, the first carry with the step buffers, one chunk, and the
    dense output; the chunk's graph is replayed once per chunk from the
    host. After each chunk the host copies its segments into the step
    buffers and reads the done flag, as the eager loop (:func:`_solve`)
    does: the same chunks run, the same bits come out, and a solve that
    is done early stops early."""
    start, chunk_fn, done, finish = parts
    n_chunks = budget // chunk

    def begin():
        # the carry in memory of its own, which every chunk rewrites
        carry = pytree.tree_map(lambda x: x.clone(memory_format=torch.contiguous_format), start())
        t, y = carry[0], carry[2]
        steps = (t.new_empty((budget,) + t.shape), t.new_empty((budget,) + t.shape),
                 tuple(leaf.new_empty((budget,) + leaf.shape) for leaf in y))
        return carry, steps

    def advance(carry):
        new, segments = chunk_fn(carry)
        for buf, x in zip(pytree.tree_leaves(carry), pytree.tree_leaves(new)):
            buf.copy_(x)
        return segments, done(carry)

    def run() -> Solution:
        carry, (t_starts, t_ends, y_ends) = phase("start", begin)
        steps = (t_starts, t_ends, *y_ends)
        for c in range(n_chunks):
            (ts_c, te_c, ye_c), finished = phase("chunk", lambda: advance(carry))
            for buf, x in zip(steps, (ts_c, te_c, *ye_c)):
                buf[c * chunk:(c + 1) * chunk].copy_(x)
            if c + 1 < n_chunks and bool(finished):
                for buf, x in zip(steps, (carry[0], carry[0], *carry[2])):
                    buf[(c + 1) * chunk:].copy_(x.expand(buf[(c + 1) * chunk:].shape))
                break
        return phase("finish", lambda: finish(carry, t_starts, t_ends, y_ends))

    return run


def _solve_adaptive_grid(
    term: ODETerm,
    solver: AbstractSolver,
    controller: AbstractStepSizeController,
    subs,
    k_per_interval: int,
    n_saves: int,
    budget: int,
    compensated: bool,
    t0,
    dt0,
    y0,
    args,
    save_ts,
    bshape: tuple,
    grad: bool,
) -> Solution:
    """Adaptive stepping bounded by the save grid (JAX ``_solve_adaptive_grid``).

    One loop over the save intervals, each of at most ``k_per_interval``
    PID steps (the first ``max(2k, 16)``, to ramp dt up from the initial
    step) whose dt is clamped so that the last one lands exactly on the
    save point; the save is the accepted state itself. An interval that
    runs out of steps, or a solve out of its global ``budget``, leaves NaN
    saves from there until the member catches up, and sets ``result``.
    ``t0`` is 0-d; ``bshape`` is the batch shape, ``()`` or ``(B,)``.
    """
    nb = len(bshape)
    host_skips = _host_skips(t0.device)
    t0b = t0.expand(bshape)
    f0 = term.vf(t0b, y0, args)
    dt_init = _init_dt(controller, term, solver, t0b, save_ts[-1], y0, f0, args, dt0)
    pid = _unwrap_pid(controller)
    jump_grid = _jump_grid(controller, t0)
    clamp = getattr(controller, "clamp_dt", None)
    spacing = (save_ts[-1] - save_ts[0]) / (n_saves - 1)
    seg_eps = 1e-6 * torch.clamp(spacing.abs(), min=1.0)

    def do_step(carry, s_end):
        t, t_comp, y, yc, f, dt_next, na, nr = carry
        dt_to_end = s_end - t
        dt_allowed = dt_to_end
        if jump_grid is not None:
            nj = jump_grid[torch.searchsorted(jump_grid[:-1], t, right=True)]
            dt_to_jump = torch.nextafter(nj, torch.full_like(nj, -math.inf)) - t
            dt_allowed = torch.minimum(dt_allowed, dt_to_jump)
        dt_used = torch.minimum(dt_next, dt_allowed).detach()
        landing = dt_used >= dt_to_end - seg_eps
        jumping = dt_used >= dt_to_jump if jump_grid is not None else torch.zeros_like(landing)

        if compensated:
            inc, err, f1 = solver.step_inc(term, t, dt_used, y, args, f0=f)
            y1, yc1 = _kahan_update(y, yc, inc)
        else:
            y1, err, f1 = solver.step(term, t, dt_used, y, args, f0=f)
            yc1 = yc

        if pid is not None:
            norm = rms_error_norm(err, y, y1, pid.rtol, pid.atol, batch_dims=nb)
            accept, factor = controller.adapt(norm, dt_used, solver)
            # an accepted step clamped to a save point or a jump says nothing
            # of the controller's natural dt, so that is kept; a rejected one
            # shrinks from the clamped size, or the retry would repeat it
            keep_natural = (landing | jumping) & accept
            dt_new = torch.where(keep_natural, dt_next, dt_used * factor.detach())
            if clamp is not None:
                dt_new = clamp(dt_new)
        else:
            accept = torch.ones_like(landing)
            dt_new = dt_next

        yk = torch.where(accept, dt_used, torch.zeros_like(dt_used)) - t_comp
        t_new = t + yk
        t_comp_new = (t_new - t) - yk
        # snap onto the save point, or hop the jump, on acceptance; a jump on
        # a save point lands (t on the far side) and still refreshes FSAL
        landed = landing & accept
        made_jump = jumping & accept
        t_new = torch.where(landed, s_end, t_new)
        if jump_grid is not None:
            t_new = torch.where(
                made_jump & ~landed, torch.nextafter(nj, torch.full_like(nj, math.inf)), t_new
            )
        t_comp_new = torch.where(landed | made_jump, torch.zeros_like(t_comp_new), t_comp_new)

        y_next = _select(accept, y1, y)
        yc_next = _select(accept, yc1, yc)
        if solver.fsal:
            f_next = _select(accept, f1, f)
            if jump_grid is not None:
                f_next = _select(made_jump, term.vf(t_new, y_next, args), f_next)
        else:
            f_next = f
        na = na + accept.to(na.dtype)
        nr = nr + (~accept).to(nr.dtype)
        return (t_new, t_comp_new, y_next, yc_next, f_next, dt_new, na, nr)

    def make_interval(k_steps):
        def interval(carry, s_end):
            step = functools.partial(do_step, s_end=s_end)
            for _ in range(k_steps):
                # done on reaching the save point or the global budget
                done = (carry[0] >= s_end - seg_eps) | (carry[6] + carry[7] >= budget)
                carry = _advance(carry, done, step, host_skips)
            reached = carry[0] >= s_end - seg_eps
            emit = subs(s_end, carry[2], args) if subs is not None else carry[2]
            emit = tuple(
                torch.where(_bcast(reached, leaf), leaf, torch.full_like(leaf, math.nan))
                for leaf in emit
            )
            return carry, emit, reached

        return interval

    zero_i = torch.zeros(bshape, dtype=torch.int32, device=t0.device)
    yc0 = tuple(torch.zeros_like(leaf) for leaf in y0) if compensated else ()
    carry = (t0b, torch.zeros_like(t0b), y0, yc0, f0, dt_init, zero_i, zero_i)
    k_first = max(2 * k_per_interval, 16)
    first_int = _checkpointed(make_interval(k_first), grad and n_saves > 8)
    interval = _checkpointed(make_interval(k_per_interval), grad and n_saves > 8)
    emits = [subs(t0, y0, args) if subs is not None else y0]
    reached_all = torch.ones(bshape, dtype=torch.bool, device=t0.device)
    for i in range(1, n_saves):
        fn = first_int if i == 1 else interval
        carry, emit, reached = fn(carry, save_ts[i])
        emits.append(emit)
        reached_all = reached_all & reached
    na, nr = carry[6], carry[7]
    result = torch.where(reached_all, RESULT_SUCCESS, RESULT_MAX_STEPS).to(torch.int32)
    capacity = min(budget, k_first + k_per_interval * (n_saves - 2))
    return Solution(
        t0=t0b,
        t1=save_ts[-1].expand(bshape),
        ts=save_ts.expand(bshape + save_ts.shape),
        ys=_stack(emits, nb),
        stats=_stats(na, nr, capacity),
        result=result,
    )


def _solve_constant_direct(
    term: ODETerm,
    solver: AbstractSolver,
    subs,
    stride: int,
    n_saves: int,
    compensated: bool,
    t0,
    dt,
    y0,
    args,
    save_ts,
    bshape: tuple,
    grad: bool,
) -> Solution:
    """Fixed dt that tiles the save grid: save every ``stride`` steps
    (JAX ``_solve_constant_direct``), no buffer and no interpolation.

    ``t`` and ``dt`` stay 0-d: every member of a batch shares them.
    """
    nb = len(bshape)
    f0 = term.vf(t0, y0, args)

    def interval(carry):
        for _ in range(stride):
            t, y, yc, f = carry
            if compensated:
                inc, _, f1 = solver.step_inc(term, t, dt, y, args, f0=f, error=False)
                y1, yc1 = _kahan_update(y, yc, inc)
            else:
                y1, _, f1 = solver.step(term, t, dt, y, args, f0=f, error=False)
                yc1 = yc
            carry = (t + dt, y1, yc1, f1 if solver.fsal else f)
        t, y = carry[0], carry[1]
        return carry, (subs(t, y, args) if subs is not None else y)

    interval_fn = _checkpointed(interval, grad and n_saves > 8)
    yc0 = tuple(torch.zeros_like(leaf) for leaf in y0) if compensated else ()
    carry = (t0, y0, yc0, f0)
    emits = [subs(t0, y0, args) if subs is not None else y0]
    for _ in range(n_saves - 1):
        carry, emit = interval_fn(carry)
        emits.append(emit)
    n_steps = torch.full(bshape, stride * (n_saves - 1), dtype=torch.int32, device=t0.device)
    return Solution(
        t0=t0.expand(bshape),
        t1=save_ts[-1].expand(bshape),
        ts=save_ts.expand(bshape + save_ts.shape),
        ys=_stack(emits, nb),
        stats={
            "num_accepted": n_steps,
            "num_rejected": torch.zeros_like(n_steps),
            "num_steps": n_steps,
            "step_budget": n_steps,
        },
        result=torch.zeros_like(n_steps),
    )


def _save_grid(ts, fdtype, device):
    """A save grid as given (sequence, numpy array, tensor) on ``device`` in
    the state's dtype, and its values as a float64 numpy array.

    A grid of host values is read in float64 on the host and cast to the
    state's dtype there, outside any ``torch.func`` transform (inside one,
    a new tensor is wrapped as a batched or gradient-tracking tensor
    without storage, which ``.numpy()`` refuses), then placed by
    :func:`_device.constant`. A tensor on a device stays there: reading it
    would make the host wait, so its values are None, as a traced grid's
    under JAX's jit."""
    if torch.is_tensor(ts) and ts.device.type != "cpu":
        return ts.detach().to(device=device, dtype=fdtype), None
    if torch.is_tensor(ts):
        ts = ts.detach()
    with torch._C._DisableFuncTorch():
        grid = torch.as_tensor(np.asarray(ts, dtype=np.float64)).to(fdtype)
        values = grid.double().numpy()
    return _device.constant(grid, device), values


def _end_grid(t0, t1, t0_arr, t1_arr, fdtype, device):
    """The save grid ``[t0, t1]`` on ``device`` in the state's dtype: from
    host values when both ends are static (:func:`_device.from_host`), else
    stacked on the device from their 0-d tensors, with no read by the host."""
    st0, st1 = _static_float(t0), _static_float(t1)
    if st0 is None or st1 is None:
        return torch.stack([t0_arr, t1_arr])
    return _device.from_host((st0, st1), device, fdtype)


#: the kept solves, JAX's jit cache on the engines: key -> entry
#: (:func:`_kept_solve`), at most ``_graphs.EXEC_CACHE_SIZE``. An entry
#: holds the functions its key names: its graphs read what they close over
_SOLVE_CACHE: "OrderedDict[tuple, dict]" = OrderedDict()
#: the keys solved once, eagerly: each with weak references to the objects
#: its key names by identity (the key is forgotten when one dies) and the
#: device constants its call kept, which the next call (the capture) reads
_SEEN: "OrderedDict[tuple, tuple]" = OrderedDict()
_SEEN_SIZE = 64
#: calls of the kept-graph route by the route they took: "eager" (a key's
#: first call), "capture" (its second) and "replay"
_ROUTES: Counter = Counter()


def _graphed(device: torch.device) -> bool:
    """Whether a solve on ``device`` takes the kept-graph route: on a card.
    (CPU tests set it True, and then the static buffers are solved eagerly.)"""
    return device.type == "cuda"


def _capturing(device: torch.device) -> bool:
    """Whether the current stream is capturing a graph (``MCMC``'s and
    SVI's capture a solve inside theirs: a graph does not nest)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _identity(fn) -> tuple:
    """The objects a function is keyed by: itself, or a bound method's
    function and owner (the method is a new object at every access)."""
    if isinstance(fn, types.MethodType):
        return (fn.__func__, fn.__self__)
    return (fn,)


def _static_token(obj):
    """A solver or a controller as JAX hashes a static argument: its class
    and its fields by value, nested objects alike. Raises ``TypeError`` on
    a field it cannot take by value (a tensor, a function)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (tuple, list)):
        return tuple(_static_token(x) for x in obj)
    if isinstance(obj, (torch.Tensor, types.FunctionType, types.MethodType)) or not hasattr(obj, "__dict__"):
        raise TypeError(f"no static value for {type(obj).__name__}")
    return (type(obj), tuple((k, _static_token(v)) for k, v in sorted(vars(obj).items())))


def _leaf_token(x):
    """A leaf of the state or the arguments in a key: a tensor's shape,
    strides, dtype and device (never its values); any other leaf by value."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device)
    if isinstance(x, np.ndarray):
        return (x.shape, x.dtype.str, x.tobytes())
    hash(x)  # TypeError for an unhashable leaf
    return (type(x), x)


def _tracks_grad(fns) -> bool:
    """Whether any output of the calls ``fns`` requires grad."""
    return any(isinstance(x, torch.Tensor) and x.requires_grad for fn in fns for x in pytree.tree_leaves(fn()))


def _expanded(x: torch.Tensor) -> tuple:
    """An index that keeps one element along each expanded (stride-0)
    dimension of ``x`` and the whole of every other."""
    return tuple(slice(0, 1) if st == 0 and n > 1 else slice(None) for n, st in zip(x.shape, x.stride()))


def _fresh(x):
    """A tensor ``x`` copied into memory of its own, laid out as ``x``: its
    expanded dimensions stay views of one element."""
    return x.detach()[_expanded(x)].clone().expand(x.shape) if isinstance(x, torch.Tensor) else x


def _tensor_inputs(y0, args) -> list:
    """The tensors a kept solve copies in: ``y0``'s leaves, then ``args``'."""
    return [*y0, *(x for x in pytree.tree_leaves(args) if isinstance(x, torch.Tensor))]


def _phase(entry: dict, name: str, fn):
    """``fn()``, the phase ``name`` of a kept solve. On a card its first
    run captures it into a graph with host syncs raising
    (:func:`_graphs.capture`), inside the constants the key's first
    (eager) call kept, so that none is copied; every run replays the
    graph and returns its static outputs. On CPU tensors ``fn()`` runs."""
    device = entry["device"]
    if device.type != "cuda":
        return fn()
    if name not in entry["graphs"]:
        graph, _, out, _, capture_s = _graphs.capture(device, entry["constants"], lambda: None, fn,
                                                      f"the ODE solve ({name})")
        entry["graphs"][name] = (graph, out, fn)
        entry["capture_s"] = (entry["capture_s"] or 0.0) + capture_s
    graph, out, _ = entry["graphs"][name]
    graph.replay()
    return out


def _solve_entry(run, y0, args, device: torch.device, objects: list, constants: dict) -> dict:
    """A kept solve: static buffers that hold ``y0``'s and ``args``'
    tensors, and ``entry["run"]``, the engine's call on them through
    :func:`_phase`, built once (``run(y, a, phase)``). Each phase is
    captured at its first run, on the key's second call."""
    leaves, spec = pytree.tree_flatten(args)
    inputs = _tensor_inputs(y0, args)
    with torch.inference_mode(False):
        bufs = [x.detach()[_expanded(x)].clone() for x in inputs]
    views = iter([b.expand(x.shape) for b, x in zip(bufs, inputs)])
    y_in = tuple(next(views) for _ in y0)
    a_in = pytree.tree_unflatten([next(views) if isinstance(x, torch.Tensor) else x for x in leaves], spec)
    entry = {"objects": objects, "fps": [], "bufs": bufs, "y0": y_in, "args": a_in, "device": device,
             "graphs": {}, "constants": constants, "replays": 0, "capture_s": None}
    with _device.keep_constants(constants):
        entry["run"] = run(y_in, a_in, functools.partial(_phase, entry))
    return entry


def _release_solve(entry: dict) -> None:
    """Free a kept solve's graphs, its buffers and its kept constants."""
    entry.update(graphs={}, constants={}, bufs=None, y0=None, args=None, run=None)


def _remember(key: tuple, objects: list, constants: dict) -> None:
    """Record ``key``'s first call: weak references to ``objects`` (an
    object that takes none, as ``None``, is held), whose death forgets the
    key, and the call's kept ``constants``; at most ``_SEEN_SIZE`` keys."""
    def forget(_ref, key=key):
        _SEEN.pop(key, None)

    refs = []
    for obj in objects:
        try:
            refs.append(weakref.ref(obj, forget))
        except TypeError:
            refs.append(lambda obj=obj: obj)
    _SEEN[key] = (refs, constants)
    while len(_SEEN) > _SEEN_SIZE:
        _SEEN.popitem(last=False)


def clear_solve_cache() -> None:
    """Drop every kept solve, releasing its graphs (JAX's cache clear), and
    forget the keys solved once. The memory goes back to the caching
    allocator, which ``torch.cuda.empty_cache()`` returns to the card."""
    while _SOLVE_CACHE:
        _release_solve(_SOLVE_CACHE.popitem()[1])
    _SEEN.clear()


def _kept_solve(key: tuple, objects: list, run, y0, args, device: torch.device) -> Solution:
    """``run(y0, args, None)``, an engine call, by the kept-graph route.

    A key's first call runs eagerly, keeping the device constants it
    places, and records the key (:func:`_remember`). The second builds the
    entry (:func:`_solve_entry`) and runs it, capturing each phase; the
    next ones copy ``y0``'s and ``args``' tensors into its buffers and run
    it, replaying. Each returns copies of the outputs, which the next
    replay rewrites. A capture that fails raises, and the key's next call
    captures again."""
    entry = _graphs.cached(_SOLVE_CACHE, key, objects, [], "diffeqsolve")
    if entry is not None:
        for buf, x in zip(entry["bufs"], _tensor_inputs(y0, args)):
            buf.copy_(x.detach()[_expanded(x)])
        out = entry["run"]()
        route = "replay"
    else:
        seen = _SEEN.pop(key, None)
        if seen is None or any(ref() is not obj for ref, obj in zip(seen[0], objects)):
            constants = {}
            with _device.keep_constants(constants):
                out = run(y0, args, None)
            _remember(key, objects, constants)
            _ROUTES["eager"] += 1
            return out
        entry = None
        try:
            entry = _solve_entry(run, y0, args, device, objects, seen[1])
            out = entry["run"]()
        except BaseException:
            if entry is not None:
                _release_solve(entry)
            _remember(key, objects, seen[1])
            raise
        _graphs.keep(_SOLVE_CACHE, key, entry, _release_solve, _graphs.EXEC_CACHE_SIZE)
        route = "capture"
    entry["replays"] += 1
    _ROUTES[route] += 1
    return pytree.tree_map(_fresh, out)


def diffeqsolve(
    term,
    solver: AbstractSolver,
    t0,
    t1,
    dt0,
    y0,
    args: Any = None,
    *,
    saveat: Optional[SaveAt] = None,
    stepsize_controller: Optional[AbstractStepSizeController] = None,
    max_steps: int = DEFAULT_STEP_BUDGET,
    step_budget: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    steps_per_save: Optional[int] = None,
    compensated_summation: bool = False,
    batched: bool = False,
) -> Solution:
    """Integrate ``term`` from t0 to t1 and return the states on a save grid.

    The JAX signature. ``y0`` is a tuple of tensors, all on one device (the
    tensors of ``args`` too: a mix raises ``ValueError``); the solve runs
    there, in the promoted floating dtype of ``y0``. ``step_budget`` bounds
    the number of steps (default ``min(max_steps, 4096)``); running out of
    it sets ``result`` to ``RESULT_MAX_STEPS`` and NaN-fills the unreached
    save times.

    Routing, as in JAX: a constant ``dt0`` that tiles a uniform save grid
    goes to :func:`_solve_constant_direct`; an adaptive solve on a uniform
    grid spanning ``[t0, t1]`` with at least 3 intervals and a budget of
    at least intervals + 17 goes to :func:`_solve_adaptive_grid`
    (``steps_per_save`` bounds its steps per interval); everything else to
    :func:`_solve`, in chunks of ``checkpoint_every`` steps (default about
    sqrt(budget)).

    ``batched=True`` solves a batch-leading ensemble: ``y0``'s leaves and
    ``args``' tensors carry a leading member axis, and each member gets its
    own dt chain, as JAX's ``vmap(diffeqsolve)``.

    On a card a call without gradients is a kept solve, as JAX jits its
    engines: a key's first call runs eagerly, its second captures the
    engine into a CUDA graph and later calls replay it with their own
    tensors (module docstring, :func:`_kept_solve`).
    """
    if callable(term) and not isinstance(term, ODETerm):
        term = ODETerm(term)
    if stepsize_controller is None:
        stepsize_controller = ConstantStepSize()

    y0 = tuple(y0)
    arg_tensors = [x for x in pytree.tree_leaves(args) if isinstance(x, torch.Tensor)]
    device = _device.common_device(*y0, *arg_tensors)
    fdtype = functools.reduce(torch.promote_types, [leaf.dtype for leaf in y0])
    if not fdtype.is_floating_point:
        fdtype = torch.get_default_dtype()
    y0 = tuple(leaf.to(fdtype) for leaf in y0)
    bshape = tuple(y0[0].shape[:1]) if batched else ()
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (*y0, *arg_tensors))

    t0_arr = _device.scalar(t0, fdtype, device)
    t1_arr = _device.scalar(t1, fdtype, device)

    # ---- save grid ---------------------------------------------------------
    subs_fn = None
    save_np = None  # the grid's host values; [t0, t1] needs none (one interval)
    if saveat is None:
        save_ts = _end_grid(t0, t1, t0_arr, t1_arr, fdtype, device)
    elif saveat.subs is not None:
        save_ts, save_np = _save_grid(saveat.subs.ts, fdtype, device)
        subs_fn = saveat.subs.fn
    else:
        save_ts, save_np = _save_grid(saveat.ts, fdtype, device)

    compensated = bool(compensated_summation)
    rhs = term.vf
    kept = not grad and not _under_functorch() and _graphed(device) and not _capturing(device)

    def terms(a):
        """The term and ``SubSaveAt`` function the engine calls with the
        arguments ``a``: mapped over the members of a batch-leading solve."""
        if not batched:
            return term, subs_fn
        return (ODETerm(_member_map(rhs, a), member_fn=rhs),
                _member_map(subs_fn, a) if subs_fn is not None else None)

    def tracks_grad() -> bool:
        """With autograd on, whether the RHS or the ``SubSaveAt`` function,
        probed at ``t0``, tracks a gradient through a tensor it closes
        over: a graph would cut it from autograd, so the call stays eager."""
        if not torch.is_grad_enabled():
            return False
        tm, sb = terms(args)
        probes = [lambda: tm.vf(t0_arr.expand(bshape), y0, args)]
        if sb is not None:
            probes.append(lambda: sb(save_ts[0], y0, args))
        return _tracks_grad(probes)

    def solve(statics: tuple, run) -> Solution:
        """``run(y0, args, None)``, eagerly or by the kept-graph route."""
        if kept:
            objects = [*_identity(term.vector_field), *_identity(term.member_fn), *_identity(subs_fn)]
            times = tuple(None if x is None else _static_float(x) for x in (t0, t1, dt0))
            dynamic = any(v is None and x is not None for v, x in zip(times, (t0, t1, dt0)))
            if not dynamic and (saveat is None or save_np is not None):
                leaves, spec = pytree.tree_flatten(args)
                try:
                    key = (statics, batched, tuple(map(id, objects)), _static_token(solver),
                           _static_token(stepsize_controller), times,
                           None if save_np is None else save_np.tobytes(), spec,
                           tuple(_leaf_token(x) for x in (*y0, *leaves)), torch.get_default_dtype())
                    hash(key)
                except TypeError:  # a part JAX could not hash either: stays eager
                    key = None
                if key is not None and not tracks_grad():
                    return _kept_solve(key, objects, run, y0, args, device)
        return run(y0, args, None)

    # ---- routing -----------------------------------------------------------
    adaptive = stepsize_controller.adaptive
    if not adaptive:
        st0, st1, sdt = _static_float(t0), _static_float(t1), _static_float(dt0)
        if st0 is not None and st1 is not None and sdt is not None:
            budget = max(int(math.ceil((st1 - st0) / sdt - 1e-9)), 1)
            n_pts = int(save_ts.shape[0])
            if n_pts >= 2:
                spacing = (st1 - st0) / (n_pts - 1)
                stride_f = spacing / sdt
                stride = int(round(stride_f))
                if (
                    stride >= 1
                    and abs(stride_f - stride) < 1e-9
                    and abs(stride * (n_pts - 1) * sdt - (st1 - st0)) < 1e-9
                ):
                    dt_arr = _device.scalar(sdt, fdtype, device)

                    def run_direct(y, a, phase):
                        def call():
                            tm, sb = terms(a)
                            return _solve_constant_direct(tm, solver, sb, stride, n_pts, compensated, t0_arr,
                                                          dt_arr, y, a, save_ts, bshape, grad)

                        return call() if phase is None else lambda: phase("solve", call)

                    return solve(("constant_direct", stride, n_pts, compensated), run_direct)
        else:
            budget = step_budget or min(int(max_steps), DEFAULT_STEP_BUDGET)
    else:
        budget = step_budget or min(int(max_steps), DEFAULT_STEP_BUDGET)
        # the grid engine needs a step per interval plus the first
        # interval's dt ramp; a smaller budget goes to the buffered engine.
        # So does a batch-leading solve: JAX's jitted vmap traces the save
        # grid, and a traced grid takes the buffered engine there.
        grid = None if batched or save_np is None else _uniform_grid_info(save_np, t0, t1)
        if grid is not None and grid >= 3 and budget >= grid + 17:
            if steps_per_save is not None:
                k = max(int(steps_per_save), 2)
            else:
                # headroom over the mean: adaptive step density is not
                # uniform in time; the global budget still caps the work
                k = max(-(-(5 * budget) // (4 * grid)) + 2, 6)
            dt0_grid = None if dt0 is None else _device.scalar(dt0, fdtype, device)

            def run_grid(y, a, phase):
                def call():
                    tm, sb = terms(a)
                    return _solve_adaptive_grid(tm, solver, stepsize_controller, sb, k, grid + 1, budget,
                                                compensated, t0_arr, dt0_grid, y, a, save_ts, bshape, grad)

                return call() if phase is None else lambda: phase("solve", call)

            return solve(("grid", k, grid + 1, budget, compensated), run_grid)

    if checkpoint_every is None:
        if budget <= 128:
            chunk = budget
        else:
            chunk = 1 << max(1, (int(math.isqrt(budget)) - 1).bit_length())
            chunk = min(chunk, budget)
    else:
        chunk = min(checkpoint_every, budget)
    budget = -(-budget // chunk) * chunk

    dt0_arr = None if dt0 is None else _device.scalar(dt0, fdtype, device)

    def run_buffered(y, a, phase):
        tm, sb = terms(a)
        engine = (tm, solver, stepsize_controller, sb, budget, chunk, compensated, t0_arr, t1_arr, dt0_arr, y, a,
                  save_ts, bshape, grad)
        if phase is None:
            return _solve(*engine)
        return _kept_buffered(_buffered(*engine), budget, chunk, phase)

    return solve(("buffered", budget, chunk, compensated), run_buffered)


__all__ = ["diffeqsolve", "clear_solve_cache", "DEFAULT_STEP_BUDGET"]
