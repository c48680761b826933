"""Whole-solve ensemble solves for any rows-RHS: constant step and adaptive.

Port of ``dynode_tpu/ops/generic_pallas.py``. The rows contract is the JAX
one::

    rhs(y: list[Tensor], p: list[Tensor], t) -> list[Tensor]

``y`` holds R state rows and ``p`` P parameter rows, each a ``(B,)`` float32
row over the ensemble; structure (ages, strains, compartments) is Python
loops over rows.

A GPU kernel cannot run a Python function, so a rows-RHS that is to reach
the Triton kernel is a :class:`RowsRHS`: the plain torch form above, plus a
factory of its ``@triton.jit`` form ``rhs(y, p, t, C)``, where ``y``/``p``
are tuples of ``[BLOCK]`` row tensors and ``C`` is a tuple of compile-time
constants the RHS was built with (for example the contact matrix).

:func:`ensemble_solve_kernel` takes its route from the device of ``y0_rows``:
CPU tensors go to :func:`ensemble_solve_kernel_reference` (the plain version;
any callable or :class:`RowsRHS`), CUDA tensors to the Triton kernel of
:mod:`.generic_triton` (a :class:`RowsRHS` only), or raise.
:func:`ensemble_solve_kernel_adaptive` does the same for the lockstep-dt
adaptive solve: :func:`ensemble_solve_kernel_adaptive_reference` on the CPU,
the adaptive Triton kernel on the card.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import _device
from ..ode.solvers import ADAPTIVE_METHODS, METHODS

__all__ = [
    "ADAPTIVE_BLOCK",
    "RowsRHS",
    "ensemble_solve_kernel",
    "ensemble_solve_kernel_adaptive",
    "ensemble_solve_kernel_adaptive_reference",
    "ensemble_solve_kernel_reference",
    "pack_rows",
    "select_saves",
    "unpack_rows",
]

SAVE_DTYPES = (torch.float32, torch.bfloat16)

#: members per lockstep block of the adaptive solve when the caller names
#: none (one Triton program each). The block's stiffest member sets its dt,
#: so the width changes the decisions as well as the work. A sweep
#: (``chip_sweep.py``) on an H100 80GB HBM3 at 700 W, multi-strain rows-RHS,
#: bosh3, 200 days, gave at B = 163,840 (all rows, bf16) 3.346 / 3.358 /
#: 3.275 / 3.489, 3.209 / 3.079 / 3.213 / 3.539 and 3.249 / 3.060 / 3.639 /
#: 3.523 ms in three calls for 32 / 64 / 128 / 256, and at B = 655,360
#: (c rows, bf16) 10.243 / 10.786 / 11.462 / 12.497 and 10.735 / 11.356 /
#: 11.464 / 12.240 ms, with the same attempts per member (about 215) at
#: every width. 64 is the best at B = 163,840 in two calls of three and
#: 5-6% behind 32 at B = 655,360.
ADAPTIVE_BLOCK = 64


class RowsRHS:
    """One rows-RHS in two forms: plain torch and ``@triton.jit``.

    ``torch_fn(y, p, t)`` follows the rows contract; ``triton_factory()``
    imports Triton and returns the jitted ``rhs(y, p, t, C)``, called with
    ``C = consts``. The factory runs at the first kernel launch only, so
    building a ``RowsRHS`` needs no Triton.
    """

    def __init__(self, torch_fn: Callable, triton_factory: Callable, consts: tuple = ()):
        self.torch_fn = torch_fn
        self.triton_factory = triton_factory
        self.consts = consts
        self._triton_fn = None

    def __call__(self, y, p, t):
        return self.torch_fn(y, p, t)

    def triton_fn(self):
        """The ``@triton.jit`` form, built on first use."""
        if self._triton_fn is None:
            self._triton_fn = self.triton_factory()
        return self._triton_fn


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def pack_rows(leaves: Sequence, batch: int):
    """Leaves ``(*struct, B)`` -> packed ``(R, B)`` float32 and their spec.

    Leaves without a trailing batch axis are shared and broadcast. ``spec``
    is the per-leaf struct shape that :func:`unpack_rows` takes.
    """
    rows, spec = [], []
    for leaf in leaves:
        leaf = torch.as_tensor(leaf).to(torch.float32)
        if leaf.ndim == 0 or leaf.shape[-1] != batch:
            leaf = leaf[..., None].expand(*leaf.shape, batch)
        spec.append(tuple(leaf.shape[:-1]))
        rows.append(leaf.reshape(-1, batch))
    return torch.cat(rows, dim=0), tuple(spec)


def unpack_rows(packed: torch.Tensor, spec) -> list[torch.Tensor]:
    """Inverse of :func:`pack_rows`; takes ``(R, B)`` or ``(T, R, B)``."""
    out, off = [], 0
    lead = packed.shape[:-2]
    batch = packed.shape[-1]
    for struct in spec:
        size = int(np.prod(struct, dtype=int)) if struct else 1
        blk = packed[..., off : off + size, :]
        out.append(blk.reshape(*lead, *struct, batch))
        off += size
    return out


def _rk_step_rows(rhs, y, p, t, dt, a, b, c, n_stages):
    """One explicit RK step on rows: ``y + dt * sum_j b_j k_j``, zeros skipped."""
    n_rows = len(y)
    ks = []
    for stage in range(n_stages):
        if stage == 0:
            y_stage = y
        else:
            coeffs = a[stage - 1]
            y_stage = [
                y[r] + dt * sum(coeffs[j] * ks[j][r] for j in range(stage) if coeffs[j] != 0.0)
                for r in range(n_rows)
            ]
        ks.append(rhs(y_stage, p, t + c[stage] * dt))
    return [
        y[r] + dt * sum(b[j] * ks[j][r] for j in range(n_stages) if b[j] != 0.0)
        for r in range(n_rows)
    ]


def _rk_embedded_step_rows(rhs, y, p, t, dt, a, b, e, c, n_stages, f0=None):
    """One embedded FSAL RK attempt on rows: ``(y_new, err_rows, k_last)``.

    The last stage is ``f(t + dt, y_new)`` (``b[last] == 0``), which is the
    next attempt's first stage after an accept. ``f0``, when given, is the
    first stage ``f(t, y)`` carried from before (exact after a reject too,
    since ``(t, y)`` is unchanged). Same expression order and skipped zero
    coefficients as the JAX ``_rk_embedded_step_rows``.
    """
    n_rows = len(y)
    n_sub = n_stages - 1
    ks = []
    for stage in range(n_sub):
        if stage == 0:
            if f0 is not None:
                ks.append(list(f0))
                continue
            y_stage = y
        else:
            coeffs = a[stage - 1]
            y_stage = [
                y[r] + dt * sum(coeffs[j] * ks[j][r] for j in range(stage) if coeffs[j] != 0.0)
                for r in range(n_rows)
            ]
        ks.append(rhs(y_stage, p, t + c[stage] * dt))
    y_new = [
        y[r] + dt * sum(b[j] * ks[j][r] for j in range(n_sub) if b[j] != 0.0)
        for r in range(n_rows)
    ]
    k_last = list(rhs(y_new, p, t + c[n_stages - 1] * dt))
    ks.append(k_last)
    err = [
        dt * sum(e[j] * ks[j][r] for j in range(n_stages) if e[j] != 0.0)
        for r in range(n_rows)
    ]
    return y_new, err, k_last


def _check_save_rows(save_rows, n_rows) -> tuple[int, ...]:
    """Normalise and validate a ``save_rows`` selection to a tuple."""
    if save_rows is None:
        return tuple(range(n_rows))
    rows = tuple(int(r) for r in save_rows)
    if not rows:
        raise ValueError("save_rows must select at least one row")
    for r in rows:
        if not 0 <= r < n_rows:
            raise ValueError(f"save_rows index {r} out of range for {n_rows} state rows")
    return rows


def _pad_save_rows(picked: torch.Tensor) -> torch.Tensor:
    """The kernel's 8-row padded save layout (zero padding rows)."""
    n_saves, n_save, batch = picked.shape
    s_pad = _pad8(n_save)
    if s_pad == n_save:
        return picked
    pad = torch.zeros((n_saves, s_pad - n_save, batch), dtype=picked.dtype, device=picked.device)
    return torch.cat([picked, pad], dim=1)


def select_saves(full: torch.Tensor, save_rows, save_dtype, padded_rows: bool) -> torch.Tensor:
    """The plain version's full ``(n_saves, R, B)`` saves cut to what the
    kernel returns: ``save_rows`` in order, in ``save_dtype``, padded to 8
    rows when ``padded_rows``."""
    picked = full[:, list(save_rows), :].to(save_dtype)
    return _pad_save_rows(picked) if padded_rows else picked


def _grid(duration: float, dt: float, save_every: float) -> tuple[int, int]:
    """``(n_steps, save_stride)``; raises unless both are whole."""
    n_steps = int(round(duration / dt))
    save_stride = int(round(save_every / dt))
    if abs(n_steps * dt - duration) > 1e-9 * max(1.0, abs(duration)):
        raise ValueError("duration must be a whole number of dt steps")
    if n_steps % save_stride:
        raise ValueError("save_every must divide duration into whole strides")
    return n_steps, save_stride


def _step_time(t0: float, step: int, dt: float, device) -> torch.Tensor:
    """Float32 start time of step ``step`` (1-based): ``t0 + (step - 1) * dt``."""
    t = np.float32(t0) + np.float32(step - 1) * np.float32(dt)
    return torch.tensor(t, dtype=torch.float32, device=device)


def check_block_b(block_b: int | None) -> None:
    """Accept the JAX entry points' ``block_b`` (the lane-block width of a
    TPU grid step) and reject a non-positive one. The port's constant-step
    kernels pick their own width and mask the ragged last block, so the
    value changes nothing else: unlike the JAX kernels, no
    ``batch % block_b`` constraint applies."""
    if block_b is not None and int(block_b) <= 0:
        raise ValueError(f"block_b must be positive, got {block_b}")


def _float_rows(y0_rows, p_rows):
    """``y0_rows`` ``(R, B)`` and ``p_rows`` ``(P, B)`` in float32 (no
    parameter rows for None)."""
    y0_rows = torch.as_tensor(y0_rows).to(torch.float32)
    if y0_rows.ndim != 2:
        raise ValueError(f"y0_rows must be (R, B), got {tuple(y0_rows.shape)}")
    if p_rows is None:
        p_rows = torch.zeros((0, y0_rows.shape[1]), dtype=torch.float32, device=y0_rows.device)
    return y0_rows, torch.as_tensor(p_rows).to(torch.float32)


def solve_args(y0_rows, p_rows=None, *, duration, dt, save_every=1.0, method="tsit5", t0=0.0,
               save_dtype=torch.float32, save_rows=None, padded_rows=False, block_b=None):
    """:func:`ensemble_solve_kernel`'s checks of its arguments, none of
    which depends on the batch width (``ValueError`` with the value):
    ``(y0_rows, p_rows, (n_steps, save_stride), save_rows)``."""
    check_block_b(block_b)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {list(METHODS)}")
    if save_dtype not in SAVE_DTYPES:
        raise ValueError(f"save_dtype must be one of {SAVE_DTYPES}, got {save_dtype}")
    y0_rows, p_rows = _float_rows(y0_rows, p_rows)
    grid = _grid(duration, dt, save_every)
    return y0_rows, p_rows, grid, _check_save_rows(save_rows, y0_rows.shape[0])


def adaptive_solve_args(y0_rows, p_rows=None, *, duration, save_every=1.0, rtol=1e-4, atol=1e-6, dt0=None,
                        steps_per_save=8, block_b=None, method="bosh3", save_dtype=torch.float32, t0=0.0,
                        save_rows=None, padded_rows=False):
    """:func:`ensemble_solve_kernel_adaptive`'s checks of its arguments,
    none of which depends on the batch width (``ValueError`` with the
    value): ``(y0_rows, p_rows, n_saves, save_rows, block_b)``."""
    if method not in ADAPTIVE_METHODS:
        raise ValueError(f"unknown method {method!r}; one of {list(ADAPTIVE_METHODS)}")
    if save_dtype not in SAVE_DTYPES:
        raise ValueError(f"save_dtype must be one of {SAVE_DTYPES}, got {save_dtype}")
    y0_rows, p_rows = _float_rows(y0_rows, p_rows)
    n_saves = int(round(duration / save_every)) + 1
    if abs((n_saves - 1) * save_every - duration) > 1e-9 * max(1.0, abs(duration)):
        raise ValueError("duration must be a whole number of save intervals")
    if n_saves < 2:
        raise ValueError("duration must cover at least one save interval")
    block_b = ADAPTIVE_BLOCK if block_b is None else int(block_b)
    if block_b < 16 or block_b > 1024 or block_b & (block_b - 1):
        # the kernel's rule (one member per thread), held on every device
        raise ValueError(f"block_b must be a power of two from 16 to 1024, got {block_b}")
    return y0_rows, p_rows, n_saves, _check_save_rows(save_rows, y0_rows.shape[0]), block_b


def ensemble_solve_kernel_reference(
    rhs, y0_rows, p_rows=None, *, duration, dt, save_every=1.0, method="tsit5", t0=0.0,
) -> torch.Tensor:
    """The plain version: the kernel's computation as a Python time loop.

    Runs on whatever device ``y0_rows`` is on and returns every row,
    ``(n_saves, R, B)`` float32. Step ``n`` starts at the float32 time
    ``t0 + (n - 1) * dt``, as in the kernel.
    """
    a, b, c, n_stages = METHODS[method]
    y0_rows = torch.as_tensor(y0_rows).to(torch.float32)
    n_rows, batch = y0_rows.shape
    device = y0_rows.device
    if p_rows is None:
        p_rows = torch.zeros((0, batch), dtype=torch.float32, device=device)
    p_rows = torch.as_tensor(p_rows).to(torch.float32)
    p = [p_rows[r] for r in range(p_rows.shape[0])]
    n_steps = int(round(duration / dt))
    save_stride = int(round(save_every / dt))
    n_saves = n_steps // save_stride + 1

    out = torch.empty((n_saves, n_rows, batch), dtype=torch.float32, device=device)
    out[0] = y0_rows
    rows = [y0_rows[r] for r in range(n_rows)]
    for step in range(1, n_steps + 1):
        t = _step_time(t0, step, dt, device)
        rows = _rk_step_rows(rhs, rows, p, t, dt, a, b, c, n_stages)
        if step % save_stride == 0:
            out[step // save_stride] = torch.stack(rows)
    return out


def ensemble_solve_kernel(
    rhs,
    y0_rows,
    p_rows=None,
    *,
    duration: float,
    dt: float,
    save_every: float = 1.0,
    method: str = "tsit5",
    t0: float = 0.0,
    save_dtype: torch.dtype = torch.float32,
    save_rows: Sequence[int] | None = None,
    padded_rows: bool = False,
    block_b: int | None = None,
) -> torch.Tensor:
    """Whole-solve ensemble of a rows-RHS on a uniform save grid.

    Parameters
    ----------
    rhs: a :class:`RowsRHS` (any rows callable on CPU tensors).
    y0_rows: ``(R, B)`` initial state (see :func:`pack_rows`).
    p_rows: ``(P, B)`` parameter rows, or None.
    duration, dt, save_every: ``duration/dt`` and ``save_every/dt`` whole.
    method: ``"tsit5"`` (default), ``"bosh3"`` or ``"rk4"``.
    t0: time of the first save.
    save_dtype: ``torch.float32`` or ``torch.bfloat16``; the solve is
        float32 either way, only the saves narrow.
    save_rows: rows to save, in this order (default: all R).
    padded_rows: return ``(n_saves, pad8(len(save_rows)), B)`` with zero
        padding rows, the JAX kernel's layout, instead of exact rows.
    block_b: the JAX keyword, accepted for its call form; a positive value
        changes nothing (:func:`check_block_b`).

    Returns ``(n_saves, len(save_rows), B)`` saves in ``save_dtype``.
    """
    y0_rows, p_rows, (n_steps, save_stride), save_rows = solve_args(
        y0_rows, p_rows, duration=duration, dt=dt, save_every=save_every, method=method,
        save_dtype=save_dtype, save_rows=save_rows, block_b=block_b)
    device = _device.common_device(y0_rows, p_rows)

    if not _device.uses_kernel(device):
        full = ensemble_solve_kernel_reference(
            rhs, y0_rows, p_rows, duration=duration, dt=dt,
            save_every=save_every, method=method, t0=t0,
        )
        return select_saves(full, save_rows, save_dtype, padded_rows)
    if not isinstance(rhs, RowsRHS):
        raise TypeError("a CUDA solve needs a RowsRHS with a Triton form, "
                        f"got {type(rhs).__name__}")
    from .generic_triton import launch_rk_solve

    return launch_rk_solve(
        rhs, y0_rows.contiguous(), p_rows.contiguous(), t0=float(t0), dt=float(dt),
        n_steps=n_steps, save_stride=save_stride, method=method,
        save_rows=save_rows, save_dtype=save_dtype, padded_rows=bool(padded_rows),
    )


def _save_ends(t0: float, save_every: float, n_saves: int) -> np.ndarray:
    """Float32 end of every save interval, as the JAX kernel computes it.

    Entry 0 is ``t0``; the first interval ends at ``float32(t0 + save_every)``
    (a Python double rounded once); interval ``s >= 2`` ends at
    ``float32(t0) + float32(s) * float32(save_every)`` in float32.
    """
    ends = np.float32(t0) + np.arange(n_saves, dtype=np.float32) * np.float32(save_every)
    ends[0] = np.float32(t0)
    if n_saves > 1:
        ends[1] = np.float32(t0 + save_every)
    return ends


def _adaptive_budgets(steps_per_save: int) -> tuple[int, int]:
    """``(first-interval attempts, attempts of every later interval)``."""
    k = int(steps_per_save)
    return max(4 * k, 32), k


def ensemble_solve_kernel_adaptive_reference(
    rhs, y0_rows, p_rows=None, *, duration, save_every=1.0, rtol=1e-4, atol=1e-6,
    dt0=None, steps_per_save=8, method="bosh3", t0=0.0, block_b=None,
):
    """The plain version of the adaptive solve: lockstep dt per lane block.

    The JAX ``ensemble_solve_kernel_adaptive_reference`` with one more
    argument, ``block_b``: members ``[i * block_b, (i + 1) * block_b)`` form
    block ``i``, which carries its own ``(t, dt, n_accepted, n_rejected,
    exhausted)`` chain, driven by the max over its own members of the
    scaled-RMS error norm. The last block may be short; its absent members
    are left out of the max. ``block_b=None`` (one block of the whole batch)
    is the JAX reference exactly, and any ``block_b`` reproduces the
    decisions of the kernel at that width.

    The blocks are vectorised: ``t``, ``dt`` and the counters are ``(nb,)``
    tensors, and an attempt is evaluated for every member and kept only
    where its block accepted. Attempts stop early once no block is active,
    which changes nothing, since an inactive attempt changes no state.

    Returns ``(saves, stats)``: ``(n_saves, R, B)`` float32 saves (NaN where
    a block did not reach the end of an interval) and ``(nb,)`` int32
    ``exhausted_intervals``, ``n_accepted`` and ``n_rejected``.
    """
    a, b, e, c, n_stages, err_order = ADAPTIVE_METHODS[method]
    y0_rows = torch.as_tensor(y0_rows).to(torch.float32)
    n_rows, batch = y0_rows.shape
    device = y0_rows.device
    if p_rows is None:
        p_rows = torch.zeros((0, batch), dtype=torch.float32, device=device)
    p_rows = torch.as_tensor(p_rows).to(torch.float32)
    p = [p_rows[r] for r in range(p_rows.shape[0])]
    n_saves = int(round(duration / save_every)) + 1
    k_first, k = _adaptive_budgets(steps_per_save)
    dt0 = float(save_every / 8.0 if dt0 is None else dt0)
    block_b = batch if block_b is None else int(block_b)
    nb = -(-batch // block_b)
    block_of = torch.arange(batch, device=device) // block_b  # member -> block

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    eps = f32(1e-6 * max(float(save_every), 1.0))
    ends = torch.as_tensor(_save_ends(t0, save_every, n_saves), device=device)
    i32 = dict(dtype=torch.int32, device=device)
    t = ends[0].expand(nb).clone()
    dt = f32(dt0).expand(nb).clone()
    na, nr, bad = (torch.zeros(nb, **i32) for _ in range(3))
    y = [y0_rows[r] for r in range(n_rows)]
    f = list(rhs(y, p, ends[0]))

    def block_max(norm_m):
        """Max over each block's own members; a NaN in a block wins."""
        padded = torch.zeros(nb * block_b, dtype=torch.float32, device=device)
        padded[:batch] = norm_m
        return padded.reshape(nb, block_b).amax(dim=1)

    out = torch.empty((n_saves, n_rows, batch), dtype=torch.float32, device=device)
    out[0] = y0_rows
    for s in range(1, n_saves):
        s_end = ends[s]
        for _ in range(k_first if s == 1 else k):
            remaining = s_end - t
            active = remaining > eps
            if not bool(active.any()):
                break
            dt_used = torch.minimum(dt, remaining)
            landing = dt_used >= remaining - eps
            y_new, err, k_last = _rk_embedded_step_rows(
                rhs, y, p, t[block_of], dt_used[block_of], a, b, e, c, n_stages, f0=f,
            )
            sq = None
            for r in range(n_rows):
                sc = atol + rtol * torch.maximum(y[r].abs(), y_new[r].abs())
                q = err[r] / sc
                sq = q * q if sq is None else sq + q * q
            norm = block_max(torch.sqrt(sq * (1.0 / n_rows)))
            ok = torch.isfinite(norm)
            safe = torch.maximum(norm, f32(1e-30))
            factor = torch.clip(0.9 * torch.exp(torch.log(safe) * (-1.0 / err_order)), 0.2, 10.0)
            factor = torch.where(ok, factor, f32(0.2))
            good = ok & (norm <= 1.0)
            acc = active & good
            dt_new = torch.where(landing & good, dt, dt_used * factor)
            dt = torch.where(active, dt_new, dt)
            acc_m = acc[block_of]
            y = [torch.where(acc_m, yn, yo) for yn, yo in zip(y_new, y)]
            f = [torch.where(acc_m, kn, fo) for kn, fo in zip(k_last, f)]
            t = torch.where(acc, torch.where(landing, s_end, t + dt_used), t)
            na = na + acc.to(torch.int32)
            nr = nr + (active & ~acc).to(torch.int32)
        reached = t >= s_end - eps
        bad = bad + (~reached).to(torch.int32)
        out[s] = torch.where(reached[block_of], torch.stack(y), f32(float("nan")))
    stats = {"exhausted_intervals": bad, "n_accepted": na, "n_rejected": nr}
    return out, stats


def ensemble_solve_kernel_adaptive(
    rhs,
    y0_rows,
    p_rows=None,
    *,
    duration: float,
    save_every: float = 1.0,
    rtol: float = 1e-4,
    atol: float = 1e-6,
    dt0: float | None = None,
    steps_per_save: int = 8,
    block_b: int | None = None,
    method: str = "bosh3",
    save_dtype: torch.dtype = torch.float32,
    t0: float = 0.0,
    save_rows: Sequence[int] | None = None,
    padded_rows: bool = False,
):
    """Adaptive (lockstep-dt) whole-solve ensemble of a rows-RHS.

    Embedded Bogacki-Shampine 3(2) (``"bosh3"``, the default) or Tsitouras
    5(4) (``"tsit5"``) with an I-controller: one dt per block of ``block_b``
    members, driven by the block's max of each member's scaled-RMS error
    ``sqrt(mean((err / (atol + rtol * max(|y|, |y_new|)))**2))``, with the
    step factor ``clip(0.9 * norm**(-1/err_order), 0.2, 10)``, clamped to land
    exactly on each save point. An interval gets ``steps_per_save`` attempts
    (the first ``max(4 * steps_per_save, 32)``); a block that runs out saves
    NaN for that interval and counts it in ``exhausted_intervals``.

    Parameters as :func:`ensemble_solve_kernel`, plus ``rtol``, ``atol``,
    ``dt0`` (default ``save_every / 8``), ``steps_per_save`` and ``block_b``
    (default :data:`ADAPTIVE_BLOCK`; a power of two from 16 to 1024; the
    batch need not be a multiple of it). ``atol``
    defaults to 1e-6, scaled for O(1) states; for ~1e3-scale populations
    use about 1e-3.

    Returns ``(saves, stats)``: saves ``(n_saves, len(save_rows), B)`` in
    ``save_dtype`` (padded to 8 rows with zeros when ``padded_rows``);
    ``stats`` holds per-block int32 tensors ``exhausted_intervals`` (nonzero
    means raise ``steps_per_save``), ``n_accepted`` and ``n_rejected``, of
    shape ``(ceil(B / block_b),)``.
    """
    y0_rows, p_rows, n_saves, save_rows, block_b = adaptive_solve_args(
        y0_rows, p_rows, duration=duration, save_every=save_every, block_b=block_b, method=method,
        save_dtype=save_dtype, save_rows=save_rows)
    if dt0 is None:
        dt0 = save_every / 8.0
    device = _device.common_device(y0_rows, p_rows)
    kw = dict(save_every=float(save_every), rtol=float(rtol), atol=float(atol),
              dt0=float(dt0), steps_per_save=int(steps_per_save), method=method,
              t0=float(t0))

    if not _device.uses_kernel(device):
        full, stats = ensemble_solve_kernel_adaptive_reference(
            rhs, y0_rows, p_rows, duration=duration, block_b=block_b, **kw,
        )
        return select_saves(full, save_rows, save_dtype, padded_rows), stats
    if not isinstance(rhs, RowsRHS):
        raise TypeError("a CUDA solve needs a RowsRHS with a Triton form, "
                        f"got {type(rhs).__name__}")
    from .generic_triton import launch_rk_solve_adaptive

    return launch_rk_solve_adaptive(
        rhs, y0_rows.contiguous(), p_rows.contiguous(), n_saves=n_saves,
        block_b=block_b, save_rows=save_rows, save_dtype=save_dtype,
        padded_rows=bool(padded_rows), **kw,
    )
