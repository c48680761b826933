"""Whole-solve constant-step ensemble solve for any rows-RHS.

Port of the constant-step half of ``dynode_tpu/ops/generic_pallas.py``. The
rows contract is the JAX one::

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
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import _device
from ..ode.solvers import METHODS

__all__ = [
    "RowsRHS",
    "ensemble_solve_kernel",
    "ensemble_solve_kernel_reference",
    "pack_rows",
    "select_saves",
    "unpack_rows",
]

SAVE_DTYPES = (torch.float32, torch.bfloat16)


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

    Returns ``(n_saves, len(save_rows), B)`` saves in ``save_dtype``.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {list(METHODS)}")
    if save_dtype not in SAVE_DTYPES:
        raise ValueError(f"save_dtype must be one of {SAVE_DTYPES}, got {save_dtype}")
    y0_rows = torch.as_tensor(y0_rows).to(torch.float32)
    if y0_rows.ndim != 2:
        raise ValueError(f"y0_rows must be (R, B), got {tuple(y0_rows.shape)}")
    n_rows, batch = y0_rows.shape
    if p_rows is None:
        p_rows = torch.zeros((0, batch), dtype=torch.float32, device=y0_rows.device)
    p_rows = torch.as_tensor(p_rows).to(torch.float32)
    n_steps, save_stride = _grid(duration, dt, save_every)
    save_rows = _check_save_rows(save_rows, n_rows)
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
