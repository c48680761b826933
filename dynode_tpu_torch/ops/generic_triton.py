"""Triton kernel: constant-step explicit RK of a rows-RHS over an ensemble.

Replaces the Pallas TPU kernel ``dynode_tpu/ops/generic_pallas.py::_solve_kernel``
(launched by ``_solve_pallas``, entry ``ensemble_solve_kernel``). It computes
what that kernel computes -- ``n_steps`` constant steps of Tsit5, Bosh3 or
RK4 on a user rows-RHS, saving the selected rows every ``save_stride`` steps,
optionally as bfloat16 -- with a Hopper shape rather than a block-by-block
copy:

- One program owns ``BLOCK`` members and each thread one member, for the
  whole solve. The R state rows, the stage rows and the P parameter rows are
  tuples of ``[BLOCK]`` tensors that Triton keeps in registers; the row and
  stage loops are ``tl.static_range`` and unroll, the time loop stays rolled.
  The RHS is a ``@triton.jit`` function passed as a constexpr and inlined,
  as Pallas traced the Python RHS into its kernel.
- What bounds it on the H100: float32 FMAs. HBM traffic is y0, the
  parameter rows and the save grid (at the main path: 6 bfloat16 rows plus
  2 zero padding rows per member per day) against about 1e3 flops per member
  per step, so the kernel is compute- and latency-bound. Everything but the
  saves stays in registers; saves are stores along the member axis, which
  neighbouring threads make coalesced, and the cast to bfloat16 happens in
  registers before the store.
- The 8-row padding of the save buffer was a Mosaic DMA constraint; here
  the padding rows are written as zeros only when ``padded_rows`` asks for
  that layout, and otherwise the output has exact rows (no post-kernel copy).
- The ragged last block is masked; there is no ``batch % block`` constraint.

Triton is imported inside the functions that build and launch the kernel,
never at import time; its compile cache goes under ``build/dynode_tpu_torch/``
of the checkout unless ``TRITON_CACHE_DIR`` is already set.
"""

from __future__ import annotations

import functools
import os

import torch

from .. import _device
from ..ode.solvers import METHODS
from . import _build
from .generic import _pad8

#: members per program (one per thread, BLOCK // 32 warps). A sweep on an
#: H100 80GB HBM3 at 700 W (multi-strain rows-RHS, 200 days at dt = 0.5,
#: c rows saved as bf16) gave at B = 9,984: 0.539 / 0.447 / 0.459 / 0.735 ms
#: for 32 / 64 / 128 / 256, and at B = 655,360: 11.91 / 11.85 / 11.93 /
#: 12.15 ms. 64 is the best at both widths.
BLOCK = 64


def _import_triton():
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_ROOT / "triton"))
    import triton
    import triton.language as tl

    return triton, tl


@functools.cache
def _kernel():
    """Build the jitted solve kernel (once per process)."""
    triton, tl = _import_triton()

    @triton.jit
    def rk_step(y, p, t, dt, RHS: tl.constexpr, C: tl.constexpr, R: tl.constexpr,
                A_TAB: tl.constexpr, B_TAB: tl.constexpr, C_TAB: tl.constexpr,
                NS: tl.constexpr):
        ks = ()
        for s in tl.static_range(NS):
            if s == 0:
                ys = y
            else:
                ys = ()
                for r in tl.static_range(R):
                    acc = tl.zeros_like(y[r])
                    for j in tl.static_range(s):
                        if A_TAB[s * NS + j] != 0.0:
                            acc = acc + A_TAB[s * NS + j] * ks[j][r]
                    ys = ys + (y[r] + dt * acc,)
            ks = ks + (RHS(ys, p, t + C_TAB[s] * dt, C),)
        out = ()
        for r in tl.static_range(R):
            acc = tl.zeros_like(y[r])
            for j in tl.static_range(NS):
                if B_TAB[j] != 0.0:
                    acc = acc + B_TAB[j] * ks[j][r]
            out = out + (y[r] + dt * acc,)
        return out

    @triton.jit
    def save(out_ptr, y, slot, batch, offs, mask, SAVE_ROWS: tl.constexpr,
             N_SAVE: tl.constexpr, S_ROWS: tl.constexpr):
        base = out_ptr + slot.to(tl.int64) * S_ROWS * batch
        for j in tl.static_range(N_SAVE):
            tl.store(base + j * batch + offs,
                     y[SAVE_ROWS[j]].to(out_ptr.dtype.element_ty), mask=mask)
        for j in tl.static_range(N_SAVE, S_ROWS):
            tl.store(base + j * batch + offs,
                     tl.zeros_like(y[0]).to(out_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def solve(y_ptr, p_ptr, out_ptr, batch, t0, dt, n_steps, save_stride,
              RHS: tl.constexpr, C: tl.constexpr, R: tl.constexpr, P: tl.constexpr,
              A_TAB: tl.constexpr, B_TAB: tl.constexpr, C_TAB: tl.constexpr,
              NS: tl.constexpr, SAVE_ROWS: tl.constexpr, N_SAVE: tl.constexpr,
              S_ROWS: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < batch
        y = ()
        for r in tl.static_range(R):
            y = y + (tl.load(y_ptr + r * batch + offs, mask=mask, other=1.0),)
        p = ()
        for r in tl.static_range(P):
            p = p + (tl.load(p_ptr + r * batch + offs, mask=mask, other=1.0),)
        save(out_ptr, y, tl.program_id(0) * 0, batch, offs, mask, SAVE_ROWS, N_SAVE, S_ROWS)
        for step in range(1, n_steps + 1):
            t = t0 + (step - 1).to(tl.float32) * dt
            y = rk_step(y, p, t, dt, RHS, C, R, A_TAB, B_TAB, C_TAB, NS)
            if step % save_stride == 0:
                save(out_ptr, y, step // save_stride, batch, offs, mask,
                     SAVE_ROWS, N_SAVE, S_ROWS)

    return triton, solve


def _stage_matrix(a, n_stages: int) -> tuple[float, ...]:
    """``a`` as a flat ``n_stages x n_stages`` tuple: entry ``s * n + j`` is
    the weight of stage j in the input of stage s (row 0 empty, zero-padded).

    Triton takes a flat tuple of floats as one constexpr argument.
    """
    flat = [0.0] * (n_stages * n_stages)
    for s in range(1, n_stages):
        for j, coeff in enumerate(a[s - 1]):
            flat[s * n_stages + j] = float(coeff)
    return tuple(flat)


def launch_rk_solve(
    rhs,
    y0_rows: torch.Tensor,
    p_rows: torch.Tensor,
    *,
    t0: float,
    dt: float,
    n_steps: int,
    save_stride: int,
    method: str,
    save_rows: tuple[int, ...],
    save_dtype: torch.dtype,
    padded_rows: bool,
) -> torch.Tensor:
    """Launch the Triton solve on contiguous float32 CUDA rows.

    ``rhs`` is a :class:`~dynode_tpu_torch.ops.generic.RowsRHS`. Adds one to
    ``launch_rk_solve.launches`` per launch.
    """
    device = _device.require_hopper(y0_rows.device)
    n_rows, batch = y0_rows.shape
    n_params = p_rows.shape[0]
    if p_rows.shape != (n_params, batch):
        raise ValueError(f"p_rows {tuple(p_rows.shape)} does not match y0_rows {tuple(y0_rows.shape)}")
    for t in (y0_rows, p_rows):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError("rows must be contiguous float32 on one CUDA device")
    a, b, c, n_stages = METHODS[method]
    n_save = len(save_rows)
    s_rows = _pad8(n_save) if padded_rows else n_save
    n_saves = n_steps // save_stride + 1
    out = torch.empty((n_saves, s_rows, batch), dtype=save_dtype, device=device)
    # a kernel needs a valid pointer even when there are no parameter rows
    p_arg = p_rows if n_params else y0_rows
    triton, solve = _kernel()
    with torch.cuda.device(device):
        solve[(triton.cdiv(batch, BLOCK),)](
            y0_rows, p_arg, out, batch, t0, dt, n_steps, save_stride,
            RHS=rhs.triton_fn(), C=rhs.consts, R=n_rows, P=n_params,
            A_TAB=_stage_matrix(a, n_stages),
            B_TAB=tuple(b[:n_stages]), C_TAB=tuple(c[:n_stages]), NS=n_stages,
            SAVE_ROWS=save_rows, N_SAVE=n_save, S_ROWS=s_rows, BLOCK=BLOCK,
            num_warps=BLOCK // 32,
        )
    launch_rk_solve.launches += 1
    return out


launch_rk_solve.launches = 0


__all__ = ["BLOCK", "launch_rk_solve"]
