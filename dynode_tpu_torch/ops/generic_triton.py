"""Triton kernels: constant-step and adaptive explicit RK of a rows-RHS.

The constant-step kernel (``launch_rk_solve``):

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

The adaptive kernel (``launch_rk_solve_adaptive``) replaces
``dynode_tpu/ops/generic_pallas.py::_solve_kernel_adaptive`` (launched by
``_solve_pallas_adaptive``, entry ``ensemble_solve_kernel_adaptive``): an
embedded BS3(2) or Tsit5(4) pair, one dt per lane block driven by the
block's max scaled-RMS error norm, steps clamped to land on each save
point, an attempt budget per interval with NaN saves where it runs out, the
FSAL stage carried across attempts, and per-block statistics.

- One program owns ``block_b`` members, one per thread, and carries one
  scalar ``(t, dt, accepted, rejected, exhausted)`` chain with the state
  rows ``y`` and the FSAL rows ``f`` in registers for the whole solve. The
  one cross-member operation, the block max of the error norm, is one
  ``tl.max`` over the program's members per attempt.
- Inactive attempts are not run: the TPU kernel runs a fixed trip count of
  ``steps_per_save`` attempts per interval and masks those after the block
  has landed (``pl.when(active)``); here a scalar ``while`` loop runs only
  while the block has not landed and has attempts left. An inactive attempt
  changes no state, so the decisions are the same.
- NaN in the block max: ``jnp.max`` propagates a NaN norm (the step is then
  rejected with factor 0.2), but a Triton ``tl.max`` reduction may drop it.
  The kernel maps a norm that is NaN or inf to inf before the max, so the
  block's norm is inf exactly where the plain version's is not finite, and
  ``ok = norm < inf`` takes the same decision with one reduction.
- Masked lanes: members past ``batch`` load 1.0 and run the RHS on it; they
  enter the max as 0, so an RHS that gives NaN or inf there cannot reach
  the block's decisions, and they store nothing.
- Decisions are a discontinuous function of rounding: a norm that moves by
  one ulp across a threshold changes the number of steps of a block, and
  with it the whole path. On the SIR rows-RHS under tsit5, the first step's
  norm of most blocks sits near the value at which the ramp from ``dt0``
  takes two steps or three, and with FMA contraction a quarter of the
  blocks took another step than the plain version. So this kernel is
  compiled with ``enable_fp_fusion=False``, always:
  every product is rounded before it is added, as in the plain version and
  the JAX reference; divisions and square roots are IEEE (``tl.div_rn``,
  ``tl.sqrt_rn``) and the step factor uses libdevice ``exp``/``log``. The
  cost in time is in ``PERF.md``; ``chip_smoke.py`` requires every block's
  statistics to equal the plain version's.
- The interval ends are the plain version's float32 values, read from a
  small table (``generic._save_ends``): the first is ``float32(t0 +
  save_every)``, the others ``t0 + s * save_every`` in float32, with no FMA.
- What bounds it on the H100: float32 operations, issued without FMA
  contraction, so latency: each thread runs one long dependent chain and
  the SM needs many warps to hide it. Two choices keep the register file
  from limiting them. Each stage's error contribution is summed as the
  stage arrives (``embedded_stages``), in the plain version's order from
  zero, so the same rounding: stages 1 to NS - 2 die before the last RHS,
  and each row's error is finished and folded into the norm at once, so no
  error tuple exists. For bosh3 the live set at the last RHS is ``y``,
  ``f``, ``y_new`` and the partial error sums, 4R floats (it was 5R). And
  the registers are capped (:data:`ADAPTIVE_MAXNREG`, Triton's
  ``maxnreg``): at 168 a thread an SM holds 6 programs of 2 warps, where
  the uncapped bosh3 kernel (190 to 240 registers) fits 4 or 5; the main
  path's two builds (bf16 saves) do not spill. Off the main path, the
  float32 all-rows build spills 10 bytes under the cap and Tsit5, with
  more stages, 78. The compiled kernel's ``n_regs`` and ``n_spills`` are in
  ``kernel_info``, its static SASS mix from :func:`adaptive_sass_mix`.
- Statistics go to three ``(nb,)`` int32 rows; the JAX ``(nb, 8, 128)`` flag
  tile was a Mosaic layout.

Triton is imported inside the functions that build and launch the kernel,
never at import time; its compile cache goes under ``build/dynode_tpu_torch/``
of the checkout unless ``TRITON_CACHE_DIR`` is already set.
"""

from __future__ import annotations

import functools
import os

import torch

from .. import _device
from ..ode.solvers import ADAPTIVE_METHODS, METHODS
from . import _build
from .generic import _adaptive_budgets, _pad8, _save_ends

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

    # one compile serves every batch width (no divisibility specialisation)
    @triton.jit(do_not_specialize=["batch"])
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


@functools.cache
def _adaptive_kernel():
    """Build the jitted adaptive solve kernel (once per process)."""
    triton, tl = _import_triton()
    from triton.language.extra import libdevice

    @triton.jit
    def embedded_stages(y, f0, p, t, dt, RHS: tl.constexpr, C: tl.constexpr, R: tl.constexpr,
                        A_TAB: tl.constexpr, B_TAB: tl.constexpr, E_TAB: tl.constexpr,
                        C_TAB: tl.constexpr, NS: tl.constexpr):
        # stage 0 is the FSAL carry f(t, y); the caller evaluates stage NS - 1,
        # f(t + dt, y_new). Returns y_new and, per row, the error sum of the
        # stages before it, so no stage outlives this function.
        ks = (f0,)
        for s in tl.static_range(1, NS - 1):
            ys = ()
            for r in tl.static_range(R):
                acc = tl.zeros_like(y[r])
                for j in tl.static_range(s):
                    if A_TAB[s * NS + j] != 0.0:
                        acc = acc + A_TAB[s * NS + j] * ks[j][r]
                ys = ys + (y[r] + dt * acc,)
            ks = ks + (RHS(ys, p, t + C_TAB[s] * dt, C),)
        y_new = ()
        e_part = ()
        for r in tl.static_range(R):
            acc = tl.zeros_like(y[r])
            e_acc = tl.zeros_like(y[r])
            for j in tl.static_range(NS - 1):
                if B_TAB[j] != 0.0:
                    acc = acc + B_TAB[j] * ks[j][r]
                if E_TAB[j] != 0.0:
                    e_acc = e_acc + E_TAB[j] * ks[j][r]
            y_new = y_new + (y[r] + dt * acc,)
            e_part = e_part + (e_acc,)
        return y_new, e_part

    @triton.jit
    def save(out_ptr, y, slot, reached, batch, offs, mask, SAVE_ROWS: tl.constexpr,
             N_SAVE: tl.constexpr, S_ROWS: tl.constexpr):
        base = out_ptr + slot.to(tl.int64) * S_ROWS * batch
        for j in tl.static_range(N_SAVE):
            v = tl.where(reached, y[SAVE_ROWS[j]], float("nan"))
            tl.store(base + j * batch + offs, v.to(out_ptr.dtype.element_ty), mask=mask)
        for j in tl.static_range(N_SAVE, S_ROWS):
            tl.store(base + j * batch + offs,
                     tl.zeros_like(y[0]).to(out_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def select(cond, new, old, R: tl.constexpr):
        out = ()
        for r in tl.static_range(R):
            out = out + (tl.where(cond, new[r], old[r]),)
        return out

    @triton.jit(do_not_specialize=["batch", "n_saves", "n_blocks", "k_first", "k_rest"])
    def solve_adaptive(y_ptr, p_ptr, out_ptr, ends_ptr, stats_ptr, batch, n_saves, n_blocks,
                       dt0, rtol, atol, eps, k_first, k_rest,
                       RHS: tl.constexpr, C: tl.constexpr, R: tl.constexpr, P: tl.constexpr,
                       A_TAB: tl.constexpr, B_TAB: tl.constexpr, E_TAB: tl.constexpr,
                       C_TAB: tl.constexpr, NS: tl.constexpr, NEG_INV_ORDER: tl.constexpr,
                       INV_ROWS: tl.constexpr, SAVE_ROWS: tl.constexpr, N_SAVE: tl.constexpr,
                       S_ROWS: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < batch
        y = ()
        for r in tl.static_range(R):
            y = y + (tl.load(y_ptr + r * batch + offs, mask=mask, other=1.0),)
        p = ()
        for r in tl.static_range(P):
            p = p + (tl.load(p_ptr + r * batch + offs, mask=mask, other=1.0),)
        t = tl.load(ends_ptr)
        f = RHS(y, p, t, C)  # the FSAL carry, f(t0, y0)
        save(out_ptr, y, pid * 0, pid == pid, batch, offs, mask, SAVE_ROWS, N_SAVE, S_ROWS)
        dt = t * 0.0 + dt0
        n_acc = pid * 0
        n_rej = pid * 0
        n_bad = pid * 0
        for s in range(1, n_saves):
            s_end = tl.load(ends_ptr + s)
            k_att = tl.where(s == 1, k_first, k_rest)
            att = s * 0
            # an attempt runs only while the block is active (s_end - t > eps)
            while ((s_end - t) > eps) & (att < k_att):
                remaining = s_end - t
                dt_used = tl.minimum(dt, remaining)
                landing = dt_used >= remaining - eps
                y_new, e_part = embedded_stages(y, f, p, t, dt_used, RHS, C, R,
                                                A_TAB, B_TAB, E_TAB, C_TAB, NS)
                k_last = RHS(y_new, p, t + C_TAB[NS - 1] * dt_used, C)
                # each row's error is finished and folded into the sum at once
                sq = tl.zeros_like(y[0])
                for r in tl.static_range(R):
                    if E_TAB[NS - 1] != 0.0:
                        err = dt_used * (e_part[r] + E_TAB[NS - 1] * k_last[r])
                    else:
                        err = dt_used * e_part[r]
                    sc = atol + rtol * tl.maximum(tl.abs(y[r]), tl.abs(y_new[r]))
                    q = tl.div_rn(err, sc)
                    if r == 0:
                        sq = q * q
                    else:
                        sq = sq + q * q
                norm_m = tl.sqrt_rn(sq * INV_ROWS)
                # one block reduction: a NaN or inf norm counts as inf (it
                # wins the max, as NaN wins the plain version's), a masked
                # lane as 0
                norm_m = tl.where(norm_m < float("inf"), norm_m, float("inf"))
                norm = tl.max(tl.where(mask, norm_m, 0.0), axis=0)
                ok = norm < float("inf")
                safe = tl.maximum(norm, 1e-30)
                factor = 0.9 * libdevice.exp(libdevice.log(safe) * NEG_INV_ORDER)
                factor = tl.minimum(tl.maximum(factor, 0.2), 10.0)
                factor = tl.where(ok, factor, 0.2)
                good = ok & (norm <= 1.0)
                # an accepted step that landed was clamped short: keep dt
                dt = tl.where(landing & good, dt, dt_used * factor)
                t = tl.where(good, tl.where(landing, s_end, t + dt_used), t)
                y = select(good, y_new, y, R)
                f = select(good, k_last, f, R)
                n_acc += good.to(tl.int32)
                n_rej += (~good).to(tl.int32)
                att += 1
            reached = t >= s_end - eps
            n_bad += (~reached).to(tl.int32)
            save(out_ptr, y, s, reached, batch, offs, mask, SAVE_ROWS, N_SAVE, S_ROWS)
        tl.store(stats_ptr + pid, n_bad)
        tl.store(stats_ptr + n_blocks + pid, n_acc)
        tl.store(stats_ptr + 2 * n_blocks + pid, n_rej)

    return triton, solve_adaptive


#: register cap per thread of the adaptive kernel (Triton's ``maxnreg``), or
#: None for none. ``chip_sweep.py generic`` on an H100 80GB HBM3 at 700 W
#: (bosh3, multi-strain rows-RHS, 200 days, in turns) gave for none / 192 /
#: 168 / 144 / 128: at B = 655,360 with the c rows as bf16 (uncapped 190
#: registers, 5 programs an SM) 10.464 / 8.806 / 8.849 / 9.346 / 9.354 ms,
#: and at B = 163,840 with all rows as bf16 (uncapped 240, 4 programs)
#: 2.909 / 3.001 / 2.840 / 2.940 / 3.018 ms; 144 and 128 spill. 168 is the
#: best at the second width and 0.5% behind 192 at the first.
ADAPTIVE_MAXNREG = 168

#: ``n_regs``, ``n_spills`` and ``maxnreg`` of the last compiled adaptive
#: kernel, as Triton reports them, and its ``cubin``
kernel_info: dict = {}


def launch_rk_solve_adaptive(
    rhs,
    y0_rows: torch.Tensor,
    p_rows: torch.Tensor,
    *,
    n_saves: int,
    save_every: float,
    rtol: float,
    atol: float,
    dt0: float,
    steps_per_save: int,
    method: str,
    t0: float,
    block_b: int,
    save_rows: tuple[int, ...],
    save_dtype: torch.dtype,
    padded_rows: bool,
    maxnreg: int | None = ADAPTIVE_MAXNREG,
):
    """Launch the adaptive Triton solve on contiguous float32 CUDA rows.

    Returns ``(saves, stats)`` as
    :func:`~dynode_tpu_torch.ops.generic.ensemble_solve_kernel_adaptive`.
    ``maxnreg`` caps the registers per thread (None: no cap); it changes
    where values live, never the results. Adds one to
    ``launch_rk_solve_adaptive.launches`` per launch.
    """
    device = _device.require_hopper(y0_rows.device)
    n_rows, batch = y0_rows.shape
    n_params = p_rows.shape[0]
    if p_rows.shape != (n_params, batch):
        raise ValueError(f"p_rows {tuple(p_rows.shape)} does not match y0_rows {tuple(y0_rows.shape)}")
    for t in (y0_rows, p_rows):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError("rows must be contiguous float32 on one CUDA device")
    a, b, e, c, n_stages, err_order = ADAPTIVE_METHODS[method]
    n_save = len(save_rows)
    s_rows = _pad8(n_save) if padded_rows else n_save
    n_blocks = -(-batch // block_b)
    k_first, k_rest = _adaptive_budgets(steps_per_save)
    out = torch.empty((n_saves, s_rows, batch), dtype=save_dtype, device=device)
    stats = torch.empty((3, n_blocks), dtype=torch.int32, device=device)
    ends = torch.as_tensor(_save_ends(t0, save_every, n_saves), device=device)
    p_arg = p_rows if n_params else y0_rows
    triton, solve = _adaptive_kernel()
    with torch.cuda.device(device):
        compiled = solve[(n_blocks,)](
            y0_rows, p_arg, out, ends, stats, batch, n_saves, n_blocks,
            dt0, rtol, atol, 1e-6 * max(float(save_every), 1.0), k_first, k_rest,
            RHS=rhs.triton_fn(), C=rhs.consts, R=n_rows, P=n_params,
            A_TAB=_stage_matrix(a, n_stages), B_TAB=tuple(b[:n_stages]),
            E_TAB=tuple(e[:n_stages]), C_TAB=tuple(c[:n_stages]), NS=n_stages,
            NEG_INV_ORDER=-1.0 / err_order, INV_ROWS=1.0 / n_rows,
            SAVE_ROWS=save_rows, N_SAVE=n_save, S_ROWS=s_rows, BLOCK=block_b,
            num_warps=max(block_b // 32, 1),
            # no FMA contraction: the accept/reject decisions are then the
            # plain version's (with it, 16 of 64 blocks flipped; module note)
            enable_fp_fusion=False,
            **({} if maxnreg is None else {"maxnreg": maxnreg}),
        )
    kernel_info.update(n_regs=compiled.n_regs, n_spills=compiled.n_spills, maxnreg=maxnreg,
                       cubin=compiled.asm["cubin"])
    launch_rk_solve_adaptive.launches += 1
    names = ("exhausted_intervals", "n_accepted", "n_rejected")
    return out, dict(zip(names, stats))


launch_rk_solve_adaptive.launches = 0


def adaptive_sass_mix() -> dict[str, int] | None:
    """Static SASS instruction mix (:func:`._build.sass_mix`) of the last
    compiled adaptive kernel, from its cubin written under the build
    directory; None where no ``cuobjdump`` is found."""
    path = _build.BUILD_ROOT / "triton_sass" / "solve_adaptive.cubin"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(kernel_info["cubin"])
    mix = _build.sass_counts(path, match="solve_adaptive")
    return None if mix is None else mix["solve_adaptive"]


__all__ = ["ADAPTIVE_MAXNREG", "BLOCK", "adaptive_sass_mix", "kernel_info", "launch_rk_solve",
           "launch_rk_solve_adaptive"]
