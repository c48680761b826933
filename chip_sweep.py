#!/usr/bin/env python3
"""Block-width sweeps of the port's adaptive kernels, the two multi-strain
kernels in turns, and the SEIP kernels' widths, on one H100.

    python3 chip_sweep.py          # everything
    python3 chip_sweep.py generic  # the adaptive generic kernel's register caps only
    python3 chip_sweep.py seip     # the SEIP part only

Run from the root of a checkout on a machine with one CUDA card of compute
capability 9.0. It solves the two adaptive main paths of ``chip_smoke.py`` --
the multi-strain rows-RHS over 200 days, bosh3 at rtol 1e-4, atol 1e-6, at
B = 163,840 with all rows saved as bf16 and at B = 655,360 with the ``c``
rows as bf16 padded to 8 -- once for each lockstep block width ``block_b``
in 32, 64, 128 and 256. For each it prints the solve's time by CUDA events
(median of 3 after a warm-up), trajectories per second, the attempts and the
RHS evaluations counted from the statistics (``3 * attempts + n_blocks``)
and the exhausted intervals. The block's stiffest member sets its dt, so the
width changes the work as well as the parallelism. At the default width it
then sweeps the adaptive kernel's register cap (Triton's ``maxnreg``: none,
192, 168, 144, 128 at two warps a program) at both widths, in turns (the
caps in order, then in reverse, twice; CUDA events over 5 launches each),
prints each cap's median, ``n_regs``, ``n_spills`` and static SASS mix,
and checks that every cap gives the same saves and statistics. Then it
times the row kernel (``csrc/multistrain_tsit5.cu``) and the 2-D kernel
(``csrc/multistrain_tsit5_2d.cu``) at the main path's B = 9,984 in turns
(row, 2-D, 2-D, row; five rounds; CUDA events over 5 launches each) and
prints each one's median. Last, on the SEIP main path of ``chip_smoke.py``
(``bench_seip.py``'s production configuration, 200 days, scales
Uniform(0.85, 1.2)), it times the RK4 kernel (``csrc/seip_rk4.cu``, dt =
0.5, B = 32,768) with C saved in float32 at t = 0 and t = 200 only, then
daily, and with all four compartments daily in bf16, packed (the
differences are what the saves cost), with its registers and spills; and
the adaptive kernel (``csrc/seip_bs3.cu``) at every lockstep width it is
compiled for (rtol 1e-4, atol 1e-3, C saved in the packed layout): B =
32,768 in float32 and B = 65,536 in bf16, with its statistics. The RK4
kernel is compiled for one CTA width (``RK4_WIDTH``); to sweep others,
instantiate them in ``csrc/seip_rk4.cu`` for the run.

It imports no JAX and exits non-zero without a card.
"""

from __future__ import annotations

import functools
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WIDTHS_B = (163840, 655360)
DAYS = 200.0
WIDTHS = (32, 64, 128, 256)
MAXNREGS = (None, 192, 168, 144, 128)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_sweep: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dynode_tpu_torch import _device
    from dynode_tpu_torch.models import multistrain as model
    from dynode_tpu_torch.ops import generic as gen
    from dynode_tpu_torch.ops import generic_triton as gtri
    from dynode_tpu_torch.ops import multistrain as ms

    dev = _device.require_hopper("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index]
    print(smi)
    base = model.multistrain_default_params(device=dev)
    y0 = model.multistrain_initial_state(device=dev)
    rhs = ms.multistrain_rows_rhs(base.contact_matrix)
    n_rows = ms.D_ROWS
    c_rows = tuple(range(n_rows - ms.A_DIM * ms.K_DIM, n_rows))

    def inputs(batch: int):
        scales = np.clip(np.random.default_rng(0).normal(1.0, 0.15, batch), 0.6, 1.6)
        beta = base.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32, device=dev)[:, None]
        y = ms.pack_state(y0, batch)
        p = ms.pack_params(beta, base.sigma, base.gamma, base.omega, batch)
        kw = dict(duration=DAYS, rtol=1e-4, atol=1e-6, save_dtype=torch.bfloat16)
        if batch > 163840:
            kw.update(save_rows=c_rows, padded_rows=True)
        return y, p, kw

    def run(batch: int, block_b: int) -> None:
        y, p, kw = inputs(batch)
        solve = lambda: gen.ensemble_solve_kernel_adaptive(rhs, y, p, block_b=block_b, **kw)
        _, stats = solve()  # compile and warm up
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            solve()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        t = statistics.median(times)
        attempts = int((stats["n_accepted"] + stats["n_rejected"]).sum())
        n_blocks = stats["n_accepted"].shape[0]
        print(f"B={batch} {'c' if 'save_rows' in kw else 'all'} rows block_b {block_b:4d}: "
              f"{t:.3f} ms ({batch / t * 1e3:,.0f} traj/s), {attempts} attempts in {n_blocks} blocks, "
              f"{3 * attempts + n_blocks} RHS evaluations, rejected "
              f"{int(stats['n_rejected'].sum())}, exhausted {int(stats['exhausted_intervals'].sum())}, "
              f"n_regs {gtri.kernel_info['n_regs']}, n_spills {gtri.kernel_info['n_spills']} [{smi}]")

    def register_caps(batch: int) -> None:
        """The adaptive kernel at each cap of MAXNREGS, in turns."""
        y, p, kw = inputs(batch)
        rows = kw.get("save_rows", tuple(range(n_rows)))
        launch = dict(n_saves=int(DAYS) + 1, save_every=1.0, rtol=1e-4, atol=1e-6, dt0=1.0 / 8,
                      steps_per_save=8, method="bosh3", t0=0.0, block_b=gen.ADAPTIVE_BLOCK,
                      save_rows=rows, save_dtype=torch.bfloat16,
                      padded_rows=kw.get("padded_rows", False))
        solves = {cap: functools.partial(gtri.launch_rk_solve_adaptive, rhs, y, p, maxnreg=cap, **launch)
                  for cap in MAXNREGS}
        facts, first = {}, None
        for cap, solve in solves.items():  # compile, and hold every cap to the first one's results
            out, stats = solve()
            torch.cuda.synchronize()
            facts[cap] = (gtri.kernel_info["n_regs"], gtri.kernel_info["n_spills"], gtri.adaptive_sass_mix())
            if first is None:
                first = (out, stats)
            if not (torch.equal(out, first[0]) and all(torch.equal(stats[k], first[1][k]) for k in stats)):
                raise RuntimeError(f"maxnreg {cap} changed the results at B={batch}")
        attempts = int((first[1]["n_accepted"] + first[1]["n_rejected"]).sum())
        times = {cap: [] for cap in MAXNREGS}
        for _ in range(2):
            for cap in MAXNREGS + MAXNREGS[::-1]:
                times[cap].append(_event_ms(solves[cap]))
        for cap in MAXNREGS:
            n_regs, n_spills, mix = facts[cap]
            print(f"adaptive B={batch} {'c' if 'save_rows' in kw else 'all'} rows maxnreg {cap}: median "
                  f"{statistics.median(times[cap]):.3f} ms of {len(times[cap])} (min {min(times[cap]):.3f}, "
                  f"max {max(times[cap]):.3f}), in turns; {attempts} attempts, the same results at every "
                  f"cap; n_regs {n_regs}, n_spills {n_spills}; static SASS {mix} [{smi}]")

    if sys.argv[1:] == ["seip"]:
        return seip_sweep(dev, smi)
    if sys.argv[1:] != ["generic"]:
        for batch in WIDTHS_B:
            for block_b in WIDTHS:
                run(batch, block_b)
    for batch in WIDTHS_B:
        register_caps(batch)
    if sys.argv[1:] == ["generic"]:
        return 0

    n = 9984
    scales = np.clip(np.random.default_rng(1).normal(1.0, 0.15, n), 0.6, 1.6)
    beta = base.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32, device=dev)[:, None]
    contact = tuple(tuple(row) for row in base.contact_matrix.tolist())
    grid = dict(dt=0.5, n_steps=int(2 * DAYS), save_stride=2, n_age=ms.A_DIM, n_strain=ms.K_DIM)
    y_row = ms.pack_state(y0, n)
    p_row = ms.pack_params(beta, base.sigma, base.gamma, base.omega, n)
    y_2d = ms.pack_state_2d(y0, n)
    p_2d = ms.pack_rates_2d(beta, base.sigma, base.gamma, base.omega, n)
    kernels = {
        "row": lambda: ms.launch_multistrain_tsit5(y_row, p_row, contact, **grid),
        "2-D": lambda: ms.launch_multistrain_tsit5_2d(y_2d, p_2d, contact, **grid),
    }

    for fn in kernels.values():
        fn()  # build and warm up
    times = {name: [] for name in kernels}
    for _ in range(5):
        for name in ("row", "2-D", "2-D", "row"):
            times[name].append(_event_ms(kernels[name]))
    for name, ts in times.items():
        print(f"multi-strain {name} kernel, B={n}, {DAYS:.0f} days: median {statistics.median(ts):.3f} ms "
              f"of {len(ts)} (min {min(ts):.3f}, max {max(ts):.3f}), in turns [{smi}]")
    return seip_sweep(dev, smi)


def _event_ms(fn, reps=5) -> float:
    """Device time of one call: CUDA events around ``reps`` calls after one."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def seip_sweep(dev, smi) -> int:
    """The SEIP RK4 kernel's save costs and the adaptive kernel's widths."""
    import torch

    from dynode_tpu_torch.models import seip as seip_model
    from dynode_tpu_torch.ops import _build
    from dynode_tpu_torch.ops import seip as tsp

    params = seip_model.seip_default_params(True, device=dev)
    y0 = seip_model.seip_initial_state(True, device=dev)
    P = tsp.seip_static_params(params)
    scales = torch.as_tensor(np.random.default_rng(2).uniform(0.85, 1.2, (2, 32768)),
                             dtype=torch.float32, device=dev)
    kw = dict(dt=0.5, n_steps=400)
    ends_ms = _event_ms(lambda: tsp.launch_seip_rk4(y0, P, scales, save=(3,), save_dtype=torch.float32,
                                                    packed=False, save_stride=400, **kw))
    c_ms = _event_ms(lambda: tsp.launch_seip_rk4(y0, P, scales, save=(3,), save_dtype=torch.float32,
                                                 packed=False, save_stride=2, **kw))
    full4_ms = _event_ms(lambda: tsp.launch_seip_rk4(y0, P, scales, save=(0, 1, 2, 3),
                                                     save_dtype=torch.bfloat16, packed=True,
                                                     save_stride=2, **kw))
    resources = _build.ptxas_resources(_build.build_log())
    print(f"SEIP RK4 B=32768 width {tsp.RK4_WIDTH}: C saved at the ends only {ends_ms:.3f} ms, daily "
          f"C f32 {c_ms:.3f} ms, daily all four bf16 packed {full4_ms:.3f} ms (CUDA events, 5 "
          f"launches); {resources.get(f'seip_rk4_kernel<{tsp.RK4_WIDTH}>', {})} [{smi}]")
    for batch, save_dtype in ((32768, torch.float32), (65536, torch.bfloat16)):
        scales = torch.as_tensor(np.random.default_rng(2).uniform(0.85, 1.2, batch),
                                 dtype=torch.float32, device=dev)
        for block_b in tsp.ADAPTIVE_BLOCKS:
            def solve():
                return tsp.seip_ensemble_solve_adaptive(
                    y0, params, scales, duration=DAYS, rtol=1e-4, atol=1e-3, save=(3,),
                    save_dtype=save_dtype, packed=True, block_b=block_b)

            _, stats = solve()  # warm-up
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                solve()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            t = statistics.median(times)
            attempts = int((stats["n_accepted"] + stats["n_rejected"]).sum())
            rejected = int(stats["n_rejected"].sum())
            n_blocks = stats["n_accepted"].shape[0]
            print(f"SEIP B={batch} C {str(save_dtype).removeprefix('torch.')} block_b {block_b:2d}: "
                  f"{t:.3f} ms ({batch / t * 1e3:,.0f} traj/s), {attempts} attempts in {n_blocks} "
                  f"blocks ({attempts / n_blocks:.1f} per block), rejected {rejected}, "
                  f"exhausted {int(stats['exhausted_intervals'].sum())}, "
                  f"{resources.get(f'seip_bs3_kernel<{block_b}>', {})} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
