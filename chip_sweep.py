#!/usr/bin/env python3
"""Block-width sweeps of the port's adaptive kernels, the two multi-strain
kernels' team and block widths, and the SEIP kernels' widths, on one H100.

    python3 chip_sweep.py              # everything
    python3 chip_sweep.py generic      # the adaptive generic kernel's register caps only
    python3 chip_sweep.py multistrain  # the two multi-strain kernels only
    python3 chip_sweep.py seip         # the SEIP part only
    python3 chip_sweep.py shapes       # the multi-strain shape builds' nvcc times only

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
times the two multi-strain kernels (the row kernel
``csrc/multistrain_tsit5.cu`` and the 2-D kernel
``csrc/multistrain_tsit5_2d.cu``, 200 days at dt = 0.5) at every team
width the launchers may pick (one lane per member, one per age) and 64,
128 and 256 threads a block: at (A, K) = (2, 3) for B = 9,984 (the main
path), 39,936, 65,536, 98,304, 163,840 and 655,360, and at (3, 2) for
B = 9,984, in turns (the variants in order, then in reverse, twice; CUDA
events over 5 launches each). It prints each variant's median, the teams
the launchers pick and every instantiation's registers, spills and
static SASS mix, and holds each variant's saves to the first variant's
(1e-5 of the largest value; past 8,192 members on the first and last
4,096). Last, on the SEIP main path of ``chip_smoke.py``
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

``shapes`` builds the two multi-strain kernels' shape builds
(``ops/_build.py``, one unit a shape and kernel: the library's templates
instantiated at the shape) one at a time, at (A, K) = ``SHAPE_LADDER``,
from 52 state rows up to ``ops/multistrain.py::MAX_ROWS``, and prints each
nvcc's wall time and each instantiation's registers and spills: the cost
that sets the limit. It is not part of the default run.

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

    if sys.argv[1:] == ["multistrain"]:
        return multistrain_sweep(dev, smi)
    if sys.argv[1:] == ["shapes"]:
        return shapes_sweep(smi)
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
    multistrain_sweep(dev, smi)
    return seip_sweep(dev, smi)


MS_WIDTHS = {(2, 3): (9984, 39936, 65536, 98304, 163840, 655360), (3, 2): (9984,)}
MS_THREADS = (64, 128, 256)
MS_SAMPLE = 4096  # members compared at each end of the widest batch


def multistrain_sweep(dev, smi) -> int:
    """The two multi-strain kernels at every team and block width, in turns."""
    import torch

    from dynode_tpu_torch.models import multistrain as model
    from dynode_tpu_torch.ops import _build
    from dynode_tpu_torch.ops import multistrain as ms

    other = dict(r0s=(2.0, 2.5), tinf=(7.0, 6.0), tlat=(3.0, 2.5), twane=(60.0, 80.0), demo=(0.4, 0.4, 0.2))
    kernels = (("multistrain_tsit5", ms.launch_multistrain_tsit5, ms.pack_state, ms.pack_params),
               ("multistrain_tsit5_2d", ms.launch_multistrain_tsit5_2d, ms.pack_state_2d, ms.pack_rates_2d))
    for (n_age, n_strain), widths in MS_WIDTHS.items():
        if (n_age, n_strain) == (ms.A_DIM, ms.K_DIM):
            params = model.multistrain_default_params(device=dev)
            y0 = model.multistrain_initial_state(device=dev)
        else:
            params = model.multistrain_default_params(other["r0s"], other["tinf"], other["tlat"],
                                                      other["twane"], n_age=n_age, device=dev)
            y0 = model.multistrain_initial_state(other["r0s"], other["demo"], device=dev)
        for batch in widths:
            scales = np.clip(np.random.default_rng(1).normal(1.0, 0.15, batch), 0.6, 1.6)
            beta = params.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32, device=dev)[:, None]
            rates = (beta, params.sigma, params.gamma, params.omega)
            grid = dict(dt=0.5, n_steps=int(2 * DAYS), save_stride=2, n_age=n_age, n_strain=n_strain)
            for name, launch, pack_y, pack_p in kernels:
                y = pack_y(y0, batch, n_age, n_strain)
                p = (pack_p(*rates, batch, n_strain) if pack_p is ms.pack_params
                     else pack_p(*rates, batch, n_age, n_strain))
                variants = {(team, threads): functools.partial(launch, y, p, params.contact_matrix,
                                                               team=team, threads=threads, **grid)
                            for team in ms.teams(n_age) for threads in MS_THREADS}
                first, diffs = None, {}
                for key, solve in variants.items():  # build, and hold every variant to the first
                    out = solve()
                    if batch > MS_SAMPLE * 2:
                        out = torch.cat([out[..., :MS_SAMPLE], out[..., -MS_SAMPLE:]], -1)
                    if first is None:
                        first = out
                    diffs[key] = (float((out - first).abs().max() / first.abs().max()),
                                  torch.equal(out, first))
                    del out
                    if diffs[key][0] > 1e-5:
                        raise RuntimeError(f"{name} team {key[0]} threads {key[1]} B={batch}: "
                                           f"rel diff {diffs[key][0]:.3e} from the first variant")
                del first
                times = {key: [] for key in variants}
                order = list(variants)
                for _ in range(2):
                    for key in order + order[::-1]:
                        times[key].append(_event_ms(variants[key]))
                for (team, threads), ts in times.items():
                    rel, same = diffs[(team, threads)]
                    print(f"{name} (A,K)=({n_age},{n_strain}) B={batch} team {team} threads {threads:3d}: "
                          f"median {statistics.median(ts):.3f} ms of {len(ts)} (min {min(ts):.3f}, max "
                          f"{max(ts):.3f}), in turns; vs the first variant rel {rel:.2e}, bit for bit "
                          f"{same} [{smi}]", flush=True)
                print(f"{name} (A,K)=({n_age},{n_strain}) B={batch}: the launcher picks team "
                      f"{ms.pick_team(batch, n_age)}, threads {ms.THREADS}", flush=True)
    facts = ms.compile_facts(_build.build_log(), _build.sass_counts(_build.library_path(), match="multistrain_"))
    for label, f in sorted(facts.items()):
        print(f"{label}: registers {f.get('registers')}, spill stores {f.get('spill_stores')} B, "
              f"loads {f.get('spill_loads')} B; static SASS {f['sass'] or 'not available'}")
    return 0


#: (A, K) of the shape-build ladder: 52, 136, 208, 232 and 245 state rows
SHAPE_LADDER = ((4, 3), (8, 4), (16, 3), (8, 7), (5, 12))


def shapes_sweep(smi) -> int:
    """nvcc's wall time of each multi-strain shape build of the ladder, one
    at a time, with its instantiations' registers and spills."""
    from dynode_tpu_torch.ops import _build
    from dynode_tpu_torch.ops import multistrain as ms

    for a, k in SHAPE_LADDER:
        rows = a + 4 * a * k
        if rows > ms.MAX_ROWS:
            raise RuntimeError(f"({a}, {k}) has {rows} rows, past MAX_ROWS {ms.MAX_ROWS}")
        for kernel in ("multistrain_tsit5", "multistrain_tsit5_2d"):
            wall = _build.prebuild([(kernel, (a, k))])
            facts = ms.compile_facts(_build.shape_build_log(kernel, (a, k)), None)
            mine = {name: f for name, f in facts.items() if name.startswith(f"{kernel}_kernel<{a},{k},")}
            print(f"shape build {kernel} ({a}, {k}), {rows} rows: nvcc {wall:.1f} s (0 when built); {mine} [{smi}]")
    return 0


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
