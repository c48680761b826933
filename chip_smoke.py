#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``dynode_tpu_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card of compute
capability 9.0. It builds both kernels of the scenario-ensemble path from
the sources in the checkout (nvcc into ``build/dynode_tpu_torch/``, Triton's
JIT), then:

1. checks the card and prints ``nvidia-smi``'s name and power limit;
2. holds each kernel against its plain PyTorch version on the card
   (4,096 members, 200 days, dt = 0.5), and at 4,095 members, which is a
   multiple of neither kernel's block, so each runs its masked last block;
3. holds the CUDA kernel against an anchor independent of both versions,
   ``tests/golden/trajectories.npz`` (float64, adaptive);
4. drives the main path at full size -- the scenario ensemble of
   ``examples/ensemble_scenarios.py`` at B = 9,984 through the CUDA kernel,
   and the generic kernel on the same model's rows-RHS at B = 655,360 with
   bf16 observable-only saves -- and checks finiteness, mass conservation
   and that every kernel launched;
5. times each entry point and its plain version at the main path's shapes
   (host clock, median of 3 after a warm-up), and each kernel alone with
   CUDA events, and holds the main path's results from phase 4 against the
   plain version's at those shapes.

The last two lines are a JSON object per kernel and
``{"ok": true, "device": {...}}``. Any failed check raises: the script then
exits non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DAYS = 200.0
DT = 0.5
SLICE = 4096
RAGGED = SLICE - 1  # a multiple of neither the CUDA block (128) nor the Triton BLOCK (64)
ENSEMBLE = 9984
WIDE = 655360
SEED = 0

TOL_F32 = 1e-5  # max |kernel - plain| / max |plain|, float32 saves
TOL_BF16 = 1e-2  # the same with bf16 saves (one bf16 ulp is 2**-8)
TOL_GOLDEN = 1e-3  # c rows vs the float64 adaptive golden trajectory
TOL_MASS = 1e-4  # per-age s + sum e + sum i + sum r, relative to t = 0


class SmokeFailure(RuntimeError):
    """A check of the smoke run failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|), in float32."""
    got, want = got.float(), want.float()
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / float(want.abs().max())


def truncated_normal(rng, n, loc=1.0, scale=0.15, low=0.6, high=1.6) -> np.ndarray:
    """``n`` draws of TruncatedNormal(loc, scale, low, high) by rejection,
    the prior of ``examples/ensemble_scenarios.py``."""
    out = np.empty(0)
    while out.size < n:
        draw = rng.normal(loc, scale, 2 * n)
        out = np.concatenate([out, draw[(draw >= low) & (draw <= high)]])
    return out[:n]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (REPO / "dynode_tpu_torch").is_dir():
        print(f"chip_smoke: no dynode_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dynode_tpu_torch import _device
    from dynode_tpu_torch.models import multistrain as model
    from dynode_tpu_torch.ops import _build
    from dynode_tpu_torch.ops import generic as gen
    from dynode_tpu_torch.ops import generic_triton as gtri
    from dynode_tpu_torch.ops import multistrain as ms

    # ---- 1. the card -------------------------------------------------------
    dev = _device.require_hopper("cuda")
    kind = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index]
    print(smi)
    print(f"device: {kind}, capability {torch.cuda.get_device_capability(dev)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t = time.perf_counter()
    _build.load_library()
    print(f"build: nvcc {time.perf_counter() - t:.1f} s (0 when cached)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- inputs ------------------------------------------------------------
    rng = np.random.default_rng(SEED)
    base = model.multistrain_default_params(device=dev)
    y0 = model.multistrain_initial_state(device=dev)
    A, K = ms.A_DIM, ms.K_DIM
    D = A + 4 * A * K
    c_rows = tuple(range(D - A * K, D))
    rhs_ms = ms.multistrain_rows_rhs(base.contact_matrix)

    def scaled_beta(params, scales):
        return params.beta[None, :] * torch.as_tensor(scales, dtype=torch.float32, device=dev)[:, None]

    def sir_triton():
        import triton

        @triton.jit
        def sir(y, p, t, C):
            inf = p[0] * y[0] * y[1]
            rec = p[1] * y[1]
            return (-inf, inf - rec, rec)

        return sir

    def sir_torch(y, p, t):
        inf = p[0] * y[0] * y[1]
        rec = p[1] * y[1]
        return [-inf, inf - rec, rec]

    rhs_sir = gen.RowsRHS(sir_torch, sir_triton)
    errors = {"multistrain_tsit5": [], "rk_solve": []}

    def report(kernel, what, got, want, tol):
        abs_err, rel = rel_err(got, want)
        print(f"  {kernel} {what}: max rel err {rel:.3e} (tol {tol:.0e}), max abs {abs_err:.3e}")
        check(rel <= tol, f"{kernel} {what}: rel err {rel:.3e} > {tol:.0e}")
        if tol == TOL_F32:
            errors[kernel].append(abs_err)

    # ---- 2. kernels against their plain versions ---------------------------
    print(f"phase 2: kernel vs plain, B={SLICE}, {DAYS:.0f} days, dt={DT}")
    shapes = {
        (2, 3): (model.DEFAULT_R0S, model.DEFAULT_INFECTIOUS_PERIODS,
                 model.DEFAULT_LATENT_PERIODS, model.DEFAULT_WANING_PERIODS,
                 model.DEFAULT_AGE_DEMOGRAPHICS),
        (3, 2): ((2.0, 2.5), (7.0, 6.0), (3.0, 2.5), (60.0, 80.0), (0.4, 0.4, 0.2)),
    }
    scales_slice = rng.uniform(0.6, 1.6, SLICE)
    for (na, nk), (r0s, tinf, tlat, twane, demo) in shapes.items():
        p = model.multistrain_default_params(r0s, tinf, tlat, twane, n_age=na, device=dev)
        y = model.multistrain_initial_state(r0s, demo, device=dev)
        args = (y, scaled_beta(p, scales_slice), p.sigma, p.gamma, p.omega, p.contact_matrix)
        kw = dict(batch=SLICE, duration=DAYS, dt=DT, n_age=na, n_strain=nk)
        got = ms.ensemble_solve_tsit5(*args, **kw)
        want = ms.ensemble_solve_reference(*args, **kw)
        report("multistrain_tsit5", f"(A,K)=({na},{nk})", got, want, TOL_F32)
        if (na, nk) == (A, K):
            want_ms = want

    beta_slice = scaled_beta(base, scales_slice)
    y_ms = ms.pack_state(y0, SLICE)
    p_ms = ms.pack_params(beta_slice, base.sigma, base.gamma, base.omega, SLICE)
    y_sir = torch.tensor(np.stack([np.full(SLICE, 0.99), np.full(SLICE, 0.01), np.zeros(SLICE)]),
                         dtype=torch.float32, device=dev)
    p_sir = torch.tensor(np.stack([rng.uniform(0.2, 0.5, SLICE), np.full(SLICE, 0.1)]),
                         dtype=torch.float32, device=dev)
    for method in ("tsit5", "bosh3", "rk4"):
        for name, rhs, y, p in (("multistrain", rhs_ms, y_ms, p_ms), ("sir", rhs_sir, y_sir, p_sir)):
            kw = dict(duration=DAYS, dt=DT, method=method)
            got = gen.ensemble_solve_kernel(rhs, y, p, **kw)
            want = gen.ensemble_solve_kernel_reference(rhs, y, p, **kw)
            report("rk_solve", f"{method} {name}", got, want, TOL_F32)
            if (method, name) == ("tsit5", "multistrain"):
                full_rows_tsit5, want_rk = got, want
    obs_kw = dict(save_rows=c_rows, save_dtype=torch.bfloat16, padded_rows=True)
    got = gen.ensemble_solve_kernel(rhs_ms, y_ms, p_ms, duration=DAYS, dt=DT, **obs_kw)
    want = gen.select_saves(gen.ensemble_solve_kernel_reference(rhs_ms, y_ms, p_ms, duration=DAYS, dt=DT),
                            c_rows, torch.bfloat16, True)
    check(tuple(got.shape) == (int(DAYS) + 1, 8, SLICE), f"obs saves shape {tuple(got.shape)}")
    check(not got[:, len(c_rows):].any(), "padding rows of the obs saves are not zero")
    report("rk_solve", "c rows, bf16, padded", got[:, :len(c_rows)], want[:, :len(c_rows)], TOL_BF16)
    want_obs = want
    # the ragged width: the plain version works member by member, so its
    # first RAGGED columns above are the plain solve of the first RAGGED members
    got = ms.ensemble_solve_tsit5(y0, beta_slice[:RAGGED], base.sigma, base.gamma, base.omega,
                                  base.contact_matrix, batch=RAGGED, duration=DAYS, dt=DT)
    report("multistrain_tsit5", f"B={RAGGED}", got, want_ms[..., :RAGGED], TOL_F32)
    y_rag, p_rag = y_ms[:, :RAGGED].contiguous(), p_ms[:, :RAGGED].contiguous()
    got = gen.ensemble_solve_kernel(rhs_ms, y_rag, p_rag, duration=DAYS, dt=DT)
    report("rk_solve", f"tsit5 multistrain B={RAGGED}", got, want_rk[..., :RAGGED], TOL_F32)
    got = gen.ensemble_solve_kernel(rhs_ms, y_rag, p_rag, duration=DAYS, dt=DT, **obs_kw)
    check(not got[:, len(c_rows):].any(), f"padding rows not zero at B={RAGGED}")
    report("rk_solve", f"c rows, bf16, padded B={RAGGED}", got[:, :len(c_rows)],
           want_obs[:, :len(c_rows), :RAGGED], TOL_BF16)
    # the two kernels are independent implementations of the same solve
    k2 = ms.ensemble_solve_tsit5(y0, beta_slice, base.sigma, base.gamma, base.omega,
                                 base.contact_matrix, batch=SLICE, duration=DAYS, dt=DT)
    _, rel = rel_err(full_rows_tsit5, k2)
    print(f"  rk_solve tsit5 multistrain vs multistrain_tsit5: max rel err {rel:.3e} (tol {TOL_F32:.0e})")
    check(rel <= TOL_F32, f"the two kernels disagree: rel {rel:.3e}")

    # ---- 3. anchor independent of both versions ----------------------------
    golden = np.load(REPO / "tests" / "golden" / "trajectories.npz")["multistrain_c"]
    saves = ms.ensemble_solve_tsit5(y0, base.beta, base.sigma, base.gamma, base.omega,
                                    base.contact_matrix, batch=1, duration=300.0, dt=DT)
    c_member = ms.unpack_saves(saves)[4][:, 0].double().cpu().numpy()  # (301, A, K)
    gold_rel = float(np.max(np.abs(c_member - golden)) / np.max(np.abs(golden)))
    print(f"phase 3: scale-1.0 member, 300 days, c rows vs golden (float64 adaptive): "
          f"max rel err {gold_rel:.3e} (tol {TOL_GOLDEN:.0e})")
    check(gold_rel <= TOL_GOLDEN, f"golden anchor: rel err {gold_rel:.3e}")

    # ---- 4. the main path at full size -------------------------------------
    print(f"phase 4: main path, B={ENSEMBLE} (CUDA kernel) and B={WIDE} (Triton kernel)")
    scales = truncated_normal(rng, ENSEMBLE)
    scales_wide = truncated_normal(rng, WIDE)
    beta = scaled_beta(base, scales)
    beta_wide = scaled_beta(base, scales_wide)
    y_wide = ms.pack_state(y0, WIDE)
    p_wide = ms.pack_params(beta_wide, base.sigma, base.gamma, base.omega, WIDE)
    torch.cuda.synchronize()

    ms.launch_multistrain_tsit5.launches = 0
    gtri.launch_rk_solve.launches = 0
    saves = ms.ensemble_solve_tsit5(y0, beta, base.sigma, base.gamma, base.omega,
                                    base.contact_matrix, batch=ENSEMBLE, duration=DAYS, dt=DT)
    obs = gen.ensemble_solve_kernel(rhs_ms, y_wide, p_wide, duration=DAYS, dt=DT, **obs_kw)
    torch.cuda.synchronize()
    launches = {"multistrain_tsit5": ms.launch_multistrain_tsit5.launches,
                "rk_solve": gtri.launch_rk_solve.launches}
    print(f"  launches in the main path: {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel of the path did not launch: {launches}")

    check(tuple(saves.shape) == (int(DAYS) + 1, D, ENSEMBLE), f"saves shape {tuple(saves.shape)}")
    check(bool(torch.isfinite(saves).all()), f"non-finite saves at B={ENSEMBLE}")
    s, e, i, r, c = ms.unpack_saves(saves)
    mass = s + e.sum(-1) + i.sum(-1) + r.sum(-1)  # (T, B, A)
    drift = float(((mass - mass[0]).abs() / mass[0]).max())
    print(f"  B={ENSEMBLE}: {tuple(saves.shape)} f32 saves finite; per-age mass drift {drift:.3e} "
          f"(tol {TOL_MASS:.0e})")
    check(drift <= TOL_MASS, f"mass not conserved at B={ENSEMBLE}: {drift:.3e}")
    peak = torch.argmax(torch.diff(c.sum(dim=(2, 3)), dim=0), dim=0).cpu().numpy()
    print(f"  scenario ensemble: {ENSEMBLE} trajectories; epidemic peak day 5%/50%/95% = "
          f"{np.percentile(peak, [5, 50, 95])}")

    check(tuple(obs.shape) == (int(DAYS) + 1, 8, WIDE), f"obs saves shape {tuple(obs.shape)}")
    check(bool(torch.isfinite(obs).all()), f"non-finite saves at B={WIDE}")
    check(not obs[:, len(c_rows):].any(), f"padding rows not zero at B={WIDE}")
    # the obs run keeps c rows only: a second solve of the same members that
    # saves every row at t = 0 and t = DAYS checks their mass and final c
    ends = gen.ensemble_solve_kernel(rhs_ms, y_wide, p_wide, duration=DAYS, dt=DT, save_every=DAYS)
    wide_mass = ends[:, :A] + sum(ends[:, A + q * A * K:A + (q + 1) * A * K].reshape(2, A, K, WIDE).sum(2)
                                  for q in range(3))
    wide_drift = float(((wide_mass[1] - wide_mass[0]).abs() / wide_mass[0]).max())
    _, c_rel = rel_err(obs[-1, :len(c_rows)], ends[-1, list(c_rows)])
    print(f"  B={WIDE}: {tuple(obs.shape)} bf16 saves finite, padding zero; per-age mass drift "
          f"{wide_drift:.3e} (tol {TOL_MASS:.0e}); final c bf16 vs f32 rel {c_rel:.3e} (tol {TOL_BF16:.0e})")
    check(wide_drift <= TOL_MASS, f"mass not conserved at B={WIDE}: {wide_drift:.3e}")
    check(c_rel <= TOL_BF16, f"bf16 obs saves disagree with the f32 solve: {c_rel:.3e}")
    c_wide = obs[:, :len(c_rows)].float().sum(dim=1)  # (T, B)
    peak_wide = torch.argmax(torch.diff(c_wide, dim=0), dim=0).cpu().numpy()
    print(f"  wide ensemble: {WIDE} trajectories; peak day 5%/50%/95% = "
          f"{np.percentile(peak_wide, [5, 50, 95])}")
    del ends, s, e, i, r, c, mass

    # ---- 5. times, and the main path against the plain version ---------------
    def wall_ms(fn):
        """(wall ms of one call of ``fn``, its result)"""
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        float(out.reshape(-1)[-1])  # a host fetch of a scalar of the result
        return (time.perf_counter() - t) * 1e3, out

    def median_ms(fn):
        """(median wall ms of 3 calls after a warm-up, the last call's result)"""
        wall_ms(fn)  # warm-up
        walls = []
        for _ in range(3):
            wall, out = wall_ms(fn)
            walls.append(wall)
        return statistics.median(walls), out

    def event_ms(fn, n=5) -> float:
        """Device time of one launch: CUDA events around n launches."""
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    print(f"phase 5: times, median of 3 after a warm-up, on {smi}")
    ms_args = (y0, beta, base.sigma, base.gamma, base.omega, base.contact_matrix)
    ms_kw = dict(batch=ENSEMBLE, duration=DAYS, dt=DT)
    k_ms, _ = median_ms(lambda: ms.ensemble_solve_tsit5(*ms_args, **ms_kw))
    p_ms_, plain = median_ms(lambda: ms.ensemble_solve_reference(*ms_args, **ms_kw))
    report("multistrain_tsit5", f"main path B={ENSEMBLE}", saves, plain, TOL_F32)
    times = {"multistrain_tsit5": (k_ms, p_ms_, ENSEMBLE)}
    del saves, plain
    k_ms, _ = median_ms(lambda: gen.ensemble_solve_kernel(
        rhs_ms, y_wide, p_wide, duration=DAYS, dt=DT, **obs_kw))
    p_ms_, plain = median_ms(lambda: gen.select_saves(gen.ensemble_solve_kernel_reference(
        rhs_ms, y_wide, p_wide, duration=DAYS, dt=DT), c_rows, torch.bfloat16, True))
    report("rk_solve", f"main path B={WIDE}, c rows, bf16, padded", obs[:, :len(c_rows)],
           plain[:, :len(c_rows)], TOL_BF16)
    times["rk_solve"] = (k_ms, p_ms_, WIDE)
    del obs, plain
    n_steps, stride = int(round(DAYS / DT)), int(round(1.0 / DT))
    y_ens = ms.pack_state(y0, ENSEMBLE)
    p_ens = ms.pack_params(beta, base.sigma, base.gamma, base.omega, ENSEMBLE)
    contact = tuple(tuple(row) for row in base.contact_matrix.tolist())
    device_ms = {
        "multistrain_tsit5": event_ms(lambda: ms.launch_multistrain_tsit5(
            y_ens, p_ens, contact, dt=DT, n_steps=n_steps, save_stride=stride, n_age=A, n_strain=K)),
        "rk_solve": event_ms(lambda: gtri.launch_rk_solve(
            rhs_ms, y_wide, p_wide, t0=0.0, dt=DT, n_steps=n_steps, save_stride=stride,
            method="tsit5", save_rows=c_rows, save_dtype=torch.bfloat16, padded_rows=True)),
    }
    for name, (k_ms, p_ms_, b) in times.items():
        print(f"  {name} B={b}: entry point {k_ms:.3f} ms ({b / k_ms * 1e3:,.0f} traj/s), "
              f"kernel alone {device_ms[name]:.3f} ms (CUDA events), "
              f"plain {p_ms_:.1f} ms ({b / p_ms_ * 1e3:,.0f} traj/s) [{smi}]")

    check("jax" not in sys.modules, "jax was imported")
    meta = {
        "multistrain_tsit5": ("cuda", "dynode_tpu_torch/csrc/multistrain_tsit5.cu",
                              "dynode_tpu/ops/multistrain_pallas.py:195"),
        "rk_solve": ("triton", "dynode_tpu_torch/ops/generic_triton.py",
                     "dynode_tpu/ops/generic_pallas.py:236"),
    }
    kernels = [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": max(errors[name]),
         "ms": times[name][0], "plain_ms": times[name][1], "batch": times[name][2],
         "kernel_event_ms": device_ms[name]}
        for name, (route, source, replaces) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
