#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``dynode_tpu_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card of compute
capability 9.0. It builds the six kernels of the scenario-ensemble and SEIP
paths from the sources in the checkout (nvcc into ``build/dynode_tpu_torch/``, one
compile per CUDA source, all started together, beside phase 18's shape
builds; Triton's JIT), then:

1. checks the card and prints ``nvidia-smi``'s name and power limit;
2. holds the two constant-step kernels against their plain PyTorch versions
   on the card (4,096 members, 200 days, dt = 0.5), and at 4,095 members,
   which is a multiple of neither kernel's block, so each runs its masked
   last block; the CUDA kernel at 4,095 members at each team width its
   launcher may pick (one lane per member, one per age) and both shapes;
3. holds the CUDA kernel against an anchor independent of both versions,
   ``tests/golden/trajectories.npz`` (float64, adaptive);
4. drives their main path at full size -- the scenario ensemble of
   ``examples/ensemble_scenarios.py`` at B = 9,984 through the CUDA kernel,
   and the generic kernel on the same model's rows-RHS at B = 655,360 with
   bf16 observable-only saves -- and checks finiteness, mass conservation
   and that every kernel launched;
5. times each entry point and its plain version at the main path's shapes
   (host clock: entry points median of 3 after a warm-up, plain versions
   one call), and each kernel alone with
   CUDA events, and holds the main path's results from phase 4 against the
   plain version's at those shapes; prints the CUDA kernel's team width,
   block width, registers, spills and static SASS mix;
6. holds the adaptive kernel against its plain version at the same block
   width (bosh3 and tsit5; multi-strain at 4,096 and 4,095 members, SIR at
   4,096; c rows as bf16): every block must take the plain version's
   accept/reject decisions; checks its attempt budget (NaN slots equal the
   exhausted intervals) and its accuracy against the constant-step kernel
   at dt = 0.05;
7. holds the 2-D multi-strain kernel against its plain version and against
   the row kernel, at (2, 3) and (3, 2), 4,096 and 4,095 members (there at
   each team width);
8. drives the main path of those two -- the adaptive kernel at B = 163,840
   (all rows, bf16) and B = 655,360 (c rows, bf16), the 2-D kernel at
   B = 9,984 -- and checks finiteness, zero exhausted intervals, padding,
   mass conservation and that every kernel launched;
9. times them as phase 5 does and holds their main path against the plain
   versions; prints the adaptive kernel's registers, spills and static SASS
   instruction mix (Triton's compile facts, ``cuobjdump`` on its cubin) and
   the 2-D kernel's facts as phase 5 does;
10. holds the two SEIP kernels (the production SEIP model of
    ``bench_seip.py``, 640 floats per member) against their plain versions:
    the RK4 kernel's time table bit for bit, RK4 at 4,096 and 4,095 members
    (a ragged last CTA), BS3 at the same widths with the per-block
    gate of phase 6, every compartment in float32 over 200 days, bf16 saves,
    per-age mass conservation, the attempt budget, and BS3 against RK4 at
    dt = 0.05 on 1,024 members;
11. drives the SEIP main path at full width (``bench_seip.py``): RK4 at
    B = 32,768 with C in float32 and with all four compartments in bf16
    (packed), BS3 at B = 32,768 (C, float32) and 65,536 (C, bf16), and
    checks finiteness, zero exhausted intervals and that both kernels
    launched;
12. times the SEIP entry points, kernels and plain versions and holds the
    C-only main path against the plain versions; prints the SEIP kernels'
    registers and spills (ptxas) and static SASS instruction mix
    (``cuobjdump``, where the toolkit has it); then prints each kernel's
    work, counted from the plain versions' operations on this run's inputs
    (and, for the adaptive kernels, their statistics), and its bound on the
    card, and the RK4 kernel with all four compartments saved in bf16 beside
    its own bound;
13. drives the ODE engine and ``simulate`` (eager PyTorch on the card, no
    kernel of its own): (a) an adaptive float64 ``simulate`` of 300 days
    against ``tests/golden/trajectories.npz`` (``test_golden.py``'s bound),
    with the accepted and rejected steps of the same call on CPU tensors;
    (b) ``simulate_ensemble`` lane-major at B = 9,984, Tsit5 at dt = 0.5,
    against kernel #2 on the same inputs, and batch-leading against
    lane-major on 1,024 members; (c) ``bench_nuts.py``'s lane-major fit
    potential at its 4,096 chains (100 days), built as the bench builds it
    from the port's config and ``dist``: ``multistrain_config`` ->
    ``multistrain_odeparams``, a ``TruncatedNormal`` prior moved to
    unconstrained space by ``biject_to`` and its Jacobian, a centred
    ``Poisson`` likelihood, the chains drawn from the prior with a CUDA
    generator; finite, a float64 gradient on 4 chains against central
    differences, the forward and forward + backward times, the prior and
    Jacobian's share of them, peak memory, and, from ``torch.profiler``, the
    device's idle share of one forward and its kernel launches per step;
    (d) an exhausted step budget (result 1, NaN tail);
14. drives the configs to the kernels and ``dist`` on the card: (a)
    ``multistrain_odeparams(multistrain_config())`` equals
    ``multistrain_default_params()`` bit for bit, kernel #2 at B = 9,984
    gives equal saves from both, and the Poisson log-likelihood of its daily
    incidence matches the engine's likelihood term of 13 (c) on 64 chains
    (1e-5); (b) ``seip_config(seasonal_vaccination=True)`` ->
    ``seip_odeparams`` -> kernel #4 at B = 32,768 (draws from
    ``dist.Uniform(0.85, 1.2)`` on a CUDA generator) equals the same call on
    ``seip_default_params(True)`` bit for bit; (c) every family's
    ``log_prob`` on CUDA float64 tensors against the CPU (1e-12), and 2**20
    draws of each from a CUDA generator: in the support, equal bits from
    equal seeds, the sample mean (median for the Cauchy pair) within 5
    standard errors;
15. samples ``bench_nuts.py``'s fit on the card with the port's ``infer``
    (its own synthetic counts, ``tests/test_torch/golden/bench_nuts_obs.npz``,
    the model for names, transforms and inits a copy of its
    ``build_model()``, the potential 13 (c)'s): (a) the potential and
    gradient at 4,096 chains captured into a CUDA graph equal the eager
    call bit for bit; eager call (one, after the capture's warm-up) and
    replay times (median of 3) and the
    replay's device idle share (``torch.profiler``); (b) ``ChEES`` and (c)
    ``NUTS(dense_mass=True, max_tree_depth=3)`` at 4,096 chains,
    ``steps_per_call=16``, replaying that graph (``INFER_CHEES``,
    ``INFER_NUTS`` warmup and draws; (c)'s warmup holds a metric window):
    finite draws, posterior-mean drift from the true scales below 0.05
    (``bench_nuts.py``'s ``oneshot_ok`` gate), for (b) no stuck chain after
    rescue, for (c) the shares of stuck and of diverging chains within 5
    binomial standard errors of the JAX package's on the same schedule
    (``NUTS_REFERENCE``); wall, leapfrogs, divergences, split-Rhat, min
    ESS; (d) a NUTS and a ChEES transition and a 20-step NUTS warmup with
    its metric window at 4 chains in float64 on the card against CPU
    tensors, the draws recorded on the CPU and replayed, within 1e-10; (e)
    9,984 of (b)'s posterior draws through kernel #2 (200 days), 64 members
    against ``simulate`` within 1e-5. Phase 15 takes ``INFER_BUDGET_S`` or
    less;
16. runs the rest of inference on the card, on the same counts: (a)
    ``bench_nuts.py``'s ``run_oneshot`` row through ``MCMCProcess``
    (ChEES, 1,024 chains, 8 warmup + 8 draws, ``nuts_kwargs`` handing the
    kernel the batched potential, whose graph at this width is captured
    first and timed), ``get_samples``, ``to_arviz`` (posterior, sample
    stats, prior and posterior predictive through ``Predictive``, the
    pointwise log-likelihood), ``loo`` and ``waic`` with the Pareto-k
    shares, ``save_mcmc`` to a temporary directory, ``load_mcmc_warm_start``
    and a second ``infer(warm_start=...)`` of 8 draws: every draw finite,
    drift below 0.05 after each segment, the second segment's draws not
    the first's, finite estimates; (b) the forecast row: (a)'s draws
    resampled (``resample_draws``) to 9,984 members, kernel #2 over 200
    days, the daily incidence through ``member_quantiles`` at (0.05, 0.25,
    0.5, 0.75, 0.95): the bands within 1e-6 of ``numpy.quantile`` of the
    same saves on the host, ordered, kernel #2's launches counted on this
    path; (c) ``bench_nuts.py``'s ``bench_svi`` row: ``SVI(...,
    AutoMultivariateNormal, Adam(0.1), Trace_ELBO()).run_multistart`` at
    1,024 starts, ``SVI_EAGER_STEPS`` steps through the eager loop, then,
    from the same seed, ``SVI_STEPS`` (10) of the row's 300 steps
    replayed from the bank step's CUDA graph (the row's 300 extrapolated:
    all 300 took the script too close to its time limit), whose first
    losses must equal the eager ones bit for bit, then ``Predictive(guide, params,
    num_samples=2000)``: final ELBOs finite on 99% of the starts, start
    0's loss falls; the capture's wall (warm-up and capture), the eager
    and replayed steps' walls and ELBO-steps per second, the final ELBO's
    wall and the row's wall; the same fit again on the same ``SVI`` and
    ``obs``, from the kept bank (no capture), equal to the first run bit
    for bit and leaving its result as it was, with both walls and the
    memory reserved and allocated with the kept bank; on 4 starts, 3 steps and 4 days in float64
    the card's parameters (through the graph) equal the CPU's within
    1e-10 given the same draws. Phase 16 takes ``SLICE_BUDGET_S`` or
    less;
17. runs the stiff solvers and the mesh split on the card, over a mesh of
    every visible card (or the one card listed twice, whose shards then
    run in turn): (a) in float64, the stiff SEIRS of
    ``examples/seirs_stiff_waning.py`` through ``simulate`` with ``TRBDF2``
    (the example's tolerances and budget): result 0, the CPU's accepted
    and rejected steps and its saves within 1e-10, the example's bound
    against Tsit5 (budget 8,192, on the CPU) and under a quarter of its
    steps; ``ImplicitEuler`` at looser tolerances within ``TOL_IE`` of
    Tsit5; Robertson against scipy's Radau (rtol 5e-4, atol 1e-9, mass to
    1e-9); the multi-strain model at its published widths through
    ``simulate_ensemble`` of one member against Tsit5 (2e-5); a gradient
    through TRBDF2 against central differences; (b) 4,096 members of the
    stiff SEIRS in float32 over ``STIFF_ENSEMBLE_DAYS``, batch-leading:
    every result 0, ``STIFF_PICK`` (4) members held
    to single-member solves (1e-5, equal steps), wall, steps and the
    device's idle share; (c) the four split kernel entries (#1, #3, #4,
    #5) at ``obs_max``, ``adaptive_obs``, ``seip_c`` and
    ``seip_adaptive``'s widths, each bit for bit with the unsplit entry
    (the adaptive ones with equal statistics), a ragged adaptive split
    within the solve tolerance, walls and launches; (d)
    ``simulate_ensemble(mesh=)`` bit for bit on ``engine_lane_10k`` and
    (b)'s ensemble, ``MCMC(ChEES(...), mesh=)`` at 1,024 chains (the split
    potential and gradient against the unsplit graph at the initial and
    final positions), ``SVI.run_multistart(mesh=)`` at 1,024 starts
    over ``MESH_SVI_DAYS`` days (one graph of the bank step a shard)
    against the unsplit bank (one graph). Phase 17 takes ``MESH_BUDGET_S`` or less;
18. runs the kernels' other shapes, driven from the port's configs, on
    shape builds (``ops/_build.py``: a unit per kernel family and shape,
    compiled at first use) whose nvcc round starts beside the library's at
    the top of the script and is printed on its own: (a) kernels #4 and #5
    at ``seip_config()``'s default, (A, J, K, M, L) = (4, 4, 3, 4, 2) with
    no seasonal vaccination, and at a second shape, (2, 2, 3, 3, 1) with
    seasonal vaccination (``seip_shape_config``), through
    ``seip_ensemble_solve`` (RK4, dt = 0.5, C in float32) and
    ``seip_ensemble_solve_adaptive`` (BS3, C in bf16, packed) at
    ``SEIP_WIDE`` members over 200 days: finite, no exhausted interval,
    launches; on the first ``SHAPE_CHECK`` members over the first
    ``SHAPE_CHECK_DAYS`` days every compartment against the plain versions
    (RK4 within 1e-5, BS3 with every block's decisions equal), the main
    path's saves there bit for bit, the time table bit for bit, mass per
    age, BS3 against RK4 at dt = 0.05; (b)
    kernels #2 and #6 at four ages and three strains from
    ``multistrain_config`` (``multistrain_4x3_config``) at 9,984 members:
    finite, mass per age, padding rows zero, the first ``SHAPE_CHECK``
    members' first ``SHAPE_CHECK_DAYS`` days against the plain versions;
    (c) ``seip_ensemble_solve_sharded``
    at (a)'s default shape and the adaptive lane-major
    ``simulate_ensemble(mesh=)`` at 9,984 members, each over one card
    listed twice and bit for bit with its unsplit call. For each new
    instantiation it prints the kernel's time (CUDA events), bound, share
    of the bound, launches, registers and spills. Phase 18 takes
    ``SHAPES_BUDGET_S`` or less, its nvcc round apart.
19. runs every example of ``examples_torch/`` on the card through its
    ``run`` functions at the example's widths (``examples_phase``'s
    docstring has each check and cut): (a) the eight simulation examples
    at their own settings, each against the same call on CPU tensors; (b)
    ``ensemble_scenarios``' 4,096 members through kernel #2, held against
    its plain version on 1,024; (c) ``seip_forecast``'s 32,768 members
    through kernel #5 (bf16, packed), held against its plain version, its
    bands against ``numpy.quantile`` and its median against the data; (d)
    every fit's log density and gradient, card against CPU, a sampling call
    at the example's widths with its counts cut, every MCMC bank through
    the CUDA graph of its generic potential and every SVI fit through the
    graph of its step, and, at the example's own width and window, one
    gradient of each sampler's bank and one step of each SVI fit: eager,
    captured and replayed (bit for bit with the eager call), with the wall
    extrapolated to the example's own counts, the graphs' memory, and one
    fit's ``MCMC.run`` repeated on the same arguments from the kept cache
    entry, capturing nothing. Phase 19 takes ``EXAMPLES_BUDGET_S`` or less.

The last two lines are a JSON object per kernel and
``{"ok": true, "device": {...}}``. Any failed check raises: the script then
exits non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DAYS = 200.0
DT = 0.5
SLICE = 4096
RAGGED = SLICE - 1  # a multiple of no CUDA block or warp's members, nor of the Triton BLOCK (64)
ENSEMBLE = 9984
WIDE = 655360
SEED = 0

TOL_F32 = 1e-5  # max |kernel - plain| / max |plain|, float32 saves
TOL_BF16 = 1e-2  # the same with bf16 saves (one bf16 ulp is 2**-8)
TOL_GOLDEN = 1e-3  # c rows vs the float64 adaptive golden trajectory
TOL_MASS = 1e-4  # per-age s + sum e + sum i + sum r, relative to t = 0
MID = 163840  # the adaptive kernel's all-rows width (bench stage 3)
D2 = 40  # rows of the aligned 2-D layout at (A, K) = (2, 3) and (3, 2)
RTOL, ATOL = 1e-4, 1e-6  # the adaptive solve's tolerances on the main path
ADAPTIVE_STAGES = 4  # bosh3: 3 RHS evaluations per attempt (FSAL), 1 more per block
MIN_SAME = 0.99  # share of SEIP adaptive blocks whose stats must equal the plain version's
TOL_ADAPTIVE_ALL = 1e-3  # SEIP adaptive kernel vs plain over all blocks (a decision may flip)
TOL_ACCURACY = 5e-3  # adaptive vs dt = 0.05 constant step: max |d| / (1e-6 + |ref|)
SEIP_WIDE = 32768  # bench_seip.py's KERNEL_WIDE; the adaptive kernel also runs at twice it
SEIP_RTOL, SEIP_ATOL = 1e-4, 1e-3  # bench_seip.py's adaptive tolerances
TOL_SEIP_ACCURACY = 1e-2  # SEIP BS3 vs RK4 at dt = 0.05, C: max |d| / max |ref| (bench_seip.py)
FIT_CHAINS = 4096  # bench_nuts.py NUM_CHAINS
FIT_DAYS = 100  # bench_nuts.py DURATION
FIT_TRUE_SCALES = (1.1, 0.95, 1.05)  # bench_nuts.py's synthetic data
FIT_PRIOR = (1.0, 0.3, 0.5, 2.0)  # bench_nuts.py: TruncatedNormal(loc, scale, low, high) of the R0 scales
SCENARIO_PRIOR = (1.0, 0.15, 0.6, 1.6)  # examples/ensemble_scenarios.py's TruncatedNormal
LAYOUT_B = 1024  # batch-leading against lane-major
TOL_ENGINE = 1e-5  # simulate vs kernel #2 and layout vs layout: max |d| / max |ref|, float32
GOLDEN_RTOL, GOLDEN_ATOL = 1e-5, 1e-6  # tests/test_dynamics/test_golden.py, float64 adaptive
TOL_FD = 1e-4  # autograd vs central differences, float64: max |d| / max |fd|
FD_STEP = 1e-6
FIT_CHECK_CHAINS = 64  # kernel #2's likelihood against the engine's
INFER_CHEES = (8, 8)  # phase 15 (b): ChEES warmup and draws at FIT_CHAINS
# phase 15 (c): NUTS warmup and draws at FIT_CHAINS. 24 warmup steps hold a
# metric window (steps 3-21: Welford, the dense metric at its end, the
# step-size re-search) and leave 2 steps of dual averaging after it
# (infer.hmc.build_warmup_schedule), too few to settle the step size: the
# JAX package itself leaves about a third of the chains stuck there
# (NUTS_REFERENCE), so (c) holds the port to JAX's shares.
INFER_NUTS = (24, 8)
#: the JAX package's NUTS on the CPU with INFER_NUTS, the same data and
#: FIT_CHAINS chains, float32: shares of stuck chains and of chains with a
#: divergence (tests/test_torch/golden/nuts_warmup_reference.py)
NUTS_REFERENCE = {"stuck": 0.36767578125, "diverging": 0.443115234375, "chains": FIT_CHAINS,
                  "source": "tests/test_torch/golden/nuts_warmup_reference.py"}
TOL_SHARE_SE = 5.0  # phase 15 (c): those shares on the card within 5 binomial SE of JAX's
INFER_BUDGET_S = 180.0  # phase 15's time on the card
TOL_DRIFT = 0.05  # posterior-mean drift from FIT_TRUE_SCALES (bench_nuts.py's oneshot_ok gate)
CHECK_DAYS = 10  # phase 15 (d): card against CPU transitions, 4 chains (its CPU side is eager: few days hold the budget)
CHECK_WARMUP = 20  # and a NUTS warmup there: the shortest with a metric window (infer.hmc.build_warmup_schedule)
CHECK_WARMUP_DAYS = 4  # over this many days: its CPU side, eager, grows with them and holds phase 15's budget
TOL_CARD_CPU = 1e-10  # that check: max |d| / max |cpu|, float64
TOL_LIKELIHOOD = 1e-5  # that check: max |d| / max |engine|, float32
TOL_DIST_LOG_PROB = 1e-12  # log_prob on CUDA vs CPU tensors, float64
DIST_DRAWS = 2**20  # draws of each family from a CUDA generator
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 without tensor cores
SLICE_CHAINS = 1024  # phase 16 (a): bench_nuts.py's run_oneshot width
SLICE_CHEES = (8, 8)  # and its ChEES warmup and draws (bench: 200 + 400), then 8 more from a saved warm start
FORECAST_QS = (0.05, 0.25, 0.5, 0.75, 0.95)
TOL_BANDS = 1e-6  # member_quantiles on the card vs numpy.quantile on the host: max |d| / max |ref|
SVI_STARTS = 1024  # phase 16 (c): bench_nuts.py's bench_svi width
SVI_EAGER_STEPS = 2  # of its 300 through the eager loop: the reference of the graphed run's first losses
# of the row's own 300 steps, replayed from the bank step's CUDA graph: all 300 held phase 16's gate (179.0 s)
# but took the whole script to 1,092 s of its 1,200 s on an H100 80GB HBM3 at 700 W, whose hosts vary by a
# third; the row's 300 are extrapolated from the replays, and a second run of as many on the kept bank follows
SVI_STEPS = 10  # cut from 50 to pay for the second run on the kept bank
SVI_SAMPLES = 2000  # Predictive(guide, params, num_samples=...), as bench_svi
SVI_CHECK = (4, 3, 4)  # starts, steps, days: the card against the CPU in float64
MIN_FINITE_ELBO = 0.99  # share of starts whose final ELBO is finite
SLICE_BUDGET_S = 200.0  # phase 16's time on the card
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# phase 17: the stiff solvers and the mesh split
STIFF = (0.3, 1 / 3.6, 1 / 7.0, 50.0, 1 / 90.0)  # beta, sigma, gamma, kappa, omega: examples/seirs_stiff_waning.py:64-70
STIFF_Y0 = (9990.0, 0.0, 10.0, 0.0, 0.0)  # S, E, I, B, R (the example's)
STIFF_DAYS = 100
STIFF_TOLS = (1e-6, 1e-4)  # rtol, atol (the example's; states are O(1e4))
STIFF_BUDGET, TSIT5_BUDGET = 512, 8192  # the example's step budgets
# the grid engine's steps per save interval for TRBDF2: every slot runs on the
# card, masked; 5 hold the solve's 257 steps (the default, 8, gives 808 slots)
STIFF_SPS = 5
STIFF_AGREE = (5e-3, 1.0)  # TRBDF2 against Tsit5: the example's rtol, atol
TOL_STIFF_CPU = 1e-10  # the stiff SEIRS on the card against the same call on the CPU: max |d| / max |ref|
IE_TOLS, IE_BUDGET, IE_SPS = (1e-3, 1e-1), 512, 3  # ImplicitEuler, first order: looser tolerances than TRBDF2's
TOL_IE = 0.1  # its saves against Tsit5's: max |d| / max |ref| (2.5x the CPU's 4.08e-2)
ROBER = ((1e-6, 1e-10), (5e-4, 1e-9))  # TRBDF2 tolerances; against Radau (tests/test_ode/test_implicit.py:87-118)
MS_STIFF = ((1e-7, 1e-9), (1e-9, 1e-11), 1024)  # TRBDF2, Tsit5 tolerances, TRBDF2 budget (test_implicit.py:157-190)
TOL_MS_STIFF = 2e-5  # max |d| / max |ref| per compartment
GRAD_DAYS = 30  # the gradient's horizon through TRBDF2, at a constant dt = DT (central differences see the same grid)
# bench_nuts.py's chain width; members held to single-member solves (1.4 s each, host-bound: the script's time)
STIFF_ENSEMBLE, STIFF_PICK = 4096, 4  # 4 picks, not 8, pay for the repeated runs of the kept caches
STIFF_ENSEMBLE_DAYS = 30  # (b) and its split in (d): cut from STIFF_DAYS to hold phase 17's budget on slower hosts
MS_STIFF_DAYS = 30  # (a)'s multi-strain TRBDF2 solve: cut from DAYS for the same reason, and to pay for phase 19
# and the repeated runs of the kept caches
TOL_STIFF_MEMBER = 1e-5
RAGGED_ADAPTIVE = 2 * 32800  # 32,800 members a shard: not a multiple of block_b 64
TOL_RAGGED = TOL_BF16  # a ragged split of the adaptive kernel against the unsplit one, bf16 c-row saves (the main
# path's build of the kernel): the solves agree to their tolerance, the saves to one bf16 rounding
MESH_CHAINS, MESH_CHEES = 1024, (1, 1)  # oneshot_1024's width; ChEES warmup and draws (cut to phase 17's budget)
TOL_MESH_POT = 1e-6  # split potential and gradient against the unsplit: max |d| / max |ref| when not bit for bit
MESH_SVI = (1024, 2, 1)  # starts, steps, final particles (cut to phase 17's budget)
MESH_SVI_DAYS = 20  # its fit window: cut from FIT_DAYS, since each run now captures a graph of its step a shard
TOL_MESH_SVI = 1e-10
MESH_BUDGET_S = 180.0  # phase 17's time on the card
# phase 18: the kernels' other shapes, from their configs
MS_AGES = ("age_0_17", "age_18_49", "age_50_64", "age_65_plus")  # multistrain_config: ages 0-17, 18-49, 50-64, 65+
MS_DEMOGRAPHICS = (0.25, 0.35, 0.25, 0.15)  # the SEIP model's AGE_DEMOGRAPHICS; contact: the config's default
SHAPE_CHECK = 1024  # members held against the plain versions (the first 1,024: 256 BS3 blocks of 4)
SHAPE_CHECK_DAYS = 50  # over the first 50 days of the main path's saves (the plain versions are host-bound)
SHAPES_BUDGET_S = 180.0  # phase 18's time on the card, its nvcc round apart
SEIP_SHAPES = {"default": (4, 4, 3, 4, 2, 0), "second": (2, 2, 3, 3, 1, 1)}  # (A, J, K, M, L, seasonal) of (a)
MS_SHAPE = (4, 3)  # (b)
LANE_ADAPTIVE = dict(steps_per_save=3)  # (c): Tsit5 at the default rtol 1e-5, atol 1e-6 takes 1-2 steps a day
# phase 19: the examples of examples_torch/, run on the card through their run functions
EXAMPLES_BUDGET_S = 240.0  # phase 19's time on the card
EXAMPLE_SIMULATIONS = ("sir", "sir_age_stratified", "sir_age_risk_stratified", "seirs", "seirs_seasonal_forcing",
                       "seirs_multi_strain_age_stratified", "seip", "seirs_stiff_waning")
EXAMPLE_CHECK = 1024  # (b): the ensemble's first members held against kernel #2's plain version
#: (d): each fit's sampling call at the example's widths, its counts cut to
#: hold the gate, then its tree depth (the example's own in the docstring),
#: over a fit window of ``EXAMPLE_FIT_DAYS`` days
FIT_CUTS = {
    "ensemble_scenarios": dict(warmup=4, samples=4, max_tree_depth=3),
    "hierarchical_strains": dict(warmup=4, samples=4, max_tree_depth=3),
    "seip_fit": dict(warmup=4, samples=4, max_num_steps=8),
    "sir_infer_parameters": dict(warmup=4, samples=4, max_tree_depth=3, svi_iterations=4),
    "model_selection": dict(warmup=4, samples=4, max_tree_depth=3),
    "svi_multistart": dict(iterations=4, draws=4, burn=0),
}
EXAMPLE_FIT_DAYS = 5  # (d): the sampling calls' and the card-vs-CPU log densities' fit window
GRAPH_REPLAYS = 5  # (d): replays of each sampler's bank graph at the example's own width and window
#: (d): the fits whose banks each worker process measures at their own widths and windows, beside (a)-(c)
BANK_WORKERS = (("seip_fit",), ("ensemble_scenarios", "hierarchical_strains", "svi_multistart"),
                ("sir_infer_parameters", "model_selection"))
#: (d): the fit whose ``MCMC.run`` the last worker repeats on the same model and arguments (the kept entry's
#: second run), at its width and own window, ``FIT_CUTS``' counts and depth: NUTS at 64 chains
REPEAT_FIT = "ensemble_scenarios"
#: (d): the name of each fit's window in its counts
FIT_WINDOW = {"ensemble_scenarios": "fit_days", "hierarchical_strains": "duration", "seip_fit": "fit_days",
              "sir_infer_parameters": "tf_fit", "model_selection": "tf", "svi_multistart": "tf_fit"}
#: (d): per sampler or SVI fit of each fit: (its stage in the run's walls,
#: what, the width of its bank, the example's own transitions or steps,
#: gradients or steps each at most; None: as many as the cut run took,
#: which a zero-warmup ChEES bank keeps from its warm start)
FIT_OWN = {
    "ensemble_scenarios": [("fit", "NUTS", 64, 150 + 150, 2**6 - 1)],
    "hierarchical_strains": [("fit", "NUTS", 16, 300 + 300, 2**10 - 1)],
    "seip_fit": [("fit", "ChEES", 256, 100 + 100, 64)],
    "sir_infer_parameters": [("mcmc", "NUTS", 1, 500 + 100, 2**10 - 1), ("svi", "SVI", 1, 500, 1)],
    "model_selection": [("fits", "NUTS, two fits", 1, 2 * (400 + 200), 2**8 - 1)],
    "svi_multistart": [("svi", "SVI", 64, 500, 1), ("chees", "ChEES, 0 warmup", 256, 24, None)],
}
#: (d): the log density's positions (constrained), card against CPU in float64
FIT_POSITIONS = {
    "ensemble_scenarios": {"r0_scales": [1.05, 0.97, 1.02]},
    "hierarchical_strains": {"mu": 1.05, "tau": 0.2, "r0_scale": [0.9, 1.0, 1.2]},
    "seip_fit": {"beta_scales": [1.05, 0.95]},
    "sir_infer_parameters": {"strains_0_r0": 2.1, "strains_0_infectious_period": 6.5},
    "model_selection poisson": {"strains_0_r0": 2.1, "strains_0_infectious_period": 6.5},
    "model_selection negbin": {"strains_0_r0": 2.1, "strains_0_infectious_period": 6.5, "concentration": 3.5},
}


def shape_units() -> list:
    """The shape builds phase 18 runs: #2 and #6 at ``MS_SHAPE``, the
    general RK4 and BS3 kernels at each of ``SEIP_SHAPES``."""
    return ([(kernel, MS_SHAPE) for kernel in ("multistrain_tsit5", "multistrain_tsit5_2d")]
            + [(family, shape) for shape in SEIP_SHAPES.values() for family in ("seip_rk4", "seip_bs3")])


def seip_shape_config(models, strain, name: str):
    """A SEIP configuration of phase 18, built by ``models.seip_config`` (the
    port's ``dynode_tpu_torch.models.seip``, or the JAX package's in the CPU
    tests; ``strain`` the matching ``config.Strain``):

    - ``"default"``: ``seip_config()`` as it is: (A, J, K, M, L) = (4, 4, 3,
      4, 2), no seasonal vaccination;
    - ``"second"``: two ages (0-17, 18+; 60% and 40%), one strain (R0 2.2),
      one vaccination, three waning stages (70 and 110 days, then none;
      protection 1, 0.7, 0.4), seasonal vaccination: (2, 2, 3, 3, 1);
    - ``"three"``: the default with a third strain (R0 3.5, introduced on
      day 120): (4, 8, 3, 4, 3) (the CPU and card tests).
    """
    def alpha(n_dose):
        return strain(strain_name="alpha", r0=2.2, infectious_period=7.0, exposed_to_infectious=3.6,
                      vaccine_efficacy={k: min(0.35 * k, 0.8) for k in range(n_dose)})

    if name == "default":
        return models.seip_config()
    if name == "second":
        return models.seip_config(
            strains=[alpha(3)], n_age=2, max_vaccinations=1, seasonal_vaccination=True,
            waning_times=(70.0, 110.0, math.inf), waning_protections=(1.0, 0.7, 0.4), age_edges=(0, 18, 99),
            age_demographics=(0.6, 0.4))
    if name == "three":
        more = [strain(strain_name=n, r0=r0, infectious_period=7.0, exposed_to_infectious=3.6,
                       vaccine_efficacy={k: min(0.30 * k, 0.7) for k in range(3)}, is_introduced=True,
                       introduction_time=day, introduction_percentage=0.02, introduction_scale=5.0)
                for n, r0, day in (("delta", 3.0, 60.0), ("omicron", 3.5, 120.0))]
        return models.seip_config(strains=[alpha(3), *more])
    raise ValueError(f"unknown SEIP shape {name!r}")


def multistrain_4x3_config(models):
    """``multistrain_config`` with four ages (``MS_AGES``, ``MS_DEMOGRAPHICS``,
    the config's default contact matrix) and its three default strains."""
    return models.multistrain_config(age_names=MS_AGES, age_demographics=MS_DEMOGRAPHICS)


def _nonzero(row) -> int:
    return sum(1 for v in row if v != 0.0)


def rhs_flops(n_age: int, n_strain: int) -> int:
    """Float operations of one multi-strain rows-RHS evaluation per member
    (``ops/multistrain.py::_rhs_rows``): population sums, reciprocals, then
    per (age, strain) the contact mixing and the ten flux operations."""
    ak = n_age * n_strain
    return 3 * ak + n_age + ak * (10 + 3 * n_age)


def rhs_flops_2d(n_age: int, n_strain: int) -> int:
    """The same for ``_rhs_2d`` on the live rows of the aligned layout."""
    ak = n_age * n_strain
    return (2 * ak + ak + n_age + ak + ak * (2 * n_age - 1) + 2 * ak + 3 * ak + ak
            + n_age * (n_strain - 1) + 3 * ak)


def step_flops(table, rhs: int, n_rows: int) -> int:
    """One constant RK step per member: the RHS evaluations and, per row,
    the stage combinations ``y + dt * sum_j a_j k_j`` (zeros skipped)."""
    a, b, _, n_stages = table
    per_row = sum(2 * _nonzero(a[s - 1][:s]) + 2 for s in range(1, n_stages))
    return n_stages * rhs + n_rows * (per_row + 2 * _nonzero(b[:n_stages]) + 2)


def step_flops_2d(table, n_age: int, n_strain: int) -> int:
    """One ``_tsit5_step_2d`` per member: ``ys + (dt * a_j) * k_j`` per term."""
    a, b, _, n_stages = table
    per_row = sum(2 * _nonzero(a[s - 1][:s]) for s in range(1, n_stages)) + 2 * _nonzero(b[:n_stages])
    return n_stages * rhs_flops_2d(n_age, n_strain) + (n_age + 4 * n_age * n_strain) * per_row


def adaptive_flops(stats, batch: int, block_b: int, table, rhs: int, n_rows: int) -> int:
    """Operations of an adaptive run, counted from its per-block attempts:
    per member and attempt, the RHS evaluations after the FSAL stage, the
    stage, solution and error combinations and the error norm; plus one RHS
    evaluation per member for the first FSAL stage."""
    a, b, e, _, n_stages, _ = table
    combos = sum(2 * _nonzero(a[s - 1][:s]) + 2 for s in range(1, n_stages - 1))
    combos += 2 * _nonzero(b[:n_stages - 1]) + 2 + 2 * _nonzero(e[:n_stages]) + 1
    per_attempt = (n_stages - 1) * rhs + n_rows * (combos + 8) + 2
    attempts = (stats["n_accepted"] + stats["n_rejected"]).long().cpu()
    members = [block_b] * (len(attempts) - 1) + [batch - block_b * (len(attempts) - 1)]
    member_attempts = sum(int(n) * m for n, m in zip(attempts, members))
    return member_attempts * per_attempt + batch * rhs


_COUNTED_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum", "clamp",
                "where", "sqrt", "exp", "log", "cos", "sin", "gt", "ge", "lt", "le"}


def count_ops(fn, exclude=frozenset()) -> int:
    """Elementwise arithmetic operations ``fn`` performs in PyTorch: one per
    output element of every arithmetic op (but those named in ``exclude``),
    counted by a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counted = _COUNTED_OPS - set(exclude)

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in counted and hasattr(out, "numel"):
                Counter.n += out.numel()
            return out

    with Counter():
        fn()
    return Counter.n


def seip_work(cpu_p, cpu_y, seip_kw) -> tuple:
    """Work of the SEIP kernels at the shape of ``cpu_p`` (CPU parameters and
    state), counted from the plain versions' operations at one and at two
    members: the difference is a member's work, the rest is shared by the
    members that share a time (the time scalars and products of them):
    every member in RK4, whose table kernel computes them once per stage
    time, a lockstep block in BS3. Returns ``(rhs_m, rhs_s, step_m, step_s,
    attempt_m, attempt_s)``: an RHS, an RK4 step and a BS3 attempt, per
    member and shared."""
    import torch

    from dynode_tpu_torch.models import seip as seip_model
    from dynode_tpu_torch.ops import seip as tsp

    def by_member(run, exclude=frozenset()):
        """(operations per member, operations shared) of ``run(b)`` on b members."""
        one, two = count_ops(lambda: run(1), exclude), count_ops(lambda: run(2), exclude)
        return two - one, 2 * one - two

    step_m, step_s = by_member(lambda b: tsp.seip_solve_reference(
        cpu_y, cpu_p, torch.ones(b), duration=DT, dt=DT, save_every=DT))
    cpu_consts = tsp._Consts(tsp.seip_static_params(cpu_p), torch.float32, torch.device("cpu"))
    n_strains = cpu_consts.dims[-1]

    def one_rhs(b):
        return tsp.seip_kernel_rhs(cpu_consts, seip_model.seip_ensemble_state(cpu_y, b),
                                   torch.zeros(1), torch.ones(n_strains, b))

    rhs_m, rhs_s = by_member(one_rhs)
    probe = {}

    def one_day(b):  # identical members: one block takes the decisions of one member
        _, probe["s"] = tsp.seip_solve_adaptive_reference(cpu_y, cpu_p, torch.ones(b), duration=2.0, **{
            k: v for k, v in seip_kw.items() if k != "duration"})

    # The plain version keeps or drops a whole attempt with selects over the
    # state (y, k, the NaN saves); the kernel branches on the block's decision
    # instead, so outside the RHS those selects are not work. It also gives
    # each member its own time, so its RHS calls count their time scalars per
    # member: those come off, and the block's three stage times count instead.
    no_select = {"where"}
    day_m, day_s = by_member(one_day, exclude=no_select)
    arith_m, arith_s = by_member(one_rhs, exclude=no_select)
    ps = probe["s"]
    a1, r1 = int(ps["n_accepted"][0] + ps["n_rejected"][0]), int(ps["n_rejected"][0])
    attempt_m = (day_m - (arith_m + arith_s) * (3 * a1 + r1 + 1)) / a1 + 3 * rhs_m
    attempt_s = day_s / a1 + 3 * rhs_s
    return rhs_m, rhs_s, step_m, step_s, attempt_m, attempt_s


def seip_bs3_flops(work, stats, batch: int, block_b: int) -> int:
    """Operations of a BS3 run from its per-block attempts and rejections
    (``work`` from :func:`seip_work`): per member each attempt and one RHS
    after each rejection and at the start, plus the block's shared work."""
    import torch

    rhs_m, rhs_s, _, _, attempt_m, attempt_s = work
    att = (stats["n_accepted"] + stats["n_rejected"]).long().cpu()
    rej = stats["n_rejected"].long().cpu()
    members = torch.full_like(att, block_b)
    members[-1] = batch - block_b * (len(att) - 1)
    return int((members * (att * attempt_m + (rej + 1) * rhs_m) + att * attempt_s + (rej + 1) * rhs_s).sum())


def event_ms(fn, n=5) -> float:
    """Device time of one launch: CUDA events around n launches."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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


def scenario_scales(gen, n: int):
    """``n`` R0 scales from TruncatedNormal(1, 0.15, 0.6, 1.6), the prior of
    ``examples/ensemble_scenarios.py``, drawn with the port's ``dist`` from
    ``gen`` (on its device, float32)."""
    from dynode_tpu_torch import dist

    loc, scale, low, high = SCENARIO_PRIOR
    return dist.TruncatedNormal(loc, scale, low=low, high=high).sample(gen, (n,))


def bench_nuts_obs():
    """``bench_nuts.py``'s synthetic counts, (FIT_DAYS, A, K) int64 on the
    CPU: its ``jax.random.poisson`` draw at ``FIT_TRUE_SCALES``, kept in
    ``tests/test_torch/golden/bench_nuts_obs.npz`` (written by
    ``gen_bench_nuts_obs.py`` beside it), since no JAX runs here."""
    import torch

    golden = np.load(REPO / "tests" / "test_torch" / "golden" / "bench_nuts_obs.npz")
    check(tuple(golden["true_scales"]) == FIT_TRUE_SCALES, "the golden fit data are for other true scales")
    obs = torch.as_tensor(golden["obs"])
    check(tuple(obs.shape) == (FIT_DAYS, 2, 3), f"the golden fit data have shape {tuple(obs.shape)}")
    return obs


def fit_potential(obs, *, days=FIT_DAYS, dtype=None, device=None):
    """``bench_nuts.py``'s ``build_lane_major_potential`` on the port.

    The model comes from ``multistrain_config(solver_params=
    SolverParams(constant_step_size=0.5))``, ``multistrain_odeparams`` and the
    config's initializer; the prior of the three R0 scales is
    ``dist.TruncatedNormal(1, 0.3, low=0.5, high=2.0)``, moved to
    unconstrained space by ``biject_to(prior.support)`` and its
    ``log_abs_det_jacobian``; the likelihood is ``dist.Poisson`` of the daily
    incidence, centred on the saturated log-likelihood. ``obs`` is ``(days,
    A, K)``. Returns a namespace of ``potential(z)`` ((C, 3) unconstrained ->
    (C,)), its parts ``prior_term(z)`` -> (scales, log prior + log |J|) and
    ``loglik(c)`` ((C, T, A, K) cumulative incidence -> (C,)), the
    ``prior`` and its ``transform``.
    """
    import types

    import torch

    from dynode_tpu_torch import SolverParams, dist, simulate
    from dynode_tpu_torch.models import multistrain as model

    dtype = dtype or torch.float32
    cfg = model.multistrain_config(solver_params=SolverParams(constant_step_size=DT))
    base = model.multistrain_odeparams(cfg, dtype=dtype, device=device)
    y0 = model.multistrain_initial_state(cfg, dtype=dtype, device=device)
    sp = cfg.parameters.solver_params
    loc, scale, low, high = FIT_PRIOR
    ones = torch.ones(3, dtype=dtype, device=base.beta.device)
    prior = dist.TruncatedNormal(loc=loc * ones, scale=scale * ones, low=low, high=high)
    transform = dist.biject_to(prior.support)
    obs_f = torch.as_tensor(obs, dtype=dtype, device=base.beta.device)
    center = dist.Poisson(torch.clamp(obs_f, min=1e-6)).log_prob(obs_f)

    def prior_term(zb):
        scales = transform(zb)
        lp = prior.log_prob(scales).sum(-1)
        return scales, lp + transform.log_abs_det_jacobian(zb, scales).sum(-1)

    def loglik(c):
        inc = torch.clamp(torch.diff(c, dim=1), min=1e-6)
        return (dist.Poisson(inc).log_prob(obs_f[None]) - center[None]).sum(dim=(1, 2, 3))

    def potential(zb):
        n = zb.shape[0]
        scales, lp = prior_term(zb)
        pb = base.replace(beta=base.beta[:, None] * scales.T)  # (K, C)
        sol = simulate(model.multistrain_ode_ensemble, days, model.multistrain_ensemble_state(y0, n), pb, sp,
                       sub_save_indices=(4,))
        return -(lp + loglik(sol.ys[4].movedim(-1, 0)))

    return types.SimpleNamespace(potential=potential, prior_term=prior_term, loglik=loglik, prior=prior,
                                 transform=transform, base=base, y0=y0, obs=obs_f)


def fit_model(days=FIT_DAYS, dtype=None, device=None):
    """``bench_nuts.py``'s ``build_model()`` on the port: the model that
    names the fit's site (``r0_scales``), gives its transform and inits,
    and observes ``obs`` ((days, A, K) daily incidence) as Poisson counts
    of the forward's daily incidence."""
    import torch

    from dynode_tpu_torch import SolverParams, dist, simulate
    from dynode_tpu_torch.infer import handlers
    from dynode_tpu_torch.models import multistrain as model

    dtype = dtype or torch.float32
    cfg = model.multistrain_config(solver_params=SolverParams(constant_step_size=DT))
    base = model.multistrain_odeparams(cfg, dtype=dtype, device=device)
    y0 = model.multistrain_initial_state(cfg, dtype=dtype, device=device)
    sp = cfg.parameters.solver_params
    loc, scale, low, high = FIT_PRIOR
    ones = torch.ones(3, dtype=dtype, device=base.beta.device)

    def forward(r0_scales):
        sol = simulate(model.multistrain_ode, days, y0, base.replace(beta=base.beta * r0_scales), sp)
        return sol.ys[-1]  # cumulative incidence (T, A, K)

    def fit(obs=None):
        scales = handlers.sample("r0_scales", dist.TruncatedNormal(loc=loc * ones, scale=scale * ones,
                                                                   low=low, high=high))
        incidence = torch.clamp(torch.diff(forward(scales), dim=0), min=1e-6)
        handlers.sample("obs_incidence", dist.Poisson(incidence), obs=obs)

    return fit


def engine_phase(dev, smi: str, gen):
    """Phase 13: the ODE engine and ``simulate`` on the card (module
    docstring). Returns the fit of (c) and its chains' positions for
    phase 14, and (b)'s lane-major solve with its scales and wall for
    phase 17."""
    import torch
    import torch.utils._pytree as tree

    from dynode_tpu_torch import SolverParams, simulate, simulate_ensemble
    from dynode_tpu_torch.models import multistrain as model
    from dynode_tpu_torch.ode import RESULT_MAX_STEPS
    from dynode_tpu_torch.ops import multistrain as ms

    t_phase = time.perf_counter()
    print(f"phase 13: the ODE engine and simulate, eager PyTorch on the card [{smi}]")

    # (a) adaptive anchor, float64, and the same call on CPU tensors
    golden = np.load(REPO / "tests" / "golden" / "trajectories.npz")["multistrain_c"]
    anchor = {}
    for where in (dev, torch.device("cpu")):
        p = model.multistrain_default_params(dtype=torch.float64, device=where)
        y = model.multistrain_initial_state(dtype=torch.float64, device=where)
        t = time.perf_counter()
        sol = simulate(model.multistrain_ode, 300, y, p, SolverParams(step_budget=512))
        c = sol.ys[4].cpu().numpy()
        anchor[where.type] = (sol, c, time.perf_counter() - t)
    sol, c, wall = anchor[dev.type]
    excess = float(np.max(np.abs(c - golden) - (GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden))))
    steps = {k: (int(v[0].stats["num_accepted"]), int(v[0].stats["num_rejected"])) for k, v in anchor.items()}
    print(f"  (a) simulate 300 days, float64, adaptive (grid engine, step_budget 512): result {int(sol.result)}, "
          f"accepted / rejected on the card {steps[dev.type]}, on the CPU {steps['cpu']}; c vs golden: max "
          f"|d| - (atol {GOLDEN_ATOL:g} + rtol {GOLDEN_RTOL:g} |ref|) = {excess:.3e} (<= 0); wall {wall:.2f} s "
          f"on the card, {anchor['cpu'][2]:.2f} s on the CPU")
    check(int(sol.result) == 0 and excess <= 0.0, f"simulate vs golden: excess {excess:.3e}")
    check(steps[dev.type] == steps["cpu"], f"card and CPU took other steps: {steps}")
    print(f"      (a) took {time.perf_counter() - t_phase:.1f} s")

    # (b) constant step at B = 9,984 against kernel #2, and the two layouts
    base = model.multistrain_default_params(device=dev)
    y0 = model.multistrain_initial_state(device=dev)

    def batch_params(params, s):
        """Every field batched on a leading member axis, beta scaled."""
        pb = tree.tree_map(lambda leaf: leaf.expand((s.shape[0],) + leaf.shape), params)
        return pb.replace(beta=params.beta[None, :] * (s if s.dim() == 2 else s[:, None]))

    sp_c = SolverParams(constant_step_size=DT)
    scales = scenario_scales(gen, ENSEMBLE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lane = simulate_ensemble(model.multistrain_ode, int(DAYS), y0, batch_params(base, scales), sp_c,
                             layout="lane_major")
    torch.cuda.synchronize()
    lane_s = time.perf_counter() - t
    kern = ms.unpack_saves(ms.ensemble_solve_tsit5(
        y0, base.beta[None, :] * scales[:, None], base.sigma, base.gamma, base.omega, base.contact_matrix,
        batch=ENSEMBLE, duration=DAYS, dt=DT))
    rel = max(rel_err(g.movedim(-1, 1), w)[1] for g, w in zip(lane.ys, kern))
    print(f"  (b) simulate_ensemble lane_major B={ENSEMBLE}, {DAYS:.0f} days, Tsit5 dt={DT}: {lane_s:.2f} s; vs "
          f"kernel #2 (multistrain_tsit5): max rel err {rel:.3e} (tol {TOL_ENGINE:.0e})")
    check(all(bool(torch.isfinite(x).all()) for x in lane.ys), "non-finite lane-major saves")
    check(rel <= TOL_ENGINE, f"simulate_ensemble vs kernel #2: rel err {rel:.3e}")
    del kern
    # the first LAYOUT_B members again, batch-leading: lane-major members
    # share dt and nothing else, so the wide run holds their solves
    t = time.perf_counter()
    lead = simulate_ensemble(model.multistrain_ode, int(DAYS), y0, batch_params(base, scales[:LAYOUT_B]), sp_c)
    torch.cuda.synchronize()
    lead_s = time.perf_counter() - t
    rel = max(rel_err(a, b[..., :LAYOUT_B].movedim(-1, 0))[1] for a, b in zip(lead.ys, lane.ys))
    print(f"      batch_leading vs lane_major B={LAYOUT_B}: max rel err {rel:.3e} (tol {TOL_ENGINE:.0e}); "
          f"batch_leading {lead_s:.2f} s")
    check(rel <= TOL_ENGINE, f"batch_leading vs lane_major: rel err {rel:.3e}")
    del lead

    print(f"      (a) and (b) took {time.perf_counter() - t_phase:.1f} s")

    # (c) bench_nuts.py's lane-major fit potential at its width, built from
    # the port's config and dist
    n_steps = int(round(FIT_DAYS / DT))
    # bench_nuts.py's synthetic data: its own Poisson counts of the forward at the true scales
    obs = bench_nuts_obs()  # (FIT_DAYS, A, K)
    fit = fit_potential(obs, device=dev)
    # the chains' positions: prior draws on the card, moved to unconstrained space
    fit_z = fit.transform.inv(fit.prior.sample(gen, (FIT_CHAINS,)))

    def forward():
        with torch.no_grad():
            return fit.potential(fit_z).sum()

    def forward_backward():
        z = fit_z.clone().requires_grad_(True)
        fit.potential(z).sum().backward()
        return z.grad

    def prior_forward():
        with torch.no_grad():
            return fit.prior_term(fit_z)[1]

    def prior_forward_backward():
        z = fit_z.clone().requires_grad_(True)
        fit.prior_term(z)[1].sum().backward()
        return z.grad

    fwd_ms, pot = median_ms(forward)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)  # what the earlier phases still hold
    fb_ms, grad = median_ms(forward_backward)  # each call frees what the one before held
    peak = torch.cuda.max_memory_allocated(dev) - held
    prior_ms, _ = median_ms(prior_forward)
    prior_fb_ms, _ = median_ms(prior_forward_backward)
    check(bool(torch.isfinite(pot)) and bool(torch.isfinite(grad).all()), "non-finite fit value or gradient")
    print(f"  (c) bench_nuts.py's lane-major potential from multistrain_config, TruncatedNormal prior through "
          f"biject_to and the centred Poisson likelihood: {FIT_CHAINS} chains, {FIT_DAYS} days, dt={DT}: "
          f"potential sum {float(pot):.6e}, gradient {tuple(grad.shape)} finite; forward {fwd_ms:.1f} ms, "
          f"forward + backward {fb_ms:.1f} ms (host clock, median of 3 after a warm-up); of which the prior "
          f"and Jacobian alone: forward {prior_ms:.3f} ms, forward + backward {prior_fb_ms:.3f} ms; peak "
          f"memory of forward + backward {peak / 2**20:.1f} MiB above the {held / 2**20:.0f} MiB held before "
          f"[{smi}]")

    # float64 gradient on 4 chains against central differences: the 4 chains
    # and their 2 x 3 shifted copies go through one solve (chains are independent)
    fit64 = fit_potential(obs, dtype=torch.float64, device=dev)
    z4 = fit_z[:4].double().clone().requires_grad_(True)
    shifts = torch.eye(3, dtype=torch.float64, device=dev) * FD_STEP
    shifted = torch.cat([z4.detach() + sign * shifts[k] for k in range(3) for sign in (1.0, -1.0)])
    per = fit64.potential(torch.cat([z4, shifted]))
    per[:4].sum().backward()
    per = per[4:].detach().reshape(3, 2, 4)
    fd = ((per[:, 0] - per[:, 1]) / (2 * FD_STEP)).T  # (4, 3)
    fd_rel = float((z4.grad - fd).abs().max() / fd.abs().max())
    print(f"      float64 gradient on 4 chains vs central differences (h = {FD_STEP:g}): max rel err "
          f"{fd_rel:.3e} (tol {TOL_FD:.0e})")
    check(fd_rel <= TOL_FD, f"fit gradient vs finite differences: {fd_rel:.3e}")

    print(f"      (a) to the gradient check took {time.perf_counter() - t_phase:.1f} s")

    # the device's share of one forward, from a trace of the device alone
    # (host events too would trace every one of the 100,000 operations twice)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    # the raw device records: the profiler's event tree of 100,000 of them
    # takes longer to build than the forward takes to run
    on_card = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    if on_card:
        busy_ms = sum(e.duration_ns() for e in on_card) / 1e6
        idle = 1.0 - busy_ms / fwd_ms
        print(f"      one forward traced: {len(on_card)} device operations, {len(on_card) / n_steps:.1f} per "
              f"step; device busy {busy_ms:.1f} ms of the untraced {fwd_ms:.1f} ms: idle share {idle:.1%} "
              f"[{smi}]")
    else:
        print("      one forward traced: the profiler saw no device time; idle share and launches not measured")

    # (d) an exhausted step budget on the card
    sol = simulate(model.multistrain_ode, FIT_DAYS, y0, base, SolverParams(step_budget=8))
    tail = all(bool(torch.isnan(x[-1]).all()) for x in sol.ys)
    print(f"  (d) step_budget 8 (buffered engine): result {int(sol.result)} (RESULT_MAX_STEPS = "
          f"{RESULT_MAX_STEPS}), {int(sol.stats['num_steps'])} steps, NaN tail {tail}")
    check(int(sol.result) == RESULT_MAX_STEPS and tail, "an exhausted budget did not flag and NaN-fill")
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
    return fit, fit_z, (scales, lane, lane_s)


def in_support(constraint, x):
    """Whether every value of ``x`` lies in the closure of ``constraint``
    (a float32 draw of a positive family may round to 0)."""
    import torch

    from dynode_tpu_torch.dist import constraints as C

    x = x.double()
    integral = bool((x == torch.round(x)).all())
    if isinstance(constraint, C._Simplex):
        return bool((x >= 0).all()) and bool(((x.sum(-1) - 1.0).abs() < 1e-5).all())
    if isinstance(constraint, C.IntegerNonnegative):
        return integral and bool((x >= 0).all())
    if isinstance(constraint, C.IntegerInterval):
        high = math.inf if constraint.high is None else constraint.high
        return integral and bool(((x >= constraint.low) & (x <= high)).all())
    if isinstance(constraint, C.Interval):
        return bool(((x >= constraint.low) & (x <= constraint.high)).all())
    if isinstance(constraint, C.GreaterThan):
        return bool((x >= constraint.low).all())
    if isinstance(constraint, (C._Positive, C._Nonnegative)):
        return bool(((x >= 0) & torch.isfinite(x)).all())
    if isinstance(constraint, C._UnitInterval):
        return bool(((x >= 0) & (x <= 1)).all())
    return bool(torch.isfinite(x).all())


def dist_families(dtype, device):
    """One distribution of each family, its parameters as ``dtype`` tensors
    on ``device``; with the centre its draws are held to: ("mean", mean,
    variance or None) or, for the Cauchy pair, ("median", median, its
    standard error per draw)."""
    import torch

    from dynode_tpu_torch import dist

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def mean(d):
        try:
            var = d.variance
        except NotImplementedError:
            var = None
        return ("mean", d.mean, var)

    fams = {
        "Normal": dist.Normal(t(0.5), t(2.0)),
        "LogNormal": dist.LogNormal(t(0.1), t(0.4)),
        "HalfNormal": dist.HalfNormal(t(1.5)),
        "Cauchy": dist.Cauchy(t(0.3), t(2.0)),
        "HalfCauchy": dist.HalfCauchy(t(1.2)),
        "StudentT": dist.StudentT(t(5.0), t(0.5), t(2.0)),
        "Uniform": dist.Uniform(t(-1.0), t(3.0)),
        "Exponential": dist.Exponential(t(2.5)),
        "Gamma": dist.Gamma(t(2.5), t(1.5)),
        "Beta": dist.Beta(t(2.0), t(3.0)),
        "TruncatedNormal": dist.TruncatedNormal(t(1.0), t(0.3), low=0.5, high=2.0),
        "TruncatedNormal_right_tail": dist.TruncatedNormal(t(0.0), t(1.0), low=8.0, high=30.0),
        "Dirichlet": dist.Dirichlet(t([1.5, 2.0, 0.5])),
        "MultivariateNormal": dist.MultivariateNormal(t([0.5, -1.0]), t([[1.0, 0.0], [0.5, 2.0]])),
        "Poisson": dist.Poisson(t(3.5)),
        "Bernoulli": dist.Bernoulli(probs=t(0.3)),
        "Binomial": dist.Binomial(t(10.0), t(0.35)),
        "NegativeBinomial": dist.NegativeBinomial(t(4.0), t(2.5)),
        "Categorical": dist.Categorical(probs=t([0.1, 0.2, 0.3, 0.4])),
        "Multinomial": dist.Multinomial(10, t([0.2, 0.3, 0.5])),
        "BetaBinomial": dist.BetaBinomial(t(2.0), t(3.0), t(12.0)),
        "ZeroInflatedPoisson": dist.ZeroInflatedPoisson(t(0.3), t(4.0)),
        "ZeroInflatedNegativeBinomial": dist.ZeroInflatedNegativeBinomial(t(0.2), t(3.0), t(2.0)),
    }
    out = []
    for name, d in fams.items():
        if name == "Cauchy":
            centre = ("median", d.loc, math.pi * d.scale / 2)
        elif name == "HalfCauchy":
            centre = ("median", d.scale, math.pi * d.scale / 2)
        elif name == "TruncatedNormal_right_tail":
            # its ``mean`` is inf, as in the JAX package (ndtr(30) - ndtr(8)
            # rounds to 0); the draws are held to the Mills-ratio mean
            a = torch.tensor(8.0, dtype=torch.float64)
            centre = ("mean", float(torch.exp(-0.5 * a * a - 0.5 * math.log(2 * math.pi)
                                              - torch.special.log_ndtr(-a))), None)
        else:
            centre = mean(d)
        out.append((name, d, centre))
    return out


def check_draws(name, d, centre, gen, seed: int, n: int) -> str:
    """Draw ``n`` samples of ``d`` from ``gen`` seeded with ``seed`` twice:
    equal bits, every draw in the support, the sample mean (median for the
    Cauchy pair) within 5 standard errors of the distribution's. Returns a
    summary; raises on a failed check."""
    import torch

    gen.manual_seed(seed)
    x = d.sample(gen, (n,))
    gen.manual_seed(seed)
    check(torch.equal(x, d.sample(gen, (n,))), f"{name}: equal seeds drew other bits")
    check(in_support(d.support, x), f"{name}: a draw outside the support {d.support!r}")
    kind, want, spread = centre
    x = x.double()
    if kind == "median":
        got = x.median(dim=0).values
        se = torch.as_tensor(spread, dtype=torch.float64) / math.sqrt(n)
    else:
        got = x.mean(dim=0)
        var = x.var(dim=0) if spread is None else torch.as_tensor(spread, dtype=torch.float64)
        se = torch.sqrt(var / n)
    want = torch.as_tensor(want, dtype=torch.float64, device=got.device)
    dev_se = float(((got - want).abs() / se.to(got.device)).max())
    check(dev_se <= 5.0, f"{name}: sample {kind} {got.tolist()} is {dev_se:.2f} standard errors from {want.tolist()}")
    return f"{kind} {dev_se:.2f} SE"


def config_phase(dev, smi: str, gen, fit, fit_z) -> dict:
    """Phase 14: config to kernels #2 and #4, and ``dist`` on the card
    (module docstring). Returns the launches of its two kernel paths."""
    import torch

    from dynode_tpu_torch import SolverParams, dist
    from dynode_tpu_torch.models import multistrain as model
    from dynode_tpu_torch.models import seip as seip_model
    from dynode_tpu_torch.ops import multistrain as ms
    from dynode_tpu_torch.ops import seip as tsp

    t_phase = time.perf_counter()
    print(f"phase 14: config to kernels #2 and #4, and dist on the card [{smi}]")

    # (a) kernel #2 from the config, against the config-free defaults
    cfg = model.multistrain_config()
    p_cfg, y_cfg = model.multistrain_odeparams(cfg, device=dev), model.multistrain_initial_state(cfg, device=dev)
    p_def, y_def = model.multistrain_default_params(device=dev), model.multistrain_initial_state(device=dev)
    fields = ("beta", "sigma", "gamma", "omega", "contact_matrix")
    same = all(torch.equal(getattr(p_cfg, f), getattr(p_def, f)) for f in fields)
    same_y = all(torch.equal(a, b) for a, b in zip(y_cfg, y_def))
    print(f"  (a) multistrain_odeparams(multistrain_config()) == multistrain_default_params(): {same}; "
          f"initial states equal: {same_y}")
    check(same and same_y, "config-built multi-strain params or state differ from the defaults")
    draws = scenario_scales(gen, ENSEMBLE)

    def solve(p, y):
        return ms.ensemble_solve_tsit5(y, p.beta[None, :] * draws[:, None], p.sigma, p.gamma, p.omega,
                                       p.contact_matrix, batch=ENSEMBLE, duration=DAYS, dt=DT)

    torch.cuda.synchronize()
    ms.launch_multistrain_tsit5.launches = 0
    saves_cfg, saves_def = solve(p_cfg, y_cfg), solve(p_def, y_def)
    torch.cuda.synchronize()
    launches = {"multistrain_tsit5": ms.launch_multistrain_tsit5.launches}
    print(f"      kernel #2 at B={ENSEMBLE}, {DAYS:.0f} days, from both: saves equal bit for bit "
          f"{torch.equal(saves_cfg, saves_def)}; launches {launches['multistrain_tsit5']}")
    check(launches["multistrain_tsit5"] > 0, "kernel #2 did not launch from the config-built params")
    check(torch.equal(saves_cfg, saves_def), "kernel #2's saves differ between config-built and default params")
    del saves_cfg, saves_def

    # the Poisson log-likelihood of kernel #2's daily incidence against the
    # engine's likelihood term of phase 13 (c), on 64 of its chains
    z = fit_z[:FIT_CHECK_CHAINS]
    with torch.no_grad():
        scales, lp = fit.prior_term(z)
        ll_engine = -fit.potential(z) - lp
        ms.launch_multistrain_tsit5.launches = 0
        kern = ms.unpack_saves(ms.ensemble_solve_tsit5(
            fit.y0, fit.base.beta[None, :] * scales, fit.base.sigma, fit.base.gamma, fit.base.omega,
            fit.base.contact_matrix, batch=FIT_CHECK_CHAINS, duration=float(FIT_DAYS), dt=DT))
        ll_kernel = fit.loglik(kern[4].movedim(1, 0))  # (C, T, A, K)
    ll_rel = float((ll_kernel - ll_engine).abs().max() / ll_engine.abs().max())
    print(f"      Poisson log-likelihood of kernel #2's daily incidence vs the engine's potential term, "
          f"{FIT_CHECK_CHAINS} chains, {FIT_DAYS} days: max rel err {ll_rel:.3e} (tol {TOL_LIKELIHOOD:.0e}); "
          f"launches {ms.launch_multistrain_tsit5.launches}")
    check(ms.launch_multistrain_tsit5.launches > 0, "kernel #2 did not launch for the likelihood check")
    check(ll_rel <= TOL_LIKELIHOOD, f"kernel #2 likelihood vs the engine: rel err {ll_rel:.3e}")

    # (b) kernel #4 from seip_config, as bench_seip.py builds it
    scfg = seip_model.seip_config(seasonal_vaccination=True, solver_params=SolverParams(constant_step_size=DT))
    sp_cfg, sy_cfg = seip_model.seip_odeparams(scfg, device=dev), seip_model.seip_initial_state(scfg, device=dev)
    sp_def, sy_def = seip_model.seip_default_params(True, device=dev), seip_model.seip_initial_state(True, device=dev)
    seip_draws = dist.Uniform(0.85, 1.2).sample(gen, (SEIP_WIDE,))
    torch.cuda.synchronize()
    tsp.launch_seip_rk4.launches = 0
    (c_cfg,) = tsp.seip_ensemble_solve(sy_cfg, sp_cfg, seip_draws, duration=DAYS, dt=DT, save=(3,))
    (c_def,) = tsp.seip_ensemble_solve(sy_def, sp_def, seip_draws, duration=DAYS, dt=DT, save=(3,))
    torch.cuda.synchronize()
    launches["seip_rk4"] = tsp.launch_seip_rk4.launches
    same_seip = torch.equal(c_cfg, c_def)
    print(f"  (b) seip_config(seasonal_vaccination=True) -> seip_odeparams -> kernel #4 at B={SEIP_WIDE}, draws "
          f"Uniform(0.85, 1.2): C saves equal to seip_default_params(True)'s bit for bit {same_seip}; launches "
          f"{launches['seip_rk4']}")
    check(launches["seip_rk4"] > 0, "kernel #4 did not launch from the config-built params")
    check(same_seip and bool(torch.isfinite(c_cfg).all()), "kernel #4's saves differ or are not finite")
    del c_cfg, c_def

    # (c) dist on the card: log_prob against the CPU in float64, draws
    t_dist = time.perf_counter()
    cpu = torch.device("cpu")
    worst = (0.0, "")
    summary = []
    for (name, d_card, centre), (_, d_cpu, _) in zip(dist_families(torch.float64, dev),
                                                    dist_families(torch.float64, cpu)):
        gen.manual_seed(SEED)
        x = d_card.sample(gen, (4096,))
        got, want = d_card.log_prob(x), d_cpu.log_prob(x.cpu())
        rel = float(((got.cpu() - want).abs() / want.abs().clamp(min=1e-300)).max())
        worst = max(worst, (rel, name))
        check(rel <= TOL_DIST_LOG_PROB, f"{name}: log_prob on the card vs the CPU, rel err {rel:.3e}")
    for name, d, centre in dist_families(torch.float32, dev):
        summary.append(f"{name} {check_draws(name, d, centre, gen, SEED, DIST_DRAWS)}")
    torch.cuda.synchronize()
    print(f"  (c) dist: log_prob of {len(summary)} families on CUDA float64 vs the CPU: max rel err {worst[0]:.3e} "
          f"({worst[1]}) "
          f"(tol {TOL_DIST_LOG_PROB:.0e}); {DIST_DRAWS} float32 draws each from a CUDA generator, all in the "
          f"support, equal bits from equal seeds, centre within 5 SE: {', '.join(summary)}; "
          f"{time.perf_counter() - t_dist:.1f} s")
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches


class DrawTape:
    """The sampler's draw seam (``infer.hmc.Draws``) on a CPU generator in
    float64, recording every draw; or, given a recording, replaying it on
    another device in the same order."""

    def __init__(self, generator=None, tape=None, device=None):
        from dynode_tpu_torch.infer.hmc import Draws

        self.source = Draws(generator) if generator is not None else None
        self.tape = [] if tape is None else list(tape)
        self.device = device if device is not None else generator.device

    def _next(self, kind, *args):
        import torch

        if self.source is not None:
            x = getattr(self.source, kind)(*args)
            self.tape.append(x)
            return x
        x = self.tape.pop(0)
        return x.to(self.device)

    def normal(self, shape, dtype, device, active=None):
        import torch

        return self._next("normal", shape, dtype, torch.device("cpu")) if self.source else self._next("normal")

    def uniform(self, shape, dtype, device, active=None):
        import torch

        return self._next("uniform", shape, dtype, torch.device("cpu")) if self.source else self._next("uniform")

    def bernoulli(self, shape, device, active=None):
        import torch

        return self._next("bernoulli", shape, torch.device("cpu")) if self.source else self._next("bernoulli")


def card_vs_cpu(dev, obs, z4, days=None):
    """A NUTS and a ChEES transition (each after its step-size search) of
    the fit at 4 chains in float64, then a NUTS warmup of ``CHECK_WARMUP``
    steps (``CHECK_WARMUP_DAYS`` days) with its metric window (Welford, the
    dense metric and its Cholesky factor at the window's end, the step-size
    re-search under it) and two draws, on the card (potential
    graph-captured) and on CPU tensors, with the draws recorded on the CPU
    and replayed on the card.
    Returns (max relative error of eps, z, accept_prob, the potential and
    the tuned metric; (NUTS num_steps, ChEES leapfrogs); whether num_steps
    and diverging are equal)."""
    import torch

    from dynode_tpu_torch.infer import MCMC, NUTS
    from dynode_tpu_torch.infer import chees as ch
    from dynode_tpu_torch.infer import hmc
    from dynode_tpu_torch.infer.mcmc import batched_pot_and_grad, graphed_potential

    days = days or CHECK_DAYS
    cpu = torch.device("cpu")
    z4 = z4.double()

    def potentials(n_days):
        fits = {where: fit_potential(obs[:n_days].cpu(), days=n_days, dtype=torch.float64, device=where)
                for where in (cpu, dev)}
        return {cpu: batched_pot_and_grad(fits[cpu].potential),
                dev: graphed_potential(fits[dev].potential, z4.shape[0], 3, torch.float64, dev)}

    pag, pag_warm = potentials(days), potentials(CHECK_WARMUP_DAYS)
    inv = torch.eye(3, dtype=torch.float64) * 0.5 + 0.1
    out = {}
    tape = None
    for where in (cpu, dev):
        draws = DrawTape(torch.Generator().manual_seed(SEED)) if where == cpu else DrawTape(tape=tape, device=dev)
        inv_mass = inv.expand(z4.shape[0], 3, 3).to(where)
        chol = hmc.chol_of_inv(inv_mass, True)
        state = hmc.init_state(pag[where], z4.to(where))
        eps = hmc.find_reasonable_step_size(pag[where], inv_mass, chol, state, draws)
        nuts = hmc.nuts_transition(pag[where], inv_mass, chol, eps, 3, state, draws)
        bank = ch.init_bank_state(pag[where], z4.to(where))
        inv_b, chol_b = inv.to(where), hmc.chol_of_inv(inv.to(where), True)
        eps_b = ch.find_reasonable_step_size_bank(pag[where], inv_b, chol_b, bank, draws)
        chees, _ = ch.chees_transition(pag[where], inv_b, chol_b, eps_b, 6.0 * eps_b, 64, bank, draws)
        warm = MCMC(NUTS(None, dense_mass=True, max_tree_depth=3), num_warmup=CHECK_WARMUP, num_samples=2,
                    num_chains=z4.shape[0])
        last, tuned, drawn = warm._run_nuts(pag_warm[where], 3, torch.float64, where, z4.to(where), draws,
                                            rescue=False)
        out[where.type] = (eps, nuts, eps_b, chees, *tuned, drawn["z"], last)
        tape = draws.tape if where == cpu else tape
    worst, equal = 0.0, True
    for got, want in zip(out[dev.type], out["cpu"]):
        pairs = [(got, want)] if torch.is_tensor(got) else [
            (got.z, want.z), (got.accept_prob, want.accept_prob), (got.potential, want.potential)]
        for a, b in pairs:
            worst = max(worst, float((a.cpu() - b).abs().max() / b.abs().max()))
        if not torch.is_tensor(got):
            equal = equal and torch.equal(got.num_steps.cpu(), want.num_steps) and torch.equal(
                got.diverging.cpu(), want.diverging)
    return worst, (out["cpu"][1].num_steps.tolist(), int(out["cpu"][3].num_steps[0])), equal


def timed(fn, events):
    """``fn`` with a pair of CUDA events recorded around each call into
    ``events`` (read after a synchronize)."""
    import torch

    def call(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    return call


def sampler_report(name, mcmc, wall, replays, replay_s, transitions, smi, reference=None):
    """Print a fit's statistics (bench_nuts.py's) and gate them; returns
    the r0_scales draws (chains, draws, 3).

    Gates: finite draws and the drift; with no ``reference``, no stuck
    chain (every coordinate's spread over the draws below 1e-5); with one
    (``NUTS_REFERENCE``), the shares of stuck chains and of chains with a
    divergence each within ``TOL_SHARE_SE`` binomial standard errors of
    the JAX package's on the same schedule and data."""
    import torch

    from dynode_tpu_torch.infer.diagnostics import effective_sample_size, split_rhat

    arr = mcmc.get_samples(group_by_chain=True)["r0_scales"].double().cpu().numpy()
    by_chain = mcmc.get_extra_fields(group_by_chain=True)
    ef = mcmc.get_extra_fields()
    div = int(ef["diverging"].sum())
    leapfrogs = float(ef["num_steps"].double().mean())
    ess = min(effective_sample_size(arr[:, :, k]) for k in range(3))
    rhat = max(split_rhat(arr[:, :, k]) for k in range(3))
    stuck = int((arr.std(axis=1).max(axis=-1) < 1e-5).sum())
    shares = (stuck / arr.shape[0], float(by_chain["diverging"].any(dim=1).double().mean()))
    eps_q = np.quantile(ef["step_size"].double().cpu().numpy(), [0.05, 0.5, 0.95])
    drift = float(np.max(np.abs(arr.reshape(-1, 3).mean(axis=0) - np.asarray(FIT_TRUE_SCALES))))
    outside_s = wall - replay_s
    print(f"  {name}: wall {wall:.1f} s, {replays} potential replays ({replays / wall:.2f} leapfrogs/s over the "
          f"run), {transitions} transitions; the replays' device time {replay_s:.1f} s (CUDA events, "
          f"{replay_s * 1e3 / max(replays, 1):.1f} ms each), {replay_s / wall:.1%} of the run; "
          f"outside the replays {outside_s:.1f} s (the trace, inits and the sampler's host work), "
          f"{outside_s * 1e3 / transitions:.1f} ms a transition; "
          f"sampling: step size after warmup 5/50/95% {np.round(eps_q, 4).tolist()}, mean leapfrogs per "
          f"transition {leapfrogs:.2f}, divergences {div}, max split-Rhat "
          f"{rhat:.4f}, min ESS {ess:.0f} -> {ess / wall:.1f} ESS/s over this short run (not bench_nuts's "
          f"metric); rescued {mcmc._n_rescued}, stuck chains {stuck} ({shares[0]:.4f}), chains with a "
          f"divergence {shares[1]:.4f}; posterior means "
          f"{np.round(arr.reshape(-1, 3).mean(axis=0), 4).tolist()} vs true {list(FIT_TRUE_SCALES)}: drift "
          f"{drift:.4f} (gate {TOL_DRIFT}) [{smi}]")
    check(bool(np.isfinite(arr).all()), f"{name}: non-finite draws")
    check(drift < TOL_DRIFT, f"{name}: posterior-mean drift {drift:.4f}")
    if reference is None:
        check(stuck == 0, f"{name}: {stuck} stuck chains after rescue")
        return arr
    n_ref, n = reference["chains"], arr.shape[0]
    for what, got, want in zip(("stuck", "diverging"), shares, (reference["stuck"], reference["diverging"])):
        pooled = (got * n + want * n_ref) / (n + n_ref)
        se = math.sqrt(max(pooled * (1.0 - pooled), 1.0 / n) * (1.0 / n + 1.0 / n_ref))
        z = abs(got - want) / se
        print(f"      share of {what} chains {got:.4f} vs the JAX package's {want:.4f} on the same schedule "
              f"({n_ref} chains, {reference['source']}): {z:.2f} SE (gate {TOL_SHARE_SE})")
        check(z <= TOL_SHARE_SE, f"{name}: share of {what} chains {got:.4f} vs JAX's {want:.4f}: {z:.2f} SE")
    return arr


def infer_phase(dev, smi: str, gen, fit, fit_z) -> dict:
    """Phase 15: bench_nuts.py's fit sampled on the card with a graph-captured
    potential, and its posterior predictive through kernel #2 (module
    docstring). Returns the launches of kernel #2 on this path."""
    import torch

    from dynode_tpu_torch import SolverParams, simulate
    from dynode_tpu_torch.infer import MCMC, NUTS, ChEES
    from dynode_tpu_torch.infer.mcmc import batched_pot_and_grad, graphed_potential
    from dynode_tpu_torch.models import multistrain as model
    from dynode_tpu_torch.ops import multistrain as ms

    t_phase = time.perf_counter()
    print(f"phase 15: bench_nuts.py's fit sampled on the card, graph-captured potential [{smi}]")

    # (a) capture: the graphed potential and gradient against the eager ones
    eager = batched_pot_and_grad(fit.potential)
    graph = graphed_potential(fit.potential, FIT_CHAINS, 3, fit_z.dtype, dev)
    t = time.perf_counter()
    pe_g, g_g = graph(fit_z)  # captures, then replays
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    eager_ms, (pe_e, g_e) = wall_ms(lambda: eager(fit_z))  # one call: host-bound, 5-7 s, and phase 15 has 180 s
    same = torch.equal(pe_g, pe_e) and torch.equal(g_g, g_e)
    replay_ms, _ = median_ms(lambda: graph(fit_z))
    print(f"  (a) potential and gradient at {FIT_CHAINS} chains, {FIT_DAYS} days: warm-up + capture {capture_s:.1f} "
          f"s; graph replay equals the eager call bit for bit (value and gradient): {same}; eager {eager_ms:.1f} "
          f"ms (one call after the capture's warm-up), replay {replay_ms:.1f} ms (median of 3 after a warm-up), host clock: "
          f"{1e3 / eager_ms:.2f} vs "
          f"{1e3 / replay_ms:.2f} leapfrogs/s [{smi}]")
    check(same, "the graph replay differs from the eager potential")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph(fit_z)
        torch.cuda.synchronize()
    on_card = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    if on_card:
        busy_ms = sum(e.duration_ns() for e in on_card) / 1e6
        print(f"      one replay traced: {len(on_card)} device operations, busy {busy_ms:.1f} ms of the untraced "
              f"{replay_ms:.1f} ms: idle share {1.0 - busy_ms / replay_ms:.1%} [{smi}]")
    else:
        print("      one replay traced: the profiler saw no device time; the replay's idle share not measured")

    # (b), (c): ChEES and NUTS over the bank, bench_nuts.py's kernels
    obs = fit.obs
    fit_fn = fit_model(days=obs.shape[0], device=dev)
    arrs = {}
    for name, kernel, (warm, draws), reference in (
        ("(b) ChEES", ChEES(fit_fn, batched_potential_fn=fit.potential), INFER_CHEES, None),
        ("(c) NUTS dense, max_tree_depth=3",
         NUTS(fit_fn, dense_mass=True, max_tree_depth=3, batched_potential_fn=fit.potential), INFER_NUTS,
         NUTS_REFERENCE),
    ):
        mcmc = MCMC(kernel, num_warmup=warm, num_samples=draws, num_chains=FIT_CHAINS, steps_per_call=16)
        before = graph.replays
        events = []
        graph.graph.replay = timed(graph.graph.replay, events)  # this run's replays, by CUDA events
        torch.cuda.synchronize()
        t = time.perf_counter()
        mcmc.run(gen, obs=obs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        del graph.graph.replay
        replay_s = sum(start.elapsed_time(end) for start, end in events) / 1e3
        check(mcmc.graph is graph, f"{name}: the run did not replay the cached graph")
        check(mcmc.get_samples()["r0_scales"].device.type == "cuda", f"{name}: the draws left the card")
        arrs[name] = sampler_report(f"{name} at {FIT_CHAINS} chains, {warm} warmup + {draws} draws",
                                    mcmc, wall, graph.replays - before, replay_s, warm + draws, smi, reference)

    # (d) the card against the CPU: transitions at 4 chains in float64, the
    # draws recorded on the CPU and replayed on the card
    t = time.perf_counter()
    worst, steps, equal = card_vs_cpu(dev, obs, fit_z[:4])
    check_s = time.perf_counter() - t
    print(f"  (d) card vs CPU, 4 chains, {CHECK_DAYS} days, float64, draws recorded on the CPU and replayed: "
          f"step-size search, a NUTS transition (num_steps {steps[0]}), the bank search and a ChEES transition "
          f"({steps[1]} leapfrogs), a NUTS warmup of {CHECK_WARMUP} steps ({CHECK_WARMUP_DAYS} days) with its metric "
          f"window and 2 draws, the "
          f"card's potential graph-captured: max rel err of eps, z, accept_prob, potential and the tuned metric "
          f"{worst:.3e} (tol {TOL_CARD_CPU:.0e}); num_steps and diverging equal: {equal}; {check_s:.1f} s")
    check(equal, "card and CPU transitions took other steps or divergences")
    check(worst <= TOL_CARD_CPU, f"card vs CPU transitions: rel err {worst:.3e}")

    # (e) posterior predictive through kernel #2: 9,984 of (b)'s draws, 200 days
    post = torch.as_tensor(arrs["(b) ChEES"].reshape(-1, 3)[:ENSEMBLE], dtype=torch.float32, device=dev)
    base, y0 = fit.base, fit.y0
    torch.cuda.synchronize()
    ms.launch_multistrain_tsit5.launches = 0
    saves = ms.unpack_saves(ms.ensemble_solve_tsit5(
        y0, base.beta[None, :] * post, base.sigma, base.gamma, base.omega, base.contact_matrix,
        batch=ENSEMBLE, duration=DAYS, dt=DT))
    torch.cuda.synchronize()
    launches = {"multistrain_tsit5": ms.launch_multistrain_tsit5.launches}
    n = FIT_CHECK_CHAINS
    sim = simulate(model.multistrain_ode_ensemble, int(DAYS), model.multistrain_ensemble_state(y0, n),
                   base.replace(beta=base.beta[:, None] * post[:n].T), SolverParams(constant_step_size=DT))
    rel = max(rel_err(g.movedim(-1, 1), w[:, :n])[1] for g, w in zip(sim.ys, saves))
    c_end = saves[4][-1].sum(dim=(1, 2))
    print(f"  (e) posterior predictive: {ENSEMBLE} of (b)'s draws through kernel #2 (multistrain_tsit5), "
          f"{DAYS:.0f} days, dt={DT}: launches {launches['multistrain_tsit5']}; cumulative incidence at day "
          f"{DAYS:.0f}: median {float(c_end.median()):.5f}, 5-95% {float(c_end.quantile(0.05)):.5f} - "
          f"{float(c_end.quantile(0.95)):.5f}; {n} members vs simulate: max rel err {rel:.3e} (tol {TOL_ENGINE:.0e})")
    check(launches["multistrain_tsit5"] > 0, "kernel #2 did not launch on the posterior predictive")
    check(all(bool(torch.isfinite(x).all()) for x in saves), "non-finite posterior-predictive saves")
    check(rel <= TOL_ENGINE, f"posterior predictive vs simulate: rel err {rel:.3e}")
    phase_s = time.perf_counter() - t_phase
    print(f"  phase 15: {phase_s:.1f} s (gate {INFER_BUDGET_S:.0f} s)")
    check(phase_s <= INFER_BUDGET_S, f"phase 15 took {phase_s:.1f} s, over its {INFER_BUDGET_S:.0f} s")
    return launches


def slice_phase(dev, smi: str, fit) -> dict:
    """Phase 16: the rest of inference on the card (module docstring).
    Returns the launches of kernel #2 on the forecast path."""
    import tempfile

    import torch

    from dynode_tpu_torch.infer import (
        SVI,
        Adam,
        AutoMultivariateNormal,
        MCMCProcess,
        Predictive,
        Trace_ELBO,
        load_mcmc_warm_start,
        loo,
        member_quantiles,
        resample_draws,
        save_mcmc,
        waic,
    )
    from dynode_tpu_torch.infer.mcmc import graphed_potential
    from dynode_tpu_torch.ops import multistrain as ms

    t_phase = time.perf_counter()
    print(f"phase 16: processes, SVI and forecast bands on the card [{smi}]")
    obs = fit.obs
    fit_fn = fit_model(days=obs.shape[0], device=dev)

    # (a) bench_nuts.py's run_oneshot row through MCMCProcess (ChEES)
    warm, draws = SLICE_CHEES
    graph = graphed_potential(fit.potential, SLICE_CHAINS, 3, torch.float32, dev)
    z0 = fit.transform.inv(fit.prior.sample(torch.Generator(device=dev).manual_seed(SEED), (SLICE_CHAINS,)))
    t = time.perf_counter()
    graph(z0)  # warm-up and capture at this width; the process's run replays the cached graph
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    proc = MCMCProcess(numpyro_model=fit_fn, num_samples=draws, num_warmup=warm, num_chains=SLICE_CHAINS,
                       nuts_max_tree_depth=3, sampler="chees", progress_bar=False, inference_prngkey=SEED,
                       nuts_kwargs={"batched_potential_fn": fit.potential})
    segments, mcmc = [], None
    for segment in ("first", "second"):
        warm_start = None
        if segment == "second":
            with tempfile.TemporaryDirectory() as tmp:
                path = f"{tmp}/oneshot.npz"
                save_mcmc(path, mcmc)
                warm_start = load_mcmc_warm_start(path, device=dev)
            check(torch.equal(warm_start[0].z, proc.warm_start_state()[0].z), "the saved warm start differs")
        before = graph.replays
        torch.cuda.synchronize()
        t = time.perf_counter()
        mcmc = proc.infer(warm_start=warm_start, obs=obs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(mcmc.graph is graph, f"(a) {segment} segment: the run did not replay the cached graph")
        r0 = proc.get_samples()["r0_scales"]
        drift = float((r0.double().mean(dim=0).cpu() - torch.tensor(FIT_TRUE_SCALES, dtype=torch.float64)).abs().max())
        segments.append(r0)
        print(f"  (a) MCMCProcess ChEES, {SLICE_CHAINS} chains, {'0 (warm start from the saved file)' if warm_start else warm} "
              f"warmup + {draws} draws: wall {wall:.1f} s, {graph.replays - before} potential replays; drift "
              f"{drift:.4f} (gate {TOL_DRIFT}) [{smi}]")
        check(bool(torch.isfinite(r0).all()), f"(a) {segment} segment: non-finite draws")
        check(drift < TOL_DRIFT, f"(a) {segment} segment: posterior-mean drift {drift:.4f}")
        if segment == "first":
            t = time.perf_counter()
            idata = proc.to_arviz()
            arviz_s = time.perf_counter() - t
            ll = idata.log_likelihood["obs_incidence"]
            t = time.perf_counter()
            scores = {"loo": loo(idata), "waic": waic(idata)}
            score_s = time.perf_counter() - t
            k = scores["loo"].pareto_k
            shares = [float(np.mean(k <= 0.5)), float(np.mean((k > 0.5) & (k <= 0.7))), float(np.mean(k > 0.7))]
            print(f"      to_arviz {arviz_s:.1f} s: groups {idata.groups()}, log-likelihood {ll.shape}; loo and waic "
                  f"{score_s:.1f} s: elpd_loo {scores['loo'].elpd:.2f} (se {scores['loo'].se:.2f}), elpd_waic "
                  f"{scores['waic'].elpd:.2f}; Pareto k <= 0.5 / 0.5-0.7 / > 0.7: "
                  f"{shares[0]:.4f} / {shares[1]:.4f} / {shares[2]:.4f}")
            check(idata.posterior["r0_scales"].shape == (SLICE_CHAINS, draws, 3), "(a) posterior group shape")
            check(idata.posterior_predictive["obs_incidence"].shape == (SLICE_CHAINS * draws,) + tuple(obs.shape),
                  "(a) posterior predictive shape")
            check(all(math.isfinite(v.elpd) for v in scores.values()), "(a) loo or waic not finite")
    check(not torch.equal(segments[0], segments[1]), "(a) the second segment repeated the first's draws")
    print(f"      warm-up + capture at {SLICE_CHAINS} chains {capture_s:.1f} s")

    # (b) the forecast row: (a)'s draws resampled to 9,984 members through kernel #2, bands on the card
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base, y0 = fit.base, fit.y0
    torch.cuda.synchronize()
    ms.launch_multistrain_tsit5.launches = 0
    t = time.perf_counter()
    members = resample_draws(segments[0], ENSEMBLE, gen)
    saves = ms.unpack_saves(ms.ensemble_solve_tsit5(
        y0, base.beta[None, :] * members, base.sigma, base.gamma, base.omega, base.contact_matrix,
        batch=ENSEMBLE, duration=DAYS, dt=DT))
    incidence = torch.diff(saves[4], dim=0)  # (days, members, A, K)
    bands = member_quantiles(incidence, FORECAST_QS, member_axes=1)
    torch.cuda.synchronize()
    forecast_s = time.perf_counter() - t
    launches = {"multistrain_tsit5": ms.launch_multistrain_tsit5.launches}
    host = np.quantile(incidence.cpu().numpy(), FORECAST_QS, axis=1)
    band_err = float(np.abs(bands.cpu().numpy() - host).max() / np.abs(host).max())
    ordered = bool((bands[1:] >= bands[:-1]).all())
    print(f"  (b) forecast: {ENSEMBLE} members resampled from (a)'s {segments[0].shape[0]} draws, kernel #2 "
          f"{DAYS:.0f} days (launches {launches['multistrain_tsit5']}), daily incidence bands "
          f"{tuple(bands.shape)} at {FORECAST_QS}: {forecast_s * 1e3:.1f} ms; against numpy.quantile on the host: "
          f"max rel err {band_err:.3e} (tol {TOL_BANDS:.0e}); ordered: {ordered} [{smi}]")
    check(launches["multistrain_tsit5"] > 0, "kernel #2 did not launch on the forecast path")
    check(bool(torch.isfinite(bands).all()), "non-finite forecast bands")
    check(band_err <= TOL_BANDS, f"forecast bands vs numpy.quantile: rel err {band_err:.3e}")
    check(ordered, "forecast bands out of order")

    # (c) bench_nuts.py's bench_svi row: multi-start SVI, its first steps through the eager loop,
    # the row through the bank step's CUDA graph from the same seed, then Predictive
    def bench_svi():
        return SVI(fit_fn, AutoMultivariateNormal(fit_fn), Adam(0.1), Trace_ELBO())

    svi = bench_svi()
    svi._graphed = lambda device: False  # the eager loop: the reference of the graph's first losses
    # (its final ELBO, which nothing reads, on one particle)
    eager_walls = eager_bank_walls(svi)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eager = svi.run_multistart(SEED, num_steps=SVI_EAGER_STEPS, num_starts=SVI_STARTS, final_particles=1, obs=obs)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t
    svi = bench_svi()
    with svi_graphs(timed=True) as graphs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = svi.run_multistart(SEED, num_steps=SVI_STEPS, num_starts=SVI_STARTS, obs=obs)
        torch.cuda.synchronize()
        svi_s, done = time.perf_counter() - t, time.perf_counter()
    check(len(graphs) == 1 and graphs[0].replays == SVI_STEPS and graphs[0].graph is not None,
          "(c) the SVI bank did not replay one kept graph a step")
    g = graphs[0]
    capture_s = g.warmup_s + g.capture_s
    step_s = statistics.median(b - a for a, b in zip(g.ends, g.ends[1:]))  # the replayed steps, draws included
    eager_step_s = statistics.median(eager_walls)
    first_equal = torch.equal(result.all_losses[:, :SVI_EAGER_STEPS], eager.all_losses)
    finite = float(torch.isfinite(result.final_elbos).double().mean())
    start0 = result.all_losses[0].double().cpu()
    t = time.perf_counter()
    post = Predictive(svi.guide, params=result.params, num_samples=SVI_SAMPLES)(SEED, obs=obs)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t
    row_s = capture_s + 300 * step_s
    print(f"  (c) SVI AutoMultivariateNormal, Adam(0.1), {SVI_STARTS} starts: {SVI_EAGER_STEPS} steps through the "
          f"eager loop {eager_s:.1f} s, a step {eager_step_s:.2f} s ({SVI_STARTS / eager_step_s:.1f} ELBO-steps/s); "
          f"{SVI_STEPS} steps replayed from the bank step's CUDA graph {svi_s:.1f} s: warm-up and capture "
          f"{capture_s:.2f} s ({g.warmup_s:.2f} + {g.capture_s:.2f}), a replayed step {step_s * 1e3:.1f} ms (median "
          f"of {SVI_STEPS - 1}, draws included; {SVI_STARTS / step_s:.1f} ELBO-steps/s, {eager_step_s / step_s:.1f}x "
          f"the eager step), the final ELBO (eager, 16 particles) {done - g.ends[-1]:.2f} s; the row's 300 steps "
          f"{row_s:.1f} s with the capture ({'measured' if SVI_STEPS == 300 else 'extrapolated'}), about "
          f"{(eager_s / SVI_EAGER_STEPS) * 300:.0f} s eager; the first {SVI_EAGER_STEPS} steps' losses equal the "
          f"eager loop's bit for bit: {first_equal}; final ELBOs finite {finite:.4f} (gate {MIN_FINITE_ELBO}), best "
          f"start {int(result.best_idx)} ELBO {float(result.final_elbos[result.best_idx]):.2f}; start 0's loss "
          f"{float(start0[0]):.2f} -> {float(start0[-1]):.2f}; Predictive(guide, {SVI_SAMPLES}) {pred_s:.1f} s, "
          f"r0_scales mean {np.round(post['r0_scales'].double().mean(dim=0).cpu().numpy(), 4).tolist()} [{smi}]")
    check(first_equal, "(c) the graphed SVI bank's first losses differ from the eager loop's")
    check(finite >= MIN_FINITE_ELBO, f"(c) finite final ELBOs on {finite:.4f} of the starts")
    check(float(start0[-1]) < float(start0[0]), "(c) start 0's loss did not fall")
    check(post["r0_scales"].shape == (SVI_SAMPLES, 3) and bool(torch.isfinite(post["r0_scales"]).all()),
          "(c) Predictive draws")
    kept_mem = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
    first_params = {k: v.clone() for k, v in result.all_params.items()}
    # the same fit again on the same SVI and obs: the kept bank's graph, no capture
    with svi_graphs() as again_graphs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = svi.run_multistart(SEED, num_steps=SVI_STEPS, num_starts=SVI_STARTS, obs=obs)
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t
    again_equal = (torch.equal(again.all_losses, result.all_losses) and torch.equal(again.final_elbos,
                                                                                   result.final_elbos)
                   and all(torch.equal(again.all_params[k], v) for k, v in first_params.items()))
    not_aliased = all(torch.equal(result.all_params[k], v) for k, v in first_params.items())
    print(f"      the same fit again on the same SVI and obs (the kept bank): {again_s:.1f} s against the first run's "
          f"{svi_s:.1f} s; graphs captured {len(again_graphs)}, the kept graph's captures {g.captures} and replays "
          f"{g.replays}; equal to the first run bit for bit: {again_equal}; the first result unchanged: "
          f"{not_aliased}; with the kept bank {kept_mem[0] / 2**30:.2f} GiB reserved, {kept_mem[1] / 2**30:.2f} GiB "
          f"allocated [{smi}]")
    check(not again_graphs and g.captures == 1 and g.replays == 2 * SVI_STEPS,
          "(c) the second run on the kept bank captured a graph")
    check(again_equal, "(c) the second run on the kept bank differs from the first")
    check(not_aliased, "(c) the second run overwrote the first result's parameters")
    t = time.perf_counter()
    svi_err = svi_card_vs_cpu(dev, obs)
    print(f"      card (through the graph) vs CPU, {SVI_CHECK[0]} starts x {SVI_CHECK[1]} steps, {SVI_CHECK[2]} days, "
          f"float64, draws recorded on the CPU and replayed: parameters max rel err {svi_err:.3e} (tol {TOL_CARD_CPU:.0e}); "
          f"{time.perf_counter() - t:.1f} s")
    check(svi_err <= TOL_CARD_CPU, f"(c) SVI card vs CPU: rel err {svi_err:.3e}")
    phase_s = time.perf_counter() - t_phase
    print(f"  phase 16: {phase_s:.1f} s (gate {SLICE_BUDGET_S:.0f} s)")
    check(phase_s <= SLICE_BUDGET_S, f"phase 16 took {phase_s:.1f} s, over its {SLICE_BUDGET_S:.0f} s")
    return launches


@functools.cache
def stiff_seirs():
    """``(ode, Params)``: the stiff SEIRS of ``examples/seirs_stiff_waning.py:46-62``
    on the port, a fast boosting compartment B that decays into R at
    kappa = 50 per day against weeks-long transmission."""
    import torch

    from dynode_tpu_torch.struct import pytree_dataclass

    @pytree_dataclass
    class StiffSEIRSParams:
        beta: torch.Tensor
        sigma: torch.Tensor  # E -> I
        gamma: torch.Tensor  # I -> B
        kappa: torch.Tensor  # B -> R, the stiff rate
        omega: torch.Tensor  # R -> S waning

    def stiff_seirs_ode(t, state, p: StiffSEIRSParams):
        s, e, i, b, r = state
        n = s + e + i + b + r
        foi = p.beta * i / n
        return (
            -foi * s + p.omega * r,
            foi * s - p.sigma * e,
            p.sigma * e - p.gamma * i,
            p.gamma * i - p.kappa * b,
            p.kappa * b - p.omega * r,
        )

    # the hint as a class (this module's annotations are strings): simulate checks the params' type
    stiff_seirs_ode.__annotations__["p"] = StiffSEIRSParams
    return stiff_seirs_ode, StiffSEIRSParams


def stiff_inputs(dtype, device, beta=None):
    """``(y0, params)`` of the stiff SEIRS; ``beta`` (a tensor) gives a
    batch whose other rates are broadcast to its members."""
    import torch

    _, params = stiff_seirs()
    y0 = tuple(torch.tensor(v, dtype=dtype, device=device) for v in STIFF_Y0)
    rates = [torch.tensor(v, dtype=dtype, device=device) for v in STIFF]
    if beta is not None:
        rates = [beta] + [r.expand(beta.shape).clone() for r in rates[1:]]
    return y0, params(*rates)


def rel64(got, want) -> float:
    """max |got - want| / max |want| in float64, over tuples of tensors."""
    return max(float((g.double().cpu() - w.double().cpu()).abs().max() / w.double().cpu().abs().max())
               for g, w in zip(got, want))


def mesh_phase(dev, smi: str, fit, k) -> dict:
    """Phase 17: the stiff solvers and the mesh split on the card (module
    docstring). ``k`` holds the main path's inputs of kernels #1, #3, #4
    and #5. Returns each kernel's launches on the split entries' path."""
    import numpy as np
    import torch
    from scipy.integrate import solve_ivp

    from dynode_tpu_torch import SolverParams, dist, simulate, simulate_ensemble
    from dynode_tpu_torch.infer import SVI, Adam, AutoMultivariateNormal, ChEES, MCMC, Trace_ELBO
    from dynode_tpu_torch.infer.mcmc import graphed_potential, split_pot_and_grad
    from dynode_tpu_torch.models import multistrain as model
    from dynode_tpu_torch.ode import (
        ImplicitEuler,
        ODETerm,
        PIDController,
        SaveAt,
        TRBDF2,
        diffeqsolve,
    )
    from dynode_tpu_torch.ops import generic as gen
    from dynode_tpu_torch.ops import generic_triton as gtri
    from dynode_tpu_torch.ops import seip as tsp
    from dynode_tpu_torch.ops import sharded
    from dynode_tpu_torch.parallel import create_mesh
    from dynode_tpu_torch.parallel.mesh import shard_plan
    from torch.utils._pytree import tree_leaves

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    f64 = torch.float64
    n_cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(n_cards)] if n_cards > 1 else [dev, dev]
    mesh = create_mesh(("ensemble",), devices=devices)
    print(f"phase 17: the stiff solvers and the mesh split on the card; mesh {mesh.shape} over "
          f"{'every visible card' if n_cards > 1 else 'the one card listed twice (its shards run in turn)'}: "
          f"{[str(d) for d in devices]} [{smi}]")
    ode, _ = stiff_seirs()
    rtol, atol = STIFF_TOLS

    def steps(sol):
        return int(sol.stats["num_accepted"].sum()), int(sol.stats["num_rejected"].sum())

    # (a) stiff solves in float64
    sp_tr = SolverParams(solver_method=TRBDF2(), ode_solver_rel_tolerance=rtol, ode_solver_abs_tolerance=atol,
                         step_budget=STIFF_BUDGET, steps_per_save=STIFF_SPS)
    runs = {}
    for where in (dev, cpu):
        y0, p = stiff_inputs(f64, where)
        t = time.perf_counter()
        runs[where.type] = (simulate(ode, STIFF_DAYS, y0, p, sp_tr), time.perf_counter() - t)
    (card, card_s), (host, host_s) = runs[dev.type], runs["cpu"]
    y0, p = stiff_inputs(f64, cpu)
    ref = simulate(ode, STIFF_DAYS, y0, p, SolverParams(ode_solver_rel_tolerance=rtol, ode_solver_abs_tolerance=atol,
                                                         step_budget=TSIT5_BUDGET))
    err = rel64(card.ys, host.ys)
    excess = max(float(((a.cpu() - b).abs() - (STIFF_AGREE[1] + STIFF_AGREE[0] * b.abs())).max())
                 for a, b in zip(card.ys, ref.ys))
    n_tr, n_ts = sum(steps(card)), sum(steps(ref))
    print(f"  (a) stiff SEIRS (kappa {STIFF[3]:g}/day, examples/seirs_stiff_waning.py), {STIFF_DAYS} days, "
          f"TRBDF2 rtol {rtol:g} atol {atol:g} budget {STIFF_BUDGET} ({STIFF_SPS} steps a save interval): result "
          f"{int(card.result)}, accepted / "
          f"rejected on the card {steps(card)}, on the CPU {steps(host)}; card vs CPU max rel {err:.3e} (tol "
          f"{TOL_STIFF_CPU:.0e}); vs Tsit5 (budget {TSIT5_BUDGET}, CPU, {n_ts} steps): max |d| - (atol "
          f"{STIFF_AGREE[1]:g} + rtol {STIFF_AGREE[0]:g} |ref|) = {excess:.3e} (<= 0); {n_tr} TRBDF2 steps, "
          f"{n_ts / n_tr:.1f}x fewer (gate 4x); {card_s:.2f} s on the card, {host_s:.2f} s on the CPU [{smi}]")
    check(int(card.result) == 0, "stiff SEIRS: TRBDF2 did not finish")
    check(steps(card) == steps(host), f"stiff SEIRS: card and CPU took other steps {steps(card)}, {steps(host)}")
    check(err <= TOL_STIFF_CPU, f"stiff SEIRS card vs CPU: {err:.3e}")
    check(excess <= 0.0, f"stiff SEIRS TRBDF2 vs Tsit5: excess {excess:.3e}")
    check(n_tr < n_ts / 4, f"TRBDF2 took {n_tr} steps, Tsit5 {n_ts}: not a quarter")
    y0, p = stiff_inputs(f64, dev)
    t = time.perf_counter()
    ie = simulate(ode, STIFF_DAYS, y0, p, SolverParams(solver_method=ImplicitEuler(), ode_solver_rel_tolerance=IE_TOLS[0],
                                                        ode_solver_abs_tolerance=IE_TOLS[1], step_budget=IE_BUDGET,
                                                        steps_per_save=IE_SPS))
    ie_s = time.perf_counter() - t
    ie_err = rel64(ie.ys, ref.ys)
    print(f"      ImplicitEuler rtol {IE_TOLS[0]:g} atol {IE_TOLS[1]:g} budget {IE_BUDGET} ({IE_SPS} steps a save "
          f"interval): result {int(ie.result)}, "
          f"steps {steps(ie)}; vs Tsit5 max |d| / max |ref| {ie_err:.3e} (bound {TOL_IE:g}, first order); "
          f"{ie_s:.2f} s")
    check(int(ie.result) == 0 and ie_err <= TOL_IE, f"ImplicitEuler: result {int(ie.result)}, {ie_err:.3e}")

    def rober(t, y, args):
        y1, y2, y3 = y[0][0], y[0][1], y[0][2]
        return (torch.stack([-0.04 * y1 + 1e4 * y2 * y3, 0.04 * y1 - 1e4 * y2 * y3 - 3e7 * y2**2, 3e7 * y2**2]),)

    (r_rtol, r_atol), (g_rtol, g_atol) = ROBER
    t = time.perf_counter()
    rob = diffeqsolve(ODETerm(rober), TRBDF2(), 0.0, 100.0, None, (torch.tensor([1.0, 0.0, 0.0], dtype=f64, device=dev),),
                      saveat=SaveAt(ts=np.array([1.0, 10.0, 100.0])),
                      stepsize_controller=PIDController(rtol=r_rtol, atol=r_atol), max_steps=4096)
    rob_s = time.perf_counter() - t
    radau = solve_ivp(lambda t, y: np.array([-0.04 * y[0] + 1e4 * y[1] * y[2],
                                             0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] ** 2, 3e7 * y[1] ** 2]),
                      (0, 100), [1.0, 0.0, 0.0], method="Radau", t_eval=[1.0, 10.0, 100.0], rtol=1e-10,
                      atol=1e-12).y.T
    got = rob.ys[0].cpu().numpy()
    rob_excess = float(np.max(np.abs(got - radau) - (g_atol + g_rtol * np.abs(radau))))
    mass = float(np.max(np.abs(got.sum(axis=-1) - 1.0)))
    print(f"      Robertson, TRBDF2 rtol {r_rtol:g} atol {r_atol:g}: result {int(rob.result)}, steps {steps(rob)}; "
          f"vs scipy Radau: max |d| - (atol {g_atol:g} + rtol {g_rtol:g} |ref|) = {rob_excess:.3e} (<= 0); mass "
          f"drift {mass:.3e} (tol 1e-9); {rob_s:.2f} s")
    check(int(rob.result) == 0 and rob_excess <= 0.0 and mass <= 1e-9, f"Robertson: {rob_excess:.3e}, {mass:.3e}")

    # the multi-strain model at its published widths; one member through
    # simulate_ensemble, whose buffered engine steps a chunk at a time (the
    # grid engine of simulate gives each of the 200 intervals the slots of
    # its stiffest: on the card every slot runs, masked)
    (ms_tr, ms_ts, ms_budget) = MS_STIFF
    p_ms = model.multistrain_default_params(dtype=f64, device=dev)
    y_ms = model.multistrain_initial_state(dtype=f64, device=dev)
    p1 = torch.utils._pytree.tree_map(lambda x: x[None].clone(), p_ms)
    t = time.perf_counter()
    ms_sol = simulate_ensemble(model.multistrain_ode, MS_STIFF_DAYS, y_ms, p1, SolverParams(
        solver_method=TRBDF2(), ode_solver_rel_tolerance=ms_tr[0], ode_solver_abs_tolerance=ms_tr[1],
        step_budget=ms_budget))
    ms_s = time.perf_counter() - t
    ms_ref = simulate(model.multistrain_ode, MS_STIFF_DAYS, tuple(x.cpu() for x in y_ms),
                      torch.utils._pytree.tree_map(lambda x: x.cpu(), p_ms),
                      SolverParams(ode_solver_rel_tolerance=ms_ts[0], ode_solver_abs_tolerance=ms_ts[1]))
    ms_err = rel64([x[0] for x in ms_sol.ys], ms_ref.ys)
    print(f"      multi-strain (A, K) = {tuple(p_ms.contact_matrix.shape[:1]) + tuple(p_ms.beta.shape)}, "
          f"{sum(x.numel() for x in y_ms)} rows, {MS_STIFF_DAYS} days, "
          f"TRBDF2 rtol {ms_tr[0]:g} atol {ms_tr[1]:g}: result {int(ms_sol.result[0])}, steps {steps(ms_sol)}, "
          f"{ms_s:.2f} s; vs Tsit5 rtol {ms_ts[0]:g} atol {ms_ts[1]:g} (CPU): max rel {ms_err:.3e} (tol "
          f"{TOL_MS_STIFF:.0e})")
    check(int(ms_sol.result[0]) == 0 and ms_err <= TOL_MS_STIFF, f"multi-strain TRBDF2 vs Tsit5: {ms_err:.3e}")

    beta = torch.tensor(STIFF[0], dtype=f64, device=dev, requires_grad=True)
    sp_grad = SolverParams(solver_method=TRBDF2(), constant_step_size=DT)

    def loss(b):
        y0, p = stiff_inputs(f64, dev)
        return simulate(ode, GRAD_DAYS, y0, p.replace(beta=b), sp_grad).ys[2].sum() / 1e4

    t = time.perf_counter()
    loss(beta).backward()
    h = FD_STEP * STIFF[0]
    with torch.no_grad():
        fd = float((loss(beta.detach() + h) - loss(beta.detach() - h)) / (2 * h))
    grad_rel = abs(float(beta.grad) - fd) / abs(fd)
    print(f"      d/dbeta of sum(I) / 1e4 over {GRAD_DAYS} days through TRBDF2 at dt = {DT}: autograd "
          f"{float(beta.grad):.10e}, "
          f"central differences (h = {h:g}) {fd:.10e}: rel {grad_rel:.3e} (tol {TOL_FD:.0e}); "
          f"{time.perf_counter() - t:.1f} s")
    check(grad_rel <= TOL_FD, f"TRBDF2 gradient vs central differences: {grad_rel:.3e}")
    print(f"      (a) took {time.perf_counter() - t_phase:.1f} s")

    # (b) a stiff ensemble, float32, batch-leading
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    betas = dist.Uniform(0.2, 0.4).sample(gen_dev, (STIFF_ENSEMBLE,))
    y32, p32 = stiff_inputs(torch.float32, dev, beta=betas)
    sp32 = SolverParams(solver_method=TRBDF2(), ode_solver_rel_tolerance=rtol, ode_solver_abs_tolerance=atol,
                        step_budget=STIFF_BUDGET)

    def ensemble():
        return simulate_ensemble(ode, STIFF_ENSEMBLE_DAYS, y32, p32, sp32)

    from torch.profiler import ProfilerActivity, profile

    walls = []
    for run in range(3):  # eager: (a) ran the same operations, so no warm-up; the device traced in the last
        torch.cuda.synchronize()
        t = time.perf_counter()
        if run < 2:
            ens = ensemble()
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ens = ensemble()
                torch.cuda.synchronize()
        float(ens.ys[0][-1, -1])
        walls.append(time.perf_counter() - t)
    ens_s = statistics.median(walls)
    n_steps = (ens.stats["num_accepted"] + ens.stats["num_rejected"]).cpu()
    check(int(ens.result.max()) == 0, "stiff ensemble: a member did not finish")
    pick = torch.randperm(STIFF_ENSEMBLE, generator=torch.Generator().manual_seed(SEED))[:STIFF_PICK].tolist()
    member_err, same_steps = 0.0, True
    t = time.perf_counter()
    for i in pick:
        _, p_i = stiff_inputs(torch.float32, dev, beta=betas[i:i + 1])
        one = simulate_ensemble(ode, STIFF_ENSEMBLE_DAYS, y32, p_i, sp32)
        member_err = max(member_err, rel64([x[0] for x in one.ys], [x[i] for x in ens.ys]))
        same_steps &= all(int(one.stats[key][0]) == int(ens.stats[key][i]) for key in ("num_accepted", "num_rejected"))
    single_s = (time.perf_counter() - t) / STIFF_PICK
    on_card = [e for e in prof.profiler.kineto_results.events() if e.device_type() == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.duration_ns() for e in on_card) / 1e9
    idle = f"{1.0 - busy_s / walls[2]:.1%} ({len(on_card)} device operations, busy {busy_s:.3f} s of the traced run's " \
        f"{walls[2]:.2f} s)" if on_card else "not measured (the profiler saw no device time)"
    print(f"  (b) stiff ensemble: {STIFF_ENSEMBLE} members, {STIFF_ENSEMBLE_DAYS} days, beta ~ Uniform(0.2, 0.4), "
          f"float32, batch_leading, TRBDF2: "
          f"wall {ens_s:.2f} s (median of 3; host clock), steps per member min / median / max "
          f"{int(n_steps.min())} / {int(n_steps.median())} / {int(n_steps.max())}, every result 0; device idle share "
          f"{idle}; {STIFF_PICK} members against single-member solves ({single_s:.2f} s each): max rel "
          f"{member_err:.3e} (tol {TOL_STIFF_MEMBER:.0e}), equal steps {same_steps} [{smi}]")
    check(member_err <= TOL_STIFF_MEMBER and same_steps, f"stiff members vs single solves: {member_err:.3e}")
    print(f"      (a) and (b) took {time.perf_counter() - t_phase:.1f} s")

    # (c) the four split kernel entries at bench widths, against the unsplit ones
    counters = {"rk_solve": gtri.launch_rk_solve, "rk_solve_adaptive": gtri.launch_rk_solve_adaptive,
                "seip_rk4": tsp.launch_seip_rk4, "seip_bs3": tsp.launch_seip_bs3}
    mesh_launches = dict.fromkeys(counters, 0)
    rhs_ms, y_w, p_w = k["rhs"], k["y_wide"], k["p_wide"]
    seip_c = dict(save=(3,))
    cases = (
        ("rk_solve", f"obs_max B={WIDE}, Tsit5, c rows bf16",
         lambda: gen.ensemble_solve_kernel(rhs_ms, y_w, p_w, duration=DAYS, dt=DT, **k["obs_kw"]),
         lambda: sharded.ensemble_solve_kernel_sharded(rhs_ms, y_w, p_w, mesh=mesh, duration=DAYS, dt=DT,
                                                       **k["obs_kw"])),
        ("rk_solve_adaptive", f"adaptive_obs B={WIDE}, bosh3, block_b {gen.ADAPTIVE_BLOCK}",
         lambda: gen.ensemble_solve_kernel_adaptive(rhs_ms, y_w, p_w, **k["adaptive_kw"], **k["obs_kw"]),
         lambda: sharded.ensemble_solve_kernel_adaptive_sharded(rhs_ms, y_w, p_w, mesh=mesh, **k["adaptive_kw"],
                                                                **k["obs_kw"])),
        ("seip_rk4", f"seip_c B={SEIP_WIDE}, RK4, C f32",
         lambda: tsp.seip_ensemble_solve(k["sy"], k["sp"], k["scales"], duration=DAYS, dt=DT, **seip_c),
         lambda: sharded.seip_ensemble_solve_sharded(k["sy"], k["sp"], k["scales"], mesh=mesh, duration=DAYS, dt=DT,
                                                     **seip_c)),
        ("seip_bs3", f"seip_adaptive B={SEIP_WIDE}, BS3, block_b {tsp.SEIP_ADAPTIVE_BLOCK}, C f32",
         lambda: tsp.seip_ensemble_solve_adaptive(k["sy"], k["sp"], k["scales"], **k["seip_kw"], **seip_c),
         lambda: sharded.seip_ensemble_solve_adaptive_sharded(k["sy"], k["sp"], k["scales"], mesh=mesh,
                                                              **k["seip_kw"], **seip_c)),
    )
    for name, what, whole, split in cases:
        whole_ms, want = median_tree_ms(whole)
        counter = counters[name]
        counter.launches = 0
        split_ms, got = median_tree_ms(split)
        mesh_launches[name] += counter.launches
        if isinstance(want, tuple) and isinstance(want[-1], dict):  # (saves, stats)
            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])))
            same_stats = all(torch.equal(got[1][key], want[1][key]) for key in want[1])
        else:
            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
            same_stats = True
        print(f"  (c) {name} split ({what}): {counter.launches // 4} launches a call; bit for bit: {same}, stats "
              f"equal: {same_stats}; split {split_ms:.3f} ms, unsplit {whole_ms:.3f} ms (median of 3) [{smi}]")
        check(same and same_stats, f"the split {name} entry differs from the unsplit one")
        check(counter.launches > 0, f"the split {name} entry launched no kernel")
        del want, got
    y_r, p_r = y_w[:, :RAGGED_ADAPTIVE].contiguous(), p_w[:, :RAGGED_ADAPTIVE].contiguous()
    rag_kw = dict(**k["adaptive_kw"], **k["obs_kw"])
    gtri.launch_rk_solve_adaptive.launches = 0
    got, st = sharded.ensemble_solve_kernel_adaptive_sharded(rhs_ms, y_r, p_r, mesh=mesh, **rag_kw)
    mesh_launches["rk_solve_adaptive"] += gtri.launch_rk_solve_adaptive.launches
    want, _ = gen.ensemble_solve_kernel_adaptive(rhs_ms, y_r, p_r, **rag_kw)
    rag = rel_err(got, want)[1]
    print(f"      ragged: B={RAGGED_ADAPTIVE}, {RAGGED_ADAPTIVE // 2} a shard (not a multiple of block_b "
          f"{gen.ADAPTIVE_BLOCK}), c rows bf16: exhausted {int(st['exhausted_intervals'].sum())}, max rel {rag:.3e} "
          f"against the unsplit (tol {TOL_RAGGED:.0e}: the solve tolerance, then one bf16 rounding)")
    check(rag <= TOL_RAGGED and int(st["exhausted_intervals"].sum()) == 0, f"ragged split: {rag:.3e}")
    del got, want

    # (d) mesh= on the engine and on inference
    def batch_params(params, s):
        pb = torch.utils._pytree.tree_map(lambda leaf: leaf.expand((s.shape[0],) + leaf.shape), params)
        return pb.replace(beta=params.beta[None, :] * s[:, None])

    base, y0 = model.multistrain_default_params(device=dev), model.multistrain_initial_state(device=dev)
    lane_scales, lane, lane_s = k["lane"]  # phase 13 (b)'s solve
    lane_p = batch_params(base, lane_scales)
    sp_c = SolverParams(constant_step_size=DT)
    for what, call, done in (
        (f"engine_lane_10k: lane_major B={ENSEMBLE}, Tsit5 dt={DT}, float32, {DAYS:.0f} days (unsplit: phase 13 (b))",
         lambda m: simulate_ensemble(model.multistrain_ode, int(DAYS), y0, lane_p, sp_c, layout="lane_major", mesh=m),
         (lane, lane_s)),
        (f"(b)'s stiff ensemble: batch_leading B={STIFF_ENSEMBLE}, TRBDF2 (unsplit: (b))",
         lambda m: simulate_ensemble(ode, STIFF_ENSEMBLE_DAYS, y32, p32, sp32, mesh=m), (ens, ens_s)),
    ):
        whole, whole_s = done
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = call(mesh)
        torch.cuda.synchronize()
        split_s = time.perf_counter() - t
        same = all(torch.equal(a, b) for a, b in zip(got.ys, whole.ys)) and torch.equal(got.result, whole.result)
        same &= all(torch.equal(got.stats[key], whole.stats[key]) for key in whole.stats)
        print(f"  (d) simulate_ensemble(mesh=) {what}: bit for bit {same}; split {split_s:.2f} s, unsplit "
              f"{whole_s:.2f} s")
        check(same, f"simulate_ensemble(mesh=) differs: {what}")
        del whole, got

    chain_mesh = create_mesh(("chain",), devices=devices)
    plan = shard_plan(chain_mesh, "chain", MESH_CHAINS, "chain bank")
    days = fit.obs.shape[0]
    potential, fit_fn = fit.potential, fit_model(days=days, device=dev)
    if n_cards > 1:
        # the fit's tensors live on one card: a copy on each card, picked
        # by the device of the positions or of the observations
        on_card = {d: (fit_potential(fit.obs, days=days, device=d), fit_model(days=days, device=d)) for d in devices}

        def potential(zb):
            return on_card[zb.device][0].potential(zb)

        def fit_fn(obs=None):
            return on_card[obs.device][1](obs=obs)

    z0 = fit.transform.inv(fit.prior.sample(torch.Generator(device=dev).manual_seed(SEED), (MESH_CHAINS,)))
    shards = {s: graphed_potential(potential, plan.width, 3, torch.float32, plan.place(s),
                                   mesh=(chain_mesh.key(), "chain")) for s in plan.local}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s in plan.local:  # warm-up and capture of each card's shard graph at its width, one after another
        shards[s](z0[s * plan.width:(s + 1) * plan.width].to(plan.place(s)))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    n_graphs = len({id(g) for g in shards.values()})
    replay_ms, _ = median_ms(lambda: shards[plan.local[0]](z0[:plan.width])[0])
    whole = graphed_potential(fit.potential, MESH_CHAINS, 3, torch.float32, dev)  # phase 16's, cached
    warm, draws = MESH_CHEES
    mcmc = MCMC(ChEES(fit_fn, batched_potential_fn=potential), num_warmup=warm, num_samples=draws,
                num_chains=MESH_CHAINS, mesh=chain_mesh, chain_axis="chain")
    t = time.perf_counter()
    mcmc.run(torch.Generator(device=dev).manual_seed(SEED), obs=fit.obs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    check(len(mcmc.graphs) == len(plan.local) and all(g is shards[s] for s, g in zip(plan.local, mcmc.graphs)),
          "the split bank did not replay the shards' cached graphs")
    split_pag = split_pot_and_grad(plan, shards)
    pot_err, same = 0.0, True
    for z in (z0, mcmc.last_state.z):
        a, b = split_pag(z), whole(z)
        same &= all(torch.equal(x, y) for x, y in zip(a, b))
        pot_err = max(pot_err, rel_err(a[0], b[0])[1], rel_err(a[1], b[1])[1])
    r0 = mcmc.get_samples()["r0_scales"]
    print(f"  (d) MCMC(ChEES, mesh=) {MESH_CHAINS} chains ({len(plan.local)} shards of {plan.width}), {warm} warmup + "
          f"{draws} draws: {run_s:.1f} s; shard graph warm-up + capture {capture_s:.1f} s ({n_graphs} graph(s), one a "
          f"card), replay {replay_ms:.1f} ms (median of 3); split potential and gradient at the initial and "
          f"final positions bit for bit {same}, max rel {pot_err:.3e} (tol {TOL_MESH_POT:.0e}); draws finite "
          f"{bool(torch.isfinite(r0).all())} [{smi}]")
    check(pot_err <= TOL_MESH_POT, f"split potential vs unsplit: {pot_err:.3e}")
    check(bool(torch.isfinite(r0).all()), "MCMC(mesh=): non-finite draws")

    starts, n_steps_svi, particles = MESH_SVI
    start_mesh = create_mesh(("start",), devices=devices)
    svi_models = {d: fit_model(days=MESH_SVI_DAYS, device=d) for d in set(devices)}

    def svi_fn(obs=None):  # the model on the card of its observations
        return svi_models[obs.device](obs=obs)

    svi = SVI(svi_fn, AutoMultivariateNormal(svi_fn), Adam(0.1), Trace_ELBO())
    fits = []
    for m in (None, start_mesh):
        t = time.perf_counter()
        fits.append(svi.run_multistart(SEED, num_steps=n_steps_svi, num_starts=starts, final_particles=particles,
                                       mesh=m, obs=fit.obs[:MESH_SVI_DAYS]))
        torch.cuda.synchronize()
        fits[-1] = (fits[-1], time.perf_counter() - t)
        check([g.replays for g in svi.graphs] == [n_steps_svi] * (1 if m is None else len(devices)),
              "SVI(mesh=): not one graph a shard, replayed every step")
    (a, a_s), (b, b_s) = fits
    finite = torch.isfinite(a.final_elbos)
    check(torch.equal(finite, torch.isfinite(b.final_elbos)), "SVI(mesh=): other starts' final ELBOs are finite")
    elbo_err = rel64([b.final_elbos[finite]], [a.final_elbos[finite]])
    param_err = rel64([b.all_params[key] for key in a.all_params], [a.all_params[key] for key in a.all_params])
    print(f"  (d) SVI.run_multistart(mesh=) {starts} starts x {n_steps_svi} steps, {MESH_SVI_DAYS} days: best start {int(b.best_idx)} "
          f"(unsplit {int(a.best_idx)}); final ELBOs max rel {elbo_err:.3e}, parameters {param_err:.3e} (tol "
          f"{TOL_MESH_SVI:.0e}); split {b_s:.1f} s, unsplit {a_s:.1f} s [{smi}]")
    check(int(a.best_idx) == int(b.best_idx), "SVI(mesh=): another best start")
    check(elbo_err <= TOL_MESH_SVI and param_err <= TOL_MESH_SVI, f"SVI(mesh=): {elbo_err:.3e}, {param_err:.3e}")
    phase_s = time.perf_counter() - t_phase
    print(f"  phase 17: {phase_s:.1f} s (gate {MESH_BUDGET_S:.0f} s); split entries' launches {mesh_launches}")
    check(phase_s <= MESH_BUDGET_S, f"phase 17 took {phase_s:.1f} s, over its {MESH_BUDGET_S:.0f} s")
    return mesh_launches


def shapes_phase(dev, smi: str, build_wall) -> dict:
    """Phase 18: the kernels' other shapes, from their configs (module
    docstring). ``build_wall()`` waits for the shape builds started with the
    library's and gives their nvcc round's wall seconds. Returns, for
    kernels #2, #4, #5 and #6, their launches on this path and each new
    shape's time, bound and compile facts."""
    import numpy as np
    import torch

    from dynode_tpu_torch import SolverParams, simulate_ensemble
    from dynode_tpu_torch.config import Strain
    from dynode_tpu_torch.models import multistrain as ms_model
    from dynode_tpu_torch.models import seip as seip_model
    from dynode_tpu_torch.ode.solvers import METHODS
    from dynode_tpu_torch.ops import _build
    from dynode_tpu_torch.ops import multistrain as ms
    from dynode_tpu_torch.ops import seip as tsp
    from dynode_tpu_torch.ops import sharded
    from dynode_tpu_torch.parallel import create_mesh

    wall = build_wall()
    print(f"phase 18: the kernels' other shapes from their configs [{smi}]; shape builds {shape_units()}: "
          f"nvcc round {wall:.1f} s wall, beside the library's")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 18)
    f32, n_days = torch.float32, int(DAYS) + 1
    n_steps = int(round(DAYS / DT))
    out = {name: {"shape_path_launches": 0, "shapes": []} for name in
           ("multistrain_tsit5", "seip_rk4", "seip_bs3", "multistrain_tsit5_2d")}
    launchers = {"multistrain_tsit5": ms.launch_multistrain_tsit5, "multistrain_tsit5_2d": ms.launch_multistrain_tsit5_2d,
                 "seip_rk4": tsp.launch_seip_rk4, "seip_bs3": tsp.launch_seip_bs3}

    def launched(run):
        """``run()`` with every launch count set to 0 before it; each kernel's
        launches in it are added to its row."""
        for fn in launchers.values():
            fn.launches = 0
        tsp.launch_seip_time_table.launches = 0
        torch.cuda.synchronize()
        result = run()
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in launchers.items()}
        for name, n in counts.items():
            out[name]["shape_path_launches"] += n
        return result, counts, tsp.launch_seip_time_table.launches

    def facts(family, shape, kernel):
        """Registers and spill bytes of the shape build's ``kernel``."""
        res = _build.ptxas_resources(_build.shape_build_log(family, shape))
        return next((v for k, v in res.items() if kernel in k), {})

    def record(name, shape, batch, event, flops, nbytes, launches, compiled, plain_ms, what):
        bound_ms, bound_by = max((flops / PEAK_F32_FLOPS * 1e3, "operations"), (nbytes / PEAK_BYTES * 1e3, "bytes"))
        row = {"shape": list(shape), "batch": batch, "ms": event, "bound_ms": bound_ms, "bound_by": bound_by,
               "share": bound_ms / event, "launches": launches, "plain_ms": plain_ms, "plain_batch": SHAPE_CHECK,
               "plain_days": SHAPE_CHECK_DAYS, "library_ms": None, **compiled}
        out[name]["shapes"].append(row)
        print(f"  {name} {what}, B={batch}: kernel {event:.3f} ms (CUDA events); {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB -> bound {bound_ms:.4f} ms by {bound_by} ({bound_ms / event:.1%} of it); "
              f"{launches} launch(es) on the path; registers {compiled.get('registers')}, spill stores / loads "
              f"{compiled.get('spill_stores')} / {compiled.get('spill_loads')} B; plain {plain_ms:.1f} ms on "
              f"{SHAPE_CHECK} members over {SHAPE_CHECK_DAYS} days [{smi}]")

    def seip_mass(outs) -> float:
        living = sum(x.float().sum(dim=(2, 3, 4)) for x in outs[:3])  # (T, A, B)
        return float(((living - living[0]).abs() / living[0]).max())

    # ---- (a) SEIP at seip_config()'s default and at a second shape --------------
    seip_kw = dict(duration=DAYS, rtol=SEIP_RTOL, atol=SEIP_ATOL)
    unsplit = {}
    for name, shape in SEIP_SHAPES.items():
        cfg = seip_shape_config(seip_model, Strain, name)
        sp, sy = seip_model.seip_odeparams(cfg, device=dev), seip_model.seip_initial_state(cfg, device=dev)
        P = tsp.seip_static_params(sp)
        check((*P.dims, int(P.seasonal)) == shape, f"seip_config {name}: shape {(*P.dims, P.seasonal)}")
        L, cells = P.dims[-1], int(np.prod(P.dims[:3]))
        values = cells * (P.dims[3] + 3 * L)  # floats of a member's state
        scales = torch.as_tensor(rng.uniform(0.85, 1.2, (L, SEIP_WIDE)), dtype=f32, device=dev)
        what = f"{name} {shape}"
        ((c_rk4,), ((c_bs3,), st)), counts, table_n = launched(lambda: (
            tsp.seip_ensemble_solve(sy, sp, scales, duration=DAYS, dt=DT, save=(3,)),
            tsp.seip_ensemble_solve_adaptive(sy, sp, scales, save=(3,), save_dtype=torch.bfloat16, packed=True,
                                             **seip_kw)))
        check(counts["seip_rk4"] > 0 and counts["seip_bs3"] > 0 and table_n > 0,
              f"SEIP {what}: a kernel of the path did not launch: {counts}, table {table_n}")
        check(tuple(c_rk4.shape) == (n_days, *P.dims[:3], L, SEIP_WIDE), f"SEIP {what}: C {tuple(c_rk4.shape)}")
        check(bool(torch.isfinite(c_rk4).all()) and bool(torch.isfinite(c_bs3).all()), f"SEIP {what}: non-finite")
        n_bad = int(st["exhausted_intervals"].sum())
        print(f"  (a) SEIP {what} from seip_config, B={SEIP_WIDE}, {DAYS:.0f} days: RK4 dt={DT} C f32, BS3 C bf16 "
              f"packed ({int((st['n_accepted'] + st['n_rejected']).sum())} attempts in {st['n_accepted'].shape[0]} "
              f"blocks, {n_bad} exhausted); launches {counts}, time table {table_n}")
        check(n_bad == 0, f"SEIP {what}: {n_bad} exhausted intervals")
        if name == "default":
            unsplit = dict(sp=sp, sy=sy, scales=scales, c=c_rk4)
        # against the plain versions on the first SHAPE_CHECK members over SHAPE_CHECK_DAYS: every
        # compartment in float32, and the main path's first saves
        sub = scales[:, :SHAPE_CHECK].contiguous()
        check_kw = dict(duration=float(SHAPE_CHECK_DAYS), dt=DT)
        n_check = SHAPE_CHECK_DAYS + 1
        p_rk4, want = wall_ms(lambda: tsp.seip_solve_reference(sy, sp, sub, dtype=f32, **check_kw))
        got = tsp.seip_ensemble_solve(sy, sp, sub, **check_kw)
        errs = [rel_err(g, w)[1] for g, w in zip(got, want)]
        same = torch.equal(got[3], c_rk4[:n_check, ..., :SHAPE_CHECK])
        drift = seip_mass(got)
        print(f"      RK4 vs plain, {SHAPE_CHECK} members, {SHAPE_CHECK_DAYS} days, S E I C f32: max rel {max(errs):.3e} "
              f"(tol {TOL_F32:.0e}); their C equal to the main path's bit for bit: {same}; per-age mass drift "
              f"{drift:.3e}")
        check(max(errs) <= TOL_F32 and same and drift <= TOL_MASS, f"SEIP RK4 {what} against its plain version")
        P64 = tsp.seip_static_params(sp)
        table = tsp.launch_seip_time_table(P64, dt=DT, n_steps=n_steps, device=dev)
        check(torch.equal(table, tsp.seip_time_table_reference(P64, dt=DT, n_steps=n_steps, device=dev)),
              f"SEIP {what}: the time table differs from its plain version")
        plain_stats = {}

        bs3_kw = dict(seip_kw, duration=float(SHAPE_CHECK_DAYS))

        def bs3_plain():
            outs, plain_stats["s"] = tsp.seip_solve_adaptive_reference(
                sy, sp, sub, block_b=tsp.SEIP_ADAPTIVE_BLOCK, dtype=f32, **bs3_kw)
            return outs

        p_bs3, want = wall_ms(bs3_plain)
        wst = plain_stats["s"]
        got, gst = tsp.seip_ensemble_solve_adaptive(sy, sp, sub, **bs3_kw)
        nb = gst["n_accepted"].shape[0]
        same_st = all(torch.equal(gst[k], wst[k]) for k in wst)
        same_main = torch.equal(tsp.unpack_members(c_bs3)[:n_check, ..., :SHAPE_CHECK], got[3].to(torch.bfloat16))
        errs = [rel_err(g, w)[1] for g, w in zip(got, want)]
        drift = seip_mass(got)
        print(f"      BS3 vs plain, {SHAPE_CHECK} members ({nb} blocks), {SHAPE_CHECK_DAYS} days, S E I C f32: every "
              f"block's decisions equal: {same_st}; max rel {max(errs):.3e} (tol {TOL_F32:.0e}); their C equal to the "
              f"main path's (bf16) bit for bit: {same_main}; per-age mass drift {drift:.3e}; time table bit for bit")
        check(same_st and same_main and max(errs) <= TOL_F32 and drift <= TOL_MASS,
              f"SEIP BS3 {what} against its plain version")
        (c_ref,) = tsp.seip_ensemble_solve(sy, sp, sub, duration=float(SHAPE_CHECK_DAYS), dt=0.05, save=(3,))
        acc = rel_err(got[3], c_ref)[1]
        print(f"      BS3 vs RK4 at dt = 0.05, {SHAPE_CHECK} members, {SHAPE_CHECK_DAYS} days, C: max rel {acc:.3e} "
              f"(tol {TOL_SEIP_ACCURACY:.0e})")
        check(acc < TOL_SEIP_ACCURACY, f"SEIP {what}: BS3 against RK4 at dt = 0.05: {acc:.3e}")
        del want, got, c_ref
        # times and bounds at the main path's width
        norm = tsp._norm_scales(scales, L, f32, dev)
        rk4_ms = event_ms(lambda: tsp.launch_seip_rk4(sy, P64, norm, dt=DT, n_steps=n_steps, save_stride=2, save=(3,),
                                                      save_dtype=f32, packed=False), n=3)
        bs3_ms = event_ms(lambda: tsp.launch_seip_bs3(
            sy, P64, norm, n_saves=n_days, save_every=1.0, rtol=SEIP_RTOL, atol=SEIP_ATOL, dt0=1.0 / 8,
            steps_per_save=8, block_b=tsp.SEIP_ADAPTIVE_BLOCK, save=(3,), save_dtype=torch.bfloat16, packed=True), n=3)
        cpu_p, cpu_y = seip_model.seip_odeparams(cfg, device="cpu"), seip_model.seip_initial_state(cfg, device="cpu")
        work = seip_work(cpu_p, cpu_y, seip_kw)
        inputs = 4 * values + 8 * tsp._host_constants(P64).size + 4 * L * SEIP_WIDE
        c_floats = cells * L
        record("seip_rk4", shape, SEIP_WIDE, rk4_ms, n_steps * (SEIP_WIDE * work[2] + work[3]),
               inputs + 4 * n_days * c_floats * SEIP_WIDE, counts["seip_rk4"],
               facts("seip_rk4", shape, "seip_rk4_any_kernel"), p_rk4, f"{what}, C f32")
        record("seip_bs3", shape, SEIP_WIDE, bs3_ms, seip_bs3_flops(work, st, SEIP_WIDE, tsp.SEIP_ADAPTIVE_BLOCK),
               inputs + 2 * n_days * c_floats * SEIP_WIDE + 12 * st["n_accepted"].shape[0], counts["seip_bs3"],
               facts("seip_bs3", shape, "seip_bs3_any_kernel"), p_bs3, f"{what}, C bf16 packed")
        del c_rk4, c_bs3

    # ---- (b) multi-strain at four ages and three strains, from multistrain_config ----
    A, K = MS_SHAPE
    cfg = multistrain_4x3_config(ms_model)
    p, y0 = ms_model.multistrain_odeparams(cfg, device=dev), ms_model.multistrain_initial_state(cfg, device=dev)
    check(tuple(p.contact_matrix.shape) == (A, A) and p.beta.shape[0] == K, "multistrain_config (4, 3)")
    beta = p.beta[None, :] * torch.as_tensor(rng.uniform(0.6, 1.6, ENSEMBLE), dtype=f32, device=dev)[:, None]
    args = (y0, beta, p.sigma, p.gamma, p.omega, p.contact_matrix)
    kw = dict(batch=ENSEMBLE, duration=DAYS, dt=DT, n_age=A, n_strain=K)
    (rows, two_d), counts, _ = launched(lambda: (ms.ensemble_solve_tsit5(*args, **kw),
                                                 ms.ensemble_solve_tsit5_2d(*args, **kw)))
    check(counts["multistrain_tsit5"] > 0 and counts["multistrain_tsit5_2d"] > 0,
          f"multi-strain (4, 3): a kernel did not launch: {counts}")
    D = A + 4 * A * K
    _, D2 = ms._offsets_2d(A, K)
    check(tuple(rows.shape) == (n_days, D, ENSEMBLE) and tuple(two_d.shape) == (n_days, D2, ENSEMBLE),
          "multi-strain (4, 3) saves' shapes")
    team = ms.pick_team(ENSEMBLE, A)
    sub_args = (y0, beta[:SHAPE_CHECK], *args[2:])
    sub_kw = dict(kw, batch=SHAPE_CHECK, duration=float(SHAPE_CHECK_DAYS))
    for name, saves, unpack in (("multistrain_tsit5", rows, ms.unpack_saves), ("multistrain_tsit5_2d", two_d,
                                                                              ms.unpack_saves_2d)):
        check(bool(torch.isfinite(saves).all()), f"{name} (4, 3): non-finite saves")
        s_, e_, i_, r_, _ = unpack(saves, A, K)
        mass = s_ + e_.sum(-1) + i_.sum(-1) + r_.sum(-1)
        drift = float(((mass - mass[0]).abs() / mass[0]).max())
        if name == "multistrain_tsit5":
            p_ms_, want = wall_ms(lambda: ms.ensemble_solve_reference(*sub_args, **sub_kw))
        else:
            p_ms_, want = wall_ms(lambda: ms._solve_2d_reference(
                ms.pack_state_2d(y0, SHAPE_CHECK, A, K), ms.pack_rates_2d(*sub_args[1:5], SHAPE_CHECK, A, K),
                duration=float(SHAPE_CHECK_DAYS), dt=DT, save_every=1.0,
                contact_tuple=ms._contact_tuple(p.contact_matrix), n_age=A, n_strain=K))
        err = rel_err(saves[:SHAPE_CHECK_DAYS + 1, :, :SHAPE_CHECK], want)[1]
        pad_ok = True
        if name == "multistrain_tsit5_2d":
            pad = sorted(set(range(D2)) - set(ms._live_rows_2d(A, K)))
            pad_ok = not bool(saves[:, pad].any())
        print(f"  (b) {name} {MS_SHAPE} from multistrain_config (ages 0-17 / 18-49 / 50-64 / 65+), B={ENSEMBLE}, Tsit5 "
              f"dt={DT}, {DAYS:.0f} days, team of {team}: finite, per-age mass drift {drift:.3e} (tol "
              f"{TOL_MASS:.0e}); first {SHAPE_CHECK} members' first {SHAPE_CHECK_DAYS} days vs plain max rel "
              f"{err:.3e} (tol {TOL_F32:.0e}); "
              f"padding rows zero: {pad_ok}")
        check(drift <= TOL_MASS and err <= TOL_F32 and pad_ok, f"{name} (4, 3) against its plain version")
        if name == "multistrain_tsit5":
            y_p, p_p = ms.pack_state(y0, ENSEMBLE, A, K), ms.pack_params(*args[1:5], ENSEMBLE, K)
            launch, flops = ms.launch_multistrain_tsit5, n_steps * ENSEMBLE * step_flops(METHODS["tsit5"],
                                                                                       rhs_flops(A, K), D)
            nbytes = 4 * ENSEMBLE * (D + 4 * K) + 4 * A * A + 4 * n_days * D * ENSEMBLE
        else:
            y_p, p_p = ms.pack_state_2d(y0, ENSEMBLE, A, K), ms.pack_rates_2d(*args[1:5], ENSEMBLE, A, K)
            launch, flops = ms.launch_multistrain_tsit5_2d, n_steps * ENSEMBLE * step_flops_2d(METHODS["tsit5"], A, K)
            nbytes = 4 * ENSEMBLE * (D2 + p_p.shape[0]) + 4 * A * A + 4 * n_days * D2 * ENSEMBLE
        k_ms = event_ms(lambda: launch(y_p, p_p, p.contact_matrix, dt=DT, n_steps=n_steps, save_stride=2,
                                       n_age=A, n_strain=K))
        compiled = ms.compile_facts(_build.shape_build_log(name, MS_SHAPE), None)
        record(name, MS_SHAPE, ENSEMBLE, k_ms, flops, nbytes, counts[name],
               {"team": team, **compiled.get(ms.kernel_name(name, A, K, team), {})}, p_ms_, f"{MS_SHAPE}")
        del want
    del rows, two_d

    # ---- (c) a split entry of each new family over one card listed twice -------------
    mesh = create_mesh(("ensemble",), devices=[dev, dev])
    u = unsplit
    (c_split,), counts, _ = launched(lambda: sharded.seip_ensemble_solve_sharded(
        u["sy"], u["sp"], u["scales"], mesh=mesh, duration=DAYS, dt=DT, save=(3,)))
    same = torch.equal(c_split, u["c"])
    print(f"  (c) seip_ensemble_solve_sharded at {SEIP_SHAPES['default']}, B={SEIP_WIDE}, over one card twice: "
          f"{counts['seip_rk4']} launches, bit for bit with the unsplit call: {same}")
    check(same and counts["seip_rk4"] == 2, "the split SEIP entry at the default shape differs")
    del c_split, unsplit, u
    base, y0 = ms_model.multistrain_default_params(device=dev), ms_model.multistrain_initial_state(device=dev)
    lane_scales = torch.as_tensor(rng.uniform(0.6, 1.6, ENSEMBLE), dtype=f32, device=dev)
    lane_p = torch.utils._pytree.tree_map(lambda leaf: leaf.expand((ENSEMBLE,) + leaf.shape), base).replace(
        beta=base.beta[None, :] * lane_scales[:, None])
    sp_a = SolverParams(**LANE_ADAPTIVE)
    walls = {}
    for where, m in (("unsplit", None), ("split", mesh)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sol = simulate_ensemble(ms_model.multistrain_ode, int(DAYS), y0, lane_p, sp_a, layout="lane_major", mesh=m)
        torch.cuda.synchronize()
        walls[where] = (time.perf_counter() - t, sol)
    (w_s, whole), (s_s, got) = walls["unsplit"], walls["split"]
    same = all(torch.equal(a, b) for a, b in zip(got.ys, whole.ys)) and torch.equal(got.result, whole.result)
    same &= all(torch.equal(got.stats[k], whole.stats[k]) for k in whole.stats)
    print(f"  (c) simulate_ensemble(layout='lane_major', mesh=) adaptive (Tsit5, rtol 1e-5, atol 1e-6, "
          f"{LANE_ADAPTIVE}), engine_lane_10k's B={ENSEMBLE}, {DAYS:.0f} days: result {int(got.result)}, "
          f"{int(got.stats['num_accepted'])} accepted / {int(got.stats['num_rejected'])} rejected; bit for bit with "
          f"the unsplit call: {same}; split {s_s:.2f} s, unsplit {w_s:.2f} s")
    check(same and int(got.result) == 0, "the split adaptive lane-major ensemble differs from the unsplit one")
    del walls, whole, got

    phase_s = time.perf_counter() - t_phase
    print(f"  phase 18: {phase_s:.1f} s (gate {SHAPES_BUDGET_S:.0f} s, the nvcc round apart); launches "
          f"{ {k: v['shape_path_launches'] for k, v in out.items()} }")
    check(phase_s <= SHAPES_BUDGET_S, f"phase 18 took {phase_s:.1f} s, over its {SHAPES_BUDGET_S:.0f} s")
    return out


def example_module(name: str):
    """``examples_torch/<name>.py`` as a module."""
    import importlib

    path = str(REPO / "examples_torch")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def fit_models(name: str, mod, device, days: int, dtype) -> list:
    """(label, model, keyword arguments) of fit ``name``'s model(s) on
    ``device`` in ``dtype`` over a fit window of ``days``, the data made
    on the CPU as the example makes them."""
    import torch

    cpu = torch.device("cpu")
    if name in ("ensemble_scenarios", "hierarchical_strains"):
        days = days if name == "ensemble_scenarios" else float(days)
        (obs,) = mod.fit_problem(cpu, days, dtype)[1].values()
        return [(name, *mod.fit_problem(device, days, dtype, obs=obs))]
    if name == "seip_fit":
        obs = mod.problem(cpu, dtype=dtype, fit_days=days).kwargs["obs_data"]
        prob = mod.problem(device, dtype=dtype, obs=obs, fit_days=days)
        return [(name, prob.model, prob.kwargs)]
    if name in ("sir_infer_parameters", "svi_multistart"):
        m = mod if name == "sir_infer_parameters" else example_module("sir_infer_parameters")
        return [(name, m.model, dict(config=m.get_config(dtype, device), tf=days,
                                     obs_data=m.observed(cpu, days, dtype).to(device)))]
    obs = mod.synthetic_counts(cpu, days, dtype).to(device)  # model_selection: both models, the same counts
    return [(f"{name} {k}", m, dict(config=mod.get_config(dtype, device), tf=days, obs_data=obs))
            for k, m in mod.MODELS.items()]


def bank_potential(model, kwargs, width: int, dev, seed: int = SEED):
    """The flat potential of ``model`` as ``MCMC`` builds it for a model with
    no batched potential (observed sites centred at the trace's values),
    and a ``(width, D)`` bank of positions drawn from the prior on ``dev``."""
    import torch

    from dynode_tpu_torch.infer import util

    gen = torch.Generator(device=dev).manual_seed(seed)
    tr = util.get_model_trace(model, gen, **kwargs)
    transforms = util.get_transforms(tr)
    centers = util.observed_logprob_centers(tr)
    u0 = util.unconstrain_sample(transforms, util.initialize_latents(tr, gen, util.init_to_median))
    pot = util.make_potential_fn(model, (), kwargs, transforms, centers=centers)
    flat, _, unravel = util.flatten_potential(pot, u0)
    bank = util.initialize_latents(tr, gen, util.init_to_sample, num_chains=width)
    return flat, unravel.ravel(util.unconstrain_sample(transforms, bank), batch_dims=1).to(dev)


def bank_capture(model, kwargs, width: int, dev) -> dict:
    """One bank gradient of ``model`` at ``width`` chains on ``dev``, as
    ``MCMC`` maps it (``generic_pot_and_grad``), eager and in the CUDA graph
    that ``MCMC`` captures: the eager call's wall (``eager_s``, the capture's
    warm-up), the capture's (``capture_s``, warm-up and capture), and, under
    ``"held"``, a replay that tells whether it equals the eager call bit for
    bit and the graph's release, for :func:`bank_replays`."""
    import torch

    from dynode_tpu_torch.infer.mcmc import generic_pot_and_grad

    flat, z = bank_potential(model, kwargs, width, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    graph = generic_pot_and_grad(flat, dev)
    pe, grad = graph.capture(z)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(pe).all() and torch.isfinite(grad).all()), "(d) a non-finite bank gradient")

    def replay() -> bool:
        pe_g, grad_g = graph(z)
        return torch.equal(pe_g, pe) and torch.equal(grad_g, grad)

    return {"eager_s": graph.warmup_s, "capture_s": time.perf_counter() - t, "held": (replay, graph.release)}


def svi_capture(model, kwargs, width: int, dev) -> dict:
    """One SVI step of ``model`` at ``width`` starts on ``dev``, as the
    example's ``SVIProcess`` fits it (``AutoMultivariateNormal``,
    ``init_to_median``, ``Adam(0.1)``, ``Trace_ELBO()``): ``SVI.run``'s step
    at one start, ``run_multistart``'s vmapped bank step at more. Its eager
    wall (``eager_s``), then its CUDA graph as the runs capture it
    (``infer.graphs.GraphedStep``; ``capture_s``, warm-up and capture,
    after a first replay that must equal the eager step bit for bit), and,
    under ``"held"``, a replay from the same state and draws that tells
    whether it equals the eager step (loss, parameters and Adam state) bit
    for bit, and the graph's release, for :func:`bank_replays`."""
    import torch
    from torch.utils._pytree import tree_leaves

    from dynode_tpu_torch.infer import SVI, Adam, AutoMultivariateNormal, Trace_ELBO
    from dynode_tpu_torch.infer.graphs import GraphedStep
    from dynode_tpu_torch.infer.util import GivenDraws, bank_draws

    svi = SVI(model, AutoMultivariateNormal(model), Adam(0.1), Trace_ELBO())
    base = svi.init(SEED, **kwargs)
    if width == 1:
        def step(carry, draws):
            return svi._step(*carry, GivenDraws(draws, dev), (), kwargs)

        state = (base.params, base.opt_state)
        draws = bank_draws(base.rng_key, svi._signature, None)
    else:
        step = svi._bank_fns(dev, dev, (), kwargs, 1)[0]
        params = {k: v.expand((width,) + tuple(v.shape)).clone() for k, v in base.params.items()}
        state = (params, torch.func.vmap(svi.optim.init)(params))
        draws = bank_draws(base.rng_key, svi._signature, width)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = step(state, draws)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(want)), "(d) a non-finite SVI step")
    graph = GraphedStep(step)
    graph.start(state)

    def replay() -> bool:
        for buf, x in zip(tree_leaves(graph.state), tree_leaves(state)):
            buf.copy_(x)
        loss = graph(draws)
        return torch.equal(loss, want[1]) and all(torch.equal(a, b) for a, b in zip(tree_leaves(graph.state),
                                                                                   tree_leaves(want[0])))

    check(replay(), "(d) the SVI step's first replay differs from the eager step")
    torch.cuda.synchronize()
    return {"eager_s": eager_s, "capture_s": graph.warmup_s + graph.capture_s, "held": (replay, graph.release)}


def bank_replays(m: dict) -> dict:
    """``m`` of :func:`bank_capture` or :func:`svi_capture` with the median
    wall of ``GRAPH_REPLAYS`` replays of its graph (``replay_s``) and
    whether every replay equals the eager call bit for bit (``equal``);
    the graph is released."""
    import torch

    replay, release = m.pop("held")
    walls, equal = [], True
    for _ in range(GRAPH_REPLAYS):
        t = time.perf_counter()
        same = replay()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        equal = equal and same
    release()
    return {**m, "replay_s": statistics.median(walls), "equal": equal}


def bank_worker(names, dev, conn) -> None:
    """Phase 19 (d)'s bank measurements in a process of their own, beside
    (a) to (c) in the main one (both host-bound): for each fit of ``names``
    and each of its samplers and SVI fits (``FIT_OWN``), :func:`bank_capture`
    or :func:`svi_capture` at the example's own width and window;
    "captured" through ``conn``; then, on the main process's word (its card
    work done, so the replays share the card with nothing),
    :func:`bank_replays` of each, sent back as ``{(name, stage):
    measurement}``. A failure is sent as its traceback."""
    import traceback

    import torch

    try:
        held = {}
        for name in names:
            mod = example_module(name)
            (_, model, kwargs), *_ = fit_models(name, mod, dev, mod.COUNTS[FIT_WINDOW[name]], torch.float32)
            for stage, _, width, _, _ in FIT_OWN[name]:
                measure = svi_capture if stage == "svi" else bank_capture
                held[(name, stage)] = measure(model, kwargs, width, dev)
                held[(name, stage)]["memory"] = (torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev))
        if names == BANK_WORKERS[-1]:
            repeated = repeat_fit(REPEAT_FIT, dev)
        conn.send("captured")
        conn.recv()
        replies = {key: bank_replays(m) for key, m in held.items()}
        if names == BANK_WORKERS[-1]:
            replies[("repeat", REPEAT_FIT)] = repeated
        conn.send(replies)
    except BaseException:
        conn.send(traceback.format_exc())
        raise


def repeat_fit(name: str, dev) -> dict:
    """``MCMC.run`` of fit ``name``'s model (NUTS at the width of its first
    sampler in ``FIT_OWN``, ``FIT_CUTS``' counts and depth, float32) over
    the example's own window, twice on the same model and argument
    objects: the first run traces and captures, the second is served the
    kept entry. The walls of both, each run's graph and capture count,
    whether every draw is finite, and the memory reserved and allocated
    with the entry kept (``torch.cuda`` totals of the process)."""
    import torch

    from dynode_tpu_torch.infer import MCMC, NUTS

    mod = example_module(name)
    (_, model, kwargs), *_ = fit_models(name, mod, dev, mod.COUNTS[FIT_WINDOW[name]], torch.float32)
    width, cut = FIT_OWN[name][0][2], FIT_CUTS[name]
    walls, graphs, captures, finite = [], [], [], True
    for seed in (SEED, SEED + 1):
        mc = MCMC(NUTS(model, max_tree_depth=cut["max_tree_depth"]), num_warmup=cut["warmup"],
                  num_samples=cut["samples"], num_chains=width)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mc.run(torch.Generator(device=dev).manual_seed(seed), **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        graphs.append(mc.graph)
        captures.append(mc.graph.captures)
        finite = finite and all(bool(torch.isfinite(v).all()) for v in mc.get_samples().values())
    return {"walls": walls, "captures": captures, "same_graph": graphs[0] is graphs[1],
            "replays": graphs[1].replays, "capture_s": graphs[0].warmup_s + graphs[0].capture_s, "finite": finite,
            "width": width, "days": mod.COUNTS[FIT_WINDOW[name]],
            "memory": (torch.cuda.memory_reserved(dev), torch.cuda.memory_allocated(dev))}


def log_density_card_vs_cpu(name: str, mod, dev) -> list:
    """Fit ``name``'s joint log density and its gradient at
    ``FIT_POSITIONS`` over ``EXAMPLE_FIT_DAYS`` on the card and on CPU
    tensors in float64: per model, (label, max rel err of the value and
    every gradient, card s, CPU s, the log density)."""
    import torch

    from dynode_tpu_torch.infer.util import log_density

    got = {}
    for where in (torch.device("cpu"), dev):
        for label, model, kwargs in fit_models(name, mod, where, EXAMPLE_FIT_DAYS, torch.float64):
            pos = {k: torch.tensor(v, dtype=torch.float64, device=where, requires_grad=True)
                   for k, v in FIT_POSITIONS[label].items()}
            t = time.perf_counter()
            lp = log_density(model, (), kwargs, pos)[0]
            grads = torch.autograd.grad(lp, list(pos.values()))
            vals = [lp.detach().cpu().reshape(1), *(g.cpu().reshape(-1) for g in grads)]
            got[(label, where.type)] = (vals, time.perf_counter() - t)
    rows = []
    for label in dict.fromkeys(k[0] for k in got):
        (cpu_vals, cpu_s), (card_vals, card_s) = got[(label, "cpu")], got[(label, dev.type)]
        err = max(float((c - w).abs().max() / w.abs().max()) for c, w in zip(card_vals, cpu_vals))
        rows.append((label, err, card_s, cpu_s, float(cpu_vals[0][0])))
    return rows


@contextlib.contextmanager
def counting_gradients():
    """Count the calls of every generic (``torch.func.vmap``) potential and
    gradient that ``MCMC`` builds inside the block, graph replays included:
    one a leapfrog or initial evaluation of the whole bank. Yields a dict
    with the count (``"calls"``) and the CUDA graphs built (``"graphs"``)."""
    from dynode_tpu_torch.infer import mcmc

    seen = {"calls": 0, "graphs": []}
    plain = mcmc.generic_pot_and_grad

    def counted(flat_potential, graph_device=None):
        pot_and_grad = plain(flat_potential, graph_device)
        if isinstance(pot_and_grad, mcmc.GraphedPotential):
            seen["graphs"].append(pot_and_grad)

        def call(zb):
            seen["calls"] += 1
            return pot_and_grad(zb)

        call.__wrapped__ = pot_and_grad  # MCMC finds its graph through it
        return call

    mcmc.generic_pot_and_grad = counted
    try:
        yield seen
    finally:
        mcmc.generic_pot_and_grad = plain


@contextlib.contextmanager
def bank_workers(dev):
    """One :func:`bank_worker` process per entry of ``BANK_WORKERS``
    (spawned), their connections yielded; every one is stopped at the end."""
    import multiprocessing

    import torch

    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the workers' graphs
    ctx = multiprocessing.get_context("spawn")
    started = []
    try:
        for names in BANK_WORKERS:
            here, there = ctx.Pipe()
            proc = ctx.Process(target=bank_worker, args=(names, dev, there), daemon=True)
            proc.start()
            started.append((proc, here))
        yield [conn for _, conn in started]
    finally:
        for proc, _ in started:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=60)


def examples_phase(dev, smi: str) -> dict:
    """Phase 19: every example of ``examples_torch/`` on the card, through
    its ``run`` functions at the example's widths (non-FAST).

    (a) The eight simulation examples at their own settings, in float64
    (the examples' ``--float64``), each against the same call on CPU
    tensors within ``TOL_CARD_CPU`` (phase 13's float64 bound) over every
    array it plots, the step counts equal. Not in float32, the examples'
    own type: there an adaptive solve's dt follows error norms a few
    float32 ulps wide, which the card and the CPU round apart, so card and
    CPU differ by up to 2.1e-5 (the multi-strain example), above phase 13's
    float32 bound of 1e-5, as float32 differs from float64 by up to 6.7e-5
    on either (my chip runs of this phase, PR 13).
    (b) ``ensemble_scenarios``: 4,096 members over 200 days through kernel
    #2 (launches counted), the first ``EXAMPLE_CHECK`` members against the
    plain version within ``TOL_F32``. (c) ``seip_forecast``: (d)'s
    ``seip_fit`` draws resampled to 32 x 1,024 = 32,768 members through
    kernel #5 over 160 days (C in bf16, the packed layout; launches
    counted), held against its plain version at that width with phase
    12's per-block gate (``MIN_SAME`` of the blocks with the plain
    version's decisions, ``TOL_BF16``), the bands against
    ``numpy.quantile`` of the same daily incidence on the host
    (``TOL_BANDS``), no exhausted interval, and the example's own check:
    the median's correlation with the data above 0.8. (d) Every fit:
    its model's joint log density and gradient at ``FIT_POSITIONS`` on the
    card against CPU tensors in float64 (``TOL_CARD_CPU``), over a fit
    window of ``EXAMPLE_FIT_DAYS`` days (the CPU side is eager; phase 15
    (d) cuts its window so too); then its ``run`` at the example's widths
    (chains, starts) in float32 over that window, with the counts cut and
    the tree depth only after them (``FIT_CUTS``; the example's own in
    brackets): ``ensemble_scenarios`` NUTS 4 warmup + 4 draws (150 + 150),
    depth 3 (6), 64 chains, its fit window 5 days (100);
    ``hierarchical_strains`` NUTS 4 + 4 (300 + 300), depth 3 (10), 16
    chains, 5 days (120); ``seip_fit`` ChEES 4 + 4 (100 + 100), up to 8
    leapfrogs a transition (64), 256 chains, 5 days (100);
    ``sir_infer_parameters`` NUTS 4 + 4 (500 + 100), depth 3 (10), SVI 4
    steps (500), its predictive draws as they are (1,000), 5 days (100);
    ``model_selection`` NUTS 4 + 4 (400 + 200) for each of its two fits,
    depth 3 (8), then ``loo`` and ``compare``, 5 days (100);
    ``svi_multistart`` SVI 4 steps (500) at 64 starts, then 4 draws (24) of
    its zero-warmup ChEES bank of 256 chains, 5 days (100). Every draw
    finite; every sampler's bank ran through its CUDA graph (replays
    counted), and every SVI fit replayed its step's graph at each of its
    steps. Per sampler and SVI fit it prints that run's transitions (or
    SVI steps), its gradient calls or step replays (counted) and wall, and
    at the example's own width and fit window the wall of one gradient of
    the bank (the model under ``torch.func.vmap``, as ``MCMC`` maps it;
    :func:`bank_capture`) or of one SVI step (``SVI.run``'s at one start,
    the vmapped bank step at 64; :func:`svi_capture`), eager, the capture
    of its graph (warm-up and capture) and the median of
    ``GRAPH_REPLAYS`` replays, each equal to the eager call bit for bit (a
    gate), and the replay times the example's own counts plus the capture:
    the extrapolated wall (at most, for the samplers whose leapfrogs a
    transition adapt). The banks are measured in the worker
    processes of ``BANK_WORKERS`` (:func:`bank_worker`), started with the
    phase: their eager calls and captures, host-bound as (a) to (c) are,
    run beside those on other cores; their replays run after them, one
    worker at a time, with the card otherwise idle. Each worker's memory
    (reserved and allocated) is printed as it holds its graphs, and the
    main process's after each fit with its kept ``MCMC`` cache entries.
    The last worker also runs ``REPEAT_FIT``'s ``MCMC.run`` twice on the
    same model and argument objects at its width and own window
    (:func:`repeat_fit`): the second run is served the kept entry, with no
    capture (a gate), and both walls are printed. The examples' own drift and ranking
    asserts need their own counts and are not run here. Phase 19 takes
    ``EXAMPLES_BUDGET_S`` or less.
    Returns the launches of kernels #2 and #5 on this path.
    """
    import torch

    from dynode_tpu_torch.infer import mcmc as mcmc_cache
    from dynode_tpu_torch.ops import multistrain as ms
    from dynode_tpu_torch.ops import seip as tsp

    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    print(f"phase 19: the examples of examples_torch/ on the card, through their run functions [{smi}]")
    with bank_workers(dev) as workers:  # (d)'s banks, measured beside (a) to (c)
        # (a) the simulation examples in float64, card against CPU
        for name in EXAMPLE_SIMULATIONS:
            mod = example_module(name)
            t = time.perf_counter()
            card = mod.run(dev, dtype=torch.float64)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t
            t = time.perf_counter()
            host = mod.run(cpu, dtype=torch.float64)
            cpu_s = time.perf_counter() - t
            errs = {}
            for key, want in host.items():
                got = card[key]
                if isinstance(want, torch.Tensor) and want.is_floating_point():
                    check(got.device.type == dev.type and got.dtype == torch.float64, f"(a) {name} {key} left the card")
                    check(bool(torch.isfinite(got).all()), f"(a) {name} {key}: non-finite")
                    errs[key] = float((got.cpu() - want).abs().max() / want.abs().max())
                else:
                    check(got == want, f"(a) {name} {key}: {got} on the card, {want} on the CPU")
            worst = max(errs, key=errs.get)
            print(f"  (a) {name}: card {card_s:.2f} s, CPU {cpu_s:.2f} s, float64; {len(errs)} arrays, max rel err "
                  f"{errs[worst]:.3e} ({worst}; tol {TOL_CARD_CPU:.0e}) [{smi}]")
            check(errs[worst] <= TOL_CARD_CPU, f"(a) {name}: card vs CPU rel err {errs[worst]:.3e}")
        print(f"      (a) took {time.perf_counter() - t_phase:.1f} s")

        # (d) first: each fit's log density and gradient, card against CPU
        for name in FIT_CUTS:
            if name == "svi_multistart":
                continue  # sir_infer_parameters' model
            for label, err, card_s, cpu_s, lp in log_density_card_vs_cpu(name, example_module(name), dev):
                print(f"  (d) {label}: log density {lp:.6f} and its gradient, float64, card {card_s:.2f} s, CPU "
                      f"{cpu_s:.2f} s: max rel err {err:.3e} (tol {TOL_CARD_CPU:.0e})")
                check(err <= TOL_CARD_CPU, f"(d) {label}: log density card vs CPU rel err {err:.3e}")
        print(f"      (a) and the log densities took {time.perf_counter() - t_phase:.1f} s")

        cut_runs = []  # per sampler of each cut run: what (d)'s lines take from it

        def fit_run(name):
            """The example's ``run`` at its widths with ``FIT_CUTS``' counts over
            ``EXAMPLE_FIT_DAYS``, every MCMC bank through its CUDA graph; per
            sampler, that run's transitions (or SVI steps), gradient calls and
            wall go to ``cut_runs``."""
            mod = example_module(name)
            cut = FIT_CUTS[name]
            with counting_gradients() as seen, svi_graphs() as steps:
                out = mod.run(dev, overrides={**cut, FIT_WINDOW[name]: EXAMPLE_FIT_DAYS})
            torch.cuda.synchronize()
            print(f"      (d) {name}'s fit done: {len(mcmc_cache._EXEC_CACHE)} kept MCMC cache entries, "
                  f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
            check(len(seen["graphs"]) > 0 and all(g.replays > 0 for g in seen["graphs"]),
                  f"(d) {name}: a sampler's bank did not run through its CUDA graph")
            for stage, what, width, own, each in FIT_OWN[name]:
                if stage == "svi":
                    done = cut.get("svi_iterations", cut.get("iterations"))
                    grads = sum(g.replays for g in steps)
                    check(len(steps) > 0 and grads == done and all(g.captures == 1 for g in steps),
                          f"(d) {name}: the SVI fit did not replay its step's CUDA graph")
                else:
                    done = cut["draws"] if stage == "chees" else (cut["warmup"] + cut["samples"])
                    done *= 2 if name == "model_selection" else 1
                    grads = seen["calls"]
                cut_runs.append((name, stage, what, width, own, grads / done if each is None else each, done, grads,
                                 out["walls"][stage], mod.COUNTS[FIT_WINDOW[name]]))
            return out

        # (b) ensemble_scenarios: the ensemble through kernel #2, then its fit
        launches = {}
        torch.cuda.synchronize()
        ms.launch_multistrain_tsit5.launches = 0
        out = fit_run("ensemble_scenarios")
        launches["multistrain_tsit5"] = ms.launch_multistrain_tsit5.launches
        mod = example_module("ensemble_scenarios")
        n = mod.COUNTS["ensemble"]
        base, y0 = mod.model_parts(dev)
        scales = out["r0_scales"][:EXAMPLE_CHECK]
        plain = ms.ensemble_solve_reference(y0, base.beta[None, :] * scales[:, None], base.sigma, base.gamma,
                                            base.omega, base.contact_matrix, batch=EXAMPLE_CHECK,
                                            duration=float(mod.COUNTS["duration"]), dt=0.5)
        _, err = rel_err(out["saves"][..., :EXAMPLE_CHECK], plain)
        peak = out["peak_day"].float().quantile(torch.tensor([0.05, 0.5, 0.95], device=dev)).tolist()
        print(f"  (b) ensemble_scenarios: {n} members, {mod.COUNTS['duration']} days through kernel #2 "
              f"(multistrain_tsit5, launches {launches['multistrain_tsit5']}): {out['walls']['ensemble'] * 1e3:.1f} ms "
              f"wall; peak day 5/50/95% {peak}; the first {EXAMPLE_CHECK} members against the plain version: max rel "
              f"err {err:.3e} (tol {TOL_F32:.0e}) [{smi}]")
        check(out["saves"].shape[-1] == n and bool(torch.isfinite(out["saves"]).all()), "(b) non-finite ensemble")
        check(launches["multistrain_tsit5"] > 0, "kernel #2 did not launch on ensemble_scenarios' path")
        check(err <= TOL_F32, f"(b) kernel #2 vs plain: rel err {err:.3e}")
        check(bool(torch.isfinite(out["posterior"]).all()), "(d) ensemble_scenarios: non-finite draws")
        del out, plain

        # (d) the other fits at their widths, counts cut
        fits = {}
        for name in ("hierarchical_strains", "seip_fit", "sir_infer_parameters", "model_selection", "svi_multistart"):
            fits[name] = out = fit_run(name)
            draws = {"hierarchical_strains": lambda o: o["r0_scale"], "seip_fit": lambda o: o["beta_scales"],
                     "sir_infer_parameters": lambda o: o["mcmc"].get_samples()["strains_0_r0"],
                     "model_selection": lambda o: o["fits"]["negbin"].get_samples()["concentration"],
                     "svi_multistart": lambda o: o["chees_r0"]}[name](out)
            check(bool(torch.isfinite(draws).all()), f"(d) {name}: non-finite draws")
            if name == "model_selection":
                print(f"      model_selection at the cut counts: ranking {list(out['table'])}, elpd "
                      f"{[round(s.elpd, 2) for s in out['scores'].values()]}")
        print(f"      (a), (b) and (d) took {time.perf_counter() - t_phase:.1f} s")

        # (c) seip_forecast: the fit's draws through kernel #5 at 32,768 members
        forecast = example_module("seip_forecast")
        draws = fits.pop("seip_fit")["beta_scales"]
        fits.clear()
        torch.cuda.synchronize()
        tsp.launch_seip_bs3.launches = 0
        out = forecast.run(dev, draws=draws)
        launches["seip_bs3"] = tsp.launch_seip_bs3.launches
        bank, c, stats = out["bank"], out["c"], out["stats"]
        width, days = bank.shape[1], out["fit_days"] + forecast.horizon(False)
        prob = out["problem"]
        plain, plain_stats = tsp.seip_solve_adaptive_reference(
            prob.y0, prob.base, bank.float(), duration=float(days), rtol=1e-4, atol=1e-3, dt0=0.125, steps_per_save=8,
            block_b=tsp.SEIP_ADAPTIVE_BLOCK, save=(3,), dtype=torch.float32)
        same = torch.ones_like(stats["n_accepted"], dtype=torch.bool)
        for key in stats:
            same &= stats[key] == plain_stats[key]
        members = tsp.unpack_members(c) if c.device.type == "cuda" else c  # the card's branch packs
        member_abs = (members.float() - plain[0]).abs().flatten(0, -2).amax(dim=0)
        block_of = torch.arange(width, device=dev) // tsp.SEIP_ADAPTIVE_BLOCK
        block_abs = torch.zeros(same.shape[0], device=dev).scatter_reduce_(0, block_of, member_abs, "amax")
        block_rel = block_abs / float(plain[0].abs().max())
        frac = float(same.float().mean())
        rel_same, rel_all = float(block_rel[same].max()), float(block_rel.max())
        inc = torch.diff(torch.sum(c, dim=(1, 2, 3, 4), dtype=torch.float32), dim=0)
        host = np.quantile(inc.reshape(inc.shape[0], -1).cpu().numpy(), forecast.QS, axis=1)
        band_err = float(np.abs(out["bands"].cpu().numpy() - host).max() / np.abs(host).max())
        print(f"  (c) seip_forecast: {draws.shape[0]} draws of (d)'s {EXAMPLE_FIT_DAYS}-day seip_fit resampled to {width} members, kernel #5 "
              f"(seip_bs3, launches {launches['seip_bs3']}) over {days} days, C bf16 packed {tuple(c.shape)}: forecast "
              f"wall {out['walls']['forecast'] * 1e3:.1f} ms; exhausted {int(stats['exhausted_intervals'].sum())}; "
              f"against the plain version: {frac:.4f} of {same.numel()} blocks with its decisions (gate {MIN_SAME}), "
              f"max rel err {rel_same:.3e} there, {rel_all:.3e} over all (tol {TOL_BF16:.0e}); bands "
              f"{tuple(out['bands'].shape)} against numpy.quantile: max rel err {band_err:.3e} (tol {TOL_BANDS:.0e}); "
              f"median-vs-data correlation {out['correlation']:.4f} (gate {forecast.MIN_CORRELATION}) [{smi}]")
        check(width == 32 * tsp.BLOCK and c.dtype == torch.bfloat16, "(c) not the card's branch of seip_forecast")
        check(launches["seip_bs3"] > 0, "kernel #5 did not launch on seip_forecast's path")
        check(frac >= MIN_SAME and rel_same <= TOL_BF16 and rel_all <= TOL_BF16, "(c) kernel #5 vs its plain version")
        check(band_err <= TOL_BANDS, f"(c) bands vs numpy.quantile: rel err {band_err:.3e}")
        check(out["correlation"] > forecast.MIN_CORRELATION, f"(c) correlation {out['correlation']:.4f}")
        del out, plain, c

        # (d) each bank at its example's own width and window, from the workers: their
        # captures ran beside (a) to (c); the replays run one worker at a time
        t = time.perf_counter()
        for conn in workers:
            reply = conn.recv()
            check(reply == "captured", f"(d) a bank worker failed:\n{reply}")
        waited, t = time.perf_counter() - t, time.perf_counter()
        banks = {}
        for conn in workers:
            conn.send("replay")
            reply = conn.recv()
            check(isinstance(reply, dict), f"(d) a bank worker failed:\n{reply}")
            banks.update(reply)
        print(f"      (d) the banks: {len(BANK_WORKERS)} workers' captures beside (a)-(c), {waited:.1f} s waited for "
              f"after them; the replays {time.perf_counter() - t:.1f} s")
        r = banks.pop(("repeat", REPEAT_FIT))
        print(f"  (d) {REPEAT_FIT}'s MCMC.run (NUTS, {r['width']} chains, {FIT_CUTS[REPEAT_FIT]['warmup']} + "
              f"{FIT_CUTS[REPEAT_FIT]['samples']}, depth {FIT_CUTS[REPEAT_FIT]['max_tree_depth']}, its own "
              f"{r['days']} days) twice on the same model and arguments, in a worker: {r['walls'][0]:.2f} s with the "
              f"trace and capture (warm-up + capture {r['capture_s']:.2f} s), then {r['walls'][1]:.2f} s from the "
              f"kept entry; captures {r['captures'][0]} then {r['captures'][1]}, the same graph: {r['same_graph']}, "
              f"{r['replays']} replays in all; draws finite: {r['finite']}; {r['memory'][0] / 2**30:.2f} GiB "
              f"reserved, {r['memory'][1] / 2**30:.2f} GiB allocated in the worker then [{smi}]")
        check(r["captures"] == [1, 1] and r["same_graph"], f"(d) {REPEAT_FIT}: the repeated run captured a graph")
        check(r["finite"], f"(d) {REPEAT_FIT}: non-finite draws in the repeated runs")
        for name, stage, what, width, own, each, done, grads, wall, own_days in cut_runs:
            m, svi = banks[(name, stage)], stage == "svi"
            total = m["replay_s"] * own * each + m["capture_s"]
            print(f"  (d) {name} {what}, width {width}: {done} transitions or steps over {EXAMPLE_FIT_DAYS} days, "
                  f"{grads} {'step replays' if svi else 'gradient calls'}, {wall:.1f} s; one "
                  f"{'step' if svi else 'gradient'} of the bank over the example's {own_days} days "
                  f"{m['eager_s']:.2f} s eager, captured in {m['capture_s']:.2f} s, replayed in {m['replay_s']:.3f} s "
                  f"(median of {GRAPH_REPLAYS}; bit for bit with the eager call: {m['equal']}); at the example's own "
                  f"{own} x {'at most ' if each > 1 and stage != 'chees' else ''}{each:.1f} "
                  f"{'steps' if svi else 'gradients'}: {total:,.0f} s ({total / 3600:.2f} h); its worker held "
                  f"{m['memory'][0] / 2**30:.2f} GiB reserved, {m['memory'][1] / 2**30:.2f} GiB allocated with its "
                  f"graphs up to this one [{smi}]")
            check(m["equal"], f"(d) {name} {what}: the graph's replay differs from the eager call")

        phase_s = time.perf_counter() - t_phase
        print(f"  phase 19: {phase_s:.1f} s (gate {EXAMPLES_BUDGET_S:.0f} s); launches {launches}")
        check(phase_s <= EXAMPLES_BUDGET_S, f"phase 19 took {phase_s:.1f} s, over its {EXAMPLES_BUDGET_S:.0f} s")
        return launches


def median_tree_ms(fn):
    """:func:`median_ms` of an entry whose result is a tree of tensors
    (saves and a dict of statistics): (median ms, the last result); the
    host fetches a scalar of its first tensor."""
    from torch.utils._pytree import tree_leaves

    out = None

    def call():
        nonlocal out
        out = fn()
        return tree_leaves(out)[0]

    ms, _ = median_ms(call)
    return ms, out


def svi_card_vs_cpu(dev, obs) -> float:
    """``run_multistart`` of the fit at ``SVI_CHECK``'s starts, steps and
    days in float64 on CPU tensors and on the card, the draws recorded on
    the CPU and replayed on the card, the guide's locations started at the
    prior mean (no draws); the max relative error of every start's final
    parameters. The card's run replays its step from a CUDA graph (a
    failed check otherwise)."""
    import torch

    from dynode_tpu_torch.infer import SVI, Adam, AutoMultivariateNormal, Trace_ELBO, init_to_mean

    starts, steps, days = SVI_CHECK
    cpu = torch.device("cpu")
    out, tape = {}, None
    for where in (cpu, dev):
        model = fit_model(days=days, dtype=torch.float64, device=where)
        draws = DrawTape(torch.Generator().manual_seed(SEED)) if where == cpu else DrawTape(tape=tape, device=dev)
        svi = SVI(model, AutoMultivariateNormal(model, init_loc_fn=init_to_mean), Adam(0.1), Trace_ELBO())
        with svi_graphs() as graphs:
            result = svi.run_multistart(draws, num_steps=steps, num_starts=starts, final_particles=2,
                                        obs=obs[:days].to(where))
        if where != cpu:
            check([g.replays for g in graphs] == [steps], "(c) the card's SVI check did not replay its graph")
        out[where.type] = result.all_params
        tape = draws.tape if where == cpu else tape
    return max(float((out[dev.type][k].cpu() - v).abs().max() / v.abs().max()) for k, v in out["cpu"].items())


@contextlib.contextmanager
def svi_graphs(timed: bool = False):
    """The CUDA graphs of the SVI steps that the runs inside the block
    capture (``infer.svi``'s ``GraphedStep`` replaced by a subclass that
    keeps each one): yields their list. With ``timed``, each call of a
    graph (the first captures, the others replay) also synchronizes the
    card and records when it ended (``ends``, host clock)."""
    import torch

    from dynode_tpu_torch.infer import svi as svi_mod

    made = []
    plain = svi_mod.GraphedStep

    class Kept(plain):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ends = []
            made.append(self)

        def __call__(self, draws):
            loss = super().__call__(draws)
            if timed:
                torch.cuda.synchronize(self.device)
                self.ends.append(time.perf_counter())
            return loss

    svi_mod.GraphedStep = Kept
    try:
        yield made
    finally:
        svi_mod.GraphedStep = plain


def eager_bank_walls(svi) -> list:
    """The list that the wall of each eager bank step of ``svi``'s
    ``run_multistart`` runs goes to (host clock, the card synchronized
    before and after)."""
    import torch

    walls, plain = [], svi._bank_fns

    def timed(*args, **kwargs):
        step, elbo = plain(*args, **kwargs)

        def step_timed(state, noise):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, noise)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            return out

        return step_timed, elbo

    svi._bank_fns = timed
    return walls


def wall_ms(fn):
    """(wall ms of one call of ``fn``, its result)"""
    import torch

    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    last = out[-1] if isinstance(out, tuple) else out
    float(last.reshape(-1)[-1])  # a host fetch of a scalar of the result
    return (time.perf_counter() - t) * 1e3, out


def median_ms(fn):
    """(median wall ms of 3 calls after a warm-up, the last call's result)"""
    wall_ms(fn)  # warm-up
    walls = []
    for _ in range(3):
        wall, out = wall_ms(fn)
        walls.append(wall)
    return statistics.median(walls), out


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not (REPO / "dynode_tpu_torch").is_dir():
        print(f"chip_smoke: no dynode_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dynode_tpu_torch import _device
    from dynode_tpu_torch.models import multistrain as model
    from dynode_tpu_torch.ode.solvers import ADAPTIVE_METHODS, METHODS
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

    # phase 18's shape builds compile beside the library's, one nvcc each
    shape_builds = ThreadPoolExecutor(max_workers=1)
    shape_wall = shape_builds.submit(_build.prebuild, shape_units())
    t = time.perf_counter()
    _build.load_library()
    print(f"build: nvcc {time.perf_counter() - t:.1f} s (0 when cached)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
        elif line.startswith("wall time:"):
            print("  nvcc", line)

    # the constructors put their tensors on the card when given no device
    on_card = [model.multistrain_default_params().beta, *model.multistrain_initial_state()]
    check(all(x.device.type == dev.type for x in on_card), "a constructor left the card")

    # ---- inputs ------------------------------------------------------------
    rng = np.random.default_rng(SEED)
    cuda_gen = torch.Generator(device=dev)
    cuda_gen.manual_seed(SEED)
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

    def solve_2d_plain(args, kw):
        """The plain version of ensemble_solve_tsit5_2d on the same inputs."""
        y, beta_, sigma, gamma, omega, contact_ = args
        b, na, nk = kw["batch"], kw.get("n_age", A), kw.get("n_strain", K)
        return ms._solve_2d_reference(
            ms.pack_state_2d(y, b, na, nk), ms.pack_rates_2d(beta_, sigma, gamma, omega, b, na, nk),
            duration=kw["duration"], dt=kw["dt"], save_every=1.0,
            contact_tuple=ms._contact_tuple(contact_), n_age=na, n_strain=nk)
    errors = {"multistrain_tsit5": [], "rk_solve": [], "rk_solve_adaptive": [],
              "multistrain_tsit5_2d": []}

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
        report("multistrain_tsit5", f"(A,K)=({na},{nk}) team {ms.pick_team(SLICE, na)}", got, want, TOL_F32)
        for team in ms.teams(na):  # each team width the launcher may pick, on a ragged batch
            got = ms.launch_multistrain_tsit5(
                ms.pack_state(y, RAGGED, na, nk), ms.pack_params(args[1][:RAGGED], *args[2:5], RAGGED, nk),
                p.contact_matrix, dt=DT, n_steps=int(round(DAYS / DT)), save_stride=int(round(1.0 / DT)),
                n_age=na, n_strain=nk, team=team)
            report("multistrain_tsit5", f"(A,K)=({na},{nk}) team {team} B={RAGGED}", got, want[..., :RAGGED],
                   TOL_F32)
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
    scales = scenario_scales(cuda_gen, ENSEMBLE)
    scales_wide = scenario_scales(cuda_gen, WIDE)
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
    print(f"phase 5: times, entry points median of 3 after a warm-up, plain versions one call, on {smi}")
    ms_args = (y0, beta, base.sigma, base.gamma, base.omega, base.contact_matrix)
    ms_kw = dict(batch=ENSEMBLE, duration=DAYS, dt=DT)
    k_ms, _ = median_ms(lambda: ms.ensemble_solve_tsit5(*ms_args, **ms_kw))
    p_ms_, plain = wall_ms(lambda: ms.ensemble_solve_reference(*ms_args, **ms_kw))
    report("multistrain_tsit5", f"main path B={ENSEMBLE}", saves, plain, TOL_F32)
    times = {"multistrain_tsit5": (k_ms, p_ms_, ENSEMBLE)}
    del saves, plain
    k_ms, _ = median_ms(lambda: gen.ensemble_solve_kernel(
        rhs_ms, y_wide, p_wide, duration=DAYS, dt=DT, **obs_kw))
    p_ms_, plain = wall_ms(lambda: gen.select_saves(gen.ensemble_solve_kernel_reference(
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
    # the two multi-strain kernels' compile facts: registers, spills, static SASS mix
    ms_facts = ms.compile_facts(_build.build_log(), _build.sass_counts(_build.library_path(), match="multistrain_"))

    def team_facts(kernel: str, batch: int) -> dict:
        """The instantiation the launcher picks at ``batch`` (A = 2, K = 3) and its facts."""
        team = ms.pick_team(batch, A)
        f = ms_facts.get(ms.kernel_name(kernel, A, K, team), {})
        out = {"team": team, "threads": ms.THREADS, "registers": f.get("registers"),
               "spill_stores": f.get("spill_stores"), "spill_loads": f.get("spill_loads"), "sass": f.get("sass")}
        print(f"  {kernel} B={batch}: team of {team} lane(s) a member, {ms.THREADS} threads a block; registers "
              f"{out['registers']}, spill stores / loads {out['spill_stores']} / {out['spill_loads']} B; static "
              f"SASS {out['sass'] or 'not available (no cuobjdump found)'}")
        return out

    row_facts = team_facts("multistrain_tsit5", ENSEMBLE)

    # ---- 6. the adaptive kernel against its plain version --------------------
    print(f"phase 6: adaptive kernel vs plain, {DAYS:.0f} days, rtol {RTOL:g}, atol {ATOL:g}, "
          f"block_b {gen.ADAPTIVE_BLOCK} on both sides")
    adaptive_kw = dict(duration=DAYS, rtol=RTOL, atol=ATOL)

    def adaptive_pair(rhs, y, p, **kw):
        """(kernel saves, kernel stats, plain full f32 saves, plain stats)"""
        got, got_stats = gen.ensemble_solve_kernel_adaptive(rhs, y, p, **adaptive_kw, **kw)
        kw = {k: v for k, v in kw.items() if k not in ("save_rows", "save_dtype", "padded_rows")}
        want, want_stats = gen.ensemble_solve_kernel_adaptive_reference(
            rhs, y, p, block_b=gen.ADAPTIVE_BLOCK, **adaptive_kw, **kw)
        return got, got_stats, want, want_stats

    def report_adaptive(what, got, got_stats, want, want_stats, tol):
        """Gate the kernel per block: every block's statistics equal the
        plain version's, and its saves agree within tol."""
        same = torch.ones_like(got_stats["n_accepted"], dtype=torch.bool)
        for key in got_stats:
            same &= got_stats[key] == want_stats[key]
        n = got.shape[-1]
        block_of = torch.arange(n, device=dev) // gen.ADAPTIVE_BLOCK
        member_abs = (got.float() - want.float()).abs().amax(dim=(0, 1))
        block_abs = torch.zeros(same.shape[0], device=dev).scatter_reduce_(0, block_of, member_abs, "amax")
        rel = float(block_abs.max()) / float(want.float().abs().max())
        attempts = int((got_stats["n_accepted"] + got_stats["n_rejected"]).sum())
        print(f"  rk_solve_adaptive {what}: {int((~same).sum())} of {same.numel()} blocks with other "
              f"stats (tol 0); max rel err {rel:.3e} (tol {tol:.0e}); {attempts} attempts, "
              f"{int(got_stats['exhausted_intervals'].sum())} exhausted")
        check(bool(same.all()), f"rk_solve_adaptive {what}: {int((~same).sum())} blocks with other stats")
        check(rel <= tol, f"rk_solve_adaptive {what}: rel err {rel:.3e} > {tol:.0e}")
        if tol == TOL_F32:
            errors["rk_solve_adaptive"].append(float(block_abs.max()))

    for method in ("bosh3", "tsit5"):
        cases = (("multistrain", rhs_ms, y_ms, p_ms), ("multistrain", rhs_ms, y_rag, p_rag),
                 ("sir", rhs_sir, y_sir, p_sir))
        for name, rhs, y, p in cases:
            got, got_stats, want, want_stats = adaptive_pair(rhs, y, p, method=method)
            check(int(got_stats["exhausted_intervals"].sum()) == 0, f"{method} {name}: budget exhausted")
            report_adaptive(f"{method} {name} B={y.shape[1]}", got, got_stats, want, want_stats, TOL_F32)
            if y is y_ms:
                print(f"    Triton's compile of the {method} kernel on the multistrain rows-RHS: "
                      f"n_regs {gtri.kernel_info['n_regs']}, n_spills {gtri.kernel_info['n_spills']}")
    got, got_stats, want, want_stats = adaptive_pair(rhs_ms, y_ms, p_ms, method="bosh3", **obs_kw)
    check(tuple(got.shape) == (int(DAYS) + 1, 8, SLICE), f"adaptive obs saves shape {tuple(got.shape)}")
    check(not got[:, len(c_rows):].any(), "padding rows of the adaptive obs saves are not zero")
    want = gen.select_saves(want, c_rows, torch.bfloat16, True)
    report_adaptive("bosh3 c rows, bf16, padded", got[:, :len(c_rows)], got_stats,
                    want[:, :len(c_rows)], want_stats, TOL_BF16)

    # the attempt budget: rtol 1e-10 cannot be met in float32 in 2 attempts
    got, got_stats = gen.ensemble_solve_kernel_adaptive(
        rhs_ms, y_ms, p_ms, duration=DAYS, rtol=1e-10, atol=1e-14, steps_per_save=2)
    nb = got_stats["n_accepted"].shape[0]
    nan_slot = torch.isnan(got).all(dim=1).reshape(got.shape[0], nb, gen.ADAPTIVE_BLOCK).all(dim=2)
    exhausted = got_stats["exhausted_intervals"]
    print(f"  budget (rtol 1e-10, atol 1e-14, 2 attempts): all-NaN slots per block "
          f"{int(nan_slot.sum(0).min())}..{int(nan_slot.sum(0).max())}, exhausted_intervals "
          f"{int(exhausted.min())}..{int(exhausted.max())}, slot 0 NaN in {int(nan_slot[0].sum())} blocks")
    check(bool((nan_slot.sum(0) == exhausted).all()), "NaN slots differ from exhausted_intervals")
    check(bool((exhausted > 0).all()), "a block met rtol 1e-10 in float32")
    check(not bool(nan_slot[0].any()), "slot 0 is NaN")

    # accuracy against an independent solve: the constant-step kernel at dt = 0.05
    m = 2048
    beta_acc = scaled_beta(base, scenario_scales(cuda_gen, m))
    y_s = ms.pack_state(y0, m)
    p_s = ms.pack_params(beta_acc, base.sigma, base.gamma, base.omega, m)
    ref = gen.ensemble_solve_kernel(rhs_ms, y_s, p_s, duration=DAYS, dt=0.05)
    got, _ = gen.ensemble_solve_kernel_adaptive(rhs_ms, y_s, p_s, **adaptive_kw)
    acc_rel = float(((got - ref).abs() / (1e-6 + ref.abs())).max())
    print(f"  bosh3 vs rk_solve tsit5 at dt = 0.05, B={m}: max |got - ref| / (1e-6 + |ref|) "
          f"{acc_rel:.3e} (tol {TOL_ACCURACY:.0e})")
    check(acc_rel < TOL_ACCURACY, f"adaptive accuracy gate: {acc_rel:.3e}")

    # ---- 7. the 2-D kernel against its plain version and the row kernel -------
    print(f"phase 7: 2-D kernel vs plain and vs the row kernel, {DAYS:.0f} days, dt={DT}")
    for (na, nk), (r0s, tinf, tlat, twane, demo) in shapes.items():
        p = model.multistrain_default_params(r0s, tinf, tlat, twane, n_age=na, device=dev)
        y = model.multistrain_initial_state(r0s, demo, device=dev)
        pad = sorted(set(range(D2)) - set(ms._live_rows_2d(na, nk)))
        for b in (SLICE, RAGGED):
            args = (y, scaled_beta(p, scales_slice[:b]), p.sigma, p.gamma, p.omega, p.contact_matrix)
            kw = dict(batch=b, duration=DAYS, dt=DT, n_age=na, n_strain=nk)
            got = ms.ensemble_solve_tsit5_2d(*args, **kw)
            want = solve_2d_plain(args, kw)
            check(tuple(got.shape) == (int(DAYS) + 1, D2, b), f"2-D saves shape {tuple(got.shape)}")
            check(not got[:, pad].any(), f"2-D padding rows not zero at (A,K)=({na},{nk}) B={b}")
            report("multistrain_tsit5_2d", f"(A,K)=({na},{nk}) team {ms.pick_team(b, na)} B={b}", got, want,
                   TOL_F32)
            for team in ms.teams(na) if b == RAGGED else ():  # each team width the launcher may pick
                got_t = ms.launch_multistrain_tsit5_2d(
                    ms.pack_state_2d(y, b, na, nk), ms.pack_rates_2d(*args[1:5], b, na, nk), p.contact_matrix,
                    dt=DT, n_steps=int(round(DAYS / DT)), save_stride=int(round(1.0 / DT)), n_age=na,
                    n_strain=nk, team=team)
                check(not got_t[:, pad].any(), f"2-D padding rows not zero at team {team}")
                report("multistrain_tsit5_2d", f"(A,K)=({na},{nk}) team {team} B={b}", got_t, want, TOL_F32)
            rows = ms.ensemble_solve_tsit5(*args, **kw)
            two_d = torch.cat([x.reshape(x.shape[0], b, -1) for x in ms.unpack_saves_2d(got, na, nk)], -1)
            row_k = torch.cat([x.reshape(x.shape[0], b, -1) for x in ms.unpack_saves(rows, na, nk)], -1)
            _, rel = rel_err(two_d, row_k)
            print(f"  multistrain_tsit5_2d vs multistrain_tsit5 (A,K)=({na},{nk}) B={b}: "
                  f"max rel err {rel:.3e} (tol {TOL_F32:.0e})")
            check(rel <= TOL_F32, f"the 2-D and row kernels disagree: rel {rel:.3e}")

    # ---- 8. the main path of the new kernels ----------------------------------
    print(f"phase 8: main path, adaptive kernel at B={MID} (all rows, bf16) and B={WIDE} "
          f"(c rows, bf16, padded), 2-D kernel at B={ENSEMBLE}")
    beta_mid = scaled_beta(base, scenario_scales(cuda_gen, MID))
    y_mid = ms.pack_state(y0, MID)
    p_mid = ms.pack_params(beta_mid, base.sigma, base.gamma, base.omega, MID)
    bf16_kw = dict(save_dtype=torch.bfloat16)
    torch.cuda.synchronize()

    gtri.launch_rk_solve_adaptive.launches = 0
    ms.launch_multistrain_tsit5_2d.launches = 0
    mid, mid_stats = gen.ensemble_solve_kernel_adaptive(rhs_ms, y_mid, p_mid, **adaptive_kw, **bf16_kw)
    obs_ad, obs_stats = gen.ensemble_solve_kernel_adaptive(rhs_ms, y_wide, p_wide, **adaptive_kw, **obs_kw)
    saves_2d = ms.ensemble_solve_tsit5_2d(y0, beta, base.sigma, base.gamma, base.omega,
                                          base.contact_matrix, batch=ENSEMBLE, duration=DAYS, dt=DT)
    torch.cuda.synchronize()
    launches.update(rk_solve_adaptive=gtri.launch_rk_solve_adaptive.launches,
                    multistrain_tsit5_2d=ms.launch_multistrain_tsit5_2d.launches)
    print(f"  launches in the main path of the new kernels: "
          f"{ {k: launches[k] for k in ('rk_solve_adaptive', 'multistrain_tsit5_2d')} }")
    check(launches["rk_solve_adaptive"] > 0 and launches["multistrain_tsit5_2d"] > 0,
          f"a kernel of the path did not launch: {launches}")

    for what, out, stats, rows in ((f"B={MID} all rows", mid, mid_stats, D),
                                   (f"B={WIDE} c rows", obs_ad, obs_stats, 8)):
        n_bad = int(stats["exhausted_intervals"].sum())
        attempts = int((stats["n_accepted"] + stats["n_rejected"]).sum())
        n_blocks = stats["n_accepted"].shape[0]
        print(f"  adaptive {what}: {tuple(out.shape)} bf16 saves ({out.numel() * 2 / 1e9:.2f} GB); "
              f"exhausted_intervals {n_bad}; {attempts} attempts in {n_blocks} blocks, "
              f"{(ADAPTIVE_STAGES - 1) * attempts + n_blocks} RHS evaluations")
        check(tuple(out.shape) == (int(DAYS) + 1, rows, out.shape[-1]), f"adaptive saves shape {tuple(out.shape)}")
        check(n_bad == 0, f"adaptive {what}: {n_bad} exhausted intervals")
        check(bool(torch.isfinite(out).all()), f"adaptive {what}: non-finite saves")
    check(not obs_ad[:, len(c_rows):].any(), f"adaptive padding rows not zero at B={WIDE}")
    mid_attempts = int((mid_stats["n_accepted"] + mid_stats["n_rejected"]).sum())
    mid_blocks = mid_stats["n_accepted"].shape[0]
    # the all-rows bf16 variant is a compile of its own: hold it against the plain version
    want_mid, want_mid_stats = gen.ensemble_solve_kernel_adaptive_reference(
        rhs_ms, y_mid, p_mid, block_b=gen.ADAPTIVE_BLOCK, **adaptive_kw)
    report_adaptive(f"main path B={MID}, all rows, bf16", mid, mid_stats,
                    want_mid.to(torch.bfloat16), want_mid_stats, TOL_BF16)
    del mid, want_mid

    check(tuple(saves_2d.shape) == (int(DAYS) + 1, D2, ENSEMBLE), f"2-D saves shape {tuple(saves_2d.shape)}")
    check(bool(torch.isfinite(saves_2d).all()), f"non-finite 2-D saves at B={ENSEMBLE}")
    s, e, i, r, c = ms.unpack_saves_2d(saves_2d)
    mass = s + e.sum(-1) + i.sum(-1) + r.sum(-1)
    drift = float(((mass - mass[0]).abs() / mass[0]).max())
    print(f"  2-D B={ENSEMBLE}: {tuple(saves_2d.shape)} f32 saves finite; per-age mass drift "
          f"{drift:.3e} (tol {TOL_MASS:.0e})")
    check(drift <= TOL_MASS, f"mass not conserved by the 2-D kernel at B={ENSEMBLE}: {drift:.3e}")
    del s, e, i, r, c, mass

    # ---- 9. times of the new kernels, and their main path against the plain ---
    print(f"phase 9: times, entry points median of 3 after a warm-up, plain versions one call, on {smi}")
    k_ms, _ = median_ms(lambda: gen.ensemble_solve_kernel_adaptive(
        rhs_ms, y_wide, p_wide, **adaptive_kw, **obs_kw)[0])
    plain_stats = {}

    def adaptive_plain():
        full, plain_stats["s"] = gen.ensemble_solve_kernel_adaptive_reference(
            rhs_ms, y_wide, p_wide, block_b=gen.ADAPTIVE_BLOCK, **adaptive_kw)
        return gen.select_saves(full, c_rows, torch.bfloat16, True)

    p_ms_, plain = wall_ms(adaptive_plain)
    report_adaptive(f"main path B={WIDE}, c rows, bf16, padded", obs_ad[:, :len(c_rows)], obs_stats,
                    plain[:, :len(c_rows)], plain_stats["s"], TOL_BF16)
    times["rk_solve_adaptive"] = (k_ms, p_ms_, WIDE)
    del plain
    mid_ms, _ = median_ms(lambda: gen.ensemble_solve_kernel_adaptive(
        rhs_ms, y_mid, p_mid, **adaptive_kw, **bf16_kw)[0])
    ms2_args = (y0, beta, base.sigma, base.gamma, base.omega, base.contact_matrix)
    ms2_kw = dict(batch=ENSEMBLE, duration=DAYS, dt=DT)
    k_ms, _ = median_ms(lambda: ms.ensemble_solve_tsit5_2d(*ms2_args, **ms2_kw))
    p_ms_, plain = wall_ms(lambda: solve_2d_plain(ms2_args, ms2_kw))
    report("multistrain_tsit5_2d", f"main path B={ENSEMBLE}", saves_2d, plain, TOL_F32)
    times["multistrain_tsit5_2d"] = (k_ms, p_ms_, ENSEMBLE)
    del plain
    y_2d = ms.pack_state_2d(y0, ENSEMBLE)
    r_2d = ms.pack_rates_2d(beta, base.sigma, base.gamma, base.omega, ENSEMBLE)
    grid_kw = dict(n_saves=int(DAYS) + 1, save_every=1.0, t0=0.0)
    device_ms["rk_solve_adaptive"] = event_ms(lambda: gtri.launch_rk_solve_adaptive(
        rhs_ms, y_wide, p_wide, rtol=RTOL, atol=ATOL, dt0=1.0 / 8, steps_per_save=8, method="bosh3",
        block_b=gen.ADAPTIVE_BLOCK, save_rows=c_rows, save_dtype=torch.bfloat16, padded_rows=True,
        **grid_kw))
    # the compile the main path's obs call used: Triton's facts and the static SASS mix
    adaptive_facts = {"n_regs": gtri.kernel_info["n_regs"], "n_spills": gtri.kernel_info["n_spills"],
                      "maxnreg": gtri.kernel_info["maxnreg"], "sass": gtri.adaptive_sass_mix()}
    device_ms["multistrain_tsit5_2d"] = event_ms(lambda: ms.launch_multistrain_tsit5_2d(
        y_2d, r_2d, contact, dt=DT, n_steps=n_steps, save_stride=stride, n_age=A, n_strain=K))
    for name in ("rk_solve_adaptive", "multistrain_tsit5_2d"):
        k_ms, p_ms_, b = times[name]
        print(f"  {name} B={b}: entry point {k_ms:.3f} ms ({b / k_ms * 1e3:,.0f} traj/s), "
              f"kernel alone {device_ms[name]:.3f} ms (CUDA events), "
              f"plain {p_ms_:.1f} ms ({b / p_ms_ * 1e3:,.0f} traj/s) [{smi}]")
    print(f"  rk_solve_adaptive B={MID}, all rows bf16: entry point {mid_ms:.3f} ms "
          f"({MID / mid_ms * 1e3:,.0f} traj/s); {mid_attempts} attempts in {mid_blocks} blocks [{smi}]")
    print(f"  rk_solve_adaptive B={WIDE} (bosh3, c rows bf16): n_regs {adaptive_facts['n_regs']}, n_spills "
          f"{adaptive_facts['n_spills']} at maxnreg {adaptive_facts['maxnreg']}; static SASS "
          f"{adaptive_facts['sass'] or 'not available (no cuobjdump found)'}")
    print(f"  B={ENSEMBLE}, kernel alone: multistrain_tsit5_2d {device_ms['multistrain_tsit5_2d']:.3f} ms "
          f"vs multistrain_tsit5 {device_ms['multistrain_tsit5']:.3f} ms (CUDA events) [{smi}]")
    facts_2d = team_facts("multistrain_tsit5_2d", ENSEMBLE)

    # ---- 10. the SEIP kernels against their plain versions ---------------------
    from dynode_tpu_torch.models import seip as seip_model
    from dynode_tpu_torch.ops import seip as tsp

    print(f"phase 10: SEIP kernels vs plain, all compartments f32, {DAYS:.0f} days; RK4 dt={DT}, "
          f"BS3 rtol {SEIP_RTOL:g}, atol {SEIP_ATOL:g}, block_b {tsp.SEIP_ADAPTIVE_BLOCK} on both sides")
    on_card = [seip_model.seip_default_params(True).beta, *seip_model.seip_initial_state(True)]
    check(all(x.device.type == dev.type for x in on_card), "a SEIP constructor left the card")
    sp = seip_model.seip_default_params(True, device=dev)
    sy = seip_model.seip_initial_state(True, device=dev)
    seip_kw = dict(duration=DAYS, rtol=SEIP_RTOL, atol=SEIP_ATOL)
    errors.update(seip_rk4=[], seip_bs3=[])
    seip_scales = torch.as_tensor(rng.uniform(0.85, 1.2, SLICE), dtype=torch.float32, device=dev)

    def report_seip(what, got, want, tol, kernel="seip_rk4"):
        for name, g, w in zip("SEIC", got, want):
            report(kernel, f"{what} {name}", g, w, tol)

    def seip_mass(outs) -> float:
        """Largest relative drift of S + E + I summed per age (C counts incidence)."""
        living = sum(x.float().sum(dim=(2, 3, 4)) for x in outs[:3])  # (T, A, B)
        return float(((living - living[0]).abs() / living[0]).max())

    def report_seip_adaptive(what, got, got_stats, want, want_stats, tol_same, tol_all):
        """The per-block gate of phase 6 on each saved compartment, each
        relative to its own largest plain value."""
        same = torch.ones_like(got_stats["n_accepted"], dtype=torch.bool)
        for key in got_stats:
            same &= got_stats[key] == want_stats[key]
        block_of = torch.arange(got[0].shape[-1], device=dev) // tsp.SEIP_ADAPTIVE_BLOCK
        block_abs, block_rel = [], []
        for g, w in zip(got, want):  # (T, *compartment, B)
            member_abs = (g.float() - w.float()).abs().flatten(0, -2).amax(dim=0)
            b_abs = torch.zeros(same.shape[0], device=dev).scatter_reduce_(0, block_of, member_abs, "amax")
            block_abs.append(b_abs)
            block_rel.append(b_abs / float(w.float().abs().max()))
        block_abs = torch.stack(block_abs).amax(dim=0)
        block_rel = torch.stack(block_rel).amax(dim=0)
        rel_same = float(block_rel[same].max()) if bool(same.any()) else float("nan")
        rel_all = float(block_rel.max())
        frac = float(same.float().mean())
        attempts = int((got_stats["n_accepted"] + got_stats["n_rejected"]).sum())
        print(f"  seip_bs3 {what}: {int((~same).sum())} of {same.numel()} blocks with other stats; "
              f"max rel err {rel_same:.3e} over equal-stats blocks (tol {tol_same:.0e}), {rel_all:.3e} "
              f"over all (tol {tol_all:.0e}); {attempts} attempts, "
              f"{int(got_stats['exhausted_intervals'].sum())} exhausted")
        check(frac >= MIN_SAME, f"seip_bs3 {what}: only {frac:.3f} of blocks match")
        check(rel_same <= tol_same, f"seip_bs3 {what}: rel err {rel_same:.3e} > {tol_same:.0e}")
        check(rel_all <= tol_all, f"seip_bs3 {what}: rel err {rel_all:.3e} > {tol_all:.0e}")
        if tol_same == TOL_F32:
            errors["seip_bs3"].append(float(block_abs[same].max()))

    n_steps_seip = int(round(DAYS / DT))
    P = tsp.seip_static_params(sp)
    table = tsp.launch_seip_time_table(P, dt=DT, n_steps=n_steps_seip, device=dev)
    same = torch.equal(table, tsp.seip_time_table_reference(P, dt=DT, n_steps=n_steps_seip, device=dev))
    print(f"  seip_rk4 time table {tuple(table.shape)}: equal to its plain version bit for bit: {same}")
    check(same, "the SEIP time table differs from its plain version")
    want_rk4 = tsp.seip_solve_reference(sy, sp, seip_scales, duration=DAYS, dt=DT)
    for b in (SLICE, RAGGED):
        got = tsp.seip_ensemble_solve(sy, sp, seip_scales[:b], duration=DAYS, dt=DT)
        check(all(bool(torch.isfinite(x).all()) for x in got), f"seip_rk4 B={b}: non-finite saves")
        report_seip(f"B={b}", got, [x[..., :b] for x in want_rk4], TOL_F32)
        drift = seip_mass(got)
        print(f"  seip_rk4 B={b}: per-age mass drift {drift:.3e} (tol {TOL_MASS:.0e})")
        check(drift <= TOL_MASS, f"seip_rk4 B={b}: mass drift {drift:.3e}")
    got = tsp.seip_ensemble_solve(sy, sp, seip_scales, duration=DAYS, dt=DT, save_dtype=torch.bfloat16)
    report_seip("bf16 saves", got, want_rk4, TOL_BF16)
    for b in (SLICE, RAGGED):
        got, got_stats = tsp.seip_ensemble_solve_adaptive(sy, sp, seip_scales[:b], **seip_kw)
        want, want_stats = tsp.seip_solve_adaptive_reference(
            sy, sp, seip_scales[:b], block_b=tsp.SEIP_ADAPTIVE_BLOCK, **seip_kw)
        check(int(got_stats["exhausted_intervals"].sum()) == 0, f"seip_bs3 B={b}: budget exhausted")
        report_seip_adaptive(f"B={b}", got, got_stats, want, want_stats, TOL_F32, TOL_ADAPTIVE_ALL)
        drift = seip_mass(got)
        print(f"  seip_bs3 B={b}: per-age mass drift {drift:.3e} (tol {TOL_MASS:.0e})")
        check(drift <= TOL_MASS, f"seip_bs3 B={b}: mass drift {drift:.3e}")
        if b == SLICE:
            want_bs3, want_bs3_stats = want, want_stats
    got, got_stats = tsp.seip_ensemble_solve_adaptive(sy, sp, seip_scales, save_dtype=torch.bfloat16, **seip_kw)
    report_seip_adaptive("bf16 saves", got, got_stats, want_bs3, want_bs3_stats, TOL_BF16, TOL_BF16)
    del want_rk4, want_bs3, got

    # the attempt budget: one attempt per interval cannot keep up at rtol 1e-6
    (c_bud,), bud_stats = tsp.seip_ensemble_solve_adaptive(
        sy, sp, seip_scales, duration=DAYS, rtol=1e-6, atol=1e-6, steps_per_save=1, save=(3,))
    nb = bud_stats["n_accepted"].shape[0]
    nan_slot = torch.isnan(c_bud).flatten(1, -2).all(dim=1).reshape(c_bud.shape[0], nb, -1).all(dim=2)
    exhausted = bud_stats["exhausted_intervals"]
    print(f"  seip_bs3 budget (rtol 1e-6, 1 attempt): all-NaN slots per block "
          f"{int(nan_slot.sum(0).min())}..{int(nan_slot.sum(0).max())}, exhausted_intervals "
          f"{int(exhausted.min())}..{int(exhausted.max())}, slot 0 NaN in {int(nan_slot[0].sum())} blocks")
    check(bool((nan_slot.sum(0) == exhausted).all()), "SEIP NaN slots differ from exhausted_intervals")
    check(bool((exhausted > 0).all()), "a SEIP block kept up with one attempt per interval")
    check(not bool(nan_slot[0].any()), "SEIP slot 0 is NaN")

    # accuracy against an independent solve: the RK4 kernel at dt = 0.05 (bench_seip.py's gate)
    m = 1024
    acc_scales = torch.as_tensor(rng.uniform(0.85, 1.2, m), dtype=torch.float32, device=dev)
    (c_ref,) = tsp.seip_ensemble_solve(sy, sp, acc_scales, duration=DAYS, dt=0.05, save=(3,))
    (c_ad,), ad_stats = tsp.seip_ensemble_solve_adaptive(sy, sp, acc_scales, save=(3,), **seip_kw)
    _, acc_rel = rel_err(c_ad, c_ref)
    print(f"  seip_bs3 vs seip_rk4 at dt = 0.05, B={m}: max rel err {acc_rel:.3e} "
          f"(tol {TOL_SEIP_ACCURACY:.0e}), exhausted {int(ad_stats['exhausted_intervals'].sum())}")
    check(acc_rel < TOL_SEIP_ACCURACY and int(ad_stats["exhausted_intervals"].sum()) == 0,
          f"SEIP adaptive accuracy gate: {acc_rel:.3e}")

    # ---- 11. the SEIP main path at full width ------------------------------------
    print(f"phase 11: SEIP main path (bench_seip.py), scales Uniform(0.85, 1.2): RK4 at B={SEIP_WIDE} "
          f"(C f32; all four bf16, packed), BS3 at B={SEIP_WIDE} (C f32, packed) and "
          f"B={2 * SEIP_WIDE} (C bf16, packed)")
    main_scales = torch.as_tensor(rng.uniform(0.85, 1.2, SEIP_WIDE), dtype=torch.float32, device=dev)
    wide_scales = torch.as_tensor(rng.uniform(0.85, 1.2, 2 * SEIP_WIDE), dtype=torch.float32, device=dev)
    c_kw = dict(save=(3,), packed=True)
    torch.cuda.synchronize()
    tsp.launch_seip_rk4.launches = 0
    tsp.launch_seip_time_table.launches = 0
    tsp.launch_seip_bs3.launches = 0
    (c_rk4,) = tsp.seip_ensemble_solve(sy, sp, main_scales, duration=DAYS, dt=DT, save=(3,))
    full4 = tsp.seip_ensemble_solve(sy, sp, main_scales, duration=DAYS, dt=DT,
                                    save_dtype=torch.bfloat16, packed=True)
    (c_bs3,), bs3_stats = tsp.seip_ensemble_solve_adaptive(sy, sp, main_scales, **seip_kw, **c_kw)
    (c_wide,), wide_stats = tsp.seip_ensemble_solve_adaptive(
        sy, sp, wide_scales, save_dtype=torch.bfloat16, **seip_kw, **c_kw)
    torch.cuda.synchronize()
    launches.update(seip_rk4=tsp.launch_seip_rk4.launches, seip_bs3=tsp.launch_seip_bs3.launches)
    table_launches = tsp.launch_seip_time_table.launches
    print(f"  launches in the SEIP main path: { {k: launches[k] for k in ('seip_rk4', 'seip_bs3')} }, "
          f"the RK4 kernel's time table {table_launches}")
    check(launches["seip_rk4"] > 0 and launches["seip_bs3"] > 0 and table_launches > 0,
          f"a SEIP kernel of the path did not launch: {launches}, time table {table_launches}")
    n_days = int(DAYS) + 1
    check(tuple(c_rk4.shape) == (n_days, 4, 4, 4, 2, SEIP_WIDE), f"SEIP C saves {tuple(c_rk4.shape)}")
    check(tuple(full4[0].shape) == (n_days, 4, 4, 4, 4, 8, SEIP_WIDE // 8), "SEIP packed S saves")
    for what, x in (("rk4 C f32", c_rk4), ("bs3 C f32", c_bs3), ("bs3 C bf16", c_wide),
                    *((f"rk4 {n} bf16", o) for n, o in zip("SEIC", full4))):
        check(bool(torch.isfinite(x).all()), f"SEIP {what}: non-finite saves")
    for what, st in ((f"B={SEIP_WIDE}", bs3_stats), (f"B={2 * SEIP_WIDE}", wide_stats)):
        n_bad = int(st["exhausted_intervals"].sum())
        print(f"  seip_bs3 {what}: {int((st['n_accepted'] + st['n_rejected']).sum())} attempts in "
              f"{st['n_accepted'].shape[0]} blocks, {int(st['n_rejected'].sum())} rejected, "
              f"exhausted_intervals {n_bad}")
        check(n_bad == 0, f"seip_bs3 {what}: {n_bad} exhausted intervals")
    f4_gb = sum(o.numel() for o in full4) * 2 / 1e9
    print(f"  SEIP saves finite: RK4 C f32 {c_rk4.numel() * 4 / 1e9:.2f} GB, all four bf16 {f4_gb:.2f} GB; "
          f"BS3 C f32 {c_bs3.numel() * 4 / 1e9:.2f} GB, C bf16 {c_wide.numel() * 2 / 1e9:.2f} GB")
    del full4

    # ---- 12. SEIP times, the main path against the plain versions, bounds -------
    print(f"phase 12: SEIP times, entry points median of 3 after a warm-up, plain versions one call, "
          f"on {smi}")
    seip_entry = {
        "rk4_c": lambda: tsp.seip_ensemble_solve(sy, sp, main_scales, duration=DAYS, dt=DT, save=(3,))[0],
        "rk4_full4": lambda: tsp.seip_ensemble_solve(sy, sp, main_scales, duration=DAYS, dt=DT,
                                                     save_dtype=torch.bfloat16, packed=True)[3],
        "bs3_c": lambda: tsp.seip_ensemble_solve_adaptive(sy, sp, main_scales, **seip_kw, **c_kw)[0][0],
        "bs3_wide": lambda: tsp.seip_ensemble_solve_adaptive(
            sy, sp, wide_scales, save_dtype=torch.bfloat16, **seip_kw, **c_kw)[0][0],
    }
    seip_ms = {name: median_ms(fn)[0] for name, fn in seip_entry.items()}
    p_rk4, (plain_c,) = wall_ms(lambda: tsp.seip_solve_reference(
        sy, sp, main_scales, duration=DAYS, dt=DT, save=(3,)))
    report("seip_rk4", f"main path B={SEIP_WIDE} C", c_rk4, plain_c, TOL_F32)
    del plain_c, c_rk4
    plain_stats = {}

    def bs3_plain(scales):
        def run():
            outs, plain_stats["s"] = tsp.seip_solve_adaptive_reference(
                sy, sp, scales, block_b=tsp.SEIP_ADAPTIVE_BLOCK, save=(3,), **seip_kw)
            return outs
        return run

    p_bs3_c, plain = wall_ms(bs3_plain(main_scales))
    report_seip_adaptive(f"main path B={SEIP_WIDE} C", (tsp.unpack_members(c_bs3),), bs3_stats,
                         plain, plain_stats["s"], TOL_F32, TOL_ADAPTIVE_ALL)
    p_bs3, plain = wall_ms(bs3_plain(wide_scales))
    report_seip_adaptive(f"main path B={2 * SEIP_WIDE} C bf16", (tsp.unpack_members(c_wide),), wide_stats,
                         (plain[0].to(torch.bfloat16),), plain_stats["s"], TOL_BF16, TOL_BF16)
    del plain, c_bs3, c_wide
    times["seip_rk4"] = (seip_ms["rk4_c"], p_rk4, SEIP_WIDE)
    times["seip_bs3"] = (seip_ms["bs3_wide"], p_bs3, 2 * SEIP_WIDE)
    device_ms["seip_rk4"] = event_ms(lambda: tsp.launch_seip_rk4(
        sy, P, tsp._norm_scales(main_scales, 2, torch.float32, dev), dt=DT, n_steps=n_steps_seip,
        save_stride=int(round(1.0 / DT)), save=(3,), save_dtype=torch.float32, packed=False))
    device_ms["seip_bs3"] = event_ms(lambda: tsp.launch_seip_bs3(
        sy, P, tsp._norm_scales(wide_scales, 2, torch.float32, dev), n_saves=n_days, save_every=1.0,
        rtol=SEIP_RTOL, atol=SEIP_ATOL, dt0=1.0 / 8, steps_per_save=8, block_b=tsp.SEIP_ADAPTIVE_BLOCK,
        save=(3,), save_dtype=torch.bfloat16, packed=True))
    # where the RK4 kernel's time goes: the same solve saving only its two end points
    rk4_ends_ms = event_ms(lambda: tsp.launch_seip_rk4(
        sy, P, tsp._norm_scales(main_scales, 2, torch.float32, dev), dt=DT, n_steps=n_steps_seip,
        save_stride=n_steps_seip, save=(3,), save_dtype=torch.float32, packed=False))
    full4_ms = event_ms(lambda: tsp.launch_seip_rk4(
        sy, P, tsp._norm_scales(main_scales, 2, torch.float32, dev), dt=DT, n_steps=n_steps_seip,
        save_stride=int(round(1.0 / DT)), save=(0, 1, 2, 3), save_dtype=torch.bfloat16, packed=True))
    print(f"  seip_rk4 B={SEIP_WIDE}: kernel alone {rk4_ends_ms:.3f} ms saving only t = 0 and "
          f"t = {DAYS:.0f}, {device_ms['seip_rk4']:.3f} ms with daily C saves (f32), {full4_ms:.3f} ms "
          f"with all four compartments daily (bf16, packed) (CUDA events) [{smi}]")
    resources = _build.ptxas_resources(_build.build_log())
    sass = _build.sass_counts(_build.library_path())
    chosen = {f"seip_rk4_kernel<{tsp.RK4_WIDTH}>", "seip_time_table_kernel",
              f"seip_bs3_kernel<{tsp.SEIP_ADAPTIVE_BLOCK}>"}
    for name in sorted(k for k in resources if k.startswith("seip_")):
        mix = "not available (no cuobjdump beside nvcc)" if sass is None else sass.get(name)
        print(f"  {name}{' (main path)' if name in chosen else ''}: {resources[name]}; static SASS {mix}")
    for name, what in (("rk4_c", f"seip_rk4 B={SEIP_WIDE}, C f32"),
                       ("rk4_full4", f"seip_rk4 B={SEIP_WIDE}, all four bf16 packed"),
                       ("bs3_c", f"seip_bs3 B={SEIP_WIDE}, C f32 packed"),
                       ("bs3_wide", f"seip_bs3 B={2 * SEIP_WIDE}, C bf16 packed")):
        b = 2 * SEIP_WIDE if name == "bs3_wide" else SEIP_WIDE
        print(f"  {what}: entry point {seip_ms[name]:.3f} ms ({b / seip_ms[name] * 1e3:,.0f} traj/s) [{smi}]")
    for name, (k_ms, p_ms_, b) in ((k, times[k]) for k in ("seip_rk4", "seip_bs3")):
        print(f"  {name} B={b}: kernel alone {device_ms[name]:.3f} ms (CUDA events), "
              f"plain {p_ms_:.1f} ms ({b / p_ms_ * 1e3:,.0f} traj/s) [{smi}]")
    print(f"  seip_bs3 B={SEIP_WIDE}, C f32: plain {p_bs3_c:.1f} ms [{smi}]")

    cpu_p = seip_model.seip_default_params(True, device="cpu")
    cpu_y = seip_model.seip_initial_state(True, device="cpu")
    rhs_m, rhs_s, step_m, step_s, attempt_m, attempt_s = seip_work(cpu_p, cpu_y, seip_kw)
    print(f"  SEIP work counted from the plain versions, per member (+ shared by a time's members): "
          f"RHS {rhs_m:,} (+{rhs_s:,}) operations, RK4 step {step_m:,} (+{step_s:,}), BS3 attempt "
          f"{attempt_m:,.0f} (+{attempt_s:,.0f} per block; plus one RHS after each rejection; no "
          f"selects over the state)")
    work_seip = (rhs_m, rhs_s, step_m, step_s, attempt_m, attempt_s)
    bs3_flops = seip_bs3_flops(work_seip, wide_stats, 2 * SEIP_WIDE, tsp.SEIP_ADAPTIVE_BLOCK)
    seip_in = 4 * 640 + 8 * 295  # shared y0 and the float64 constants
    rk4_flops = n_steps_seip * (SEIP_WIDE * step_m + step_s)
    full4_bytes = seip_in + 4 * 2 * SEIP_WIDE + 2 * n_days * 640 * SEIP_WIDE
    full4_bound = max(rk4_flops / PEAK_F32_FLOPS, full4_bytes / PEAK_BYTES) * 1e3
    print(f"  seip_rk4 all four bf16: {rk4_flops / 1e9:.2f} GFLOP ({rk4_flops / PEAK_F32_FLOPS * 1e3:.4f} ms), "
          f"{full4_bytes / 1e9:.2f} GB of saves and inputs ({full4_bytes / PEAK_BYTES * 1e3:.4f} ms) -> "
          f"bound {full4_bound:.4f} ms; kernel {full4_ms:.3f} ms ({full4_bound / full4_ms:.1%} of the bound) "
          f"[{smi}]")
    seip_kernel_work = {
        "seip_rk4": (rk4_flops, seip_in + 4 * 2 * SEIP_WIDE + 4 * n_days * 128 * SEIP_WIDE),
        "seip_bs3": (bs3_flops, seip_in + 4 * 2 * 2 * SEIP_WIDE + 2 * n_days * 128 * 2 * SEIP_WIDE
                     + 12 * wide_stats["n_accepted"].shape[0]),
    }

    # ---- 13. the ODE engine and simulate ---------------------------------------
    fit, fit_z, lane = engine_phase(dev, smi, cuda_gen)

    # ---- 14. config to kernels, and dist on the card -----------------------------
    config_launches = config_phase(dev, smi, cuda_gen, fit, fit_z)

    # ---- 15. bench_nuts.py's fit sampled on the card, and its posterior predictive
    infer_launches = infer_phase(dev, smi, cuda_gen, fit, fit_z)

    # ---- 16. the rest of inference: the processes, SVI and the forecast bands ----
    forecast_launches = slice_phase(dev, smi, fit)

    # ---- 17. the stiff solvers and the mesh split ------------------------------
    mesh_launches = mesh_phase(dev, smi, fit, dict(
        rhs=rhs_ms, y_wide=y_wide, p_wide=p_wide, obs_kw=obs_kw, adaptive_kw=adaptive_kw, sy=sy, sp=sp,
        scales=main_scales, seip_kw=seip_kw, lane=lane))

    # ---- 18. the kernels' other shapes, from their configs -------------------------
    shape_rows = shapes_phase(dev, smi, shape_wall.result)
    shape_builds.shutdown()

    # ---- 19. the examples of examples_torch/ ------------------------------------
    example_launches = examples_phase(dev, smi)

    # ---- the kernels' line: counts of this run's work and the card's bound ---
    obs_attempts = int((obs_stats["n_accepted"] + obs_stats["n_rejected"]).sum())
    obs_bytes = 8 * 2  # a member's save slot: 6 c rows + 2 zero rows, bf16
    work = {
        "multistrain_tsit5": (
            n_steps * ENSEMBLE * step_flops(METHODS["tsit5"], rhs_flops(A, K), D),
            4 * ENSEMBLE * (D + 4 * K) + 4 * A * A + 4 * (int(DAYS) + 1) * D * ENSEMBLE),
        "rk_solve": (
            n_steps * WIDE * step_flops(METHODS["tsit5"], rhs_flops(A, K), D),
            4 * WIDE * (D + 4 * K) + (int(DAYS) + 1) * obs_bytes * WIDE),
        "rk_solve_adaptive": (
            adaptive_flops(obs_stats, WIDE, gen.ADAPTIVE_BLOCK, ADAPTIVE_METHODS["bosh3"],
                           rhs_flops(A, K), D),
            4 * WIDE * (D + 4 * K) + 4 * (int(DAYS) + 1) + (int(DAYS) + 1) * obs_bytes * WIDE
            + 3 * 4 * obs_stats["n_accepted"].shape[0]),
        "multistrain_tsit5_2d": (
            n_steps * ENSEMBLE * step_flops_2d(METHODS["tsit5"], A, K),
            4 * ENSEMBLE * (D2 + 32) + 4 * A * A + 4 * (int(DAYS) + 1) * D2 * ENSEMBLE),
        **seip_kernel_work,
    }
    print(f"  adaptive B={WIDE}: {obs_attempts} attempts; work counted from the stats")
    check("jax" not in sys.modules, "jax was imported")
    meta = {
        "multistrain_tsit5": ("cuda", "dynode_tpu_torch/csrc/multistrain_tsit5.cu",
                              "dynode_tpu/ops/multistrain_pallas.py:195"),
        "rk_solve": ("triton", "dynode_tpu_torch/ops/generic_triton.py",
                     "dynode_tpu/ops/generic_pallas.py:236"),
        "rk_solve_adaptive": ("triton", "dynode_tpu_torch/ops/generic_triton.py",
                              "dynode_tpu/ops/generic_pallas.py:516"),
        "multistrain_tsit5_2d": ("cuda", "dynode_tpu_torch/csrc/multistrain_tsit5_2d.cu",
                                 "dynode_tpu/ops/multistrain_pallas.py:598"),
        "seip_rk4": ("cuda", "dynode_tpu_torch/csrc/seip_rk4.cu", "dynode_tpu/ops/seip_pallas.py:306"),
        "seip_bs3": ("cuda", "dynode_tpu_torch/csrc/seip_bs3.cu", "dynode_tpu/ops/seip_pallas.py:605"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        flops, nbytes = work[name]
        bound_ms, bound_by = max((flops / PEAK_F32_FLOPS * 1e3, "operations"),
                                 (nbytes / PEAK_BYTES * 1e3, "bytes"))
        print(f"  {name}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB -> bound {bound_ms:.4f} ms "
              f"by {bound_by}; kernel {device_ms[name]:.3f} ms ({bound_ms / device_ms[name]:.1%} of the "
              f"bound) [{smi}]")
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(errors[name]),
            "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "batch": times[name][2],
            "kernel_event_ms": device_ms[name],
        })
    for name, n in config_launches.items():  # phase 14's path from the configs
        kernels[list(meta).index(name)]["config_path_launches"] = n
    for name, n in infer_launches.items():  # phase 15's posterior predictive
        kernels[list(meta).index(name)]["infer_path_launches"] = n
    for name, n in forecast_launches.items():  # phase 16's forecast bands
        kernels[list(meta).index(name)]["forecast_path_launches"] = n
    for name, n in mesh_launches.items():  # phase 17's split entries
        kernels[list(meta).index(name)]["mesh_path_launches"] = n
    for name, row in shape_rows.items():  # phase 18's other shapes
        kernels[list(meta).index(name)].update(row)
    for name, n in example_launches.items():  # phase 19's examples
        kernels[list(meta).index(name)]["examples_path_launches"] = n
    kernels[list(meta).index("rk_solve_adaptive")].update(adaptive_facts)
    kernels[list(meta).index("multistrain_tsit5")].update(row_facts)
    kernels[list(meta).index("multistrain_tsit5_2d")].update(facts_2d)
    kernels[list(meta).index("seip_rk4")].update(
        time_table_launches=table_launches, full4_event_ms=full4_ms, full4_bound_ms=full4_bound)
    print(f"chip_smoke: {time.perf_counter() - t_start:.0f} s from start to the result")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
