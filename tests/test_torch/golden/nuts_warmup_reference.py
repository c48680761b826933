"""NUTS on ``bench_nuts.py``'s fit after a short warmup, in the JAX package
or in the port, on the CPU.

Runs ``MCMC(NUTS(model, dense_mass=True, max_tree_depth=3,
batched_potential_fn=...), steps_per_call=16)`` on ``bench_nuts.py``'s
counts (``bench_nuts_obs.npz`` beside this file), 100 days, float32: in JAX
with ``bench_nuts.build_model()`` and ``build_lane_major_potential``; in the
port with ``chip_smoke.fit_model`` and ``chip_smoke.fit_potential`` on CPU
tensors. Prints one JSON line: the share of stuck chains (every
coordinate's spread over the draws below 1e-5) and of chains with a
divergence, the rescued chains, the mean accept probability and leapfrogs,
the step sizes after warmup (quantiles), the max split-Rhat and the
posterior-mean drift from the true scales.

``infer.hmc.build_warmup_schedule`` gives a warmup under 20 steps no metric
window, and a warmup of W from 20 to 149 steps a window that ends int(0.1
W) steps before the warmup does; the step size after warmup averages only
those last steps of dual averaging. ``chip_smoke.py``'s phase 15 (c) holds
the card's shares to the JAX line of::

    python tests/test_torch/golden/nuts_warmup_reference.py jax --chains 4096 --warmup 24 --draws 8

Run from the repository root on the CPU; ``port`` runs the port's side.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
TRUE_SCALES = np.array([1.1, 0.95, 1.05])


def run_jax(obs, args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import bench_nuts
    from dynode_tpu.infer import MCMC, NUTS

    model, _ = bench_nuts.build_model()
    mcmc = MCMC(NUTS(model, dense_mass=True, max_tree_depth=3,
                     batched_potential_fn=bench_nuts.build_lane_major_potential(obs)),
                num_warmup=args.warmup, num_samples=args.draws, num_chains=args.chains, steps_per_call=16)
    mcmc.run(jax.random.PRNGKey(args.seed), obs=np.asarray(obs, np.float32))
    fields = {k: np.asarray(v) for k, v in mcmc.get_extra_fields(group_by_chain=True).items()}
    return mcmc, np.asarray(mcmc.get_samples(group_by_chain=True)["r0_scales"], np.float64), fields


def run_port(obs, args):
    import torch

    import chip_smoke
    from dynode_tpu_torch.infer import MCMC, NUTS

    torch.set_num_threads(args.threads)
    fit = chip_smoke.fit_potential(obs, device="cpu")
    mcmc = MCMC(NUTS(chip_smoke.fit_model(device="cpu"), dense_mass=True, max_tree_depth=3,
                     batched_potential_fn=fit.potential),
                num_warmup=args.warmup, num_samples=args.draws, num_chains=args.chains, steps_per_call=16)
    mcmc.run(torch.Generator().manual_seed(args.seed), obs=fit.obs)
    fields = {k: v.numpy() for k, v in mcmc.get_extra_fields(group_by_chain=True).items()}
    return mcmc, mcmc.get_samples(group_by_chain=True)["r0_scales"].double().numpy(), fields


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("side", choices=("jax", "port"))
    parser.add_argument("--chains", type=int, default=256)
    parser.add_argument("--warmup", type=int, default=24)
    parser.add_argument("--draws", type=int, default=8)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--threads", type=int, default=4, help="the port's CPU threads")
    args = parser.parse_args()
    obs = np.load(Path(__file__).with_name("bench_nuts_obs.npz"))["obs"]
    t = time.perf_counter()
    mcmc, arr, fields = (run_jax if args.side == "jax" else run_port)(obs, args)
    wall = time.perf_counter() - t

    from dynode_tpu_torch.infer.diagnostics import split_rhat

    step = np.asarray(fields["step_size"], np.float64)
    print(json.dumps({
        "side": args.side, "chains": args.chains, "warmup": args.warmup, "draws": args.draws, "seed": args.seed,
        "stuck": float((arr.std(axis=1).max(axis=-1) < 1e-5).mean()),
        "diverging": float(fields["diverging"].any(axis=1).mean()),
        "divergences": int(fields["diverging"].sum()),
        "rescued": int(mcmc._n_rescued),
        "accept_prob": float(fields["accept_prob"].mean()),
        "leapfrogs": float(fields["num_steps"].mean()),
        "step_size_5_50_95": np.quantile(step, [0.05, 0.5, 0.95]).tolist(),
        "split_rhat": float(max(split_rhat(arr[:, :, k]) for k in range(3))),
        "drift": float(np.abs(arr.reshape(-1, 3).mean(axis=0) - TRUE_SCALES).max()),
        "wall_s": wall,
    }))


if __name__ == "__main__":
    main()
