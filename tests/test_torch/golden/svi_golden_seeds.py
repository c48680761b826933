"""The golden SIR fit's SVI posterior over several seeds, in JAX or the port.

``tests/test_infer/test_nuts_through_ode.py``'s ``svi_fit`` (400 steps of
``Adam(0.1)`` on ``AutoMultivariateNormal``, 200 draws) and the port's
``test_torch_infer_golden.py`` hold one seed's posterior to the exact one
(``tests/golden/quadrature.npz``): means within 1%, stds within 55%, means
inside the 94% interval. This script runs the fit for each seed given and
prints each site's mean and std and which of the three criteria hold, so
that the spread over seeds of either package can be read. ``default`` is
the process's default key; ``--jax-init`` starts the port's guide at the
JAX package's ``init_to_median`` point (its own prior draws, PRNGKey(0))
instead of the port's. Run from the repository root on the CPU (JAX about
6 s a seed; the port about 4 minutes a seed, one thread)::

    python tests/test_torch/golden/svi_golden_seeds.py jax --seeds default 0 1 2
    python tests/test_torch/golden/svi_golden_seeds.py port --seeds default 0 [--jax-init]
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "test_infer"))
sys.path.insert(0, str(ROOT / "tests" / "test_torch"))

import numpy as np  # noqa: E402

QUAD = np.load(ROOT / "tests" / "golden" / "quadrature.npz")
#: the JAX package's init_to_median point of the golden guide (unconstrained,
#: sorted sites: infectious_period, r0), from its PRNGKey(0) prior draws
JAX_INIT = (-0.02564646, 0.56295014)


def verdict(samples) -> str:
    out = []
    for site in ("strains_0_r0", "strains_0_infectious_period"):
        arr = np.asarray(samples[site], dtype=np.float64)
        mean, std = arr.mean(), arr.std()
        q_mean, q_std = float(QUAD[f"{site}_mean"]), float(QUAD[f"{site}_std"])
        lo, hi = QUAD[f"{site}_eti94"]
        ok = (abs(mean / q_mean - 1) <= 0.01, abs(std / q_std - 1) <= 0.55, lo < mean < hi)
        out.append(f"{site} mean {mean:.5f} std {std:.5f} [mean 1%: {ok[0]}, std 55%: {ok[1]}, in 94%: {ok[2]}]")
    return "; ".join(out)


def run_jax(seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import test_nuts_through_ode as golden
    from dynode_tpu import SVIProcess

    kw = {} if seed == "default" else {"inference_prngkey": jax.random.PRNGKey(int(seed))}
    proc = SVIProcess(numpyro_model=golden._model, num_iterations=400, num_samples=200, progress_bar=False, **kw)
    proc.infer(config=golden.make_prior_config(), tf=golden.TF, obs_data=golden.make_observed_incidence())
    return proc.get_samples()


def run_port(seed, jax_init):
    import torch

    torch.set_num_threads(1)
    import test_torch_infer_golden as golden
    from dynode_tpu_torch import SVIProcess
    from dynode_tpu_torch.infer import init_to_value

    data = np.load(ROOT / "tests" / "test_torch" / "golden" / "sir_obs.npz")
    kw = {} if seed == "default" else {"inference_prngkey": int(seed)}
    if jax_init:
        ip, r0 = (1.0 / (1.0 + np.exp(-z)) for z in JAX_INIT)
        kw["guide_init_strategy"] = init_to_value({"strains_0_r0": 1.5 + r0,
                                                  "strains_0_infectious_period": 2.0 + 13.0 * ip})
    proc = SVIProcess(numpyro_model=golden._model, num_iterations=400, num_samples=200, progress_bar=False, **kw)
    proc.infer(config=golden._prior_config(int(data["population"])), tf=int(data["days"]),
               obs_data=torch.as_tensor(data["obs"], dtype=torch.float64))
    return {k: v.numpy() for k, v in proc.get_samples().items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("side", choices=("jax", "port"))
    parser.add_argument("--seeds", nargs="+", default=["default"])
    parser.add_argument("--jax-init", action="store_true", help="the port's guide starts at JAX's init point")
    args = parser.parse_args()
    for seed in args.seeds:
        t = time.perf_counter()
        samples = run_jax(seed) if args.side == "jax" else run_port(seed, args.jax_init)
        print(f"{args.side}{' (JAX init)' if args.jax_init else ''} seed {seed}: {verdict(samples)}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
