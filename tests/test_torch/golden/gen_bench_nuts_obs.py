"""Write ``bench_nuts_obs.npz``: ``bench_nuts.py``'s synthetic fit data.

The counts are ``bench_nuts._make_workload()``'s: Poisson draws
(``jax.random.poisson`` with ``PRNGKey(0)``) of the daily incidence of the
multi-strain model at ``true_scales`` over 100 days, shape (100, 2, 3).
``chip_smoke.py`` fits them on the card, where there is no JAX to draw
them. Also prints, for these counts and for counts drawn from the same
rates by the port's ``dist.Poisson`` with a CPU generator seeded 0, the
posterior mode of the R0 scales (L-BFGS on ``bench_nuts``'s lane-major
potential, float64), its distance to ``true_scales`` and the Laplace
standard deviations. Run from the repository root on the CPU::

    python tests/test_torch/golden/gen_bench_nuts_obs.py
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.optimize as so  # noqa: E402
import torch  # noqa: E402

import bench_nuts  # noqa: E402
from dynode_tpu.dist import TruncatedNormal  # noqa: E402
from dynode_tpu.dist.transforms import biject_to  # noqa: E402


def port_draw(true_scales) -> np.ndarray:
    """The same rates' counts from the port's Poisson, CPU generator seed 0."""
    from dynode_tpu_torch import SolverParams, dist, simulate
    from dynode_tpu_torch.models import multistrain as model

    sp = SolverParams(constant_step_size=0.5)
    cfg = model.multistrain_config(solver_params=sp)
    base = model.multistrain_odeparams(cfg, device="cpu")
    c = simulate(model.multistrain_ode, bench_nuts.DURATION, model.multistrain_initial_state(cfg, device="cpu"),
                 base.replace(beta=base.beta * torch.tensor(true_scales)), sp, sub_save_indices=(4,)).ys[4]
    rate = torch.clamp(torch.diff(c, dim=0), min=1e-6)
    return dist.Poisson(rate).sample(torch.Generator().manual_seed(0)).numpy()


def posterior_mode(obs):
    """(mode of the scales, Laplace standard deviations) under bench_nuts's potential."""
    pot = bench_nuts.build_lane_major_potential(obs)
    f = jax.jit(lambda z: pot(z[None])[0])
    vg = jax.jit(jax.value_and_grad(f))
    res = so.minimize(lambda z: tuple(map(np.asarray, vg(jnp.asarray(z)))), np.zeros(3), jac=True,
                      method="L-BFGS-B")
    z = jnp.asarray(res.x)
    t = biject_to(TruncatedNormal(jnp.ones(3), 0.3 * jnp.ones(3), low=0.5, high=2.0).support)
    jac = np.asarray(jax.jacfwd(t)(z))
    cov = jac @ np.linalg.inv(np.asarray(jax.hessian(f)(z))) @ jac.T
    return np.asarray(t(z)), np.sqrt(np.diag(cov))


def main():
    _, obs, true_scales = bench_nuts._make_workload()
    obs = np.asarray(obs, dtype=np.int64)
    true_scales = np.asarray(true_scales)
    out = Path(__file__).with_name("bench_nuts_obs.npz")
    np.savez_compressed(out, obs=obs, true_scales=true_scales)
    print(f"wrote {out}: obs {obs.shape}, total {int(obs.sum())}")
    for name, counts in (("bench_nuts (jax PRNGKey(0))", obs), ("port Poisson (CPU seed 0)", port_draw(true_scales))):
        mode, sd = posterior_mode(counts)
        print(f"{name}: total {int(counts.sum())}; posterior mode {np.round(mode, 5).tolist()}, "
              f"max |mode - true| {np.abs(mode - true_scales).max():.5f}, Laplace sd {np.round(sd, 5).tolist()}")


if __name__ == "__main__":
    main()
