"""Write ``sir_obs.npz``: the synthetic incidence of the golden SIR posterior.

The counts are ``tests/test_infer/test_nuts_through_ode.py``'s
``make_observed_incidence()``: Poisson draws (``jax.random.poisson`` with
``PRNGKey(0)``) of the daily incidence of the age-stratified SIR at R0 2.0
and an infectious period of 7 days, population 100,000, over 50 days, shape
(50, 2). ``tests/golden/quadrature.npz`` holds that data's exact posterior;
``tests/test_torch/test_torch_infer_golden.py`` fits the same counts with
the port. Run from the repository root on the CPU::

    python tests/test_torch/golden/gen_sir_obs.py
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "test_infer"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import test_nuts_through_ode as golden  # noqa: E402


def main() -> None:
    obs = np.asarray(golden.make_observed_incidence())
    path = Path(__file__).with_name("sir_obs.npz")
    np.savez(path, obs=obs, true_r0=golden.TRUE_R0, true_infectious_period=golden.TRUE_INF_PERIOD,
             population=golden.POPULATION, days=golden.TF)
    print(f"wrote {path}: obs {obs.shape}, total {obs.sum():.0f}")


if __name__ == "__main__":
    main()
