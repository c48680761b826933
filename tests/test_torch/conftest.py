"""Shared settings of the port's tests.

The tier-1 run uses several pytest-xdist workers on a few cores, so every
worker keeps torch to one intra-op thread. Each test starts from an empty
cross-run cache of ``MCMC`` and no kept solve of the ODE engine.
"""

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_exec_cache():
    """Every test starts and ends with an empty cross-run cache of
    ``MCMC`` (``infer.mcmc._EXEC_CACHE``), as the JAX package's cache
    tests clear theirs: a kept entry pins its model and arguments. The
    same for the engine's kept solves (``ode.integrate._SOLVE_CACHE``)."""
    from dynode_tpu_torch.infer.mcmc import clear_exec_cache
    from dynode_tpu_torch.ode.integrate import clear_solve_cache

    clear_exec_cache()
    clear_solve_cache()
    yield
    clear_exec_cache()
    clear_solve_cache()
