"""Bayesian inference of the port: handlers, NUTS, ChEES, MCMC, diagnostics.

Port of the main-path modules of ``dynode_tpu/infer`` on PyTorch:
:mod:`.handlers` (effect handlers and primitives), :mod:`.util` (traces,
transforms, potentials, init strategies), :mod:`.hmc` (NUTS for a bank of
chains), :mod:`.chees` (ChEES-HMC), :mod:`.mcmc` (the runner, with the
CUDA-graph cache of a batched potential) and :mod:`.diagnostics`.
"""

from . import chees, diagnostics, handlers, hmc, mcmc, util
from .chees import ChEES
from .diagnostics import (
    effective_sample_size,
    ess_bulk,
    ess_tail,
    hdi,
    mcse_mean,
    split_rhat,
    summary,
)
from .mcmc import MCMC, NUTS, GraphCaptureError
from .util import (
    init_to_mean,
    init_to_median,
    init_to_sample,
    init_to_uniform,
    init_to_value,
)

__all__ = [
    "chees",
    "diagnostics",
    "handlers",
    "hmc",
    "mcmc",
    "util",
    "ChEES",
    "MCMC",
    "NUTS",
    "GraphCaptureError",
    "effective_sample_size",
    "ess_bulk",
    "ess_tail",
    "hdi",
    "mcse_mean",
    "split_rhat",
    "summary",
    "init_to_mean",
    "init_to_median",
    "init_to_sample",
    "init_to_uniform",
    "init_to_value",
]
