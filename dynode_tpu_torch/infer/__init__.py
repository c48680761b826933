"""Bayesian inference of the port: handlers, NUTS, ChEES, SVI, Predictive,
the fit processes, diagnostics, model comparison and forecast bands.

Port of ``dynode_tpu/infer`` on PyTorch: :mod:`.handlers` (effect handlers
and primitives), :mod:`.util` (traces, transforms, potentials, init
strategies, draw seams), :mod:`.hmc` (NUTS for a bank of chains),
:mod:`.chees` (ChEES-HMC), :mod:`.mcmc` (the runner, with the CUDA-graph
cache of a batched potential), :mod:`.svi` (ELBO, autoguides, Adam without
optax, multi-start banks), :mod:`.predictive`, :mod:`.inference`
(``MCMCProcess``, ``SVIProcess``), :mod:`.sample`, :mod:`.reparam`,
:mod:`.checkpointing`, :mod:`.state_io`, :mod:`.idata`,
:mod:`.model_comparison`, :mod:`.forecast` and :mod:`.diagnostics`.
"""

from . import chees, diagnostics, handlers, hmc, mcmc, util
from .checkpointing import checkpoint_compartment_sizes
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
from .forecast import member_quantiles, resample_draws
from .idata import InferenceData, from_dynode
from .inference import InferenceProcess, MCMCProcess, SVIProcess
from .mcmc import MCMC, NUTS, GraphCaptureError
from .model_comparison import ELPDData, compare, loo, loo_pit, psislw, waic
from .predictive import Predictive, log_likelihood
from .reparam import LocScaleReparam, TransformReparam
from .sample import resolve_deterministic, sample_distributions, sample_then_resolve
from .state_io import load_mcmc_warm_start, load_pytree, save_mcmc, save_pytree
from .svi import (
    SVI,
    Adam,
    AutoDelta,
    AutoGuide,
    AutoMultivariateNormal,
    AutoNormal,
    ClippedAdam,
    SVIMultiStartResult,
    SVIRunResult,
    SVIState,
    Trace_ELBO,
    chees_warm_start_from_guide,
)
from .util import (
    init_to_mean,
    init_to_median,
    init_to_sample,
    init_to_uniform,
    init_to_value,
    log_density,
)

# primitive aliases so model code reads like the reference's numpyro calls
sample = handlers.sample
deterministic = handlers.deterministic
param = handlers.param
plate = handlers.plate
factor = handlers.factor

__all__ = [
    "chees",
    "hmc",
    "mcmc",
    "util",
    "handlers",
    "diagnostics",
    "sample",
    "deterministic",
    "param",
    "plate",
    "factor",
    "LocScaleReparam",
    "TransformReparam",
    "sample_then_resolve",
    "resolve_deterministic",
    "sample_distributions",
    "InferenceProcess",
    "MCMCProcess",
    "SVIProcess",
    "checkpoint_compartment_sizes",
    "MCMC",
    "NUTS",
    "ChEES",
    "GraphCaptureError",
    "SVI",
    "SVIState",
    "SVIRunResult",
    "SVIMultiStartResult",
    "Trace_ELBO",
    "Adam",
    "ClippedAdam",
    "AutoGuide",
    "AutoNormal",
    "AutoMultivariateNormal",
    "AutoDelta",
    "chees_warm_start_from_guide",
    "Predictive",
    "member_quantiles",
    "resample_draws",
    "log_likelihood",
    "init_to_median",
    "init_to_mean",
    "init_to_sample",
    "init_to_uniform",
    "init_to_value",
    "log_density",
    "InferenceData",
    "from_dynode",
    "loo",
    "loo_pit",
    "waic",
    "compare",
    "psislw",
    "ELPDData",
    "save_pytree",
    "load_pytree",
    "save_mcmc",
    "load_mcmc_warm_start",
    "effective_sample_size",
    "ess_bulk",
    "ess_tail",
    "mcse_mean",
    "split_rhat",
    "hdi",
    "summary",
]
