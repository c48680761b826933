"""InferenceProcess / MCMCProcess / SVIProcess: the user-facing fit drivers.

Port of ``dynode_tpu/infer/inference.py``: the same fields, defaults and
checks (pydantic's ``PositiveInt``, ``Callable``, ``Type[AutoGuide]``,
``dict``), written as the port's config :class:`~dynode_tpu_torch.config._model.Model`
without pydantic; a refused value raises ``ValueError`` (pydantic's
``ValidationError`` is one). ``to_arviz()`` returns the port's
:class:`~dynode_tpu_torch.infer.idata.InferenceData`.

``inference_prngkey`` is an int seed (default 8675314) or a
``torch.Generator``. JAX's persistent
compilation cache (``_enable_cache_on_tpu``) has no counterpart: on the
card ``MCMC`` captures a CUDA graph of the potential per run, and SVI runs
eagerly.
"""

from typing import Dict

import numpy as np
import torch

from .. import _validate as V
from ..config._model import Field, Model
from . import handlers
from .idata import InferenceData, from_dynode
from .mcmc import MCMC, NUTS
from .predictive import Predictive, log_likelihood
from .svi import (
    SVI,
    Adam,
    AutoGuide,
    AutoMultivariateNormal,
    SVIMultiStartResult,
    SVIRunResult,
    Trace_ELBO,
)
from .util import init_to_median


def _seed(value):
    """An int seed or a ``torch.Generator``, as it is."""
    if isinstance(value, torch.Generator) or (isinstance(value, int) and not isinstance(value, bool)):
        return value, V.EXACT
    raise ValueError(f"Input should be an int seed or a torch.Generator, got {value!r}")


def call_seed(key, calls: int):
    """The randomness of an ``MCMCProcess``'s ``infer()`` call number
    ``calls`` (0 for the first) given its ``inference_prngkey``.

    An int key seeds the first call as it is (``MCMC.run(key)``), and call
    k > 0 with ``SeedSequence([key, k])``'s first 64-bit word, so chained
    segments draw fresh transitions (JAX folds the call counter into its
    key). A generator is used as it is: its stream moves on from call to
    call by itself.
    """
    if not isinstance(key, int) or calls == 0:
        return key
    return int(np.random.SeedSequence([key, calls]).generate_state(1, np.uint64)[0])


class InferenceProcess(Model):
    """Abstract driver fitting a model callable to data."""

    numpyro_model = Field(V.callable_)
    inference_prngkey = Field(_seed, 8675314)

    def __init__(self, **data):
        super().__init__(**data)
        self._inference_complete = False
        self._inferer = None
        # final sampler/optimizer state, retained for chained inference
        self._inference_state = None
        # model kwargs from infer(), replayed for Predictive
        self._inferer_kwargs: dict = {}
        self._infer_calls = 0

    def infer(self, **kwargs):
        """Run inference (abstract; subclasses implement)."""
        raise NotImplementedError("Inference process not implemented, please use a subclass.")

    def get_samples(self, group_by_chain=False, exclude_deterministic=True):
        """Posterior samples (abstract; subclasses implement)."""
        raise NotImplementedError("get_samples() process not implemented, please use a subclass.")

    def to_arviz(self) -> InferenceData:
        """Convert results to :class:`InferenceData` (abstract)."""
        raise NotImplementedError("to_arviz not implemented for abstract InferenceProcess, use subclass")

    def _require_complete(self):
        if not self._inference_complete:
            raise AssertionError("Inference process not completed, please call infer() first.")


class MCMCProcess(InferenceProcess):
    """NUTS- or ChEES-based fitting over a bank of chains."""

    num_samples = Field(V.PositiveInt)
    num_warmup = Field(V.PositiveInt)
    num_chains = Field(V.PositiveInt)
    nuts_max_tree_depth = Field(V.PositiveInt)
    nuts_init_strategy = Field(V.callable_, init_to_median)
    #: extra kwargs to MCMC (e.g. steps_per_call=)
    mcmc_kwargs = Field(V.dict_, default_factory=dict)
    #: extra kwargs to the kernel (e.g. dense_mass=False, batched_potential_fn=)
    nuts_kwargs = Field(V.dict_, default_factory=dict)
    #: 'nuts' (numpyro-NUTS semantics) or 'chees' (wide-bank ChEES-HMC);
    #: nuts_kwargs are forwarded to either kernel
    sampler = Field(V.str_, "nuts")
    progress_bar = Field(V.bool_, True)

    def infer(self, warm_start=None, **kwargs) -> MCMC:
        """Fit with the configured kernel; extra kwargs go to the model.

        ``warm_start``: a value from :meth:`warm_start_state` of a previous
        process (or ``MCMC.warm_start_state()``, :func:`~.state_io.load_mcmc_warm_start`,
        :func:`~.svi.chees_warm_start_from_guide`): warmup is skipped and
        ``num_warmup`` is ignored for this run.

        Repeated ``infer()`` calls on one process draw fresh randomness
        (:func:`call_seed`): the first call uses ``inference_prngkey`` as
        it is, so chained segments never replay an earlier segment's
        momentum, accept or jitter draws. Chaining across separate process
        objects, give each its own ``inference_prngkey``.
        """
        if self.sampler == "chees":
            from .chees import ChEES

            kernel = ChEES(self.numpyro_model, init_strategy=self.nuts_init_strategy, **self.nuts_kwargs)
        elif self.sampler == "nuts":
            nuts_kwargs = dict(dense_mass=True)
            nuts_kwargs.update(self.nuts_kwargs)
            kernel = NUTS(
                self.numpyro_model,
                max_tree_depth=self.nuts_max_tree_depth,
                init_strategy=self.nuts_init_strategy,
                **nuts_kwargs,
            )
        else:
            raise ValueError(f"unknown sampler {self.sampler!r}; use 'nuts' or 'chees'")
        inferer = MCMC(
            kernel,
            num_warmup=self.num_warmup,
            num_samples=self.num_samples,
            num_chains=self.num_chains,
            progress_bar=self.progress_bar,
            **self.mcmc_kwargs,
        )
        key = call_seed(self.inference_prngkey, self._infer_calls)
        self._infer_calls += 1
        inferer.run(key, warm_start=warm_start, **kwargs)
        self._inference_complete = True
        self._inferer = inferer
        self._inference_state = inferer.last_state
        self._inferer_kwargs = kwargs
        return inferer

    def warm_start_state(self):
        """Resumable sampler state for a later ``infer(warm_start=...)``
        (see ``MCMC.warm_start_state`` and :mod:`.state_io` for the on-disk
        version)."""
        self._require_complete()
        return self._inferer.warm_start_state()

    def get_samples(self, group_by_chain=False, exclude_deterministic=True) -> Dict[str, torch.Tensor]:
        """Posterior samples: (chains*samples, ...) or (chains, samples, ...)."""
        self._require_complete()
        samples = self._inferer.get_samples(group_by_chain=group_by_chain)
        if not exclude_deterministic:
            det = self._inferer.deterministic_samples()
            if group_by_chain:
                det = {k: v.reshape((self.num_chains, self.num_samples) + tuple(v.shape[1:])) for k, v in det.items()}
            samples = {**samples, **det}
        return samples

    def to_arviz(self) -> InferenceData:
        """Posterior, sample stats, prior and posterior predictive, the
        pointwise log-likelihood and the observed data, as InferenceData
        (the groups of the reference's ``az.from_numpyro`` export).

        The predictive groups resample the observed sites
        (``uncondition_observed``), so they hold genuine replicates usable
        for predictive checks and ``loo_pit``."""
        self._require_complete()
        kwargs = self._inferer_kwargs
        key = self.inference_prngkey
        samples = self.get_samples()
        posterior_predictive = Predictive(self.numpyro_model, posterior_samples=samples,
                                          uncondition_observed=True)(rng_key=key, **kwargs)
        prior = Predictive(self.numpyro_model, num_samples=self.num_samples,
                           uncondition_observed=True)(rng_key=key, **kwargs)
        ll = log_likelihood(self.numpyro_model, samples, **kwargs)
        with handlers.trace() as tr, handlers.seed(key, device=_sample_device(samples)):
            self.numpyro_model(**kwargs)
        observed = {name: site["value"] for name, site in tr.items()
                    if site["type"] == "sample" and site["is_observed"]}
        return from_dynode(
            posterior=self.get_samples(group_by_chain=True),
            posterior_predictive=posterior_predictive,
            prior=prior,
            sample_stats=self._inferer.get_extra_fields(group_by_chain=True),
            log_likelihood=ll,
            observed_data=observed,
        )


def _sample_device(samples):
    for v in samples.values():
        return v.device
    return None


class SVIProcess(InferenceProcess):
    """Variational fitting with an autoguide (full-rank Gaussian by default)."""

    #: number of ELBO optimization steps
    num_iterations = Field(V.PositiveInt)
    #: posterior draws generated by get_samples() after a fit
    num_samples = Field(V.PositiveInt)
    guide_class = Field(V.subclass_of(AutoGuide), AutoMultivariateNormal)
    guide_init_strategy = Field(V.callable_, init_to_median)
    #: SVI optimizer: Adam, ClippedAdam or any object with init and update
    optimizer = Field(V.any_, default_factory=lambda: Adam(step_size=0.1))
    progress_bar = Field(V.bool_, True)
    guide_kwargs = Field(V.dict_, default_factory=dict)
    #: independent jittered-init SVI runs, as one bank; get_samples() draws
    #: from the best-ELBO start
    num_starts = Field(V.PositiveInt, 1)
    #: a Mesh whose axis 'start' splits the starts (SVI.run_multistart(mesh=))
    svi_mesh = Field(V.any_, None)
    #: stddev of the per-start Gaussian jitter of the unconstrained guide locs
    init_jitter = Field(V.float_, 1.0)

    def infer(self, **kwargs) -> SVI:
        """Fit with SVI; extra kwargs go to the model callable. Every call
        uses ``inference_prngkey`` as it is, as the JAX package does."""
        guide = self.guide_class(self.numpyro_model, init_loc_fn=self.guide_init_strategy, **self.guide_kwargs)
        inferer = SVI(model=self.numpyro_model, guide=guide, optim=self.optimizer, loss=Trace_ELBO())
        if self.num_starts > 1:
            self._inference_state = inferer.run_multistart(
                self.inference_prngkey,
                num_steps=self.num_iterations,
                num_starts=int(self.num_starts),
                init_jitter=self.init_jitter,
                mesh=self.svi_mesh,
                progress_bar=self.progress_bar,
                **kwargs,
            )
        else:
            svi_state = inferer.init(self.inference_prngkey, **kwargs)
            self._inference_state = inferer.run(
                self.inference_prngkey,
                num_steps=self.num_iterations,
                init_state=svi_state,
                progress_bar=self.progress_bar,
                **kwargs,
            )
        self._inference_complete = True
        self._inferer = inferer
        self._inferer_kwargs = kwargs
        return inferer

    def get_samples(self, _: bool = False, exclude_deterministic: bool = True) -> Dict[str, torch.Tensor]:
        """Draw ``num_samples`` from the fitted variational posterior."""
        self._require_complete()
        if not isinstance(self._inference_state, (SVIRunResult, SVIMultiStartResult)):
            raise AssertionError("the process holds no SVI result")
        params = self._inference_state.params
        samples = Predictive(self._inferer.guide, params=params, num_samples=self.num_samples)(
            self.inference_prngkey, **self._inferer_kwargs)
        if not exclude_deterministic:
            det = Predictive(model=self._inferer.model, guide=self._inferer.guide, params=params,
                             num_samples=self.num_samples, exclude_deterministic=False)(
                self.inference_prngkey, **self._inferer_kwargs)
            samples = {**samples, **det}
        return {name: value for name, value in samples.items() if not name.startswith("_auto")}

    def to_arviz(self) -> InferenceData:
        """Posterior, prior and posterior predictive, and the pointwise
        log-likelihood (the predictive groups resample the observed sites,
        as :meth:`MCMCProcess.to_arviz`)."""
        self._require_complete()
        kwargs = self._inferer_kwargs
        key = self.inference_prngkey
        samples = self.get_samples()
        posterior_predictive = Predictive(self.numpyro_model, posterior_samples=samples,
                                          uncondition_observed=True)(rng_key=key, **kwargs)
        prior = Predictive(self.numpyro_model, num_samples=self.num_iterations,
                           uncondition_observed=True)(rng_key=key, **kwargs)
        ll = log_likelihood(self.numpyro_model, samples, **kwargs)
        return from_dynode(
            posterior={k: v[None] for k, v in samples.items()},
            posterior_predictive=posterior_predictive,
            prior=prior,
            log_likelihood=ll,
        )


__all__ = ["InferenceProcess", "MCMCProcess", "SVIProcess", "call_seed"]
