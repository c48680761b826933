"""Predictive replay and pointwise log-likelihood.

Port of ``dynode_tpu/infer/predictive.py``: ``Predictive(model,
posterior_samples=...)``, ``Predictive(model, num_samples=...)`` (prior),
``Predictive(guide, params=..., num_samples=...)`` (variational posterior)
and ``Predictive(model, guide=..., params=..., num_samples=...)``.

JAX vmaps the replay over the draws; here the draws are a bank too, one
``torch.func.vmap`` over them (``parallel=False`` replays them one after
another instead, as JAX's ``lax.map``). The draws come from one stream:
``rng_key`` is an int, a ``torch.Generator`` or a draw seam
(:class:`~.hmc.Draws`, or a test's replay). A guide's draws for the whole
bank are taken from the seam first, in the order of one guide call's draws,
and handed to the replays, so a seam that gives each replay its own stream
(JAX's recorded draws) reproduces JAX's guide draws. The model's own draws
(prior sites, unconditioned observations) come from the seam's generator
inside the bank, with ``vmap``'s ``randomness="different"``.
"""

import contextlib
from typing import Any, Callable, Dict, Optional

import torch
import torch.utils._pytree as pytree

from . import handlers
from .util import GivenDraws, RecordingDraws, bank_draws, draw_seam


def _collect_sites(tr, skip_names, exclude_deterministic):
    out = {}
    for name, site in tr.items():
        if name in skip_names:
            continue
        if site["type"] == "sample":
            out[name] = site["value"]
        elif site["type"] == "deterministic" and not exclude_deterministic:
            out[name] = site["value"]
    return out


def _tensor_device(*trees) -> Optional[torch.device]:
    for leaf in pytree.tree_leaves(trees):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


class Predictive:
    """Vectorized forward replay of a model (and/or guide) over draws."""

    def __init__(
        self,
        model: Optional[Callable] = None,
        posterior_samples: Optional[Dict[str, Any]] = None,
        *,
        guide: Optional[Callable] = None,
        params: Optional[Dict[str, Any]] = None,
        num_samples: Optional[int] = None,
        return_sites=None,
        exclude_deterministic: bool = True,
        parallel: bool = True,
        uncondition_observed: bool = False,
    ):
        # positional-model call style: Predictive(guide, params=..., num_samples=...)
        if model is not None and guide is None and params is not None:
            guide, model = model, None
        if guide is not None and posterior_samples is not None:
            raise ValueError(
                "Predictive: pass EITHER posterior_samples (MCMC replay) OR "
                "guide=/params= (variational predictive), not both"
            )
        self.model = model
        self.guide = guide
        self.params = params or {}
        self.posterior_samples = posterior_samples
        self.return_sites = return_sites
        self.exclude_deterministic = exclude_deterministic
        #: one vmapped bank of all draws, or (False) one draw at a time
        self.parallel = parallel
        #: resample observed sites instead of echoing their data back
        self.uncondition_observed = uncondition_observed
        if posterior_samples is not None:
            sizes = {int(torch.as_tensor(v).shape[0]) for v in posterior_samples.values()}
            if len(sizes) != 1:
                raise AssertionError("posterior sample sites disagree on count")
            self.num_samples = sizes.pop()
        else:
            if num_samples is None:
                raise AssertionError("need posterior_samples or num_samples")
            self.num_samples = int(num_samples)

    def _guide_signature(self, seam, args, kwargs):
        """The guide's draws in one call (kind, shape, dtype), from a call
        whose draws come from a scratch generator (the seam's stream is
        untouched) and whose sites stay hidden."""
        from .hmc import Draws

        probe = RecordingDraws(Draws(torch.Generator(device=seam.device)))
        with handlers.block(), handlers.seed(probe), handlers.substitute(self.params):
            self.guide(*args, **kwargs)
        return probe.calls

    def __call__(self, rng_key, *args, **kwargs) -> Dict[str, Any]:
        from .mcmc import _run_device

        device = _tensor_device(self.posterior_samples, self.params) or _run_device(rng_key, args, kwargs)
        seam = draw_seam(rng_key, device)
        generator = getattr(seam, "generator", seam)
        n = self.num_samples
        guide_noise = []
        if self.guide is not None:
            guide_noise = bank_draws(seam, self._guide_signature(seam, args, kwargs), n)

        def replay(noise, posterior_draw, index=None):
            if self.guide is not None:
                with handlers.trace() as gtr, handlers.seed(GivenDraws(noise, seam.device)), \
                        handlers.substitute(self.params):
                    self.guide(*args, **kwargs)
                latents = {name: site["value"] for name, site in gtr.items()
                           if site["type"] == "sample" and not site["is_observed"]}
            else:
                latents = posterior_draw or {}
            if self.model is None:
                return dict(latents)  # guide-only predictive: the guide's sites
            unc = handlers.uncondition() if self.uncondition_observed else contextlib.nullcontext()
            with handlers.trace() as tr, handlers.seed(generator), handlers.substitute(latents), unc:
                self.model(*args, **kwargs)
            out = _collect_sites(tr, skip_names=set(latents), exclude_deterministic=self.exclude_deterministic)
            if self.return_sites is not None:
                out = {k: v for k, v in list(out.items()) + [(m, tr[m]["value"]) for m in tr]
                       if k in self.return_sites}
            return out

        posterior = self.posterior_samples or {}
        if self.parallel:
            # the draw index gives the bank its size when nothing else is mapped (a prior predictive)
            index = torch.arange(n, device=seam.device)
            return torch.func.vmap(replay, randomness="different")(guide_noise, posterior, index)
        rows = [replay([x[i] for x in guide_noise], {k: v[i] for k, v in posterior.items()}) for i in range(n)]
        return {k: torch.stack([torch.as_tensor(r[k]) for r in rows]) for k in rows[0]} if rows else {}


def log_likelihood(
    model: Callable,
    posterior_samples: Dict[str, Any],
    *args,
    **kwargs,
) -> Dict[str, torch.Tensor]:
    """Pointwise log p(obs | draw) for every observed site, one
    ``torch.func.vmap`` over the draws.

    ``posterior_samples`` must cover every stochastic latent: a missing
    site would be drawn from its prior with one seed for every draw,
    conditioning the whole matrix on one arbitrary prior draw. Such sites
    raise. (Sites whose value is recomputed deterministically -- reparam'd
    Deltas -- draw nothing and are fine.)
    """
    device = _tensor_device(posterior_samples)

    def single(draw):
        with handlers.trace() as tr, handlers.seed(0, device=device), handlers.substitute(draw):
            model(*args, **kwargs)
        fresh = [
            name
            for name, site in tr.items()
            if site["type"] == "sample"
            and not site["is_observed"]
            and name not in draw
            and site.get("rng_key") is not None
        ]
        if fresh:
            raise ValueError(
                f"log_likelihood: latent site(s) {fresh} are not in "
                "posterior_samples and were drawn fresh from the prior -- "
                "the pointwise likelihood would be conditioned on one "
                "arbitrary draw. Pass posterior values for every latent "
                "(get_samples() of the fit, unfiltered)."
            )
        return {
            name: handlers.weighted_log_prob(site)
            for name, site in tr.items()
            if site["type"] == "sample" and site["is_observed"]
        }

    return torch.func.vmap(single, randomness="different")(posterior_samples)


__all__ = ["Predictive", "log_likelihood"]
