"""Reparameterization strategies for ``handlers.reparam`` (numpyro parity).

Port of ``dynode_tpu/infer/reparam.py``. Non-centered parameterizations are
the standard fix for hierarchical funnels: when group-level scales are
small, the centered geometry ``x ~ Normal(mu, tau)`` forces tiny sampler
steps, while the equivalent ``x = mu + tau * z, z ~ Normal(0, 1)`` is
isotropic.

A strategy is a callable ``(name, fn) -> (new_fn, value)`` that may draw
auxiliary sample sites via :func:`handlers.sample`; the rewritten site
becomes a zero-density :class:`~dynode_tpu_torch.dist.distribution.Delta`
at the deterministically recomputed value, so the joint density is carried
entirely by the auxiliary site.
"""

import torch

from ..dist import Normal, TransformedDistribution
from ..dist.distribution import Delta
from . import handlers


class LocScaleReparam:
    """Decenter a ``Normal(loc, scale)`` site.

    ``centered=0`` (default, fully non-centered): draws
    ``{name}_decentered ~ Normal(0, 1)`` and emits
    ``value = loc + scale * z``. General ``centered=c`` interpolates:
    ``z ~ Normal(c*loc, scale**c)``, ``value = loc + scale**(1-c) *
    (z - c*loc)`` (c=1 is the original centered form). Only exact
    loc-scale families are supported -- for truncated or transformed
    priors use :class:`TransformReparam` or reparameterize by hand.
    """

    def __init__(self, centered: float = 0.0):
        if not 0.0 <= float(centered) <= 1.0:
            raise ValueError(f"centered must be in [0, 1], got {centered}")
        self.centered = float(centered)

    def __call__(self, name, fn):
        if not isinstance(fn, Normal):
            raise TypeError(
                f"LocScaleReparam supports Normal sites; site {name!r} has "
                f"{type(fn).__name__}. Truncation/transforms break the "
                "loc-scale algebra -- use TransformReparam or "
                "reparameterize manually."
            )
        c = self.centered
        loc, s = fn.loc, fn.scale
        if c == 0.0:
            # a Python number stays one, and takes the dtype of the tensors it meets
            base = Normal(torch.zeros_like(loc) if torch.is_tensor(loc) else 0.0,
                          torch.ones_like(s) if torch.is_tensor(s) else 1.0)
        else:
            base = Normal(c * loc, s**c)
        z = handlers.sample(f"{name}_decentered", base)
        value = loc + s ** (1.0 - c) * (z - c * loc)
        return Delta(value), value


class TransformReparam:
    """Split a :class:`TransformedDistribution` site into base + transform.

    Draws ``{name}_base ~ fn.base_dist`` and emits the transformed value
    deterministically -- e.g. the flagship prior
    ``TransformedDistribution(Beta(.5,.5), AffineTransform(1.5, 1))``
    becomes a Beta latent plus an affine push-forward, so the sampler
    works in the base geometry.
    """

    def __call__(self, name, fn):
        if not isinstance(fn, TransformedDistribution):
            raise TypeError(
                f"TransformReparam needs a TransformedDistribution; site "
                f"{name!r} has {type(fn).__name__}"
            )
        z = handlers.sample(f"{name}_base", fn.base_dist)
        value = z
        for t in fn.transforms:
            value = t(value)
        return Delta(value, event_dim=len(fn.event_shape)), value


__all__ = ["LocScaleReparam", "TransformReparam"]
