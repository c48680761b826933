"""Bijective transforms between constrained and unconstrained space.

Port of ``dynode_tpu/dist/transforms.py``: the same transforms, formulas,
``push_constraint`` and ``biject_to``, on tensors. They serve both
``TransformedDistribution`` and the reparameterisation of inference onto
unconstrained R^n. Parameters that are Python numbers take the dtype of the
tensor they are applied to; numpy parameters become tensors on its device.
"""

import math

import numpy as np
import torch

from .. import _device
from . import constraints as C


def _on(p, like: torch.Tensor):
    """``p`` ready to combine with ``like``: numbers stay numbers (weak
    scalars), numpy arrays become tensors on ``like``'s device."""
    if isinstance(p, (np.ndarray, np.generic)):
        return torch.as_tensor(p, device=like.device)
    return p


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.as_tensor(x)
    return torch.as_tensor(x, dtype=torch.float32)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(0, x)``, the JAX package's form."""
    return torch.logaddexp(torch.zeros_like(x), x)


class Transform:
    """An invertible elementwise map with a tractable log|det J|."""

    #: constraint describing the image of the transform (its codomain)
    codomain: C.Constraint = C.real

    def __call__(self, x):
        raise NotImplementedError

    def inv(self, y):
        """Apply the inverse transform (subclasses implement)."""
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        """log |dy/dx| evaluated elementwise at x (y = self(x) supplied to reuse work)."""
        raise NotImplementedError


class IdentityTransform(Transform):
    """No-op transform (``y = x``)."""

    codomain = C.real

    def __call__(self, x):
        return x

    def inv(self, y):
        """Apply the inverse transform."""
        return y

    def log_abs_det_jacobian(self, x, y):
        """``log|det J|`` of the forward map at ``(x, y)``."""
        x = _tensor(x)
        return torch.zeros_like(x, dtype=x.dtype if x.is_floating_point() else torch.float32)


class AffineTransform(Transform):
    """y = loc + scale * x."""

    def __init__(self, loc, scale, domain: C.Constraint = C.real):
        self.loc = loc
        self.scale = scale
        self.domain = domain
        # map the domain constraint through the affine map so downstream
        # code (e.g. the bijections of inference) sees the true support.
        if isinstance(domain, C._UnitInterval):
            self.codomain = C.Interval(loc, loc + scale)
        elif isinstance(domain, C.Interval):
            self.codomain = C.Interval(loc + scale * domain.low, loc + scale * domain.high)
        elif isinstance(domain, (C._Positive, C._Nonnegative)):
            self.codomain = C.GreaterThan(loc)
        else:
            self.codomain = C.real

    def __call__(self, x):
        x = _tensor(x)
        return _on(self.loc, x) + _on(self.scale, x) * x

    def inv(self, y):
        """Apply the inverse transform."""
        y = _tensor(y)
        return (y - _on(self.loc, y)) / _on(self.scale, y)

    def log_abs_det_jacobian(self, x, y):
        """``log|det J|`` of the forward map at ``(x, y)``."""
        x = _tensor(x)
        dtype = x.dtype if x.is_floating_point() else torch.float32
        scale = _device.scalar(_on(self.scale, x), dtype, x.device)
        return torch.log(torch.abs(scale)).expand(x.shape)


class ExpTransform(Transform):
    """y = exp(x); bijection R -> (0, inf)."""

    codomain = C.positive

    def __call__(self, x):
        return torch.exp(_tensor(x))

    def inv(self, y):
        """Apply the inverse transform."""
        return torch.log(_tensor(y))

    def log_abs_det_jacobian(self, x, y):
        """``log|det J|`` of the forward map at ``(x, y)``."""
        return _tensor(x)


class SigmoidTransform(Transform):
    """y = sigmoid(x); bijection R -> (0, 1)."""

    codomain = C.unit_interval

    def __call__(self, x):
        return 1.0 / (1.0 + torch.exp(-_tensor(x)))

    def inv(self, y):
        """Apply the inverse transform."""
        y = _tensor(y)
        return torch.log(y) - torch.log1p(-y)

    def log_abs_det_jacobian(self, x, y):
        # log sigmoid'(x) = log(y) + log(1-y) = -softplus(-x) - softplus(x)
        """``log|det J|`` of the forward map at ``(x, y)``."""
        x = _tensor(x)
        return -_softplus(-x) - _softplus(x)


def _stick_offsets(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.arange(k - 1, 0, -1, dtype=like.dtype, device=like.device))


class StickBreakingTransform(Transform):
    """Bijection R^{K-1} -> simplex^K (numpyro's stick-breaking convention).

    ``z_i = sigmoid(x_i - log(K-1-i))``; ``p_i = z_i * remaining_i``.
    """

    codomain = C.simplex

    def __call__(self, x):
        x = _tensor(x)
        offsets = _stick_offsets(x.shape[-1] + 1, x)
        z = 1.0 / (1.0 + torch.exp(-(x - offsets)))
        z1m_cumprod = torch.cumprod(1.0 - z, dim=-1)
        head = z * torch.cat([torch.ones_like(z[..., :1]), z1m_cumprod[..., :-1]], dim=-1)
        return torch.cat([head, z1m_cumprod[..., -1:]], dim=-1)

    def inv(self, p):
        """Apply the inverse transform."""
        p = _tensor(p)
        p_head = p[..., :-1]
        remaining = 1.0 - torch.cat(
            [torch.zeros_like(p_head[..., :1]), torch.cumsum(p_head, dim=-1)[..., :-1]], dim=-1
        )
        z = p_head / remaining
        return torch.log(z) - torch.log1p(-z) + _stick_offsets(p.shape[-1], p)

    def log_abs_det_jacobian(self, x, y):
        # sum_i [log remaining_i + log z_i + log(1 - z_i)], reduced over the
        # event axis (the transform is multivariate)
        """``log|det J|`` of the forward map at ``(x, y)``."""
        x = _tensor(x)
        t = x - _stick_offsets(x.shape[-1] + 1, x)
        log_z = -_softplus(-t)
        log_1mz = -_softplus(t)
        z1m_cumprod = torch.cumsum(log_1mz, dim=-1)
        log_remaining = torch.cat([torch.zeros_like(t[..., :1]), z1m_cumprod[..., :-1]], dim=-1)
        return torch.sum(log_z + log_1mz + log_remaining, dim=-1)


class ComposeTransform(Transform):
    """Apply a sequence of transforms left to right."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.codomain = self.parts[-1].codomain if self.parts else C.real

    def __call__(self, x):
        for p in self.parts:
            x = p(x)
        return x

    def inv(self, y):
        """Apply the inverse transform."""
        for p in reversed(self.parts):
            y = p.inv(y)
        return y

    def log_abs_det_jacobian(self, x, y):
        """``log|det J|`` of the forward map at ``(x, y)``."""
        total = 0.0
        for p in self.parts:
            x_next = p(x)
            total = total + p.log_abs_det_jacobian(x, x_next)
            x = x_next
        return total


def push_constraint(constraint: C.Constraint, transform: Transform) -> C.Constraint:
    """Image of ``constraint`` under a monotone ``transform``.

    Used to compute a TransformedDistribution's support from its base
    distribution's support (e.g. Beta + Affine(1.5, 1) -> Interval(1.5, 2.5)).
    """
    if isinstance(transform, IdentityTransform):
        return constraint
    if isinstance(transform, ComposeTransform):
        for part in transform.parts:
            constraint = push_constraint(constraint, part)
        return constraint
    if isinstance(transform, ExpTransform):
        if isinstance(constraint, C.Interval):
            return C.Interval(math.exp(constraint.low), math.exp(constraint.high))
        if isinstance(constraint, C._UnitInterval):
            return C.Interval(1.0, math.e)
        return C.positive
    if isinstance(transform, SigmoidTransform):
        return C.unit_interval
    if isinstance(transform, AffineTransform):
        loc, scale = transform.loc, transform.scale
        try:
            scale_f = float(scale)
            loc_f = float(loc)
        except (TypeError, ValueError, RuntimeError):
            return C.real  # array-valued affine: fall back to unconstrained

        def aff(x):
            return loc_f + scale_f * x

        if isinstance(constraint, C._UnitInterval):
            lo, hi = aff(0.0), aff(1.0)
            return C.Interval(min(lo, hi), max(lo, hi))
        if isinstance(constraint, C.Interval):
            lo, hi = aff(constraint.low), aff(constraint.high)
            return C.Interval(min(lo, hi), max(lo, hi))
        if isinstance(constraint, (C._Positive, C._Nonnegative)):
            return C.GreaterThan(loc_f) if scale_f > 0 else C.LessThan(loc_f)
        if isinstance(constraint, C.GreaterThan):
            b = aff(constraint.low)
            return C.GreaterThan(b) if scale_f > 0 else C.LessThan(b)
        if isinstance(constraint, C.LessThan):
            b = aff(constraint.high)
            return C.LessThan(b) if scale_f > 0 else C.GreaterThan(b)
        return C.real
    return transform.codomain


def biject_to(constraint: C.Constraint) -> Transform:
    """Return a bijection from unconstrained R onto ``constraint``'s region.

    Maps the unconstrained sample space of inference back onto each latent
    site's support, with numpyro's exp/sigmoid choices.
    """
    if isinstance(constraint, (C._Positive, C._Nonnegative)):
        return ExpTransform()
    if isinstance(constraint, C._UnitInterval):
        return SigmoidTransform()
    if isinstance(constraint, C.Interval):
        return ComposeTransform(
            [
                SigmoidTransform(),
                AffineTransform(
                    constraint.low,
                    constraint.high - constraint.low,
                    domain=C.unit_interval,
                ),
            ]
        )
    if isinstance(constraint, C.GreaterThan):
        return ComposeTransform(
            [ExpTransform(), AffineTransform(constraint.low, 1.0, domain=C.positive)]
        )
    if isinstance(constraint, C.LessThan):
        return ComposeTransform(
            [ExpTransform(), AffineTransform(constraint.high, -1.0, domain=C.positive)]
        )
    if isinstance(constraint, C._Simplex):
        return StickBreakingTransform()
    if isinstance(constraint, C._Real):
        return IdentityTransform()
    raise ValueError(f"no bijection registered for constraint {constraint!r}")


__all__ = [
    "Transform",
    "IdentityTransform",
    "AffineTransform",
    "ExpTransform",
    "SigmoidTransform",
    "ComposeTransform",
    "StickBreakingTransform",
    "biject_to",
    "push_constraint",
]
