"""Continuous distributions (PyTorch log densities and samplers).

Port of ``dynode_tpu/dist/continuous.py``: the same families, formulas and
edge values (``-inf`` outside a truncation, NaN where JAX gives NaN).
Draws come from the ``torch.Generator`` passed to ``sample`` (normal,
uniform and ``torch._standard_gamma`` draws); the location-scale families,
``TruncatedNormal`` (by inverse CDF), Gamma, Beta and Dirichlet (through
``_standard_gamma``) carry gradients to their parameters.
"""

import math

import numpy as np
import torch

from .. import _device
from . import constraints as C
from .distribution import Distribution, as_float

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _draw_shape(d: Distribution, sample_shape) -> tuple:
    return tuple(sample_shape) + d.batch_shape


def _normal(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _uniform(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def _standard_gamma(generator, concentration: torch.Tensor, shape) -> torch.Tensor:
    """Gamma(concentration, 1) draws, differentiable in ``concentration``."""
    return torch._standard_gamma(concentration.expand(shape).contiguous(), generator=generator)


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """The normal CDF in the form of ``jax.scipy.special.ndtr``."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _log_ndtr(x: torch.Tensor, series_order: int = 3) -> torch.Tensor:
    """``log(ndtr(x))`` by the segments of ``jax.scipy.special.log_ndtr``:
    ``-ndtr(-x)`` above the upper segment, ``log(ndtr(x))`` between, and
    the asymptotic series below the lower one (-20 / 8 in float64, -10 / 5
    otherwise)."""
    lower, upper = (-20.0, 8.0) if x.dtype == torch.float64 else (-10.0, 5.0)
    low = torch.clamp(x, max=lower)
    x_2 = low * low
    log_scale = -0.5 * x_2 - torch.log(-low) - 0.5 * math.log(2.0 * math.pi)
    even_sum = torch.zeros_like(low)
    odd_sum = torch.zeros_like(low)
    x_2n = x_2
    for n in range(1, series_order + 1):
        y = float(np.prod(np.arange(2 * n - 1, 0, -2))) / x_2n
        if n % 2:
            odd_sum = odd_sum + y
        else:
            even_sum = even_sum + y
        x_2n = x_2n * x_2
    series = log_scale + torch.log(1.0 + even_sum - odd_sum)
    return torch.where(x > upper, -_ndtr(-x),
                       torch.where(x > lower, torch.log(_ndtr(torch.clamp(x, min=lower))), series))


def _log_diff_ndtr(a, b):
    """log(Phi(b) - Phi(a)) for a < b, stable when both bounds share a tail.

    In the right tail the symmetric form Phi(b) - Phi(a) = Phi(-a) - Phi(-b)
    keeps the difference between two small quantities held in log form.
    """
    right = a > 0.0
    big = torch.where(right, _log_ndtr(-a), _log_ndtr(b))
    small = torch.where(right, _log_ndtr(-b), _log_ndtr(a))
    # log(exp(big) - exp(small)) = big + log1p(-exp(small - big));
    # small=-inf (one-sided truncation) gives exp(-inf)=0 exactly.
    return big + torch.log1p(-torch.exp(small - big))


class Normal(Distribution):
    """Gaussian with location ``loc`` and scale ``scale``."""

    support = C.real

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale
        self._batch_shape = self._broadcast_batch_shape(loc, scale)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        loc, scale = as_float(self.loc, self.scale, device=generator.device)
        return loc + scale * _normal(generator, _draw_shape(self, sample_shape), loc)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, loc, scale = as_float(value, self.loc, self.scale)
        z = (value - loc) / scale
        return -0.5 * z * z - torch.log(scale) - _LOG_SQRT_2PI

    @property
    def mean(self):
        """Mean of the distribution."""
        (loc,) = as_float(self.loc)
        return loc.expand(self.batch_shape)

    @property
    def variance(self):
        """Variance of the distribution."""
        (scale,) = as_float(self.scale)
        return (scale**2).expand(self.batch_shape)


class LogNormal(Distribution):
    """Distribution of ``exp(X)`` for ``X ~ Normal(loc, scale)``."""

    support = C.positive

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale
        self._batch_shape = self._broadcast_batch_shape(loc, scale)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        loc, scale = as_float(self.loc, self.scale, device=generator.device)
        return torch.exp(loc + scale * _normal(generator, _draw_shape(self, sample_shape), loc))

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, loc, scale = as_float(value, self.loc, self.scale)
        logx = torch.log(value)
        z = (logx - loc) / scale
        return -0.5 * z * z - torch.log(scale) - _LOG_SQRT_2PI - logx

    @property
    def mean(self):
        """Mean ``exp(loc + scale**2 / 2)``."""
        loc, scale = as_float(self.loc, self.scale)
        return torch.exp(loc + 0.5 * scale**2)


class HalfNormal(Distribution):
    """``Normal(0, scale)`` folded onto the nonnegative half-line."""

    support = C.positive

    def __init__(self, scale=1.0):
        self.scale = scale
        self._batch_shape = self._broadcast_batch_shape(scale)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        (scale,) = as_float(self.scale, device=generator.device)
        return torch.abs(_normal(generator, _draw_shape(self, sample_shape), scale)) * scale

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, scale = as_float(value, self.scale)
        z = value / scale
        return math.log(2.0) - 0.5 * z * z - torch.log(scale) - _LOG_SQRT_2PI

    @property
    def mean(self):
        """Mean of the distribution."""
        (scale,) = as_float(self.scale)
        return scale * math.sqrt(2.0 / math.pi)


class Cauchy(Distribution):
    """Cauchy with location ``loc`` and scale ``scale``."""

    support = C.real

    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale
        self._batch_shape = self._broadcast_batch_shape(loc, scale)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        loc, scale = as_float(self.loc, self.scale, device=generator.device)
        u = _uniform(generator, _draw_shape(self, sample_shape), loc)
        return loc + scale * torch.tan(math.pi * (u - 0.5))

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, loc, scale = as_float(value, self.loc, self.scale)
        z = (value - loc) / scale
        return -math.log(math.pi) - torch.log(scale) - torch.log1p(z * z)

    @property
    def mean(self):
        # undefined; return loc as the natural center for init heuristics.
        """Mean of the distribution."""
        (loc,) = as_float(self.loc)
        return loc.expand(self.batch_shape)


class HalfCauchy(Distribution):
    """``Cauchy(0, scale)`` folded onto the nonnegative half-line."""

    support = C.positive

    def __init__(self, scale=1.0):
        self.scale = scale
        self._batch_shape = self._broadcast_batch_shape(scale)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        (scale,) = as_float(self.scale, device=generator.device)
        u = _uniform(generator, _draw_shape(self, sample_shape), scale)
        return torch.abs(torch.tan(math.pi * (u - 0.5))) * scale

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, scale = as_float(value, self.scale)
        z = value / scale
        return math.log(2.0 / math.pi) - torch.log(scale) - torch.log1p(z * z)

    @property
    def mean(self):
        """Mean of the distribution."""
        (scale,) = as_float(self.scale)
        return scale.expand(self.batch_shape)


class StudentT(Distribution):
    """Student's t with ``df`` degrees of freedom, location and scale."""

    support = C.real

    def __init__(self, df, loc=0.0, scale=1.0):
        self.df, self.loc, self.scale = df, loc, scale
        self._batch_shape = self._broadcast_batch_shape(df, loc, scale)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        df, loc, scale = as_float(self.df, self.loc, self.scale, device=generator.device)
        shape = _draw_shape(self, sample_shape)
        z = _normal(generator, shape, loc)
        chi2 = 2.0 * _standard_gamma(generator, 0.5 * df, shape)
        return loc + scale * z * torch.rsqrt(chi2 / df)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, df, loc, scale = as_float(value, self.df, self.loc, self.scale)
        z = (value - loc) / scale
        return (
            torch.lgamma((df + 1.0) / 2.0)
            - torch.lgamma(df / 2.0)
            - 0.5 * torch.log(df * math.pi)
            - torch.log(scale)
            - (df + 1.0) / 2.0 * torch.log1p(z * z / df)
        )

    @property
    def mean(self):
        """Mean of the distribution."""
        (loc,) = as_float(self.loc)
        return loc.expand(self.batch_shape)


class Uniform(Distribution):
    """Uniform on ``[low, high)``."""

    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = low, high
        self._batch_shape = self._broadcast_batch_shape(low, high)
        self.support = C.Interval(low, high)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        low, high = as_float(self.low, self.high, device=generator.device)
        u = _uniform(generator, _draw_shape(self, sample_shape), low)
        return low + (high - low) * u

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, low, high = as_float(value, self.low, self.high)
        lp = -torch.log(high - low)
        inside = (value >= low) & (value <= high)
        return torch.where(inside, lp, -math.inf)

    @property
    def mean(self):
        """Mean of the distribution."""
        low, high = as_float(self.low, self.high)
        return 0.5 * (low + high)


class Exponential(Distribution):
    """Exponential with ``rate`` (mean ``1/rate``)."""

    support = C.positive

    def __init__(self, rate=1.0):
        self.rate = rate
        self._batch_shape = self._broadcast_batch_shape(rate)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        (rate,) = as_float(self.rate, device=generator.device)
        u = _uniform(generator, _draw_shape(self, sample_shape), rate)
        return -torch.log1p(-u) / rate

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, rate = as_float(value, self.rate)
        return torch.log(rate) - rate * value

    @property
    def mean(self):
        """Mean of the distribution."""
        (rate,) = as_float(self.rate)
        return 1.0 / rate


class Gamma(Distribution):
    """Gamma with shape ``concentration`` and ``rate``."""

    support = C.positive

    def __init__(self, concentration, rate=1.0):
        self.concentration, self.rate = concentration, rate
        self._batch_shape = self._broadcast_batch_shape(concentration, rate)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        a, rate = as_float(self.concentration, self.rate, device=generator.device)
        return _standard_gamma(generator, a, _draw_shape(self, sample_shape)) / rate

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        x, a, b = as_float(value, self.concentration, self.rate)
        return a * torch.log(b) + (a - 1.0) * torch.log(x) - b * x - torch.lgamma(a)

    @property
    def mean(self):
        """Mean of the distribution."""
        a, b = as_float(self.concentration, self.rate)
        return a / b


class Beta(Distribution):
    """Beta on ``(0, 1)`` with shapes ``concentration1``, ``concentration0``."""

    support = C.unit_interval

    def __init__(self, concentration1, concentration0):
        self.concentration1 = concentration1
        self.concentration0 = concentration0
        self._batch_shape = self._broadcast_batch_shape(concentration1, concentration0)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        a, b = as_float(self.concentration1, self.concentration0, device=generator.device)
        shape = _draw_shape(self, sample_shape)
        g1 = _standard_gamma(generator, a, shape)
        g0 = _standard_gamma(generator, b, shape)
        return g1 / (g1 + g0)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        x, a, b = as_float(value, self.concentration1, self.concentration0)
        return (
            (a - 1.0) * torch.log(x)
            + (b - 1.0) * torch.log1p(-x)
            - (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b))
        )

    @property
    def mean(self):
        """Mean of the distribution."""
        a, b = as_float(self.concentration1, self.concentration0)
        return a / (a + b)


class TruncatedNormal(Distribution):
    """Normal(loc, scale) truncated to [low, high] (either side optional).

    Draws by inverse CDF on the standardised bounds, in float64 and with
    the bounds moved to the left tail when both lie right of zero, so
    that neither tail cancels; the draw is clamped to the bounds and cast
    back to the parameters' dtype, and carries gradients to them.
    """

    def __init__(self, loc=0.0, scale=1.0, low=None, high=None):
        self.loc, self.scale = loc, scale
        self.low, self.high = low, high
        self._batch_shape = self._broadcast_batch_shape(loc, scale)
        if low is not None and high is not None:
            self.support = C.Interval(low, high)
        elif low is not None:
            self.support = C.GreaterThan(low)
        elif high is not None:
            self.support = C.LessThan(high)
        else:
            self.support = C.real

    def _std_bounds(self, loc, scale):
        a = -math.inf if self.low is None else (as_float(self.low, loc)[0] - loc) / scale
        b = math.inf if self.high is None else (as_float(self.high, loc)[0] - loc) / scale
        return _device.scalar(a, loc.dtype, loc.device), _device.scalar(b, loc.dtype, loc.device)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        bounds = [x for x in (self.low, self.high) if x is not None]
        loc, scale, *_ = as_float(self.loc, self.scale, *bounds, device=generator.device)
        shape = _draw_shape(self, sample_shape)
        a, b = (x.double().expand(shape) for x in self._std_bounds(loc, scale))
        flip = a > 0.0  # both bounds in the right tail: draw -z on (-b, -a)
        lo = torch.where(flip, -b, a)
        hi = torch.where(flip, -a, b)
        u = torch.rand(shape, generator=generator, dtype=torch.float64, device=loc.device)
        p_lo, p_hi = _ndtr(lo), _ndtr(hi)
        z = torch.special.ndtri(p_lo + u * (p_hi - p_lo))
        z = torch.minimum(torch.maximum(z, lo), hi)
        z = torch.where(flip, -z, z).to(loc.dtype)
        return loc + scale * z

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, loc, scale = as_float(value, self.loc, self.scale)
        a, b = self._std_bounds(loc, scale)
        z = (value - loc) / scale
        base = -0.5 * z * z - torch.log(scale) - _LOG_SQRT_2PI
        log_z = _log_diff_ndtr(a, b)
        inside = (z >= a) & (z <= b)
        return torch.where(inside, base - log_z, -math.inf)

    @property
    def mean(self):
        """Mean of the distribution."""
        loc, scale = as_float(self.loc, self.scale)
        a, b = self._std_bounds(loc, scale)
        phi_a = torch.where(torch.isfinite(a), torch.exp(-0.5 * a * a), 0.0) / math.sqrt(2 * math.pi)
        phi_b = torch.where(torch.isfinite(b), torch.exp(-0.5 * b * b), 0.0) / math.sqrt(2 * math.pi)
        zden = _ndtr(b) - _ndtr(a)
        return loc + scale * (phi_a - phi_b) / zden


class Dirichlet(Distribution):
    """Dirichlet over the probability simplex (event shape (K,))."""

    support = C.simplex

    def __init__(self, concentration):
        (self.concentration,) = as_float(concentration)
        self._event_shape = tuple(self.concentration.shape[-1:])
        self._batch_shape = tuple(self.concentration.shape[:-1])

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        (a,) = as_float(self.concentration, device=generator.device)
        g = _standard_gamma(generator, a, tuple(sample_shape) + self.batch_shape + self.event_shape)
        return g / torch.sum(g, dim=-1, keepdim=True)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        x, a = as_float(value, self.concentration)
        return (
            torch.sum((a - 1.0) * torch.log(x), dim=-1)
            + torch.lgamma(torch.sum(a, dim=-1))
            - torch.sum(torch.lgamma(a), dim=-1)
        )

    @property
    def mean(self):
        """Mean of the distribution."""
        return self.concentration / torch.sum(self.concentration, dim=-1, keepdim=True)


class MultivariateNormal(Distribution):
    """MVN parameterized by loc and lower-cholesky ``scale_tril``."""

    support = C.real

    def __init__(self, loc, scale_tril):
        self.loc, self.scale_tril = as_float(loc, scale_tril)
        self._event_shape = (self.loc.shape[-1],)
        self._batch_shape = tuple(torch.broadcast_shapes(self.loc.shape[:-1], self.scale_tril.shape[:-2]))

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        loc, scale_tril = as_float(self.loc, self.scale_tril, device=generator.device)
        eps = _normal(generator, tuple(sample_shape) + self.batch_shape + self.event_shape, loc)
        return loc + torch.einsum("...ij,...j->...i", scale_tril, eps)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, loc, scale_tril = as_float(value, self.loc, self.scale_tril)
        diff = value - loc
        # solve L z = diff
        tril = scale_tril.expand(diff.shape[:-1] + scale_tril.shape[-2:])
        z = torch.linalg.solve_triangular(tril, diff[..., None], upper=False)[..., 0]
        d = loc.shape[-1]
        half_logdet = torch.sum(
            torch.log(torch.abs(torch.diagonal(scale_tril, dim1=-2, dim2=-1))), dim=-1
        )
        return -0.5 * torch.sum(z * z, dim=-1) - half_logdet - d * _LOG_SQRT_2PI

    @property
    def mean(self):
        """Mean of the distribution."""
        return self.loc


__all__ = [
    "Normal",
    "LogNormal",
    "HalfNormal",
    "Cauchy",
    "HalfCauchy",
    "StudentT",
    "Uniform",
    "Exponential",
    "Gamma",
    "Beta",
    "TruncatedNormal",
    "MultivariateNormal",
    "Dirichlet",
]
