"""Discrete distributions (observation-noise models).

Port of ``dynode_tpu/dist/discrete.py``: the same families and formulas
(``Poisson.log_prob`` is ``k log(rate) - rate - lgamma(k + 1)``, no
``xlogy``, so ``k = 0, rate = 0`` is NaN as in JAX). Draws come from the
``torch.Generator`` passed to ``sample`` through ``torch.poisson``,
``torch.binomial``, ``torch.bernoulli`` and ``torch.multinomial``; counts
are returned as int64 tensors.
"""

import math

import torch

from . import constraints as C
from .continuous import _draw_shape, _standard_gamma
from .distribution import Distribution, _shape, as_float
from .transforms import _softplus


class Poisson(Distribution):
    """Poisson counts with mean ``rate``."""

    support = C.integer_nonnegative

    def __init__(self, rate):
        self.rate = rate
        self._batch_shape = self._broadcast_batch_shape(rate)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        (rate,) = as_float(self.rate, device=generator.device)
        rate = rate.expand(_draw_shape(self, sample_shape)).contiguous()
        return torch.poisson(rate, generator=generator).to(torch.int64)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        k, lam = as_float(value, self.rate)
        return k * torch.log(lam) - lam - torch.lgamma(k + 1.0)

    @property
    def mean(self):
        """Mean of the distribution."""
        return as_float(self.rate)[0]

    @property
    def variance(self):
        """Variance of the distribution."""
        return as_float(self.rate)[0]


class Bernoulli(Distribution):
    """Bernoulli trials parameterized by ``probs`` or ``logits``."""

    support = C.IntegerInterval(0, 1)

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs or logits")
        self._probs = probs
        self._logits = logits
        self._batch_shape = self._broadcast_batch_shape(probs if probs is not None else logits)

    @property
    def probs(self):
        """Probability parameterization (derived from logits if needed)."""
        if self._probs is not None:
            return as_float(self._probs)[0]
        return torch.sigmoid(as_float(self._logits)[0])

    @property
    def logits(self):
        """Logit parameterization (derived from probs if needed)."""
        if self._logits is not None:
            return as_float(self._logits)[0]
        p = as_float(self._probs)[0]
        return torch.log(p) - torch.log1p(-p)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        if self._probs is not None:
            (p,) = as_float(self._probs, device=generator.device)
        else:
            p = torch.sigmoid(as_float(self._logits, device=generator.device)[0])
        p = p.expand(_draw_shape(self, sample_shape)).contiguous()
        return torch.bernoulli(p, generator=generator).to(torch.int64)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        logits = self.logits
        v, logits = as_float(value, logits)
        # -softplus(-logits) = log sigmoid(logits)
        return v * (-_softplus(-logits)) + (1.0 - v) * (-_softplus(logits))

    @property
    def mean(self):
        """Mean of the distribution."""
        return self.probs


class Binomial(Distribution):
    """Successes in ``total_count`` Bernoulli trials."""

    def __init__(self, total_count, probs):
        self.total_count, self.probs = total_count, probs
        self._batch_shape = self._broadcast_batch_shape(total_count, probs)
        self.support = C.IntegerInterval(0, None)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        n, p = as_float(self.total_count, self.probs, device=generator.device)
        shape = _draw_shape(self, sample_shape)
        draws = torch.binomial(n.expand(shape).contiguous(), p.expand(shape).contiguous(), generator=generator)
        return draws.to(torch.int64)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        k, n, p = as_float(value, self.total_count, self.probs)
        log_comb = torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)
        return log_comb + k * torch.log(p) + (n - k) * torch.log1p(-p)

    @property
    def mean(self):
        """Mean of the distribution."""
        n, p = as_float(self.total_count, self.probs)
        return n * p


class NegativeBinomial(Distribution):
    """Gamma-Poisson mixture with mean ``mean`` and concentration ``concentration``.

    variance = mean + mean^2 / concentration.
    """

    support = C.integer_nonnegative

    def __init__(self, mean, concentration):
        self._mean_param = mean
        self.concentration = concentration
        self._batch_shape = self._broadcast_batch_shape(mean, concentration)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        r, mu = as_float(self.concentration, self._mean_param, device=generator.device)
        shape = _draw_shape(self, sample_shape)
        g = _standard_gamma(generator, r, shape) * (mu / r)
        return torch.poisson(g.expand(shape).contiguous(), generator=generator).to(torch.int64)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        k, r, mu = as_float(value, self.concentration, self._mean_param)
        log_p = torch.log(mu) - torch.log(mu + r)  # success prob of each count
        log_1mp = torch.log(r) - torch.log(mu + r)
        return torch.lgamma(k + r) - torch.lgamma(r) - torch.lgamma(k + 1.0) + r * log_1mp + k * log_p

    @property
    def mean(self):
        """Mean of the distribution."""
        return as_float(self._mean_param)[0]

    @property
    def variance(self):
        """Variance of the distribution."""
        mu, r = as_float(self._mean_param, self.concentration)
        return mu + mu * mu / r


class Categorical(Distribution):
    """Categorical over {0..K-1} from probs or logits."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("pass exactly one of probs or logits")
        if logits is None:
            logits = torch.log(as_float(probs)[0])
        (self._logits,) = as_float(logits)
        self._batch_shape = tuple(self._logits.shape[:-1])
        self.support = C.IntegerInterval(0, self._logits.shape[-1] - 1)

    @property
    def logits(self):
        """Logit parameterization (derived from probs if needed)."""
        return self._logits - torch.logsumexp(self._logits, dim=-1, keepdim=True)

    @property
    def probs(self):
        """Probability parameterization (derived from logits if needed)."""
        return torch.softmax(self._logits, dim=-1)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        (logits,) = as_float(self._logits, device=generator.device)
        k = logits.shape[-1]
        n = math.prod(sample_shape)
        probs = torch.softmax(logits, dim=-1).reshape(-1, k)
        draws = torch.multinomial(probs, n, replacement=True, generator=generator)  # (batch, n)
        return draws.T.reshape(tuple(sample_shape) + self.batch_shape)

    def log_prob(self, value):
        """Elementwise log-density of ``value`` (an index outside -K..K-1 is
        NaN and a negative one counts from the end, as JAX's gather does)."""
        norm = self.logits
        value = torch.as_tensor(value, device=norm.device)
        value = value.to(torch.int32).to(torch.int64)  # JAX casts to int32 (truncation)
        k = norm.shape[-1]
        idx = torch.where(value < 0, value + k, value)
        outside = (idx < 0) | (idx >= k)
        shape = torch.broadcast_shapes(norm.shape[:-1], idx.shape)
        gathered = torch.gather(norm.expand(shape + (k,)), -1, idx.clamp(0, k - 1).expand(shape)[..., None])[..., 0]
        return torch.where(outside, math.nan, gathered)

    @property
    def mean(self):
        """Mean of the distribution."""
        k = self._logits.shape[-1]
        return torch.sum(self.probs * torch.arange(k, dtype=self._logits.dtype, device=self._logits.device), dim=-1)


class Multinomial(Distribution):
    """Multinomial counts over K categories (event shape (K,))."""

    def __init__(self, total_count, probs):
        self.total_count = total_count
        self.probs = probs
        self._event_shape = _shape(probs)[-1:]
        self._batch_shape = tuple(torch.broadcast_shapes(_shape(total_count), _shape(probs)[:-1]))
        self.support = C.IntegerInterval(0, None)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        shape = tuple(sample_shape) + self.batch_shape
        if len(_shape(self.total_count)) != 0:
            raise NotImplementedError("Multinomial.sample requires a scalar total_count")
        n = int(self.total_count)
        # sequential binomial decomposition (K is small in this domain)
        (p,) = as_float(self.probs, device=generator.device)
        p = p.expand(shape + self.event_shape)
        remaining = torch.full(shape, float(n), dtype=p.dtype, device=p.device)
        rem_p = torch.ones(shape, dtype=p.dtype, device=p.device)
        counts = []
        for i in range(p.shape[-1] - 1):
            frac = torch.clamp(p[..., i] / torch.clamp(rem_p, min=1e-12), 0.0, 1.0)
            c = torch.binomial(remaining, frac.contiguous(), generator=generator)
            counts.append(c)
            remaining = remaining - c
            rem_p = rem_p - p[..., i]
        counts.append(remaining)
        return torch.stack(counts, dim=-1).to(torch.int64)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        k, n, p = as_float(value, self.total_count, self.probs)
        return (
            torch.lgamma(n + 1.0)
            - torch.sum(torch.lgamma(k + 1.0), dim=-1)
            + torch.sum(k * torch.log(p), dim=-1)
        )

    @property
    def mean(self):
        """Mean of the distribution."""
        n, p = as_float(self.total_count, self.probs)
        return n[..., None] * p


class BetaBinomial(Distribution):
    """``total_count`` trials with ``p ~ Beta(c1, c0)``: overdispersed
    binomial counts (test-positivity panels, severity fractions).

    mean = n*c1/(c1+c0); variance exceeds the binomial's by the factor
    (c1+c0+n)/(c1+c0+1).
    """

    def __init__(self, concentration1, concentration0, total_count):
        self.concentration1 = concentration1
        self.concentration0 = concentration0
        self.total_count = total_count
        self._batch_shape = self._broadcast_batch_shape(concentration1, concentration0, total_count)
        self.support = C.IntegerInterval(0, None)

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        a, b, n = as_float(self.concentration1, self.concentration0, self.total_count, device=generator.device)
        shape = _draw_shape(self, sample_shape)
        g1 = _standard_gamma(generator, a, shape)
        g0 = _standard_gamma(generator, b, shape)
        p = g1 / (g1 + g0)
        return torch.binomial(n.expand(shape).contiguous(), p, generator=generator).to(torch.int64)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        k, a, b, n = as_float(value, self.concentration1, self.concentration0, self.total_count)

        def betaln(x, y):
            return torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)

        log_comb = torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)
        return log_comb + betaln(k + a, n - k + b) - betaln(a, b)

    @property
    def mean(self):
        """Mean of the distribution."""
        a, b, n = as_float(self.concentration1, self.concentration0, self.total_count)
        return n * a / (a + b)

    @property
    def variance(self):
        """Variance of the distribution."""
        a, b, n = as_float(self.concentration1, self.concentration0, self.total_count)
        s = a + b
        return n * a * b * (s + n) / (s * s * (s + 1.0))


class ZeroInflatedDistribution(Distribution):
    """Mix a point mass at zero (probability ``gate``) into a count model.

    Surveillance series with reporting dropouts: P(0) = gate +
    (1-gate) * base.P(0); elsewhere (1-gate) * base.P(k).
    """

    def __init__(self, base_dist, *, gate):
        self.base_dist = base_dist
        self.gate = gate
        self._batch_shape = tuple(torch.broadcast_shapes(base_dist.batch_shape, _shape(gate)))
        self.support = base_dist.support

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        shape = tuple(sample_shape) + self.batch_shape
        (gate,) = as_float(self.gate, device=generator.device)
        dropped = torch.bernoulli(gate.expand(shape).contiguous(), generator=generator).bool()
        draws = self.base_dist.sample(generator, sample_shape).expand(shape)
        return torch.where(dropped, torch.zeros_like(draws), draws)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        value, gate = as_float(value, self.gate)
        log_gate, log1m_gate = torch.log(gate), torch.log1p(-gate)
        lp_base = self.base_dist.log_prob(value)
        lp_zero = torch.logaddexp(
            log_gate.expand(torch.broadcast_shapes(log_gate.shape, value.shape)),
            log1m_gate + self.base_dist.log_prob(torch.zeros_like(value)),
        )
        return torch.where(value == 0.0, lp_zero, log1m_gate + lp_base)

    @property
    def mean(self):
        """Mean of the distribution."""
        base_mean = self.base_dist.mean
        gate, base_mean = as_float(self.gate, base_mean)
        return (1.0 - gate) * base_mean


def ZeroInflatedPoisson(gate, rate):
    """numpyro-parity constructor: ``ZeroInflatedPoisson(gate, rate)``."""
    return ZeroInflatedDistribution(Poisson(rate), gate=gate)


def ZeroInflatedNegativeBinomial(gate, mean, concentration):
    """Zero-inflated Gamma-Poisson (dropout + overdispersion together)."""
    return ZeroInflatedDistribution(NegativeBinomial(mean, concentration), gate=gate)


__all__ = [
    "Poisson",
    "Bernoulli",
    "Binomial",
    "NegativeBinomial",
    "Categorical",
    "Multinomial",
    "BetaBinomial",
    "ZeroInflatedDistribution",
    "ZeroInflatedPoisson",
    "ZeroInflatedNegativeBinomial",
]
