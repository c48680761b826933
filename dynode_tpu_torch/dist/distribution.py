"""Distribution base class and TransformedDistribution.

Port of ``dynode_tpu/dist/distribution.py`` on PyTorch. Three rules hold
for every distribution of the port:

- **Sampling takes a generator.** ``sample(generator, sample_shape=())``
  (and ``__call__``) draws every random number from that
  ``torch.Generator``; there is no global random state.
- **Device.** Samples lie on the generator's device. A tensor parameter on
  another device raises ``ValueError``; so does ``log_prob`` when its value
  and the parameters span devices.
- **Dtype.** A tensor (or numpy) parameter keeps its floating dtype; Python
  numbers take the dtype of the tensors they meet (parameters and, in
  ``log_prob``, the value), or float32 when they meet none. Integer tensors
  are computed in that floating dtype, as the JAX package casts every input
  to a float.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import _device
from . import constraints as C
from .transforms import Transform


def _shape(x) -> Tuple[int, ...]:
    """Shape of a tensor, numpy array, list or number (no host copy)."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    return tuple(np.shape(x))


def _strong(x):
    """``x`` as a tensor when it carries its own dtype (tensor or numpy)."""
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.as_tensor(x)
    return x


def _norm_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def float_dtype(*xs) -> torch.dtype:
    """The floating dtype of an operation on ``xs``: the promotion of the
    floating tensors among them, else float32."""
    dtype = None
    for x in xs:
        x = _strong(x)
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            dtype = x.dtype if dtype is None else torch.promote_types(dtype, x.dtype)
    return torch.float32 if dtype is None else dtype


def common_device(*xs, device=None):
    """The one device of the tensors among ``xs`` (and ``device`` when
    given); None when there is no tensor and no ``device``. Raises
    ``ValueError`` on a mix."""
    devices = {_norm_device(x.device) for x in xs if isinstance(x, torch.Tensor)}
    if device is not None:
        device = _norm_device(device)
        if devices - {device}:
            raise ValueError(
                f"a parameter lies on {sorted(map(str, devices - {device}))}, "
                f"not on the generator's device {device}"
            )
        return device
    if len(devices) > 1:
        raise ValueError(f"inputs span several devices: {sorted(map(str, devices))}")
    return devices.pop() if devices else None


def as_float(*xs, device=None) -> Tuple[torch.Tensor, ...]:
    """Every ``x`` as a tensor of the common floating dtype and device
    (:func:`float_dtype`, :func:`common_device`); tensors keep their graph.
    Python numbers are filled in on the device, not copied from the host
    (``_device.scalar``), so a CUDA graph can capture the call."""
    xs = tuple(_strong(x) for x in xs)
    dtype = float_dtype(*xs)
    dev = common_device(*xs, device=device)
    return tuple(
        _device.scalar(x, dtype, dev) if isinstance(x, (bool, int, float))
        else torch.as_tensor(x, dtype=dtype, device=dev)
        for x in xs
    )


class Distribution:
    """Base class of the port's distributions.

    Subclasses implement :meth:`sample` and :meth:`log_prob` on tensors of
    their (possibly batched) parameters, plus a ``support`` constraint used
    for the bijection to unconstrained space during inference.
    """

    support: C.Constraint = C.real

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        """Shape of independent parameter batches."""
        return getattr(self, "_batch_shape", ())

    @property
    def event_shape(self) -> Tuple[int, ...]:
        """Shape of a single atomic event."""
        return getattr(self, "_event_shape", ())

    def shape(self, sample_shape=()) -> Tuple[int, ...]:
        """``sample_shape + batch_shape + event_shape``."""
        return tuple(sample_shape) + self.batch_shape + self.event_shape

    def sample(self, generator: torch.Generator, sample_shape=()) -> torch.Tensor:
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        raise NotImplementedError

    def log_prob(self, value) -> torch.Tensor:
        """Elementwise log-density of ``value``."""
        raise NotImplementedError

    @property
    def mean(self):
        """Mean of the distribution."""
        raise NotImplementedError

    @property
    def variance(self):
        """Variance of the distribution."""
        raise NotImplementedError

    def __call__(self, generator, sample_shape=()):
        return self.sample(generator, sample_shape)

    def expand(self, batch_shape):
        """Broadcast this distribution to a larger batch shape."""
        return ExpandedDistribution(self, tuple(batch_shape))

    def _broadcast_batch_shape(self, *params) -> Tuple[int, ...]:
        return tuple(torch.broadcast_shapes(*(_shape(p) for p in params)))


class ExpandedDistribution(Distribution):
    """A base distribution broadcast over a larger batch shape."""

    def __init__(self, base_dist: Distribution, batch_shape):
        self.base_dist = base_dist
        self._batch_shape = tuple(batch_shape)
        self._event_shape = base_dist.event_shape
        self.support = base_dist.support

    def sample(self, generator, sample_shape=()):
        # the base's own batch dims align with the tail of the expanded
        # shape; draw only the leading expansion and broadcast the rest
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        lead = self._batch_shape[: len(self._batch_shape) - len(self.base_dist.batch_shape)]
        draws = self.base_dist.sample(generator, tuple(sample_shape) + lead)
        target = tuple(sample_shape) + self._batch_shape + self._event_shape
        return draws.expand(target)

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        return self.base_dist.log_prob(value)

    @property
    def mean(self):
        """Mean of the distribution."""
        return torch.as_tensor(self.base_dist.mean).expand(self._batch_shape + self._event_shape)


class TransformedDistribution(Distribution):
    """Distribution of ``transform(x)`` for ``x ~ base_distribution``.

    ``log_prob(y) = base.log_prob(f^-1(y)) - log|det df/dx|(f^-1(y))``.
    """

    def __init__(self, base_distribution: Distribution, transforms):
        self.base_dist = base_distribution
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.transforms = list(transforms)
        from .transforms import push_constraint

        support = base_distribution.support
        for t in self.transforms:
            support = push_constraint(support, t)
        self.support = support
        self._batch_shape = base_distribution.batch_shape
        self._event_shape = base_distribution.event_shape

    def sample(self, generator, sample_shape=()):
        """Draw samples from ``generator``; shape ``sample_shape + shape()``."""
        x = self.base_dist.sample(generator, sample_shape)
        for t in self.transforms:
            x = t(x)
        return x

    def log_prob(self, value):
        """Elementwise log-density of ``value``."""
        (value,) = as_float(value)
        # walk backwards to the base space, accumulating jacobian corrections
        y = value
        log_det = torch.zeros_like(y)
        for t in reversed(self.transforms):
            x = t.inv(y)
            log_det = log_det + t.log_abs_det_jacobian(x, y)
            y = x
        return self.base_dist.log_prob(y) - log_det

    @property
    def mean(self):
        # only exact for affine-only transform chains; used by init heuristics.
        """Mean of the distribution."""
        x = self.base_dist.mean
        for t in self.transforms:
            x = t(x)
        return x


class Unit(Distribution):
    """Zero-size distribution carrying an arbitrary log-factor.

    The vehicle for ``handlers.factor``: ``sample`` returns an empty tensor
    and ``log_prob`` ignores the value and returns ``log_factor``.
    """

    support = C.real

    def __init__(self, log_factor):
        (self.log_factor,) = as_float(log_factor)
        self._batch_shape = tuple(self.log_factor.shape)
        self._event_shape = (0,)

    def sample(self, generator, sample_shape=()):
        """Return the empty value (no randomness; shape ``(*batch, 0)``)."""
        return torch.empty(
            tuple(sample_shape) + self.batch_shape + (0,),
            dtype=self.log_factor.dtype,
            device=common_device(self.log_factor, device=generator.device),
        )

    def log_prob(self, value):
        """The stored ``log_factor`` (ignores ``value``)."""
        return self.log_factor


class Delta(Distribution):
    """Point mass at ``value`` with an optional extra log-density term.

    ``event_dim`` marks the trailing ``event_dim`` axes of ``value`` as event
    dimensions: ``log_prob`` broadcasts ``log_density`` over the batch shape
    only, so a scalar correction attached to a vector latent is counted once.
    """

    def __init__(self, value, log_density=0.0, event_dim=0):
        self.value = value
        self._log_density = log_density
        self.event_dim = int(event_dim)
        shape = _shape(value)
        if self.event_dim > len(shape):
            raise ValueError(f"event_dim {event_dim} exceeds value rank {len(shape)}")
        split = len(shape) - self.event_dim
        self._batch_shape = shape[:split]
        self._event_shape = shape[split:]

    def sample(self, generator, sample_shape=()):
        """Return the fixed ``value`` broadcast to the sample shape."""
        value = torch.as_tensor(_strong(self.value), device=common_device(self.value, device=generator.device))
        return value.expand(tuple(sample_shape) + tuple(value.shape))

    def log_prob(self, value):
        """``log_density`` broadcast over the batch shape only."""
        shape = _shape(value)
        batch = shape[: len(shape) - self.event_dim]
        log_density, _ = as_float(self._log_density, value)
        return log_density.expand(batch)

    @property
    def mean(self):
        """The point-mass location."""
        return self.value


__all__ = ["Distribution", "TransformedDistribution", "Delta"]
