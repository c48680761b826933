"""Step-size controllers: constant, PID (an I-controller by default), jump clipping.

Port of ``dynode_tpu/ode/controllers.py``. ``simulate`` asks for
``ConstantStepSize`` when ``constant_step_size > 0``, else for
``ClipStepSizeController(PIDController(rtol, atol), jump_ts=...)``.

Every quantity is a tensor of the state's dtype. In a batch-leading
ensemble the leading ``batch_dims`` dimensions of each leaf are members:
the norms reduce over the rest, so each member gets its own error norm and
step size.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .solvers import _bcast


def _member_sum(x: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """Sum over every dimension after the first ``batch_dims``."""
    dims = tuple(range(batch_dims, x.dim()))
    return x.sum(dim=dims) if dims else x


def rms_error_norm(err, y0, y1, rtol, atol, batch_dims: int = 0):
    """Scaled RMS norm of the local error estimate over the whole state
    (per member of the first ``batch_dims`` dimensions)."""
    sq_sum = None
    count = 0
    for e_leaf, y0_leaf, y1_leaf in zip(err, y0, y1):
        scale = atol + rtol * torch.maximum(y0_leaf.abs(), y1_leaf.abs())
        r = e_leaf / scale
        s = _member_sum(r * r, batch_dims)
        sq_sum = s if sq_sum is None else sq_sum + s
        count += math.prod(e_leaf.shape[batch_dims:])
    return torch.sqrt(sq_sum / count)


class AbstractStepSizeController:
    """Interface: the initial dt, and an accept decision and factor per step."""

    adaptive: bool = False
    #: sorted discontinuity times the integrator lands on exactly
    jump_ts: Optional[tuple] = None

    def init_dt(self, term, solver, t0, t1, y0, f0, args, dt0):
        """The initial step size of a solve."""
        raise NotImplementedError

    def adapt(self, err_norm, dt, solver):
        """``(accept, factor)`` from the scaled error norm of a trial step."""
        raise NotImplementedError


class ConstantStepSize(AbstractStepSizeController):
    """Fixed dt; every step accepted."""

    adaptive = False

    def init_dt(self, term, solver, t0, t1, y0, f0, args, dt0):
        """The configured constant ``dt``."""
        if dt0 is None:
            raise ValueError("ConstantStepSize requires an explicit dt0")
        return torch.as_tensor(dt0, dtype=t0.dtype, device=t0.device)

    def adapt(self, err_norm, dt, solver):
        """Always accept; ``dt`` never changes."""
        return torch.ones_like(dt, dtype=torch.bool), torch.ones_like(dt)


class PIDController(AbstractStepSizeController):
    """Adaptive controller with diffrax's I-control defaults:
    ``factor = clip(safety * norm**(-1/err_order), factormin, factormax)``."""

    adaptive = True

    def __init__(
        self,
        rtol: float,
        atol: float,
        *,
        safety: float = 0.9,
        factormin: float = 0.2,
        factormax: float = 10.0,
        dtmin: Optional[float] = None,
        dtmax: Optional[float] = None,
    ):
        self.rtol = rtol
        self.atol = atol
        self.safety = safety
        self.factormin = factormin
        self.factormax = factormax
        self.dtmin = dtmin
        self.dtmax = dtmax

    def init_dt(self, term, solver, t0, t1, y0, f0, args, dt0):
        """The Hairer initial step (:func:`select_initial_step`), or ``dt0``."""
        if dt0 is not None:
            return torch.as_tensor(dt0, dtype=t0.dtype, device=t0.device)
        return select_initial_step(term, t0, y0, f0, args, solver.err_order, self.rtol, self.atol)

    def adapt(self, err_norm, dt, solver):
        """Accept when the norm is at most 1; the next ``dt`` factor from it
        (a zero norm is read as the smallest normal number)."""
        safe_norm = torch.clamp(err_norm, min=torch.finfo(err_norm.dtype).tiny)
        exponent = 1.0 / solver.err_order
        factor = torch.clamp(
            self.safety * safe_norm**-exponent, self.factormin, self.factormax
        )
        return err_norm <= 1.0, factor

    def clamp_dt(self, dt):
        """Clamp ``dt`` into the configured ``[dtmin, dtmax]``."""
        if self.dtmin is not None:
            dt = torch.clamp(dt, min=self.dtmin)
        if self.dtmax is not None:
            dt = torch.clamp(dt, max=self.dtmax)
        return dt


class ClipStepSizeController(AbstractStepSizeController):
    """Wrap another controller; the engine clips steps to land exactly on
    ``jump_ts``, so that no RK stage straddles a discontinuity of the RHS."""

    def __init__(self, controller: AbstractStepSizeController, jump_ts=None):
        self.controller = controller
        if jump_ts is not None:
            values = jump_ts.tolist() if hasattr(jump_ts, "tolist") else jump_ts
            flat = values if isinstance(values, (list, tuple)) else [values]
            self.jump_ts = tuple(sorted(float(t) for t in flat))
        else:
            self.jump_ts = None

    @property
    def adaptive(self):
        """Whether the wrapped controller adapts ``dt``."""
        return self.controller.adaptive

    def init_dt(self, term, solver, t0, t1, y0, f0, args, dt0):
        """Delegate to the wrapped controller."""
        return self.controller.init_dt(term, solver, t0, t1, y0, f0, args, dt0)

    def adapt(self, err_norm, dt, solver):
        """Delegate to the wrapped controller."""
        return self.controller.adapt(err_norm, dt, solver)

    def clamp_dt(self, dt):
        """Delegate to the wrapped controller's clamp when it has one."""
        clamp = getattr(self.controller, "clamp_dt", None)
        return clamp(dt) if clamp is not None else dt


def select_initial_step(term, t0, y0, f0, args, err_order, rtol, atol):
    """Hairer-Wanner automatic initial step (algorithm II.4 of H&W).

    ``t0`` carries the batch shape: in a batch-leading ensemble each member
    gets its own step.
    """
    batch_dims = t0.dim()

    def scaled_norm(tree, ref):
        sq, n = None, 0
        for leaf, ref_leaf in zip(tree, ref):
            r = leaf / (atol + rtol * ref_leaf.abs())
            s = _member_sum(r * r, batch_dims)
            sq = s if sq is None else sq + s
            n += math.prod(leaf.shape[batch_dims:])
        return torch.sqrt(sq / n)

    d0 = scaled_norm(y0, y0)
    d1 = scaled_norm(f0, y0)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)

    y1 = tuple(y + _bcast(h0, y) * f for y, f in zip(y0, f0))
    f1 = term.vf(t0 + h0, y1, args)
    d2 = scaled_norm(tuple(a - b for a, b in zip(f1, f0)), y0) / h0

    d12 = torch.maximum(d1, d2)
    h1 = torch.where(
        d12 <= 1e-15,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / d12) ** (1.0 / err_order),
    )
    return torch.minimum(100.0 * h0, h1)


__all__ = [
    "AbstractStepSizeController",
    "ConstantStepSize",
    "PIDController",
    "ClipStepSizeController",
    "select_initial_step",
    "rms_error_norm",
]
