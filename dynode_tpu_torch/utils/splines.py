"""Cubic-spline evaluation for time-varying vaccination uptake.

Port of ``dynode_tpu/utils/splines.py``: a cubic base polynomial plus
truncated-cubic knot terms, evaluated for every (age bin x vaccination
count) combination at simulation day ``t``. Elementwise torch on whatever
device and dtype the coefficients have.
"""

from __future__ import annotations

import torch


def _as_time(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def base_equation(t, coefficients: torch.Tensor) -> torch.Tensor:
    """a + b*t + c*t^2 + d*t^3 for each (age, dose) coefficient row.

    ``coefficients``: (NUM_AGE, MAX_VAX+1, 4) -> returns (NUM_AGE, MAX_VAX+1).
    """
    t = _as_time(t, coefficients)
    powers = torch.stack([torch.ones_like(t), t, t**2, t**3], dim=-1)  # (..., 4)
    return torch.sum(coefficients * powers[..., None, None, :], dim=-1)


def conditional_knots(t, knots: torch.Tensor, coefficients: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[i] * (t - knots[i])^3 * I(t > knots[i]) over the knot axis."""
    t = _as_time(t, knots)[..., None, None, None]
    active = torch.where(t > knots, t - knots, torch.zeros_like(knots))
    return torch.sum(active**3 * coefficients, dim=-1)


def evaluate_cubic_spline(
    t,
    knot_locations: torch.Tensor,
    base_equations: torch.Tensor,
    knot_coefficients: torch.Tensor,
) -> torch.Tensor:
    """Evaluate the full vaccination-uptake spline at day ``t``.

    ``f(t) = a + bt + ct^2 + dt^3 + sum_i coeffs[i] (t-knot_i)^3 I(t>knot_i)``
    for every age x dose combination.

    Shapes: knot_locations/knot_coefficients (NUM_AGE, MAX_VAX+1, K),
    base_equations (NUM_AGE, MAX_VAX+1, 4) -> (NUM_AGE, MAX_VAX+1).
    """
    return base_equation(t, base_equations) + conditional_knots(
        t, knot_locations, knot_coefficients
    )


__all__ = ["base_equation", "conditional_knots", "evaluate_cubic_spline"]
