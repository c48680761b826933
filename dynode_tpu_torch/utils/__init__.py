"""Helpers of the port (the vaccination-uptake splines so far)."""

from .splines import base_equation, conditional_knots, evaluate_cubic_spline

__all__ = ["base_equation", "conditional_knots", "evaluate_cubic_spline"]
