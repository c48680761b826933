"""Helpers of the port: the vaccination-uptake splines and the
object-to-tensor and posterior-dict utilities."""

from .splines import base_equation, conditional_knots, evaluate_cubic_spline
from .utils import (
    drop_keys_with_substring,
    flatten_list_parameters,
    identify_distribution_indexes,
    vectorize_objects,
)

__all__ = [
    "base_equation",
    "conditional_knots",
    "evaluate_cubic_spline",
    "vectorize_objects",
    "flatten_list_parameters",
    "drop_keys_with_substring",
    "identify_distribution_indexes",
]
