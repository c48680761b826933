"""Helpers of the port: the vaccination-uptake splines, the sim-day and
date conversions, and the object-to-tensor and posterior-dict utilities."""

from .datetime_utils import date_to_sim_day, sim_day_to_date
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
    "sim_day_to_date",
    "date_to_sim_day",
    "vectorize_objects",
    "flatten_list_parameters",
    "drop_keys_with_substring",
    "identify_distribution_indexes",
]
