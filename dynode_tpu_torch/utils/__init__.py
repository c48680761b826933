"""Helpers of the port: logging, dates and epiweeks, the vaccination-uptake
splines, profiling and solver statistics, where the kernels are built, and
the object-to-tensor and posterior-dict utilities."""

from .compilation_cache import compilation_cache_dir, enable_compilation_cache
from .custom_log_formatter import CustomLogFormatter
from .datetime_utils import date_to_epi_week, date_to_sim_day, sim_day_to_date, sim_day_to_epiweek
from .epiweek import EpiWeek, Week
from .log import logger, use_logging
from .log_decorator import log_decorator
from .profiling import assert_solved, solver_stats, trace, wall_timer
from .splines import base_equation, conditional_knots, evaluate_cubic_spline
from .utils import (
    drop_keys_with_substring,
    flatten_list_parameters,
    identify_distribution_indexes,
    vectorize_objects,
)

__all__ = [
    "enable_compilation_cache",
    "compilation_cache_dir",
    "use_logging",
    "logger",
    "log_decorator",
    "CustomLogFormatter",
    "sim_day_to_date",
    "sim_day_to_epiweek",
    "date_to_sim_day",
    "date_to_epi_week",
    "EpiWeek",
    "Week",
    "assert_solved",
    "solver_stats",
    "trace",
    "wall_timer",
    "base_equation",
    "conditional_knots",
    "evaluate_cubic_spline",
    "vectorize_objects",
    "flatten_list_parameters",
    "drop_keys_with_substring",
    "identify_distribution_indexes",
]

#: the plotting names of the JAX package's ``utils.vis_utils``
VIS_NAMES = (
    "plot_model_overview_subplot_matplotlib",
    "plot_checkpoint_inference_correlation_pairs",
    "plot_mcmc_chains",
    "plot_posterior_density",
    "plot_prior_distributions",
    "plot_violin_plots",
    "vis_utils",
)


def __getattr__(name):
    if name in VIS_NAMES:
        raise AttributeError(
            f"{name!r}: the plotting utilities (vis_utils) are not ported yet; they come with the "
            "examples (ROADMAP.md, Queue 1 #15b)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
