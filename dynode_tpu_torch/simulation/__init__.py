"""Simulation layer: ``simulate()`` over the port's ODE engine."""

from .odes import (
    AbstractODEParams,
    build_saveat,
    ensemble_rhs,
    ensemble_state,
    simulate,
    simulate_ensemble,
    tune_step_budget,
)

__all__ = [
    "simulate",
    "simulate_ensemble",
    "ensemble_rhs",
    "ensemble_state",
    "build_saveat",
    "AbstractODEParams",
    "tune_step_budget",
]
