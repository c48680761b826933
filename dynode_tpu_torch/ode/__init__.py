"""Explicit Runge-Kutta tableaus of the port."""

from .solvers import (
    METHODS,
    RK4_A,
    RK4_B,
    RK4_C,
    Bosh3,
    Dopri5,
    Euler,
    Heun,
    Tableau,
    Tsit5,
)

__all__ = [
    "Tableau", "Euler", "Heun", "Bosh3", "Tsit5", "Dopri5",
    "RK4_A", "RK4_B", "RK4_C", "METHODS",
]
