"""Configuration of the port: ``SolverParams`` so far."""

from .params import SolverParams

__all__ = ["SolverParams"]
