"""``SolverParams``: how the ODE engine integrates.

Port of ``SolverParams`` from ``dynode_tpu/config/params.py`` as a plain
dataclass: the same fields, defaults and checks, without pydantic. Each
field is coerced as pydantic's lax mode coerces it (an integral float to
an int, a number string to a number, ...), and a value pydantic refuses
raises ``ValueError`` (pydantic's ``ValidationError`` is one too). The
rest of the JAX config layer is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from dataclasses import dataclass, field
from typing import List, Optional

from ..ode.solvers import AbstractSolver, Tsit5

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _as_float(name: str, value) -> float:
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            raise ValueError(f"{name}: {value!r} is not a number") from None
    if isinstance(value, numbers.Real):
        return float(value)
    raise ValueError(f"{name}: {value!r} is not a number")


def _as_int(name: str, value) -> int:
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            raise ValueError(f"{name}: {value!r} is not an integer") from None
    if isinstance(value, numbers.Integral):
        return int(value)
    if isinstance(value, numbers.Real) and math.isfinite(value) and float(value).is_integer():
        return int(value)
    raise ValueError(f"{name}: {value!r} is not an integer")


def _as_bool(name: str, value) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, numbers.Integral) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.lower() in _TRUE | _FALSE:
        return value.lower() in _TRUE
    raise ValueError(f"{name}: {value!r} is not a boolean")


def _positive(name: str, value):
    if not value > 0:
        raise ValueError(f"{name} must be > 0, got {value!r}")
    return value


@dataclass
class SolverParams:
    """Solver, tolerances and step policy of :func:`~dynode_tpu_torch.simulate`.

    - ``solver_method``: an explicit RK solver instance (Tsit5 by default).
    - ``ode_solver_rel_tolerance``, ``ode_solver_abs_tolerance`` (> 0): the
      adaptive controller's tolerances.
    - ``max_steps`` (> 0): cap on the steps before the solve is flagged
      (``result == RESULT_MAX_STEPS``, unreached saves NaN).
    - ``constant_step_size`` (>= 0): when not 0, the fixed dt of the solve.
    - ``discontinuity_points``: days where the RHS jumps; adaptive steps
      land on them.
    - ``step_budget`` (> 0 or None): the steps an adaptive solve may take
      (default ``min(max_steps, 4096)``); ``tune_step_budget`` sizes it.
    - ``steps_per_save`` (> 0 or None): the per-interval step bound of the
      save-grid engine (default ``max(ceil(1.25 * budget / intervals) + 2,
      6)``; twice that, at least 16, for the first interval).
    - ``compensated_summation``: Kahan-compensated state accumulation.
    """

    solver_method: AbstractSolver = field(default_factory=Tsit5)
    ode_solver_rel_tolerance: float = 1e-5
    ode_solver_abs_tolerance: float = 1e-6
    max_steps: int = int(1e6)
    constant_step_size: float = 0
    discontinuity_points: List[float] = field(default_factory=list)
    step_budget: Optional[int] = None
    steps_per_save: Optional[int] = None
    compensated_summation: bool = False

    def __post_init__(self):
        if not isinstance(self.solver_method, AbstractSolver):
            raise ValueError(f"solver_method: {self.solver_method!r} is not a solver instance")
        for name in ("ode_solver_rel_tolerance", "ode_solver_abs_tolerance"):
            setattr(self, name, _positive(name, _as_float(name, getattr(self, name))))
        self.max_steps = _positive("max_steps", _as_int("max_steps", self.max_steps))
        step = _as_float("constant_step_size", self.constant_step_size)
        if not step >= 0:
            raise ValueError(f"constant_step_size must be >= 0, got {step!r}")
        self.constant_step_size = step
        for name in ("step_budget", "steps_per_save"):
            value = getattr(self, name)
            if value is not None:
                setattr(self, name, _positive(name, _as_int(name, value)))
        points = self.discontinuity_points
        if points is None or isinstance(points, (str, bytes, dict)):
            raise ValueError(f"discontinuity_points: {points!r} is not a list of numbers")
        self.discontinuity_points = [_as_float("discontinuity_points", p) for p in points]
        self.compensated_summation = _as_bool("compensated_summation", self.compensated_summation)

    def model_copy(self, *, update: Optional[dict] = None) -> "SolverParams":
        """A copy with the fields of ``update`` replaced (pydantic's
        ``model_copy``); the copy is checked as a new instance is."""
        return dataclasses.replace(self, **(update or {}))


__all__ = ["SolverParams"]
