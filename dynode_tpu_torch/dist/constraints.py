"""Support constraints for distributions.

Port of ``dynode_tpu/dist/constraints.py``: the same classes and
instances. Constraints tag a distribution's support so inference code can
pick the bijection to unconstrained space
(:func:`dynode_tpu_torch.dist.transforms.biject_to`). Bounds are kept as
given: Python numbers or tensors.
"""

from typing import Optional


class Constraint:
    """Base class: a named region of parameter space."""

    is_discrete = False

    def __repr__(self):
        return self.__class__.__name__


class _Real(Constraint):
    pass


class _Positive(Constraint):
    pass


class _Nonnegative(Constraint):
    pass


class _UnitInterval(Constraint):
    pass


class Interval(Constraint):
    """Support on the open interval (low, high)."""

    def __init__(self, low: float, high: float):
        self.low = low
        self.high = high

    def __repr__(self):
        return f"Interval({self.low}, {self.high})"


class GreaterThan(Constraint):
    """Support on (low, inf)."""

    def __init__(self, low: float):
        self.low = low

    def __repr__(self):
        return f"GreaterThan({self.low})"


class LessThan(Constraint):
    """Support on (-inf, high)."""

    def __init__(self, high: float):
        self.high = high

    def __repr__(self):
        return f"LessThan({self.high})"


class IntegerNonnegative(Constraint):
    """Constraint: integer-valued and ``>= 0``."""
    is_discrete = True


class IntegerInterval(Constraint):
    """Constraint: integer in ``[lower_bound, upper_bound]``."""
    is_discrete = True

    def __init__(self, low: int, high: Optional[int] = None):
        self.low = low
        self.high = high


class _Simplex(Constraint):
    """Vectors on the probability simplex (last axis sums to 1)."""


simplex = _Simplex()
real = _Real()
positive = _Positive()
nonnegative = _Nonnegative()
unit_interval = _UnitInterval()
integer_nonnegative = IntegerNonnegative()

__all__ = [
    "Constraint",
    "Interval",
    "GreaterThan",
    "LessThan",
    "IntegerInterval",
    "IntegerNonnegative",
    "real",
    "positive",
    "nonnegative",
    "unit_interval",
    "integer_nonnegative",
    "simplex",
]
