"""The ODE engine of the port: RK solvers and tableaus, the implicit
(ESDIRK) solvers for stiff systems, step-size controllers, save grids and
:func:`diffeqsolve`."""

from .controllers import (
    AbstractStepSizeController,
    ClipStepSizeController,
    ConstantStepSize,
    PIDController,
)
from .implicit import AbstractImplicitSolver, ImplicitEuler, TRBDF2
from .integrate import diffeqsolve
from .saveat import SaveAt, SubSaveAt
from .solution import RESULT_MAX_STEPS, RESULT_SUCCESS, Solution
from .solvers import (
    METHODS,
    RK4_A,
    RK4_B,
    RK4_C,
    AbstractSolver,
    Bosh3,
    Dopri5,
    Euler,
    Heun,
    ODETerm,
    Tsit5,
)

__all__ = [
    "diffeqsolve", "ODETerm", "AbstractSolver", "Euler", "Heun", "Bosh3", "Tsit5", "Dopri5",
    "RK4_A", "RK4_B", "RK4_C", "METHODS",
    "AbstractImplicitSolver", "ImplicitEuler", "TRBDF2",
    "AbstractStepSizeController", "ConstantStepSize", "PIDController", "ClipStepSizeController",
    "SaveAt", "SubSaveAt", "Solution", "RESULT_SUCCESS", "RESULT_MAX_STEPS",
]
