"""Parameter containers: SolverParams, TransmissionParams, Params.

Port of ``dynode_tpu/config/params.py`` on :class:`~._model.Model`: the
same fields, defaults and checks, without pydantic. Each field is coerced
as pydantic's lax mode coerces it (an integral float to an int, a number
string to a number, ...), and a value pydantic refuses raises
``ValueError`` (pydantic's ``ValidationError`` is one too).
"""

from __future__ import annotations

from .. import _validate as V
from ..ode.solvers import AbstractSolver, Tsit5
from ..dist import Distribution
from ._model import Field, Model, model_validator
from .links import DeterministicParameter
from .strains import ARRAY_LIKE, Strain


class SolverParams(Model):
    """Solver, tolerances and step policy of :func:`~dynode_tpu_torch.simulate`.

    - ``solver_method``: an RK solver instance (Tsit5 by default; ``TRBDF2``
      or ``ImplicitEuler`` of :mod:`~dynode_tpu_torch.ode.implicit` for a
      stiff system).
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

    solver_method = Field(V.instance_of(AbstractSolver), default_factory=Tsit5)
    ode_solver_rel_tolerance = Field(V.PositiveFloat, 1e-5)
    ode_solver_abs_tolerance = Field(V.PositiveFloat, 1e-6)
    max_steps = Field(V.PositiveInt, int(1e6))
    constant_step_size = Field(V.NonNegativeFloat, 0)
    discontinuity_points = Field(V.list_of(V.float_), default_factory=list)
    step_budget = Field(V.optional(V.PositiveInt), None)
    steps_per_save = Field(V.optional(V.PositiveInt), None)
    compensated_summation = Field(V.bool_, False)


def _strains_nonempty(strains):
    if not strains:
        raise ValueError("strains field must contain at least one Strain.")
    return strains


def _optional_fields_consistent(strains):
    intro_ages = [s.introduction_ages for s in strains if s.is_introduced]
    if not all(x == intro_ages[0] for x in intro_ages):
        raise ValueError("currently DynODE requires all strains have matching introduction_ages.")
    for field_name in ("exposed_to_infectious", "vaccine_efficacy"):
        present = [getattr(s, field_name) is not None for s in strains]
        if any(present) and not all(present):
            raise ValueError(
                f"if {field_name} is set within one strain it must be set in all of them."
            )
    return strains


_INTERACTION = V.union(V.NonNegativeFloat, *ARRAY_LIKE, V.instance_of(Distribution),
                       V.instance_of(DeterministicParameter))


class TransmissionParams(Model):
    """Strains + cross-immunity matrix + arbitrary model-specific extras.

    ``extra = "allow"`` makes this an open parameter bag: models attach
    contact matrices, waning periods, seasonality blocks, etc.
    """

    extra = "allow"

    strain_interactions = Field(V.dict_of(V.str_, V.dict_of(V.str_, _INTERACTION)))
    strains = Field(V.list_of(V.model(Strain)), after=(_strains_nonempty, _optional_fields_consistent))

    @model_validator
    def _interactions_cover_all_strains(self):
        names = [s.strain_name for s in self.strains]
        if set(names) != set(self.strain_interactions.keys()):
            raise ValueError(
                f"first dimension of strain_interactions must contain all strain "
                f"names as keys. Found {list(self.strain_interactions.keys())}"
                f"but expected {names}."
            )
        for outer, inner in self.strain_interactions.items():
            if set(names) != set(inner.keys()):
                raise ValueError(
                    f"strain_interactions[{outer}] interactions must contain "
                    f"all strains as keys, including itself, "
                    f"found {list(inner.keys())}, expected {names}."
                )
        return self


class Params(Model):
    """Top-level parameter container: solver + transmission."""

    solver_params = Field(V.model(SolverParams))
    transmission_params = Field(V.model(TransmissionParams))


__all__ = ["SolverParams", "TransmissionParams", "Params"]
