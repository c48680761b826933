"""Shared type vocabulary of the port's configs and models.

Port of ``dynode_tpu/typing.py``. The tensor aliases are type hints; the
two validated types, :data:`DynodeName` and :data:`UnitIntervalFloat`, are
field validators of :mod:`dynode_tpu_torch._validate` (the JAX package
builds them as pydantic ``Annotated`` types), used in the config classes'
field declarations.
"""

from typing import Any, Callable, Tuple, Union

import torch

from . import _validate as V

#: one tensor per compartment, each shaped by the compartment's dimensions
CompartmentState = Tuple[torch.Tensor, ...]
#: the same tuple shape, holding d/dt
CompartmentGradients = Tuple[torch.Tensor, ...]
#: CompartmentState with a leading time axis on every tensor
CompartmentTimeseries = CompartmentState

#: RHS contract: ``f(t, state, params) -> gradients``
ODE_Eqns = Callable[
    [Union[float, torch.Tensor], CompartmentState, Any],
    CompartmentGradients,
]

ObservedData = Union[Tuple[torch.Tensor, ...], torch.Tensor]


def _verify_name(name: str) -> str:
    """Reject names with leading digits, spaces, or non-alnum/underscore chars."""
    if name[0].isnumeric():
        raise ValueError(f"invalid name {name!r}: leading digit")
    if " " in name:
        raise ValueError(f"invalid name {name!r}: contains spaces")
    if not all(ch.isalnum() or ch == "_" for ch in name):
        raise ValueError(f"invalid name {name!r}: only alphanumerics/underscores allowed")
    return name


#: A string identifier usable as an attribute name (no spaces/leading digits).
#: As in the JAX package the check sees the raw value first, so an empty
#: string raises ``IndexError`` and a number ``TypeError``, as there.
DynodeName = V.before(_verify_name, V.str_)

#: A float in [0, 1].
UnitIntervalFloat = V.constrained(V.float_, ge=0.0, le=1.0)

__all__ = [
    "CompartmentState",
    "CompartmentGradients",
    "CompartmentTimeseries",
    "UnitIntervalFloat",
    "ODE_Eqns",
    "ObservedData",
    "DynodeName",
]
