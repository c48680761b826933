"""Type aliases of the engine and ``simulate``.

Port of the two aliases of ``dynode_tpu/typing.py`` that they use. The
rest of that module (the pydantic-validated names and bounds) belongs to
the config layer, which is not ported yet.
"""

from typing import Any, Callable, Tuple, Union

import torch

#: one tensor per compartment, each shaped by the compartment's dimensions
CompartmentState = Tuple[torch.Tensor, ...]
#: the same tuple shape, holding d/dt
CompartmentGradients = Tuple[torch.Tensor, ...]

#: RHS contract: ``f(t, state, params) -> gradients``
ODE_Eqns = Callable[
    [Union[float, torch.Tensor], CompartmentState, Any],
    CompartmentGradients,
]

__all__ = ["CompartmentState", "CompartmentGradients", "ODE_Eqns"]
