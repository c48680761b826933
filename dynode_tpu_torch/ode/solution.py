"""The result of :func:`~dynode_tpu_torch.ode.integrate.diffeqsolve`.

Port of ``dynode_tpu/ode/solution.py``: ``ys`` is a tuple of
``(num_saves, *compartment_shape)`` tensors including t0 and t1, ``ts`` the
save grid. A batch-leading ensemble puts the member axis in front of every
field, ``stats`` and ``result`` included.
"""

from typing import Any, Dict

import torch

from ..struct import pytree_dataclass

#: the solve reached t1 within its step budget
RESULT_SUCCESS = 0
#: the step budget ran out before t1; save times past the last reached time
#: are NaN
RESULT_MAX_STEPS = 1


@pytree_dataclass
class Solution:
    """Result of an ODE solve."""

    t0: torch.Tensor
    t1: torch.Tensor
    ts: torch.Tensor
    ys: Any
    stats: Dict[str, torch.Tensor]
    result: torch.Tensor

    @property
    def success(self):
        """True where the solve finished within its budget (``result == 0``)."""
        return self.result == RESULT_SUCCESS


__all__ = ["Solution", "RESULT_SUCCESS", "RESULT_MAX_STEPS"]
