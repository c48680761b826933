"""DynODE-TPU ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside ``dynode_tpu`` (JAX, the reference), ported slice by
slice. This slice is the constant-step multi-strain SEIRS scenario ensemble:
the model (:mod:`.models.multistrain`), the RK tableaus (:mod:`.ode`), the
carry-over of JAX values (:mod:`.convert`) and the two ensemble kernels with
their plain versions (:mod:`.ops`). The package imports ``torch`` and never
``jax``.
"""

from . import convert, models, ode, ops
from .models.multistrain import (
    MultiStrainParams,
    multistrain_default_params,
    multistrain_initial_state,
    multistrain_ode,
)
from .ops import ensemble_solve_kernel, ensemble_solve_tsit5, unpack_saves

__all__ = [
    "convert",
    "models",
    "ode",
    "ops",
    "MultiStrainParams",
    "multistrain_default_params",
    "multistrain_initial_state",
    "multistrain_ode",
    "ensemble_solve_kernel",
    "ensemble_solve_tsit5",
    "unpack_saves",
]
