"""DynODE-TPU ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside ``dynode_tpu`` (JAX, the reference), ported slice by
slice. So far it holds the multi-strain SEIRS scenario ensemble: the model
(:mod:`.models.multistrain`), the RK tableaus (:mod:`.ode`), the carry-over
of JAX values (:mod:`.convert`) and the four ensemble kernels with their
plain versions (:mod:`.ops`): constant-step and adaptive solves of any
rows-RHS, and the multi-strain solve on the row and the aligned 2-D layout.
Constructors put their tensors on the card unless given ``device="cpu"``.
The package imports ``torch`` and never ``jax``.
"""

from . import convert, models, ode, ops, utils
from .models.multistrain import (
    MultiStrainParams,
    multistrain_default_params,
    multistrain_initial_state,
    multistrain_ode,
)
from .models.seip import SEIPParams, seip_default_params, seip_initial_state, seip_ode
from .ops import (
    ensemble_solve_kernel,
    ensemble_solve_kernel_adaptive,
    ensemble_solve_tsit5,
    ensemble_solve_tsit5_2d,
    seip_ensemble_solve,
    seip_ensemble_solve_adaptive,
    unpack_saves,
    unpack_saves_2d,
)

__all__ = [
    "convert",
    "models",
    "ode",
    "ops",
    "utils",
    "MultiStrainParams",
    "SEIPParams",
    "multistrain_default_params",
    "multistrain_initial_state",
    "multistrain_ode",
    "seip_default_params",
    "seip_initial_state",
    "seip_ode",
    "seip_ensemble_solve",
    "seip_ensemble_solve_adaptive",
    "ensemble_solve_kernel",
    "ensemble_solve_kernel_adaptive",
    "ensemble_solve_tsit5",
    "ensemble_solve_tsit5_2d",
    "unpack_saves",
    "unpack_saves_2d",
]
