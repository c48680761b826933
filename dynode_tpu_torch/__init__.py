"""DynODE-TPU ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside ``dynode_tpu`` (JAX, the reference), ported slice by
slice. So far it holds the ODE engine (:mod:`.ode`: the RK solvers,
controllers and :func:`diffeqsolve`), ``SolverParams`` (:mod:`.config`),
:func:`simulate` and :func:`simulate_ensemble` (:mod:`.simulation`), the
multi-strain SEIRS and SEIP models (:mod:`.models`), the carry-over of JAX
values (:mod:`.convert`) and the six ensemble kernels with their plain
versions (:mod:`.ops`). Constructors put their tensors on the card unless
given ``device="cpu"``. The package imports ``torch`` and never ``jax``.
"""

from . import config, convert, models, ode, ops, simulation, struct, utils
from .config import SolverParams
from .models.multistrain import (
    MultiStrainParams,
    multistrain_default_params,
    multistrain_initial_state,
    multistrain_ode,
)
from .models.seip import SEIPParams, seip_default_params, seip_initial_state, seip_ode
from .ode import diffeqsolve
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
from .simulation import simulate, simulate_ensemble

__all__ = [
    "config",
    "convert",
    "models",
    "ode",
    "ops",
    "simulation",
    "struct",
    "utils",
    "simulate",
    "simulate_ensemble",
    "SolverParams",
    "diffeqsolve",
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
