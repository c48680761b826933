"""Hand-written Hopper kernels of the hot paths, each beside its plain version.

``ensemble_solve_tsit5`` integrates a whole multi-strain SEIRS ensemble in one
CUDA C++ kernel (``csrc/multistrain_tsit5.cu``), and ``ensemble_solve_tsit5_2d``
the same model on the aligned 2-D layout in another (``csrc/multistrain_tsit5_2d.cu``);
``ensemble_solve_kernel`` and ``ensemble_solve_kernel_adaptive`` do a
constant-step and an adaptive (lockstep-dt) solve of any rows-RHS in Triton
kernels (``generic_triton.py``). On CPU tensors each runs its plain PyTorch
version; on CUDA tensors it launches the kernel or raises.
"""

from .generic import (
    RowsRHS,
    ensemble_solve_kernel,
    ensemble_solve_kernel_adaptive,
    ensemble_solve_kernel_adaptive_reference,
    ensemble_solve_kernel_reference,
    pack_rows,
    unpack_rows,
)
from .multistrain import (
    ensemble_solve_reference,
    ensemble_solve_tsit5,
    ensemble_solve_tsit5_2d,
    multistrain_rows_rhs,
    pack_params,
    pack_rates_2d,
    pack_state,
    pack_state_2d,
    unpack_saves,
    unpack_saves_2d,
)

__all__ = [
    "RowsRHS",
    "ensemble_solve_tsit5",
    "ensemble_solve_tsit5_2d",
    "ensemble_solve_reference",
    "ensemble_solve_kernel",
    "ensemble_solve_kernel_adaptive",
    "ensemble_solve_kernel_adaptive_reference",
    "ensemble_solve_kernel_reference",
    "multistrain_rows_rhs",
    "pack_rows",
    "unpack_rows",
    "pack_state",
    "pack_state_2d",
    "pack_params",
    "pack_rates_2d",
    "unpack_saves",
    "unpack_saves_2d",
]
