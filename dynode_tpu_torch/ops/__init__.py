"""Hand-written Hopper kernels of the hot paths, each beside its plain version.

``ensemble_solve_tsit5`` integrates a whole multi-strain SEIRS ensemble in one
CUDA C++ kernel (``csrc/multistrain_tsit5.cu``); ``ensemble_solve_kernel`` does
the same for any rows-RHS in one Triton kernel (``generic_triton.py``). On CPU
tensors both run their plain PyTorch versions; on CUDA tensors they launch the
kernel or raise.
"""

from .generic import (
    RowsRHS,
    ensemble_solve_kernel,
    ensemble_solve_kernel_reference,
    pack_rows,
    unpack_rows,
)
from .multistrain import (
    ensemble_solve_reference,
    ensemble_solve_tsit5,
    multistrain_rows_rhs,
    pack_params,
    pack_state,
    unpack_saves,
)

__all__ = [
    "RowsRHS",
    "ensemble_solve_tsit5",
    "ensemble_solve_reference",
    "ensemble_solve_kernel",
    "ensemble_solve_kernel_reference",
    "multistrain_rows_rhs",
    "pack_rows",
    "unpack_rows",
    "pack_state",
    "pack_params",
    "unpack_saves",
]
