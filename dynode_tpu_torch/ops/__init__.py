"""Hand-written Hopper kernels of the hot paths, each beside its plain version.

``ensemble_solve_tsit5`` integrates a whole multi-strain SEIRS ensemble in one
CUDA C++ kernel (``csrc/multistrain_tsit5.cu``), and ``ensemble_solve_tsit5_2d``
the same model on the aligned 2-D layout in another (``csrc/multistrain_tsit5_2d.cu``);
``ensemble_solve_kernel`` and ``ensemble_solve_kernel_adaptive`` do a
constant-step and an adaptive (lockstep-dt) solve of any rows-RHS in Triton
kernels (``generic_triton.py``); ``seip_ensemble_solve`` and
``seip_ensemble_solve_adaptive`` solve the SEIP ensemble with RK4 and
lockstep BS3(2) in CUDA C++ (``csrc/seip_rk4.cu``, ``csrc/seip_bs3.cu`` at
the production shape; ``csrc/shapes/seip_rk4_any.cu``, ``seip_bs3_any.cu`` at
any other). The library holds the production shapes' instantiations; every
other shape is built on its own at first use (``_build.shape_library``).
On CPU tensors each runs its plain PyTorch version; on CUDA tensors it
launches the kernel or raises. The four ``*_sharded`` entries
(:mod:`.sharded`) split the members of #1, #3, #4 and #5 over a mesh.
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
from .seip import (
    pack_members,
    seip_ensemble_solve,
    seip_ensemble_solve_adaptive,
    seip_solve_adaptive_reference,
    seip_solve_reference,
    seip_static_params,
    unpack_members,
)
from .sharded import (
    ensemble_solve_kernel_adaptive_sharded,
    ensemble_solve_kernel_sharded,
    seip_ensemble_solve_adaptive_sharded,
    seip_ensemble_solve_sharded,
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
    "pack_members",
    "unpack_members",
    "seip_ensemble_solve",
    "seip_ensemble_solve_adaptive",
    "seip_solve_reference",
    "seip_solve_adaptive_reference",
    "seip_static_params",
    "ensemble_solve_kernel_sharded",
    "ensemble_solve_kernel_adaptive_sharded",
    "seip_ensemble_solve_sharded",
    "seip_ensemble_solve_adaptive_sharded",
]
