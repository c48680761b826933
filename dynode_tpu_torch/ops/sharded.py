"""The whole-solve ensemble kernels over a mesh.

Port of ``dynode_tpu/ops/sharded.py``. Ensemble members are independent,
so a mesh splits the member axis: each device of the mesh axis launches
the one-card entry point on its shard (kernels #1 and #3 of
``generic_triton.py``, #4 ``csrc/seip_rk4.cu`` and #5 ``csrc/seip_bs3.cu``),
and the shards' saves come back concatenated along the member axis on the
mesh's first device (:mod:`dynode_tpu_torch.parallel.mesh`; JAX leaves
them sharded). Adaptive statistics concatenate device by device along the
block axis.

Every constraint is checked before the first launch and raises
``ValueError`` with its numbers: the member count must divide over the
mesh axis, and each entry's own arguments must be valid. ``packed=True``
SEIP saves are refused: the packed member tiles are per shard and would
not concatenate to the whole batch's.

Numerics, as in JAX:

- the constant-step kernels give each member one lane for the whole
  solve, so a split solve equals the unsplit one bit for bit;
- the adaptive kernels share one dt chain per block of ``block_b``
  members. A ``block_b`` that divides the per-device batch keeps the
  blocks, and the split solve is bit for bit; otherwise a shard's last
  block is ragged (the kernels mask it), the blocks differ, and the split
  solve agrees only to the solve tolerance.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils._pytree as pytree

from ..parallel.mesh import Mesh, gather_shards, run_shards, shard_plan, split
from . import generic as _generic
from . import seip as _seip

__all__ = [
    "ensemble_solve_kernel_sharded",
    "ensemble_solve_kernel_adaptive_sharded",
    "seip_ensemble_solve_sharded",
    "seip_ensemble_solve_adaptive_sharded",
]


def _run_rows(entry, rhs, y0_rows, p_rows, mesh, axis_name, kwargs):
    plan = shard_plan(mesh, axis_name, y0_rows.shape[1], "ensemble")
    outs = run_shards(plan, lambda s: entry(rhs, split(y0_rows, plan, s, 1), split(p_rows, plan, s, 1), **kwargs))
    return plan, outs


def ensemble_solve_kernel_sharded(
    rhs: Callable,
    y0_rows,
    p_rows=None,
    *,
    mesh: Mesh,
    axis_name: str = "ensemble",
    **kwargs,
):
    """:func:`~.generic.ensemble_solve_kernel` with the members split over
    ``axis_name`` of ``mesh``.

    ``y0_rows`` ``(R, B)`` and ``p_rows`` ``(P, B)`` as for the one-card
    entry, ``B`` divisible by the axis size; each device solves its
    ``B / n`` members (kernel #1 on a card). Returns the
    ``(n_saves, rows, B)`` saves on the mesh's first device. Every keyword
    of the one-card entry is passed on.
    """
    y0_rows, p_rows = _generic.solve_args(y0_rows, p_rows, **kwargs)[:2]
    plan, outs = _run_rows(_generic.ensemble_solve_kernel, rhs, y0_rows, p_rows, mesh, axis_name, kwargs)
    return gather_shards(plan, outs, dim=-1)


def ensemble_solve_kernel_adaptive_sharded(
    rhs: Callable,
    y0_rows,
    p_rows=None,
    *,
    mesh: Mesh,
    axis_name: str = "ensemble",
    **kwargs,
):
    """:func:`~.generic.ensemble_solve_kernel_adaptive` split over a mesh
    axis (kernel #3 on a card).

    Returns ``(saves, stats)`` as the one-card entry: the saves on the
    mesh's first device, each per-block statistic the devices' blocks
    concatenated in mesh order. Bit for bit with the unsplit solve when
    ``block_b`` divides the per-device batch (the module docstring).
    """
    y0_rows, p_rows = _generic.adaptive_solve_args(y0_rows, p_rows, **kwargs)[:2]
    plan, outs = _run_rows(_generic.ensemble_solve_kernel_adaptive, rhs, y0_rows, p_rows, mesh, axis_name, kwargs)
    return gather_shards(plan, {s: o[0] for s, o in outs.items()}, dim=-1), \
        gather_shards(plan, {s: o[1] for s, o in outs.items()}, dim=0)


def _refuse_packed(kwargs) -> None:
    if kwargs.get("packed"):
        raise ValueError(
            "packed=True is a per-device layout; use packed=False when splitting over a mesh "
            "(or pack each shard)"
        )


def _run_seip(entry, y0, params, beta_scales, mesh, axis_name, kwargs):
    scales = torch.as_tensor(beta_scales)
    plan = shard_plan(mesh, axis_name, int(scales.shape[-1]), "ensemble")
    # y0 and the parameters are shared: one copy per device of the plan
    copies = {}

    def on(dev):
        if dev not in copies:
            move = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x  # noqa: E731
            copies[dev] = (tuple(move(torch.as_tensor(c)) for c in y0), pytree.tree_map(move, params))
        return copies[dev]

    for s in plan.local:
        on(plan.place(s))
    outs = run_shards(plan, lambda s: entry(*on(plan.place(s)), split(scales, plan, s, scales.ndim - 1), **kwargs))
    return plan, outs


def seip_ensemble_solve_sharded(
    y0,
    params,
    beta_scales,
    *,
    mesh: Mesh,
    axis_name: str = "ensemble",
    **kwargs,
):
    """:func:`~.seip.seip_ensemble_solve` split over a mesh axis (kernel
    #4 on a card).

    ``beta_scales`` (``(B,)`` or ``(L, B)``) is split along its member
    axis; ``y0`` and ``params`` are copied to each device. Returns the
    member-last saves on the mesh's first device. ``packed=True`` raises.
    """
    _refuse_packed(kwargs)
    _seip.rk4_args(y0, params, beta_scales, **kwargs)
    plan, outs = _run_seip(_seip.seip_ensemble_solve, y0, params, beta_scales, mesh, axis_name, kwargs)
    return gather_shards(plan, outs, dim=-1)


def seip_ensemble_solve_adaptive_sharded(
    y0,
    params,
    beta_scales,
    *,
    mesh: Mesh,
    axis_name: str = "ensemble",
    **kwargs,
):
    """:func:`~.seip.seip_ensemble_solve_adaptive` split over a mesh axis
    (kernel #5 on a card).

    Returns ``(outs, stats)`` as the one-card entry, the per-block
    statistics concatenated device by device. Bit for bit with the unsplit
    solve when ``block_b`` divides the per-device batch.
    """
    _refuse_packed(kwargs)
    _seip.bs3_args(y0, params, beta_scales, **kwargs)
    plan, outs = _run_seip(_seip.seip_ensemble_solve_adaptive, y0, params, beta_scales, mesh, axis_name, kwargs)
    return gather_shards(plan, {s: o[0] for s, o in outs.items()}, dim=-1), \
        gather_shards(plan, {s: o[1] for s, o in outs.items()}, dim=0)
