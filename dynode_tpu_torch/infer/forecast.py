"""Posterior-predictive forecasting at ensemble-kernel scale.

Port of ``dynode_tpu/infer/forecast.py``. :class:`~.predictive.Predictive`
replays a model over posterior draws; this module is the fast path for the
case that dominates production forecasting, thousands of forward ODE solves
differing only in sampled parameters:

1. :func:`resample_draws` bootstraps a posterior sample bank to a kernel
   width;
2. the ensemble kernels run the forward ensemble (``ops.seip_ensemble_solve``
   takes per-strain per-member scales directly, ``ops.ensemble_solve_tsit5``
   per-member rates);
3. :func:`member_quantiles` reduces the ensemble to forecast bands on the
   device, so member-resolved trajectories never cross to the host.
"""

from typing import Sequence, Tuple, Union

import torch

__all__ = ["resample_draws", "member_quantiles", "packed_member_axis_size"]


def resample_draws(draws, width: int, generator: torch.Generator) -> torch.Tensor:
    """Bootstrap posterior draws to an ensemble ``width``.

    ``draws``: ``(N, ...)`` tensor of posterior draws (first axis = draw).
    Returns ``(width, ...)`` sampled with replacement (``torch.randint``),
    which keeps every member an exact posterior draw, unlike tiling; when
    ``width <= N``, a without-replacement thinning (``torch.randperm``)
    keeps the members distinct. The indices come from ``generator`` and are
    drawn on its device, so they differ from JAX's for a seed.
    """
    draws = torch.as_tensor(draws)
    n = draws.shape[0]
    if width <= n:
        idx = torch.randperm(n, generator=generator, device=generator.device)[:width]
    else:
        idx = torch.randint(n, (width,), generator=generator, device=generator.device)
    return draws.index_select(0, idx.to(draws.device))


def member_quantiles(
    x: torch.Tensor,
    qs: Union[Sequence[float], torch.Tensor],
    member_axes: Union[int, Tuple[int, ...]] = (-2, -1),
) -> torch.Tensor:
    """Ensemble quantiles over the member axes, on ``x``'s device.

    ``x`` is any ensemble output whose member dimension(s) sit on
    ``member_axes`` -- by default the trailing two, the packed member-tile
    layout ``(..., 8, B // 8)`` of the JAX kernels (quantiles are
    permutation-invariant, so a packed member axis needs no relayout). For
    member-last layouts pass ``member_axes=-1``.

    Returns ``(len(qs), *kept_dims)`` in float32, for bfloat16 saves too,
    as ``jnp.quantile``'s default (linear) method: a sort along the
    members, then ``low * (1 - w) + high * w`` of the order statistics
    ``floor`` and ``ceil`` of ``q * (m - 1)`` with ``w`` its fraction.
    ``torch.quantile`` is not used: it refuses inputs of more than 2**24
    elements.
    """
    if isinstance(member_axes, int):
        member_axes = (member_axes,)
    axes = tuple(a % x.ndim for a in member_axes)
    kept = tuple(i for i in range(x.ndim) if i not in axes)
    m = 1
    for a in axes:
        m *= x.shape[a]
    xt = x.permute(kept + axes).reshape(tuple(x.shape[i] for i in kept) + (m,))
    # sorted in the saves' own dtype (bfloat16 converts to float32 exactly
    # and in order), so only the gathered order statistics are converted
    ordered = torch.sort(xt, dim=-1).values
    q = torch.as_tensor(qs, dtype=torch.float32, device=x.device)
    pos = q * (m - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_weight = pos - low
    low_weight = 1.0 - high_weight
    low = torch.clamp(low, 0, m - 1).long()
    high = torch.clamp(high, 0, m - 1).long()
    low_value = ordered.index_select(-1, low).movedim(-1, 0).float()
    high_value = ordered.index_select(-1, high).movedim(-1, 0).float()
    shape = (q.shape[0],) + (1,) * (low_value.ndim - 1)
    out = low_value * low_weight.reshape(shape) + high_value * high_weight.reshape(shape)
    # a member axis holding a NaN gives NaN at every q, as jnp.quantile
    return torch.where(torch.isnan(xt).any(dim=-1), torch.nan, out)


def packed_member_axis_size(shape: Tuple[int, ...]) -> int:
    """Number of members in a packed ``(..., 8, B // 8)`` kernel output."""
    return shape[-2] * shape[-1]
