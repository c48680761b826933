"""Forecast bands and resampling of the port (``infer.forecast``).

``member_quantiles`` against ``jnp.quantile`` (the JAX package's
``member_quantiles``) on packed ``(..., 8, B // 8)`` and member-last
layouts, float32 and bfloat16 saves, NaN members: within 1e-6 of the
largest band value (float32; XLA may fuse the interpolation's multiply and
add). ``resample_draws``'s contracts: exact posterior draws, distinct
members without replacement, the generator's stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynode_tpu.infer.forecast import member_quantiles as j_member_quantiles
from dynode_tpu_torch.infer import member_quantiles, resample_draws
from dynode_tpu_torch.infer.forecast import packed_member_axis_size

QS = (0.05, 0.25, 0.5, 0.75, 0.95)


def _check(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = np.nanmax(np.abs(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("layout", ["packed", "member_last", "middle"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_member_quantiles_match_jax(layout, dtype):
    rng = np.random.default_rng(0)
    shape, axes = {"packed": ((4, 3, 8, 16), (-2, -1)), "member_last": ((5, 2, 3, 40), -1),
                   "middle": ((6, 50, 2), 1)}[layout]
    x = torch.as_tensor(rng.gamma(2.0, 10.0, shape), dtype=dtype)
    want = j_member_quantiles(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
                              QS, member_axes=axes)
    _check(member_quantiles(x, QS, member_axes=axes), want)
    _check(member_quantiles(x, torch.tensor([0.0, 1.0]), member_axes=axes),
           j_member_quantiles(jnp.asarray(x.float().numpy()), jnp.asarray([0.0, 1.0]), member_axes=axes))


def test_member_quantiles_propagate_nan_as_jax():
    x = np.arange(2 * 3 * 8, dtype=np.float32).reshape(2, 3, 8)
    x[1, 2, 5] = np.nan
    got = member_quantiles(torch.as_tensor(x), QS, member_axes=-1)
    want = np.asarray(j_member_quantiles(jnp.asarray(x), QS, member_axes=-1))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.numpy()[~np.isnan(want)], want[~np.isnan(want)], rtol=1e-6)
    assert packed_member_axis_size((3, 8, 16)) == 128


def test_resample_draws_contracts():
    draws = torch.arange(40.0).reshape(20, 2)
    gen = torch.Generator().manual_seed(0)
    thin = resample_draws(draws, 12, gen)
    assert thin.shape == (12, 2) and torch.unique(thin[:, 0]).numel() == 12  # distinct members
    assert bool((thin[:, 1] == thin[:, 0] + 1).all())  # whole draws, not mixed coordinates
    wide = resample_draws(draws, 64, gen)
    assert wide.shape == (64, 2) and set(wide[:, 0].tolist()) <= set(draws[:, 0].tolist())
    assert torch.unique(wide[:, 0]).numel() < 64  # with replacement
    assert torch.equal(resample_draws(draws, 12, torch.Generator().manual_seed(0)), thin)  # the generator's stream
    assert torch.equal(resample_draws(draws, 20, torch.Generator().manual_seed(1)).sort(dim=0).values, draws)
