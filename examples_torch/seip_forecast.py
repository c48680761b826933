"""Posterior-predictive forecast of the production SEIP model.

The port of examples/seip_forecast.py: fit per-strain transmission scales
with a ChEES bank (seip_fit.py's model), bootstrap the posterior draws to a
kernel-width ensemble, run every member through the adaptive SEIP CUDA
kernel (``seip_ensemble_solve_adaptive``, kernel #5; its plain version on
CPU tensors) past the fitted window, and reduce to forecast bands on the
device: member trajectories never leave it, the quantile summary is a few
KB::

    python examples_torch/seip_forecast.py [--device cpu]

On the card the ensemble is 32 x 1,024 = 32,768 members saved in bf16 in
the packed member layout; on the CPU 1,024 (16 with
``DYNODE_FAST_EXAMPLES=1``) in float32, member-last.
"""

import _bootstrap

import os

import numpy as np
import torch

import seip_fit as fit
from dynode_tpu_torch.infer import member_quantiles, resample_draws
from dynode_tpu_torch.ops.seip import BLOCK, seip_ensemble_solve_adaptive
from dynode_tpu_torch.utils import enable_compilation_cache

QS = (0.05, 0.25, 0.5, 0.75, 0.95)
MIN_CORRELATION = 0.8  # the median against the data inside the fitted window


def horizon(fast: bool) -> int:
    """Days forecast past the fitted window."""
    return 15 if fast else 60


def width(device, fast: bool) -> int:
    """Members of the forecast: a multiple of ``BLOCK`` on the card."""
    if device.type == "cuda":
        return 32 * BLOCK
    return 16 if fast else BLOCK


def forecast_bands(prob, bank, total_days: int) -> dict:
    """Kernel #5 over ``bank`` (L, W) of per-strain scales for
    ``total_days``, then the daily all-ages incidence's quantile bands at
    ``QS``, on the bank's device. Raises if an interval ran out of attempts."""
    on_card = bank.device.type == "cuda"
    outs, stats = seip_ensemble_solve_adaptive(
        prob.y0,
        prob.base,
        bank.to(torch.float32),
        duration=float(total_days),
        rtol=1e-4,
        atol=1e-3,
        save=(3,),  # cumulative-infections compartment only
        save_dtype=torch.bfloat16 if on_card else torch.float32,
        packed=on_card,  # the reductions read the member-tile layout as it is
    )
    exhausted = int(stats["exhausted_intervals"].sum())
    if exhausted:
        raise RuntimeError(f"{exhausted} save intervals ran out of attempts")
    c = outs[0]  # packed (T, A, J, K, L, 8, W // 8) or member-last (..., W)
    # float32 accumulation over the structure dims, never a cast of the wide buffer
    cum = torch.sum(c, dim=(1, 2, 3, 4), dtype=torch.float32)  # (T, 8, W // 8) | (T, W)
    inc = torch.diff(cum, dim=0)
    bands = member_quantiles(inc, QS, member_axes=(-2, -1) if on_card else (-1,))
    return {"c": c, "stats": stats, "bands": bands}


def run(device, fast=False, dtype=torch.float32, obs=None, draws=None, overrides=None, seed: int = 1) -> dict:
    """The fit (unless ``draws`` (N, L) are given), the resampled bank, the
    bands, the fit problem, and the walls of the fit and of the forecast
    (``walls``); ``overrides`` as in ``seip_fit.run``."""
    if device.type == "cuda":
        # built kernels persist across runs in the checkout's build
        # directory; named before the first build
        enable_compilation_cache(os.path.join(_bootstrap.ROOT, "build", "dynode_tpu_torch"))
    prob = fit.problem(device, fast, dtype, obs)
    walls = {}
    if draws is None:
        n = {**fit.counts(fast), **(overrides or {})}
        with _bootstrap.timed(walls, "fit", device):
            proc = fit.fit(prob, chains=n["chains"], warmup=n["warmup"], samples=n["samples"],
                           max_num_steps=n["max_num_steps"], progress_bar=False)
        draws = proc.get_samples()["beta_scales"]
    draws = torch.as_tensor(draws, device=device)
    total_days = prob.fit_days + horizon(fast)
    with _bootstrap.timed(walls, "forecast", device):
        bank = resample_draws(draws, width(device, fast), torch.Generator(device=device).manual_seed(seed)).T
        out = forecast_bands(prob, bank, total_days)  # bank: (L, W)
    obs_total = prob.kwargs["obs_data"].sum(dim=1)
    med_fit = out["bands"][2][: prob.fit_days].double().cpu().numpy()
    corr = float(np.corrcoef(med_fit, obs_total.double().cpu().numpy())[0, 1])
    out.update(draws=draws, bank=bank, obs_total=obs_total, fit_days=prob.fit_days, correlation=corr, walls=walls,
               problem=prob)
    return out


def draw(plt, out):
    bands, obs_total = out["bands"], out["obs_total"]
    t_obs = np.arange(1, obs_total.shape[0] + 1)
    t_all = np.arange(1, bands.shape[1] + 1)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(t_obs, obs_total, ".", ms=4, color="k", label="observed")
    ax.fill_between(t_all, bands[0], bands[-1], alpha=0.2, label="90% band")
    ax.fill_between(t_all, bands[1], bands[-2], alpha=0.3, label="50% band")
    ax.plot(t_all, bands[2], lw=1.5, label="median")
    ax.axvline(obs_total.shape[0], ls="--", lw=1, color="gray")
    ax.set_xlabel("day")
    ax.set_ylabel("daily incidence (all ages)")
    ax.set_title(f"SEIP posterior-predictive forecast: {int(out['width'])} members through the adaptive kernel")
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, _bootstrap.fast_mode(), args.dtype)
    print(f"posterior: {out['draws'].shape[0]} draws, mean {np.round(_bootstrap.host(out['draws'].mean(dim=0)), 3)}")
    print(f"forecast bands {tuple(out['bands'].shape)} from {out['bank'].shape[1]} members")
    print(f"median-vs-data correlation in fit window: {out['correlation']:.3f}")
    _bootstrap.save("seip_forecast", {"bands": out["bands"], "obs_total": out["obs_total"],
                                      "width": out["bank"].shape[1]}, draw)
    if not out["correlation"] > MIN_CORRELATION:
        raise SystemExit(f"the median does not track the data: correlation {out['correlation']:.3f}")
