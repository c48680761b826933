"""Model comparison: PSIS-LOO, WAIC, and compare().

Port of ``dynode_tpu/infer/model_comparison.py`` (numpy in float64, as
there; a tensor goes to the CPU first). Standalone replacements for the ``az.loo`` / ``az.waic`` / ``az.compare``
workflow a reference user reaches through the arviz export path
(reference: src/dynode/infer/inference.py:208-241 returns an
``az.InferenceData`` whose log_likelihood group feeds exactly these).

Algorithms implemented from the literature:

- PSIS (Pareto-smoothed importance sampling): Vehtari, Simpson, Gelman,
  Yao & Gabry, "Pareto smoothed importance sampling" (2015/2021). The
  raw importance ratios 1/p(y_i | theta_s) have infinite variance for
  thin-tailed likelihoods; PSIS fits a generalized Pareto distribution
  to the ratio tail and replaces the tail ratios with the fitted
  quantiles, with the shape estimate ``k`` doubling as a reliability
  diagnostic (k > 0.7 => the estimate for that observation is unstable).
- Generalized-Pareto fit: Zhang & Stephens (2009) empirical-Bayes
  profile-likelihood estimator (the same estimator Stan's loo package
  and arviz use), with the n-dependent weak prior that regularizes
  small tails.
- WAIC: Watanabe (2010) / Gelman, Hwang & Vehtari (2014): elpd_i =
  lpd_i - var_s(log p(y_i | theta_s)).

Everything here is host-side f64 numpy: these are post-fit diagnostics
over a (draws, observations) matrix that is small next to the fit
itself, and f64 host reductions are a repo-wide invariant (the f32
strided-mean hazard documented in diagnostics.summary).
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """``x`` as a float64 numpy array; a tensor goes to the CPU first."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _logsumexp(a: np.ndarray, axis=None) -> np.ndarray:
    amax = np.max(a, axis=axis, keepdims=True)
    amax = np.where(np.isfinite(amax), amax, 0.0)
    out = np.log(np.sum(np.exp(a - amax), axis=axis)) + np.squeeze(amax, axis=axis)
    return out


def _gpd_fit(x: np.ndarray):
    """Empirical-Bayes generalized-Pareto fit (Zhang & Stephens 2009).

    ``x`` is the ascending-sorted tail-excess sample (all > 0). Returns
    ``(k, sigma)`` for the GPD parameterized with cdf
    ``1 - (1 + k z / sigma)^(-1/k)``. The profile likelihood is over
    ``b = -k / sigma``; the posterior mean over a data-driven grid of b
    gives a stable estimate even for tails of a few dozen points. A weak
    prior nudges k toward 0.5 for tiny samples (the loo-package
    regularization), which only strengthens the diagnostic's bias toward
    flagging unreliable tails.
    """
    n = x.size
    prior_b_scale = 3.0
    prior_k_obs = 10.0
    m = 30 + int(np.sqrt(n))
    # grid of candidate b values around the sample scale
    quart = x[int(n / 4.0 + 0.5) - 1]
    bs = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    bs = bs / (prior_b_scale * quart) + 1.0 / x[-1]
    # profile log-likelihood at each b: k(b) = mean(log1p(-b x))
    ks = np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)
    logL = n * (np.log(-bs / ks) - ks - 1.0)
    w = np.exp(logL - logL.max())  # posterior weights over the b grid
    w[w < 10.0 * np.finfo(np.float64).eps] = 0.0
    w = w / w.sum()
    b_post = np.sum(bs * w)
    k_post = np.mean(np.log1p(-b_post * x))
    # weak prior: shrink k toward 0.5 with prior_k_obs pseudo-observations
    k_post = (n * k_post + prior_k_obs * 0.5) / (n + prior_k_obs)
    sigma = -k_post / b_post
    return float(k_post), float(sigma)


def _gpd_quantiles(p: np.ndarray, k: float, sigma: float) -> np.ndarray:
    """Inverse cdf of the GPD above; p strictly inside (0, 1)."""
    if abs(k) < 1e-12:
        return sigma * (-np.log1p(-p))
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def psislw(log_weights: np.ndarray, reff: float = 1.0):
    """Pareto-smoothed, self-normalized log importance weights.

    Parameters
    ----------
    log_weights : (draws,) or (draws, n_obs) array of raw log ratios
        (for LOO: ``-log p(y_i | theta_s)``).
    reff : relative MCMC efficiency (ESS / draws); scales the tail size.

    Returns ``(smoothed_log_weights, pareto_k)`` where the weights are
    normalized per column (``logsumexp == 0``) and ``pareto_k`` is the
    fitted GPD shape per column (inf when the tail was too short to fit).
    """
    lw = _host(log_weights).copy()
    one_d = lw.ndim == 1
    if one_d:
        lw = lw[:, None]
    s, n_obs = lw.shape
    # tail size: the PSIS paper's min(S/5, 3 sqrt(S / reff))
    n_tail = int(np.ceil(min(s / 5.0, 3.0 * np.sqrt(s / max(reff, 1e-12)))))
    ks = np.full(n_obs, np.inf)
    log_tiny = np.log(np.finfo(np.float64).tiny)
    for i in range(n_obs):
        x = lw[:, i]
        x -= x.max()
        if x.min() == 0.0:
            # constant ratios (e.g. a masked observation whose log-lik was
            # zeroed): plain importance sampling is exact, there is no tail
            # to smooth -- report k = -inf (benign) instead of the inf that
            # would trip the "unreliable" warning for a healthy fit
            ks[i] = -np.inf
            x -= _logsumexp(x)
            lw[:, i] = x
            continue
        if n_tail >= 5 and s - n_tail >= 1:
            xs = np.sort(x)
            cutoff = max(xs[-n_tail - 1], log_tiny)
            tail_ids = np.where(x > cutoff)[0]
            xt = x[tail_ids]
            if xt.size > 4:
                order = np.argsort(xt)
                excess = np.exp(xt[order]) - np.exp(cutoff)
                k, sigma = _gpd_fit(excess)
                ks[i] = k
                if np.isfinite(k) and sigma > 0:
                    probs = (np.arange(1, xt.size + 1) - 0.5) / xt.size
                    sm = np.log(
                        _gpd_quantiles(probs, k, sigma) + np.exp(cutoff)
                    )
                    new_tail = np.empty_like(xt)
                    new_tail[order] = sm
                    x[tail_ids] = new_tail
        np.minimum(x, 0.0, out=x)  # no single weight above the max
        x -= _logsumexp(x)
        lw[:, i] = x
    if one_d:
        return lw[:, 0], float(ks[0])
    return lw, ks


@dataclass
class ELPDData:
    """Result of :func:`loo` or :func:`waic` (arviz's ELPDData analog)."""

    kind: str  # "loo" | "waic"
    elpd: float
    se: float
    p: float  # effective number of parameters
    n_samples: int
    n_data_points: int
    elpd_i: np.ndarray = field(repr=False)
    pareto_k: Optional[np.ndarray] = field(default=None, repr=False)
    warning: bool = False

    def __repr__(self):
        lines = [
            f"Computed from {self.n_samples} posterior draws and "
            f"{self.n_data_points} observations.",
            f"  elpd_{self.kind}: {self.elpd:10.2f}  (se {self.se:.2f})",
            f"  p_{self.kind}:    {self.p:10.2f}",
        ]
        if self.pareto_k is not None:
            n_bad = int(np.sum(self.pareto_k > 0.7))
            lines.append(
                f"  pareto_k: max {np.max(self.pareto_k):.3f}, "
                f"{n_bad} of {self.n_data_points} > 0.7"
            )
        if self.warning:
            lines.append("  WARNING: estimates may be unreliable (see above)")
        return "\n".join(lines)


LogLikInput = Union[np.ndarray, Dict[str, np.ndarray], "object"]


def _pointwise_matrix(log_lik: LogLikInput) -> np.ndarray:
    """Coerce supported inputs to an f64 (draws, n_obs) matrix.

    Accepts the dict returned by :func:`dynode_tpu_torch.infer.log_likelihood`
    (sites flattened over their observation dims and concatenated), a
    plain ``(draws, *obs)`` array, or an :class:`InferenceData` with a
    ``log_likelihood`` group.
    """
    if hasattr(log_lik, "log_likelihood") and not isinstance(
        log_lik, (dict, np.ndarray)
    ):
        group = log_lik.log_likelihood
        if not group:
            raise AssertionError("InferenceData has no log_likelihood group")
        log_lik = group
    if isinstance(log_lik, dict):
        mats = []
        for arr in log_lik.values():
            a = _host(arr)
            mats.append(a.reshape(a.shape[0], -1))
        return np.concatenate(mats, axis=1)
    a = _host(log_lik)
    if a.ndim == 1:
        a = a[:, None]
    return a.reshape(a.shape[0], -1)


def _reff_from_chains(ll: np.ndarray, n_chains: int) -> float:
    """Relative efficiency: mean per-obs ESS of the loglik / total draws."""
    from .diagnostics import effective_sample_size

    s, n_obs = ll.shape
    per_chain = s // n_chains
    by_chain = ll[: n_chains * per_chain].reshape(n_chains, per_chain, n_obs)
    # subsample obs columns for the estimate; ESS is O(S log S) per column
    cols = range(0, n_obs, max(1, n_obs // 32))
    esss = [effective_sample_size(by_chain[:, :, j]) for j in cols]
    esss = [e for e in esss if np.isfinite(e)]
    if not esss:
        return 1.0
    return float(np.clip(np.mean(esss) / s, 1e-3, 1.0))


def loo(
    log_lik: LogLikInput,
    *,
    reff: Optional[float] = None,
    n_chains: int = 1,
) -> ELPDData:
    """PSIS-LOO expected log pointwise predictive density (``az.loo``).

    ``log_lik`` holds log p(y_i | theta_s) with draws leading (chains
    stacked into the draw axis; pass ``n_chains`` so the tail-size
    relative efficiency can account for autocorrelation, or pin ``reff``
    directly). Warns (``.warning``) when any Pareto k exceeds 0.7.
    """
    ll = _pointwise_matrix(log_lik)
    s, n = ll.shape
    if reff is None:
        reff = 1.0 if n_chains <= 1 else _reff_from_chains(ll, n_chains)
    lw, ks = psislw(-ll, reff=reff)
    elpd_i = _logsumexp(lw + ll, axis=0)
    lpd_i = _logsumexp(ll, axis=0) - np.log(s)
    p_loo = float(np.sum(lpd_i - elpd_i))
    elpd = float(np.sum(elpd_i))
    se = float(np.sqrt(n * np.var(elpd_i, ddof=1))) if n > 1 else 0.0
    warning = bool(np.any(ks > 0.7))
    if warning:
        import warnings

        warnings.warn(
            f"PSIS-LOO: {int(np.sum(ks > 0.7))}/{n} observations have "
            "pareto_k > 0.7; their elpd contributions are unreliable. "
            "Consider moment matching or exact refits for those points.",
            stacklevel=2,
        )
    return ELPDData(
        kind="loo",
        elpd=elpd,
        se=se,
        p=p_loo,
        n_samples=s,
        n_data_points=n,
        elpd_i=elpd_i,
        pareto_k=ks,
        warning=warning,
    )


def waic(log_lik: LogLikInput) -> ELPDData:
    """WAIC elpd (``az.waic``): lpd_i - var_s(log p(y_i | theta_s))."""
    ll = _pointwise_matrix(log_lik)
    s, n = ll.shape
    lpd_i = _logsumexp(ll, axis=0) - np.log(s)
    p_i = np.var(ll, axis=0, ddof=1)
    elpd_i = lpd_i - p_i
    warning = bool(np.any(p_i > 0.4))
    if warning:
        import warnings

        warnings.warn(
            "WAIC: some pointwise p_waic > 0.4; the variance-based "
            "penalty is unreliable there — prefer loo().",
            stacklevel=2,
        )
    return ELPDData(
        kind="waic",
        elpd=float(np.sum(elpd_i)),
        se=float(np.sqrt(n * np.var(elpd_i, ddof=1))) if n > 1 else 0.0,
        p=float(np.sum(p_i)),
        n_samples=s,
        n_data_points=n,
        elpd_i=elpd_i,
        warning=warning,
    )


def loo_pit(
    y: np.ndarray,
    y_rep: np.ndarray,
    log_lik: LogLikInput,
    *,
    reff: float = 1.0,
) -> np.ndarray:
    """Leave-one-out probability integral transform (``az.loo_pit``).

    Calibration check: for each observation, the PSIS-weighted fraction
    of posterior-predictive replicates at or below the observed value,
    ``pit_i = sum_s w_si 1[y_rep_si <= y_i]``. If the model is
    calibrated, the pit values are ~Uniform(0, 1); U-shapes mean the
    predictive is too narrow (overconfident — the Poisson-on-
    overdispersed-counts failure), humps mean too wide.

    ``y``: observed values, any shape with N total points. ``y_rep``:
    posterior-predictive draws, ``(draws, *y.shape)`` (e.g. the
    ``posterior_predictive`` group site). ``log_lik``: matching pointwise
    log-likelihood (same draws), any :func:`loo` input form. For discrete
    data the PIT is conservative at ties (uses <=, matching arviz).
    """
    ll = _pointwise_matrix(log_lik)
    yr = _host(y_rep).reshape(ll.shape[0], -1)
    yo = _host(y).ravel()
    if yr.shape != ll.shape:
        raise AssertionError((yr.shape, ll.shape))
    if yo.shape[0] != ll.shape[1]:
        raise AssertionError((yo.shape, ll.shape))
    lw, _ = psislw(-ll, reff=reff)
    return np.sum(np.exp(lw) * (yr <= yo[None, :]), axis=0)


def compare(
    models: Dict[str, Union[ELPDData, LogLikInput]],
    *,
    ic: str = "loo",
) -> Dict[str, Dict[str, float]]:
    """Rank models by elpd (``az.compare``).

    ``models`` maps name -> :class:`ELPDData` (from :func:`loo`/:func:`waic`)
    or a raw log-likelihood input (scored with ``ic``). Returns an
    insertion-ordered dict, best first, with per-model ``rank``, ``elpd``,
    ``p``, ``elpd_diff`` (best minus this), ``dse`` (paired SE of that
    difference — the honest yardstick: elpd_i differences are correlated
    across models, so dse << naive sqrt(se1^2+se2^2)), ``se``, ``weight``
    (pseudo-BMA), and ``warning``.
    """
    if ic not in ("loo", "waic"):
        raise AssertionError(ic)
    scored: Dict[str, ELPDData] = {}
    for name, m in models.items():
        if isinstance(m, ELPDData):
            scored[name] = m
        else:
            scored[name] = loo(m) if ic == "loo" else waic(m)
    kinds = {e.kind for e in scored.values()}
    if len(kinds) != 1:
        raise AssertionError(f"cannot compare across criteria: {kinds}")
    npoints = {e.n_data_points for e in scored.values()}
    if len(npoints) != 1:
        raise AssertionError(f"models score different observation sets: {npoints}")
    n = npoints.pop()
    order = sorted(scored, key=lambda k: scored[k].elpd, reverse=True)
    best = scored[order[0]]
    # pseudo-BMA weights (no BB regularization): softmax of elpd
    elpds = np.array([scored[k].elpd for k in order])
    w = np.exp(elpds - elpds.max())
    w /= w.sum()
    out: Dict[str, Dict[str, float]] = {}
    for rank, name in enumerate(order):
        e = scored[name]
        diff_i = best.elpd_i - e.elpd_i
        dse = float(np.sqrt(n * np.var(diff_i, ddof=1))) if rank else 0.0
        out[name] = {
            "rank": rank,
            "elpd": e.elpd,
            "p": e.p,
            "elpd_diff": float(best.elpd - e.elpd),
            "dse": dse,
            "se": e.se,
            "weight": float(w[rank]),
            "warning": bool(e.warning),
        }
    return out


__all__ = ["psislw", "loo", "waic", "loo_pit", "compare", "ELPDData"]
