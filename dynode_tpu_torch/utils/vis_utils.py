"""Matplotlib fit-visualization helpers.

Port of ``dynode_tpu/utils/vis_utils.py``: a region x metric overview grid
drawn from a tidy DataFrame with per-chain-particle thin lines and a median
overlay, a posterior-correlation grid (annotated upper triangle, regression
lower triangle, histogram diagonal), per-chain trace plots, sampled-prior
histograms, prior-vs-posterior violins and shaded posterior densities.
Every function returns the matplotlib Figure.

Inputs may be tensors on any device or numpy arrays: each function moves
them to host numpy once, at its top. matplotlib and pandas are imported
inside the functions that draw, so the compute path never needs them; on a
machine without them a ``plot_*`` call raises ``ImportError`` naming the
missing package.
"""

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .utils import drop_keys_with_substring, flatten_list_parameters

_DEFAULT_STYLE: List[str] = ["seaborn-v0_8-colorblind"]


class VisualizationError(Exception):
    """Raised when a plot is requested for data that cannot be plotted."""


def _plt():
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError("the plot_* functions need matplotlib, which is not installed") from err
    matplotlib.use(matplotlib.get_backend() or "Agg")
    import matplotlib.pyplot as plt

    return plt


def _pandas():
    try:
        import pandas as pd
    except ImportError as err:
        raise ImportError("plot_model_overview_subplot_matplotlib needs pandas, which is not installed") from err
    return pd


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a bfloat16 tensor as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _host_dict(d: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in d.items()}


def _square_grid(n: int):
    """Square-ish (rows, cols) layout for n panels (reference convention)."""
    ncols = int(np.ceil(np.sqrt(max(n, 1))))
    nrows = int(np.ceil(max(n, 1) / ncols))
    return nrows, ncols


def _cleanup_and_normalize_timeseries(df, plot_types, plot_normalizations, region_pop_sizes):
    """Zero near-zero float values and apply per-capita normalization.

    A normalization of 1 leaves values untouched; N>1 scales each region's
    matching columns by N / region_population (e.g. per-100k incidence).
    """
    float_cols = [c for c in df.columns if df[c].dtype.kind == "f"]
    df[float_cols] = df[float_cols].mask(np.isclose(df[float_cols], 0, atol=1e-4), 0)
    for plot_type, norm in zip(plot_types, plot_normalizations):
        if norm <= 1:
            continue
        cols = [c for c in df.columns if plot_type in c]
        for region, pop in region_pop_sizes.items():
            df.loc[df["region"] == region, cols] *= norm / pop
    return df


def plot_model_overview_subplot_matplotlib(
    timeseries_df,
    pop_sizes: Dict[str, int],
    plot_types: Optional[np.ndarray] = None,
    plot_titles: Optional[np.ndarray] = None,
    plot_normalizations: Optional[np.ndarray] = None,
    matplotlib_style: Union[List[str], str, None] = None,
):
    """Overview grid: one row per metric, one column per region.

    ``timeseries_df`` is a tidy DataFrame with at least the columns
    ``["date", "chain_particle", "region"]`` plus one column per metric
    timeseries. Each metric row matches columns by substring (so
    ``"vaccination_"`` collects ``vaccination_0_17`` etc.); every
    chain_particle draws as a thin transparent line with the cross-particle
    median overlaid.
    """
    plt = _plt()
    pd = _pandas()

    if plot_types is None:
        plot_types = np.array(
            [
                "seasonality_coef",
                "vaccination_",
                "_external_introductions",
                "_strain_proportion",
                "_average_immunity",
                "total_infection_incidence",
                "pred_hosp_",
            ]
        )
    if plot_titles is None:
        plot_titles = plot_types.copy()
    if plot_normalizations is None:
        plot_normalizations = np.ones(len(plot_types), dtype=int)
    style = matplotlib_style or _DEFAULT_STYLE

    required = ["date", "chain_particle", "region"]
    missing = [c for c in required if c not in timeseries_df.columns]
    if missing:
        raise AssertionError(
            f"missing a necessary column within timeseries_df, require "
            f"{required} but got {list(timeseries_df.columns)}"
        )

    plot_types = np.asarray(plot_types)
    plot_titles = np.asarray(plot_titles)
    plot_normalizations = np.asarray(plot_normalizations)
    present = np.array([any(pt in col for col in timeseries_df.columns) for pt in plot_types])
    plot_types = plot_types[present]
    plot_titles = plot_titles[present]
    plot_normalizations = plot_normalizations[present]
    if len(plot_types) == 0:
        raise VisualizationError("none of the requested plot_types appear in timeseries_df")

    df = _cleanup_and_normalize_timeseries(timeseries_df.copy(), plot_types, plot_normalizations, pop_sizes)
    regions = list(df["region"].unique())
    with plt.style.context(style):
        fig, axes = plt.subplots(
            nrows=len(plot_types),
            ncols=len(regions),
            sharex=True,
            sharey="row",
            squeeze=False,
            figsize=(6 * len(regions), 3 * len(plot_types)),
        )
    # parse dates once; the per-particle loop below reuses this column
    df = df.assign(_dt=pd.to_datetime(df["date"]))
    for col_i, region in enumerate(regions):
        rsel = df["region"] == region
        for row_i, (title, ptype) in enumerate(zip(plot_titles, plot_types)):
            ax = axes[row_i][col_i]
            metric_cols = [c for c in df.columns if ptype in c]
            for mcol in metric_cols:
                # short legend labels: strip the shared plot_type prefix
                # when a row plots several columns
                label = mcol.replace(ptype, "") if len(metric_cols) > 1 else mcol
                for _, particle_df in df[rsel].groupby("chain_particle"):
                    ax.plot(particle_df["_dt"], particle_df[mcol], alpha=0.3, lw=0.25)
                med = df[rsel].groupby("date")[mcol].median()
                ax.plot(pd.to_datetime(med.index), med.values, lw=2, label=label)
            ax.set_title(f"{region}: {title}" if row_i == 0 else title)
            if len(metric_cols) > 1:
                ax.legend(fontsize=6)
    fig.tight_layout()
    return fig


def plot_checkpoint_inference_correlation_pairs(
    posteriors_in: Dict[str, Any],
    max_samples_calculated: int = 100,
    matplotlib_style: Union[List[str], str, None] = None,
):
    """Pairwise posterior grid: scatter + regression (lower), correlation
    annotation sized and coloured by magnitude (upper), histogram (diagonal).

    ``posteriors_in`` values are (num_chains, num_samples[, *plate]); plated
    sites are flattened to ``name_i`` entries and ``timestep`` sites dropped.
    Correlations, regression lines and histograms use the full posterior;
    the ``max_samples_calculated`` per-chain cap only thins the rendered
    scatter points (``-1`` draws every draw), picked with numpy's global
    generator.
    """
    plt = _plt()
    from matplotlib.colors import LinearSegmentedColormap

    posteriors = flatten_list_parameters(_host_dict(posteriors_in))
    posteriors = drop_keys_with_substring(posteriors, "timestep")
    names = list(posteriors)
    if not names:
        raise VisualizationError("no posterior sites to correlate")
    num_samples = posteriors[names[0]].shape[1]
    cols = {k: np.asarray(m).flatten() for k, m in posteriors.items()}
    if max_samples_calculated != -1 and num_samples > max_samples_calculated:
        pick = np.random.choice(num_samples, size=max_samples_calculated, replace=False)
        scatter_cols = {k: np.asarray(m[:, pick]).flatten() for k, m in posteriors.items()}
    else:
        scatter_cols = cols
    n = len(names)
    label_size = max(2, min(10, 200 / n))
    mat = np.stack([cols[k] for k in names])
    corr = np.atleast_2d(np.corrcoef(mat))  # 0-d for a single site
    cmap = LinearSegmentedColormap.from_list("", ["red", "grey", "blue"])

    style = matplotlib_style or _DEFAULT_STYLE
    with plt.style.context(style):
        fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n), squeeze=False)
    for i in range(n):
        for j in range(n):
            ax = axes[i][j]
            r = corr[i, j]
            color = cmap((r + 1) / 2)
            if i == j:
                ax.hist(cols[names[i]], bins=20, density=True)
            elif i > j:
                ax.scatter(scatter_cols[names[j]], scatter_cols[names[i]], s=0.5, alpha=0.2)
                x, y = cols[names[j]], cols[names[i]]
                slope, intercept = np.polyfit(x, y, 1)
                xs = np.linspace(x.min(), x.max(), 16)
                ax.plot(xs, slope * xs + intercept, color=color, lw=1)
            else:
                ax.annotate(
                    f"{r:.2f}",
                    xy=(0.5, 0.5),
                    xycoords="axes fraction",
                    ha="center",
                    color=color,
                    size=label_size * abs(r) + label_size,
                )
                ax.set_axis_off()
            if i == n - 1:
                ax.set_xlabel(names[j], size=label_size, rotation=90)
            if j == 0:
                ax.set_ylabel(names[i], size=label_size, rotation=0)
            ax.tick_params(labelsize=label_size)
            if i < n - 1:
                ax.set_xticklabels([])
            if j > 0:
                ax.set_yticklabels([])
    fig.tight_layout(pad=0.1)
    return fig


def plot_mcmc_chains(
    samples_in: Dict[str, Any],
    matplotlib_style: Union[List[str], str, None] = None,
):
    """Trace plots: a square-ish grid, one panel per (flattened) site, one
    line per chain. ``samples_in`` values are (num_chains, num_samples[, *plate])."""
    plt = _plt()
    samples = flatten_list_parameters(_host_dict(samples_in))
    samples = drop_keys_with_substring(samples, "timestep")
    names = list(samples)
    if not names:
        raise VisualizationError("no sample sites to plot")
    num_params = len(names)
    nrows, ncols = _square_grid(num_params)
    style = matplotlib_style or _DEFAULT_STYLE
    with plt.style.context(style):
        fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 3 * nrows), squeeze=False)
    flat_axes = axes.flatten()
    for i, name in enumerate(names):
        ax = flat_axes[i]
        arr = np.atleast_2d(samples[name])
        for c in range(arr.shape[0]):
            ax.plot(arr[c], lw=0.7, label=f"chain {c}")
        ax.set_title(name, fontsize=8)
        if i < num_params - ncols:
            ax.set_xticklabels([])
    for ax in flat_axes[num_params:]:
        ax.axis("off")
    handles, labels = flat_axes[num_params - 1].get_legend_handles_labels()
    fig.legend(handles, labels, loc="upper center", ncol=4, fontsize=6)
    fig.tight_layout()
    return fig


def _sample_prior_distributions(priors: Dict, num_samples: int):
    """Draw ``num_samples`` from every Distribution leaf in a params dict.

    Key naming follows the sampling convention: distributions nested in
    lists get ``_i`` index suffixes. The draws come from one CPU
    ``torch.Generator`` seeded with 0, site after site.
    """
    from .utils import identify_distribution_indexes

    idx_map = identify_distribution_indexes(priors)
    generator = torch.Generator().manual_seed(0)
    out = {}
    for site, where in idx_map.items():
        target = priors[where["sample_name"]]
        if where["sample_idx"] is not None:
            for i in where["sample_idx"]:
                target = target[i]
        out[site] = _host(target.sample(generator, (num_samples,)))
    return out


def plot_prior_distributions(
    priors: Dict,
    matplotlib_style: Union[List[str], str, None] = None,
    num_samples: int = 5000,
    hist_kwargs: Optional[dict] = None,
    median_line_kwargs: Optional[dict] = None,
):
    """Histograms (with median line) of every Distribution found in ``priors``."""
    plt = _plt()
    sampled = _sample_prior_distributions(priors, num_samples)
    names = list(sampled)
    if not names:
        raise VisualizationError("Attempted to visualize a config without any distributions")
    hist_kwargs = hist_kwargs or {"bins": 50, "density": True}
    median_line_kwargs = median_line_kwargs or {
        "linestyle": "dotted",
        "linewidth": 3,
        "label": "prior median",
    }
    nrows, ncols = _square_grid(len(names))
    style = matplotlib_style or _DEFAULT_STYLE
    with plt.style.context(style):
        fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 3 * nrows), squeeze=False)
    flat_axes = axes.flatten()
    for i, name in enumerate(names):
        ax = flat_axes[i]
        draws = sampled[name]
        ax.set_title(name, fontsize=8)
        ax.hist(draws, **hist_kwargs)
        ax.axvline(float(np.median(draws)), **median_line_kwargs)
    for ax in flat_axes[len(names):]:
        ax.axis("off")
    handles, labels = flat_axes[len(names) - 1].get_legend_handles_labels()
    fig.legend(handles, labels, loc="upper right", fontsize=6)
    fig.suptitle(f"Prior Distributions Visualized, n={num_samples}")
    fig.tight_layout()
    return fig


def plot_violin_plots(
    priors: Optional[Dict[str, Any]] = None,
    posteriors: Optional[Dict[str, Any]] = None,
    matplotlib_style: Union[List[str], str, None] = None,
):
    """Side-by-side prior vs posterior violins per site; parameters sharing
    a first word share a colour."""
    plt = _plt()
    if priors is None and posteriors is None:
        raise VisualizationError("must provide either a dictionary of priors or posteriors")
    priors = {k: v.reshape(-1) for k, v in _host_dict(priors or {}).items()}
    posteriors = {k: v.reshape(-1) for k, v in _host_dict(posteriors or {}).items()}
    names = list(dict.fromkeys(list(priors) + list(posteriors)))
    nrows, ncols = _square_grid(len(names))
    style = matplotlib_style or _DEFAULT_STYLE
    with plt.style.context(style):
        fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 3 * nrows), squeeze=False)
    flat_axes = axes.flatten()
    first_words = {n.split("_")[0] for n in names}
    cmap = plt.get_cmap("Set2")
    color_of = {w: cmap(i % 8) for i, w in enumerate(sorted(first_words))}
    for i, name in enumerate(names):
        ax = flat_axes[i]
        data, labels = [], []
        for label, src in (("prior", priors), ("posterior", posteriors)):
            if name in src:
                data.append(src[name])
                labels.append(label)
        parts = ax.violinplot(data, showmedians=True)
        for body in parts["bodies"]:
            body.set_facecolor(color_of[name.split("_")[0]])
        ax.set_xticks(range(1, len(labels) + 1))
        ax.set_xticklabels(labels)
        ax.set_title(name, fontsize=8)
    for ax in flat_axes[len(names):]:
        ax.axis("off")
    fig.suptitle("Violin Plot of Parameters")
    fig.tight_layout()
    return fig


def _gaussian_kde_1d(x: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Silverman-bandwidth Gaussian KDE evaluated on ``grid`` (no scipy).

    Accumulates over draw chunks: a dense (grid, draws) matrix at a bank of
    4,096 chains x 1,600 draws would take about 13 GB in float64; the
    chunked sum is the same curve in O(chunk) memory.
    """
    n = x.size
    sd = float(np.std(x, ddof=1)) if n > 1 else 0.0
    q75, q25 = np.percentile(x, [75.0, 25.0])
    iqr = float(q75 - q25)
    scale = min(sd, iqr / 1.349) if iqr > 0 else sd
    if scale <= 0:  # degenerate sample: a spike at the single value
        scale = max(abs(float(x[0])), 1.0) * 1e-3
    bw = 0.9 * scale * n ** (-0.2)
    dens = np.zeros(grid.shape[0], dtype=np.float64)
    chunk = 65536
    for start in range(0, n, chunk):
        z = (grid[:, None] - x[None, start : start + chunk]) / bw
        dens += np.exp(-0.5 * z * z).sum(axis=1)
    return dens / (n * bw * np.sqrt(2 * np.pi))


def plot_posterior_density(
    datas,
    var_names: Optional[List[str]] = None,
    data_labels: Optional[List[str]] = None,
    hdi_prob: float = 0.94,
    shade: float = 0.2,
    point_estimate: Optional[str] = "mean",
    grouped_by_chain: bool = True,
    matplotlib_style: Union[List[str], str, None] = None,
):
    """Shaded posterior density panels (arviz's ``plot_density``).

    ``datas``: a posterior dict (site -> draws), an
    :class:`~dynode_tpu_torch.infer.InferenceData` (its ``posterior`` group
    is used), or a list of either; several fits overlay per panel, labelled
    by ``data_labels``. With ``grouped_by_chain=True`` site arrays lead with
    (chains, draws), the ``get_samples(group_by_chain=True)`` and
    ``InferenceData`` layout; pass ``grouped_by_chain=False`` for flat
    ``get_samples()`` output, whose axis 0 is the draw axis. Scalar sites
    get one panel, plated sites one panel per element, titled
    ``site[i,...]``. Each density is a Gaussian KDE trimmed to the
    ``hdi_prob`` highest-density interval with a ``shade``-alpha fill and
    a ``point_estimate`` ("mean", "median" or None) marker.
    """
    from ..infer.diagnostics import hdi as _hdi

    plt = _plt()
    if not isinstance(datas, (list, tuple)):
        datas = [datas]
    dicts: List[Dict[str, np.ndarray]] = []
    for d in datas:
        if hasattr(d, "posterior") and not isinstance(d, dict):
            d = d.posterior
        if not isinstance(d, dict) or not d:
            raise VisualizationError(
                "plot_posterior_density needs posterior sample dicts or "
                "InferenceData objects with a posterior group"
            )
        dicts.append(_host_dict(d))
    if data_labels is None:
        data_labels = [None] if len(dicts) == 1 else [f"fit {i}" for i in range(len(dicts))]
    if len(data_labels) != len(dicts):
        raise VisualizationError(f"{len(data_labels)} data_labels for {len(dicts)} datasets")
    names = var_names or list(dict.fromkeys(k for d in dicts for k in d))
    lead = 2 if grouped_by_chain else 1  # (chains, draws, *plate) or (draws, *plate)
    # one panel per (site, plate element); draws flatten the leading dims
    panels: List[tuple] = []  # (title, [per-dataset 1-D f64 draws or None])
    for name in names:
        shapes = [d[name].shape[lead:] for d in dicts if name in d]
        if not shapes:
            raise VisualizationError(f"site {name!r} in no dataset")
        plate_shape = shapes[0]
        for idx in np.ndindex(*plate_shape) if plate_shape else [()]:
            title = f"{name}[{','.join(map(str, idx))}]" if idx else name
            cols = []
            for d in dicts:
                if name not in d:
                    cols.append(None)
                    continue
                # float64 before any reduction
                arr = np.asarray(d[name], dtype=np.float64)
                if arr.ndim < lead:
                    arr = arr.reshape((1,) * (lead - arr.ndim) + arr.shape)
                cols.append(arr[(slice(None),) * lead + idx].ravel())
            panels.append((title, cols))
    nrows, ncols = _square_grid(len(panels))
    style = matplotlib_style or _DEFAULT_STYLE
    with plt.style.context(style):
        fig, axes = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 2.6 * nrows), squeeze=False)
        flat_axes = axes.flatten()
        for ax, (title, cols) in zip(flat_axes, panels):
            for j, draws in enumerate(cols):
                if draws is None or draws.size == 0:
                    continue
                lo, hi = _hdi(draws, prob=hdi_prob)
                if hi <= lo:
                    hi = lo + max(abs(lo), 1.0) * 1e-6
                grid = np.linspace(lo, hi, 256)
                dens = _gaussian_kde_1d(draws, grid)
                color = f"C{j % 10}"
                (line,) = ax.plot(grid, dens, color=color, label=data_labels[j])
                if shade > 0:
                    ax.fill_between(grid, dens, color=line.get_color(), alpha=shade)
                if point_estimate:
                    pt = float(np.median(draws)) if point_estimate == "median" else float(np.mean(draws))
                    ax.plot([pt], [0.0], "o", color=line.get_color())
            ax.set_title(title, fontsize=8)
            ax.set_yticks([])
        for ax in flat_axes[len(panels):]:
            ax.axis("off")
        if any(lbl for lbl in data_labels):
            flat_axes[0].legend(fontsize=7)
        fig.tight_layout()
    return fig


__all__ = [
    "VisualizationError",
    "plot_model_overview_subplot_matplotlib",
    "plot_checkpoint_inference_correlation_pairs",
    "plot_mcmc_chains",
    "plot_posterior_density",
    "plot_prior_distributions",
    "plot_violin_plots",
]
