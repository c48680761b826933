"""The port's plotting helpers (``dynode_tpu_torch.utils.vis_utils``) against
the JAX package's, on the Agg backend.

Every case of ``tests/test_utils/test_vis.py`` runs here on both packages
with the same numpy inputs (torch tensors for the port where the case
passes arrays), and the two figures must hold the same contents: axes and
their titles and labels, every line's x and y data, every bar's height,
scatter offsets and annotation texts, within 1e-12 or equal. The prior
histograms are drawn from each package's own generator, so there only the
structure must match, and the draws are held by support and moments.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import dynode_tpu.dist as jdist  # noqa: E402
from chip_smoke import in_support  # noqa: E402
import dynode_tpu_torch  # noqa: E402
import dynode_tpu_torch.dist as tdist  # noqa: E402
from dynode_tpu.infer import InferenceData as JInferenceData  # noqa: E402
from dynode_tpu.utils import vis_utils as jvis  # noqa: E402
from dynode_tpu_torch.infer import InferenceData as TInferenceData  # noqa: E402
from dynode_tpu_torch.utils import vis_utils as tvis  # noqa: E402

TOL = 1e-12


def _numbers(x):
    arr = np.asarray(x)
    if arr.dtype.kind in "Mm" or arr.dtype == object:
        return arr.astype(str)
    return arr.astype(np.float64)


def _axis_facts(ax) -> dict:
    return {
        "title": ax.get_title(),
        "xlabel": ax.get_xlabel(),
        "ylabel": ax.get_ylabel(),
        "lines": [(_numbers(ln.get_xdata()), _numbers(ln.get_ydata()), ln.get_label()) for ln in ax.lines],
        "bars": [(p.get_x(), p.get_y(), p.get_width(), p.get_height()) for p in ax.patches],
        "texts": [t.get_text() for t in ax.texts],
        "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
        "offsets": [np.asarray(c.get_offsets(), dtype=np.float64) for c in ax.collections],
        "visible": ax.axison,
    }


def _facts(fig) -> dict:
    return {"axes": [_axis_facts(ax) for ax in fig.axes], "texts": [t.get_text() for t in fig.texts]}


def _same(want, got, path="figure"):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            _same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), f"{path}: {len(want)} vs {len(got)}"
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        assert want.shape == got.shape, path
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=path)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=TOL, abs=TOL), path
    else:
        assert want == got, path


def _tensors(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _both(name, *args, seed=None, torch_args=None, **kwargs):
    """The JAX figure and the port's for the same inputs (``torch_args``
    replaces ``args`` for the port); numpy's global generator seeded with
    ``seed`` before each call where given."""
    figs = []
    for mod, a in ((jvis, args), (tvis, args if torch_args is None else torch_args)):
        if seed is not None:
            np.random.seed(seed)
        figs.append(getattr(mod, name)(*a, **kwargs))
    want, got = (_facts(f) for f in figs)
    for f in figs:
        plt.close(f)
    _same(want, got)
    return got


def _raise_both(name, exc_name, *args, **kwargs):
    for mod in (jvis, tvis):
        exc = getattr(mod, exc_name) if exc_name == "VisualizationError" else AssertionError
        with pytest.raises(exc):
            getattr(mod, name)(*args, **kwargs)


def _overview_df(regions=("US", "EU"), particles=4, days=20):
    rng = np.random.default_rng(0)
    rows = []
    dates = pd.date_range("2022-02-11", periods=days)
    for region in regions:
        for p in range(particles):
            for d, date in enumerate(dates):
                rows.append({"date": date, "chain_particle": f"0_{p}", "region": region,
                             "total_infection_incidence": float(rng.random() + d),
                             "vaccination_0_17": float(rng.random()), "vaccination_18_49": float(rng.random())})
    return pd.DataFrame(rows)


class TestModelOverview:
    def test_grid_shape_rows_metrics_cols_regions(self):
        got = _both("plot_model_overview_subplot_matplotlib", _overview_df(), pop_sizes={"US": 1000, "EU": 2000})
        assert len(got["axes"]) == 4

    def test_particle_lines_plus_median(self):
        got = _both("plot_model_overview_subplot_matplotlib", _overview_df(regions=("US",), particles=4),
                    pop_sizes={"US": 1000})
        by_title = {ax["title"]: ax for ax in got["axes"]}
        assert [len(ax["lines"]) for t, ax in by_title.items() if "incidence" in t] == [5]
        assert [len(ax["lines"]) for t, ax in by_title.items() if "vaccination" in t] == [10]

    def test_normalization_scales_values(self):
        df = _overview_df(regions=("US",), particles=1)
        got = _both("plot_model_overview_subplot_matplotlib", df, pop_sizes={"US": 1000},
                    plot_types=np.array(["total_infection_incidence"]),
                    plot_titles=np.array(["incidence per 100k"]), plot_normalizations=np.array([100_000]))
        ydata = np.concatenate([ln[1] for ln in got["axes"][0]["lines"]])
        assert np.nanmax(ydata) == pytest.approx(df["total_infection_incidence"].max() * 100, rel=1e-6)

    def test_missing_required_column_raises(self):
        df = _overview_df().drop(columns=["chain_particle"])
        for mod in (jvis, tvis):
            with pytest.raises(AssertionError, match="necessary column"):
                mod.plot_model_overview_subplot_matplotlib(df, pop_sizes={"US": 1000, "EU": 2000})

    def test_absent_plot_types_skipped(self):
        got = _both("plot_model_overview_subplot_matplotlib", _overview_df(regions=("US",)), pop_sizes={"US": 1000},
                    plot_types=np.array(["total_infection_incidence", "pred_hosp_"]),
                    plot_titles=np.array(["inc", "hosp"]), plot_normalizations=np.array([1, 1]))
        assert len(got["axes"]) == 1


def test_cleanup_and_normalize_timeseries_matches_jax():
    df = _overview_df(regions=("US", "EU"), particles=2)
    df.loc[::7, "vaccination_0_17"] = 5e-5  # near zero: zeroed
    args = (np.array(["total_infection_incidence", "vaccination_"]), np.array([100_000, 1]),
            {"US": 1000, "EU": 2500})
    want = jvis._cleanup_and_normalize_timeseries(df.copy(), *args)
    got = tvis._cleanup_and_normalize_timeseries(df.copy(), *args)
    for col in ("total_infection_incidence", "vaccination_0_17", "vaccination_18_49"):
        np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(), rtol=TOL, atol=TOL)
    assert (got["vaccination_0_17"].to_numpy()[::7] == 0).all()


class TestCorrelationPairs:
    def test_n_by_n_grid_with_flattened_plates(self):
        rng = np.random.default_rng(1)
        post = {"r0": rng.random((2, 50)), "gamma": rng.random((2, 50, 3))}
        got = _both("plot_checkpoint_inference_correlation_pairs", post, seed=0, torch_args=(_tensors(post),))
        assert len(got["axes"]) == 16

    def test_timestep_sites_dropped(self):
        rng = np.random.default_rng(2)
        post = {"r0": rng.random((2, 50)), "final_timestep_s": rng.random((2, 50))}
        _raise_both("plot_checkpoint_inference_correlation_pairs", "VisualizationError",
                    {"final_timestep_s": post["final_timestep_s"]})
        got = _both("plot_checkpoint_inference_correlation_pairs", post, seed=0, torch_args=(_tensors(post),))
        assert len(got["axes"]) == 1

    def test_subsample_cap(self):
        rng = np.random.default_rng(3)
        post = {"a": rng.random((2, 500)), "b": rng.random((2, 500))}
        got = _both("plot_checkpoint_inference_correlation_pairs", post, seed=0, torch_args=(_tensors(post),),
                    max_samples_calculated=10)
        assert got["axes"][2]["offsets"][0].shape[0] == 20

    def test_correlation_uses_full_posterior_despite_scatter_cap(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 2000))
        y = 0.6 * x + 0.8 * rng.standard_normal((2, 2000))
        full_r = np.corrcoef(x.ravel(), y.ravel())[0, 1]
        post = {"a": x, "b": y}
        got = _both("plot_checkpoint_inference_correlation_pairs", post, seed=0, torch_args=(_tensors(post),),
                    max_samples_calculated=10)
        assert abs(float(got["axes"][1]["texts"][0]) - full_r) < 0.006

    def test_correlation_annotation_present(self):
        rng = np.random.default_rng(4)
        x = rng.random((2, 50))
        post = {"a": x, "b": 2 * x + 0.01 * rng.random((2, 50))}
        got = _both("plot_checkpoint_inference_correlation_pairs", post, seed=0, torch_args=(_tensors(post),))
        texts = got["axes"][1]["texts"]
        assert texts and float(texts[0]) > 0.95


class TestMcmcChains:
    def test_one_line_per_chain_one_panel_per_site(self):
        rng = np.random.default_rng(5)
        samples = {"r0": rng.random((4, 100)), "period": rng.random((4, 100))}
        got = _both("plot_mcmc_chains", samples, torch_args=(_tensors(samples),))
        panels = [ax for ax in got["axes"] if ax["title"]]
        assert {ax["title"] for ax in panels} == {"r0", "period"}
        assert all(len(ax["lines"]) == 4 for ax in panels)

    def test_plated_sites_flattened(self):
        samples = {"scales": np.random.default_rng(6).random((2, 40, 3))}
        got = _both("plot_mcmc_chains", samples, torch_args=(_tensors(samples),))
        assert {ax["title"] for ax in got["axes"] if ax["title"]} == {"scales_0", "scales_1", "scales_2"}


class TestPriorDistributions:
    def test_histogram_and_median_line_per_distribution(self):
        figs = [
            jvis.plot_prior_distributions({"r0": jdist.Normal(2.0, 0.2), "lst": [0.0, jdist.Beta(2.0, 2.0)]},
                                          num_samples=200),
            tvis.plot_prior_distributions({"r0": tdist.Normal(2.0, 0.2), "lst": [0.0, tdist.Beta(2.0, 2.0)]},
                                          num_samples=200),
        ]
        want, got = (_facts(f) for f in figs)
        for f in figs:
            plt.close(f)
        assert got["texts"] == want["texts"]
        assert [ax["title"] for ax in got["axes"]] == [ax["title"] for ax in want["axes"]]
        for w, g in zip(want["axes"], got["axes"]):
            assert (len(g["bars"]), len(g["lines"]), g["visible"]) == (len(w["bars"]), len(w["lines"]), w["visible"])
        panels = [ax for ax in got["axes"] if ax["title"]]
        assert {ax["title"] for ax in panels} == {"r0", "lst_1"}
        assert all(len(ax["bars"]) >= 10 and len(ax["lines"]) == 1 for ax in panels)

    def test_no_distributions_raises(self):
        for mod in (jvis, tvis):
            with pytest.raises(mod.VisualizationError):
                mod.plot_prior_distributions({"x": 1.0}, num_samples=10)


@pytest.mark.parametrize("family", ["normal", "beta", "lognormal", "truncnormal"])
def test_sample_prior_distributions_by_support_and_moments(family):
    """The port's prior draws against the JAX package's (other numbers from
    another generator): the same sites, every draw in the support, and the
    two samples' means and variances within 5 standard errors of their
    difference."""
    make = {
        "normal": lambda d: d.Normal(2.0, 0.2),
        "beta": lambda d: d.Beta(2.0, 5.0),
        "lognormal": lambda d: d.LogNormal(0.0, 0.5),
        "truncnormal": lambda d: d.TruncatedNormal(loc=8.0, scale=2.0, low=2.0, high=15.0),
    }[family]
    n = 20_000
    got = tvis._sample_prior_distributions({"a": make(tdist), "lst": [0.0, make(tdist)]}, n)
    want = jvis._sample_prior_distributions({"a": make(jdist), "lst": [0.0, make(jdist)]}, n)
    assert set(got) == set(want) == {"a", "lst_1"}
    support = make(tdist).support
    for site, draws in got.items():
        ref = np.asarray(want[site], dtype=np.float64)
        draws = draws.astype(np.float64)
        assert draws.shape == (n,) and in_support(support, torch.as_tensor(draws))
        assert abs(draws.mean() - ref.mean()) < 5 * np.sqrt((draws.var() + ref.var()) / n)

        def var_se2(x):
            return (np.mean((x - x.mean()) ** 4) - x.var() ** 2) / n

        assert abs(draws.var() - ref.var()) < 5 * np.sqrt(var_se2(draws) + var_se2(ref))


class TestViolins:
    def test_prior_and_posterior_violins(self):
        rng = np.random.default_rng(7)
        pri, post = {"r0": rng.random(100)}, {"r0": rng.random(100) + 1}
        got = _both("plot_violin_plots", priors=pri, posteriors=post)
        assert got["axes"][0]["xticklabels"] == ["prior", "posterior"]
        fig = tvis.plot_violin_plots(priors=_tensors(pri), posteriors=_tensors(post))
        _same(got, _facts(fig))
        plt.close(fig)

    def test_both_none_raises(self):
        _raise_both("plot_violin_plots", "VisualizationError")

    def test_posterior_only(self):
        got = _both("plot_violin_plots", posteriors={"r0": np.random.default_rng(8).random(50)})
        assert got["axes"][0]["xticklabels"] == ["posterior"]


def test_lazy_export_via_utils_namespace():
    import dynode_tpu_torch.utils as u

    assert callable(u.plot_mcmc_chains) and u.vis_utils is tvis
    with pytest.raises(AttributeError):
        u.not_a_function


def test_gaussian_kde_matches_jax():
    rng = np.random.default_rng(9)
    for x in (rng.normal(2.0, 0.1, 800), rng.standard_t(3, 70_000), np.full(5, 3.0), np.array([1.5])):
        grid = np.linspace(x.min() - 1, x.max() + 1, 256)
        np.testing.assert_allclose(tvis._gaussian_kde_1d(x, grid), jvis._gaussian_kde_1d(x, grid),
                                   rtol=TOL, atol=TOL)


class TestPlotPosteriorDensity:
    def _samples(self, seed=0, loc=2.0):
        rng = np.random.default_rng(seed)
        return {"r0": rng.normal(loc, 0.1, size=(4, 200)), "betas": rng.normal(0.0, 1.0, size=(4, 200, 3))}

    def test_panel_per_plate_element(self):
        got = _both("plot_posterior_density", self._samples(), torch_args=(_tensors(self._samples()),))
        assert sorted(ax["title"] for ax in got["axes"] if ax["title"]) == ["betas[0]", "betas[1]", "betas[2]", "r0"]

    def test_density_trimmed_to_hdi_and_marker(self):
        got = _both("plot_posterior_density", self._samples(), var_names=["r0"], hdi_prob=0.5)
        lines = got["axes"][0]["lines"]
        assert len(lines) == 2
        draws = self._samples()["r0"].ravel()
        assert lines[0][0].min() > draws.min() and lines[0][0].max() < draws.max()
        assert abs(lines[1][0][0] - draws.mean()) < 1e-9

    def test_overlay_two_fits_with_labels(self):
        datas = [self._samples(0, 2.0), self._samples(1, 3.0)]
        got = _both("plot_posterior_density", datas, torch_args=([_tensors(d) for d in datas],),
                    var_names=["r0"], data_labels=["mcmc", "svi"])
        labels = [ln[2] for ln in got["axes"][0]["lines"]]
        assert "mcmc" in labels and "svi" in labels

    def test_accepts_inference_data(self):
        figs = [jvis.plot_posterior_density(JInferenceData(posterior=self._samples()), var_names=["r0"]),
                tvis.plot_posterior_density(TInferenceData(posterior=self._samples()), var_names=["r0"])]
        want, got = (_facts(f) for f in figs)
        for f in figs:
            plt.close(f)
        _same(want, got)
        assert got["axes"][0]["title"] == "r0"

    def test_empty_raises(self):
        _raise_both("plot_posterior_density", "VisualizationError", {})

    def test_label_count_mismatch_raises(self):
        _raise_both("plot_posterior_density", "VisualizationError", self._samples(), data_labels=["a", "b"])

    def test_flat_input_via_grouped_flag(self):
        flat = {"betas": np.random.default_rng(0).normal(0.0, 1.0, size=(800, 3))}
        got = _both("plot_posterior_density", flat, torch_args=(_tensors(flat),), grouped_by_chain=False)
        assert sorted(ax["title"] for ax in got["axes"] if ax["title"]) == ["betas[0]", "betas[1]", "betas[2]"]


def test_names_resolve_from_the_package():
    for name in ("plot_model_overview_subplot_matplotlib", "plot_checkpoint_inference_correlation_pairs",
                 "plot_mcmc_chains", "plot_posterior_density", "plot_prior_distributions", "plot_violin_plots",
                 "VisualizationError"):
        assert getattr(dynode_tpu_torch, name) is getattr(tvis, name) is getattr(dynode_tpu_torch.utils, name)
    assert dynode_tpu_torch.vis_utils is tvis
