"""The port's small utilities against the JAX package's.

- Epiweeks and the date conversions, on every day of 2014-2026 and at the
  year edges: the same ``(year, week)``, start and end dates as
  ``dynode_tpu.utils``.
- ``use_logging`` in its three modes and ``log_decorator``: the same
  records as JAX's, from the port's own ``"dynode_tpu_torch"`` logger.
- ``solver_stats`` and ``assert_solved`` on the same solves through both
  packages (float64): equal statistics.
- ``trace`` writes a Chrome trace file.
- The kernels' build directory (``enable_compilation_cache``): its
  default resolution and kill switch, as
  ``tests/test_utils/test_compilation_cache.py`` tests JAX's. The second
  process's hit needs nvcc, so it is checked on the card.
"""

import datetime
import json
import logging
import os

import jax.numpy as jnp
import pytest
import torch

import dynode_tpu.utils as ju
import dynode_tpu_torch
import dynode_tpu_torch.utils as tu
from dynode_tpu_torch.ops import _build


def _days():
    start = datetime.date(2014, 1, 1)
    return [start + datetime.timedelta(days=d) for d in range(0, (datetime.date(2026, 12, 31) - start).days + 1)]


def test_epiweeks_match_jax_on_every_day():
    for d in _days():
        got, want = tu.date_to_epi_week(d), ju.date_to_epi_week(d)
        assert (got.year, got.week) == (want.year, want.week), d
    for year in range(2014, 2027):
        for d in (datetime.date(year, 1, 1), datetime.date(year, 1, 4), datetime.date(year, 12, 28),
                  datetime.date(year, 12, 31)):
            w = tu.EpiWeek.fromdate(d)
            j = ju.EpiWeek.fromdate(d)
            assert (w.startdate(), w.enddate()) == (j.startdate(), j.enddate())
            assert tu.EpiWeek.fromdate(w.startdate()) == w == tu.EpiWeek.fromdate(w.enddate())
            assert ((w + 1).year, (w + 1).week) == ((j + 1).year, (j + 1).week)
    assert tu.date_to_epi_week(datetime.date(2021, 1, 1)) == tu.EpiWeek(2020, 53)
    assert tu.Week is tu.EpiWeek and tu.EpiWeek(2022, 43) < tu.EpiWeek(2022, 44)
    assert hash(tu.EpiWeek(2022, 43)) == hash(tu.EpiWeek(2022, 43))


def test_sim_day_conversions_match_jax():
    init = datetime.date(2022, 10, 15)
    for day in (-400, -1, 0, 10, 77, 365, 366, 1000):
        got = tu.sim_day_to_epiweek(day, init)
        want = ju.sim_day_to_epiweek(day, init)
        assert (got.year, got.week) == (want.year, want.week)
        assert tu.sim_day_to_date(day, init) == ju.sim_day_to_date(day, init)
        assert tu.date_to_sim_day(tu.sim_day_to_date(day, init), init) == day
    assert dynode_tpu_torch.sim_day_to_epiweek is tu.sim_day_to_epiweek


def _records(logger_mod, decorator, output, tmp_path, caplog):
    logger_mod.use_logging(logging.DEBUG, output=output, log_path=str(tmp_path / output))

    @decorator
    def add(a, b=1):
        return a + b

    @decorator
    def boom():
        raise KeyError("no")

    with caplog.at_level(logging.DEBUG):
        add(2, b=3)
        with pytest.raises(KeyError):
            boom()
    return [(r.levelname, r.getMessage().split(" seconds")[0].split("Time:")[0], r.func_name_override)
            for r in caplog.records if r.name == logger_mod.logger.name]


@pytest.mark.parametrize("output", ["console", "file", "both"])
def test_logging_modes_and_decorator_match_jax(output, tmp_path, caplog):
    from dynode_tpu.utils import log as jlog
    from dynode_tpu_torch.utils import log as tlog

    jrec = _records(jlog, ju.log_decorator, output, tmp_path / "jax", caplog)
    caplog.clear()
    trec = _records(tlog, tu.log_decorator, output, tmp_path / "torch", caplog)
    assert trec == jrec and len(trec) == 5
    assert tlog.logger.name == "dynode_tpu_torch" != jlog.logger.name
    kinds = {type(h) for h in tlog.logger.handlers}
    assert (logging.FileHandler in kinds) == (output in ("file", "both"))
    assert (logging.StreamHandler in kinds) == (output in ("console", "both"))
    if output != "console":
        (logfile,) = (tmp_path / "torch" / output).iterdir()
        assert logfile.name.startswith("dynode_tpu_torch_") and "Begin function" in logfile.read_text()
    with pytest.raises(ValueError, match="output"):
        tu.use_logging(output="stdout")
    tlog.logger.handlers.clear()
    jlog.logger.handlers.clear()


def test_formatter_honours_the_decorator_overrides():
    rec = logging.LogRecord("x", logging.INFO, "wrapper.py", 1, "m", None, None, func="wrapper")
    rec.func_name_override, rec.file_name_override = "inner", "model.py"
    out = tu.CustomLogFormatter("%(funcName)s %(filename)s %(message)s").format(rec)
    assert out == "inner model.py m"


def test_package_exports():
    assert dynode_tpu_torch.log is tu.log
    for name in ("use_logging", "logger", "log_decorator", "CustomLogFormatter", "enable_compilation_cache",
                 "date_to_epi_week", "sim_day_to_epiweek", "parallel"):
        assert hasattr(dynode_tpu_torch, name), name
    from dynode_tpu_torch.utils import vis_utils

    assert tu.vis_utils is vis_utils and tu.plot_violin_plots is vis_utils.plot_violin_plots
    assert dynode_tpu_torch.plot_mcmc_chains is vis_utils.plot_mcmc_chains
    with pytest.raises(AttributeError):
        tu.plot_nothing


def test_solver_stats_and_assert_solved_match_jax():
    from dynode_tpu import simulate as j_simulate
    from dynode_tpu.config import SolverParams as JSP
    from dynode_tpu_torch import simulate as t_simulate
    from dynode_tpu_torch.config import SolverParams as TSP

    def rhs(xp):
        return lambda t, y, k: (-k * y[0] * y[1], k * y[0] * y[1] - 0.1 * y[1])

    jy0, ty0 = (jnp.asarray([0.99]), jnp.asarray([0.01])), (torch.tensor([0.99], dtype=torch.float64),
                                                            torch.tensor([0.01], dtype=torch.float64))
    for budget in (None, 40):
        kw = {} if budget is None else {"step_budget": budget, "ode_solver_rel_tolerance": 1e-9,
                                        "ode_solver_abs_tolerance": 1e-12}
        want = j_simulate(rhs(jnp), 60, jy0, jnp.asarray(0.4), JSP(**kw))
        got = t_simulate(rhs(torch), 60, ty0, torch.tensor(0.4, dtype=torch.float64), TSP(**kw))
        assert tu.solver_stats(got) == ju.solver_stats(want)
        if budget is None:
            tu.assert_solved(got)
        else:
            assert tu.solver_stats(got)["num_failed"] == 1.0
            with pytest.raises(RuntimeError, match="exhausted the step budget"):
                tu.assert_solved(got)


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    with tu.trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    (path,) = tmp_path.iterdir()
    assert path.suffix == ".json" and "traceEvents" in json.loads(path.read_text())
    assert prof.key_averages() and "trace written" in capsys.readouterr().out
    with tu.wall_timer("x"):
        pass
    assert "x:" in capsys.readouterr().out


def test_compilation_cache_env_killswitch(monkeypatch, tmp_path):
    monkeypatch.setenv("DYNODE_COMPILATION_CACHE", "off")
    root = _build.BUILD_ROOT
    assert tu.enable_compilation_cache(str(tmp_path / "never")) == ""
    assert not (tmp_path / "never").exists() and _build.BUILD_ROOT == root


def test_compilation_cache_default_dir_respects_env(monkeypatch, tmp_path):
    monkeypatch.setenv("DYNODE_COMPILATION_CACHE", str(tmp_path / "d"))
    assert tu.compilation_cache_dir() == str(tmp_path / "d")
    monkeypatch.delenv("DYNODE_COMPILATION_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "x"))
    assert tu.compilation_cache_dir() == str(tmp_path / "x" / "dynode_tpu_torch" / "kernel_cache")


def test_compilation_cache_points_both_builds_at_the_directory(monkeypatch, tmp_path):
    """Before any build: the nvcc library and Triton's cache move under the
    directory. After a build, another directory raises."""
    monkeypatch.delenv("DYNODE_COMPILATION_CACHE", raising=False)
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.setenv("TRITON_CACHE_DIR", "unset")
    got = tu.enable_compilation_cache(str(tmp_path / "k"))
    assert got == str(tmp_path / "k") and (tmp_path / "k").is_dir()
    assert _build.library_path().parent.parent == tmp_path / "k"
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "k" / "triton")
    assert tu.enable_compilation_cache(str(tmp_path / "k")) == got  # the directory in use
    monkeypatch.setattr("dynode_tpu_torch.utils.compilation_cache._built", lambda: True)
    with pytest.raises(RuntimeError, match="before the first kernel build"):
        tu.enable_compilation_cache(str(tmp_path / "other"))
