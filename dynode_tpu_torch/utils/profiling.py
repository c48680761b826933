"""Profiling and solver-statistics helpers.

Port of ``dynode_tpu/utils/profiling.py``: :func:`trace` records a
``torch.profiler`` trace of a block (the card's kernels too, where CUDA is
available) and writes it as a Chrome trace; :func:`wall_timer` prints a
block's wall time; :func:`solver_stats` and :func:`assert_solved` read a
:class:`~dynode_tpu_torch.ode.solution.Solution`'s ``stats`` and
``result``.
"""

import contextlib
import os
import tempfile
import time
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and the
    card's where CUDA is available) and write it to ``log_dir`` (default
    ``dynode_tpu_torch_trace`` under the temporary directory) as a Chrome
    trace, ``trace_<time>.json``; open it in ``chrome://tracing`` or
    ui.perfetto.dev. Yields the profiler, whose ``key_averages()`` sums
    the block's operations."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "dynode_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{datetime.now().strftime('%Y%m%d_%H%M%S_%f')}.json")
    prof.export_chrome_trace(path)
    print(f"[dynode_tpu_torch.profiling] trace written to {path}")


@contextlib.contextmanager
def wall_timer(label: str = "block"):
    """Print the wall time of a block. Where CUDA has been initialised, the
    block ends with ``torch.cuda.synchronize()``, so that the time covers
    the card's work that the block launched and not only its launches."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    print(f"[dynode_tpu_torch.profiling] {label}: {time.perf_counter() - t0:.3f}s")


def solver_stats(solution) -> Dict[str, float]:
    """A solve's step statistics as floats (the largest member's for a
    batch), the share of the step budget used, and the count of solves
    that did not finish (``result != 0``)."""
    stats = {}
    for key, val in solution.stats.items():
        arr = _host(val)
        stats[key] = float(arr.max()) if arr.ndim else float(arr)
    budget = stats.get("step_budget", 0)
    if budget:
        stats["budget_utilization"] = stats["num_steps"] / budget
    stats["num_failed"] = float((_host(solution.result) != 0).sum())
    return stats


def assert_solved(solution):
    """Raise if any solve of a (possibly batched) Solution ran out of its
    step budget."""
    failed = int((_host(solution.result) != 0).sum())
    if failed:
        raise RuntimeError(
            f"{failed} solve(s) exhausted the step budget; raise "
            "SolverParams.step_budget or loosen tolerances "
            f"(stats: {solver_stats(solution)})"
        )


__all__ = ["trace", "wall_timer", "solver_stats", "assert_solved"]
