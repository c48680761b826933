"""Record compartment snapshots as deterministic trace sites.

Port of ``dynode_tpu/infer/checkpointing.py``, the reference's contract
(``src/dynode/infer/checkpointing.py:12-47``): final-timestep sites are
named ``final_timestep_{compartment}``, dated sites
``{Y_m_d}_timestep_{compartment}``, and dates outside the solved range are
skipped without error. The requested dates are resolved to save-grid rows
up front and each compartment's snapshots are one ``index_select`` along
the time axis of the port's :class:`~dynode_tpu_torch.ode.Solution`.
"""

import datetime
from typing import List, Sequence, Tuple

import torch

from ..config import SimulationConfig
from ..ode import Solution
from ..utils import date_to_sim_day
from . import handlers


def _snapshot_plan(
    config: SimulationConfig,
    n_saved: int,
    save_final_timesteps: bool,
    compartment_save_dates: Sequence[datetime.date],
) -> Tuple[List[str], List[int]]:
    """Resolve the request to parallel (site-prefix, save-grid-row) lists;
    out-of-range dates are dropped here (the silent-skip contract)."""
    prefixes: List[str] = []
    rows: List[int] = []
    if save_final_timesteps:
        prefixes.append("final_timestep")
        rows.append(n_saved - 1)
    init_date = config.initializer.initialize_date
    for date in compartment_save_dates:
        day = date_to_sim_day(date, init_date)
        if 0 <= day < n_saved:
            prefixes.append(date.strftime("%Y_%m_%d") + "_timestep")
            rows.append(day)
    return prefixes, rows


def checkpoint_compartment_sizes(
    config: SimulationConfig,
    solution: Solution,
    save_final_timesteps: bool = True,
    compartment_save_dates: List[datetime.date] = [],
):
    """Record compartment sizes at key dates for later debugging."""
    if solution.ys is None:
        raise AssertionError("cannot checkpoint: the solve produced no saved states (solution.ys is None)")
    n_saved = len(solution.ys[0])
    prefixes, rows = _snapshot_plan(config, n_saved, save_final_timesteps, compartment_save_dates)
    if not rows:
        return
    for name, idx in vars(config.idx).items():
        ys = solution.ys[idx]
        snapshots = ys.index_select(0, torch.as_tensor(rows, device=ys.device))
        for site, snap in zip(prefixes, snapshots):
            handlers.deterministic(f"{site}_{name}", snap)


__all__ = ["checkpoint_compartment_sizes"]
