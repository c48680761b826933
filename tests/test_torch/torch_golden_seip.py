"""The golden SEIP fit of ``tests/test_infer/test_seip_quadrature.py`` in the
port: ``build_fit``'s reduced-rank SEIP (every mechanism of the production
model active, sized for an exact 2-D quadrature) and its ChEES model, with
the same constants. It imports no JAX, so the card tests use it too; the
golden itself (``tests/golden/seip_quadrature.npz``) is read with numpy.
"""

from pathlib import Path

import torch

from dynode_tpu_torch import dist, simulate
from dynode_tpu_torch.config import SolverParams, Strain
from dynode_tpu_torch.infer import handlers
from dynode_tpu_torch.models.seip import seip_config, seip_initial_state, seip_ode, seip_odeparams

GOLDEN = Path(__file__).resolve().parents[1] / "golden" / "seip_quadrature.npz"

FIT_DAYS = 50
INTRO_DAY = 25.0
DT = 1.0
PRIOR_LOC, PRIOR_SCALE, PRIOR_LO, PRIOR_HI = 1.0, 0.2, 0.5, 1.8
_MAX_VAX = 1


def build_fit(device, dtype=torch.float64):
    """(cfg, base, y0, sp) of the canonical reduced-rank SEIP fit on
    ``device`` in ``dtype``."""
    strains = [
        Strain(
            strain_name="alpha",
            r0=2.2,
            infectious_period=7.0,
            exposed_to_infectious=3.6,
            vaccine_efficacy={k: min(0.35 * k, 0.8) for k in range(_MAX_VAX + 2)},
        ),
        Strain(
            strain_name="delta",
            r0=3.0,
            infectious_period=7.0,
            exposed_to_infectious=3.6,
            vaccine_efficacy={k: min(0.30 * k, 0.7) for k in range(_MAX_VAX + 2)},
            is_introduced=True,
            introduction_time=INTRO_DAY,
            introduction_percentage=0.02,
            introduction_scale=3.0,
        ),
    ]
    cfg = seip_config(
        strains=strains,
        n_age=2,
        age_edges=(0, 50, 99),
        age_demographics=(0.6, 0.4),
        max_vaccinations=_MAX_VAX,
        seasonal_vaccination=True,
        vaccination_season_change_day=30.0,  # sin^1000 pulse inside window
        waning_times=(40.0, float("inf")),
        waning_protections=(1.0, 0.7),
        solver_params=SolverParams(constant_step_size=DT),
    )
    base = seip_odeparams(cfg, dtype=dtype, device=device)
    y0 = seip_initial_state(cfg, dtype=dtype, device=device)
    return cfg, base, y0, cfg.parameters.solver_params


def make_model(base, y0, sp, days: int = FIT_DAYS):
    """The ChEES model: per-strain transmission scales under a truncated
    normal prior, Poisson counts of the daily incidence over ``days``."""
    ones = torch.ones(base.beta.shape[0], dtype=base.beta.dtype, device=base.beta.device)
    prior = dist.TruncatedNormal(loc=PRIOR_LOC * ones, scale=PRIOR_SCALE * ones, low=PRIOR_LO, high=PRIOR_HI)

    def incidence_curve(scales):
        p = base.replace(beta=base.beta * scales)
        sol = simulate(seip_ode, days, y0, p, sp, sub_save_indices=(3,))
        cum = torch.sum(sol.ys[3], dim=(1, 2, 3))  # (days + 1, n_strains)
        return torch.clamp(torch.diff(cum, dim=0), min=1e-6)

    def model(obs_data=None):
        scales = handlers.sample("beta_scales", prior)
        handlers.sample("obs", dist.Poisson(incidence_curve(scales)), obs=obs_data)

    return model
