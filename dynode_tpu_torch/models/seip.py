"""SEIP: the production respiratory-disease model (age x immune-history x
vaccination x waning x strain).

Port of ``dynode_tpu/models/seip.py``:

- ``S[a, j, k, m]``: age x immune-history x vax-dose x waning-stage;
  ``E/I/C[a, j, k, l]``: age x immune-history x vax-dose x strain;
- layered immunity (cross-immunity chi x vaccine efficacy, scaled by the
  waning bins' base protections, floored at a minimum homologous immunity);
- recovery ``I -> S[m=0]`` through the bitwise-OR immune-history transition
  ``eta(j, l) = j | 2^l``, a one-hot contraction;
- cubic-spline vaccination uptake saturated per dose tier, the seasonal
  vaccination reset ``phi(t) = sin^1000(2 pi (t + tau) / 730)``, normal
  introduction pulses and sinusoidal seasonal forcing.

Every compartment-flow increment is a zero-padded full-shape add, never a
scatter, and every small contraction is an elementwise product and a sum,
so it runs in full float32 (or float64) on every device.

The pydantic config layer is not ported: :func:`seip_default_params` and
:func:`seip_initial_state` compute from the same defaults what
``seip_config`` -> ``seip_odeparams`` / ``SEIPInitializer`` compute in the
JAX package. Both put their tensors on the card unless the caller names a
device (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import math
from itertools import combinations
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device
from ..struct import pytree_dataclass
from ..utils.splines import evaluate_cubic_spline

#: defaults of ``dynode_tpu.models.seip.seip_config`` and its two strains
STRAIN_R0S = (2.2, 3.0)
STRAIN_INFECTIOUS_PERIODS = (7.0, 7.0)
STRAIN_LATENT_PERIODS = (3.6, 3.6)
STRAIN_VAX_EFF_STEP = (0.35, 0.30)  # efficacy of dose k: min(step * k, cap)
STRAIN_VAX_EFF_CAP = (0.8, 0.7)
STRAIN_INTERACTION = 0.7  # cross-strain interaction (1.0 on the diagonal)
INTRO_TIME = 60.0  # the second strain's introduction
INTRO_PERCENTAGE = 0.02
INTRO_SCALE = 5.0
WANING_TIMES = (70.0, 70.0, 70.0, math.inf)
WANING_PROTECTIONS = (1.0, 0.94, 0.83, 0.6)
AGE_DEMOGRAPHICS = (0.25, 0.35, 0.25, 0.15)
POPULATION = 100_000
MAX_VACCINATIONS = 2
SEASON_AMP = 0.15
SEASON_PEAK = 0.0
VACCINATION_SEASON_CHANGE_DAY = 100.0
MIN_HOMOLOGOUS_IMMUNITY = 0.9
DAILY_VAX_RATE = 2e-3
I0_PROP = 1e-3


@pytree_dataclass(frozen=True, static_fieldnames=("seasonal_vaccination",))
class SEIPParams:
    """SEIP RHS parameters; the fields and shapes of the JAX ``SEIPParams``
    (``beta`` is ``(L,)``, or ``(L, B)`` in the ensemble form)."""

    beta: torch.Tensor  # (L,)
    sigma: torch.Tensor  # (L,)
    gamma: torch.Tensor  # (L,)
    contact: torch.Tensor  # (A, A)
    pop: torch.Tensor  # (A,)
    season_amp: torch.Tensor  # ()
    season_peak: torch.Tensor  # ()
    intro_time: torch.Tensor  # (L,)
    intro_scale: torch.Tensor  # (L,)
    intro_perc: torch.Tensor  # (L,)
    intro_age_mask: torch.Tensor  # (L, A)
    vax_knots: torch.Tensor  # (A, K, n_knots)
    vax_base_coeffs: torch.Tensor  # (A, K, 4)
    vax_knot_coeffs: torch.Tensor  # (A, K, n_knots)
    seasonal_vax_tau: torch.Tensor  # ()
    omega: torch.Tensor  # (M,), last 0
    base_protection: torch.Tensor  # (M,)
    chi: torch.Tensor  # (L, J)
    vax_eff: torch.Tensor  # (L, K)
    hist_mask: torch.Tensor  # (L, J)
    min_homologous: torch.Tensor  # ()
    eta_onehot: torch.Tensor  # (J, L, J)
    seasonal_vaccination: bool = False

    def replace(self, **changes) -> "SEIPParams":
        """A copy with the named fields replaced."""
        return dataclasses.replace(self, **changes)


def _full_hist_members(n_strains: int) -> list[frozenset]:
    """Strain-membership set of every FullStratified history bin, in the
    dimension's bin order (none, singles, pairs, ...)."""
    members = [frozenset()]
    for size in range(1, n_strains + 1):
        members.extend(frozenset(c) for c in combinations(range(n_strains), size))
    return members


def default_contact_matrix(n_age: int) -> np.ndarray:
    """``0.2 + 0.8 * I / A``, the default of ``seip_config``."""
    return np.full((n_age, n_age), 0.2) + 0.8 * np.eye(n_age) / n_age


def seip_default_params(
    seasonal_vaccination: bool = False,
    *,
    max_vaccinations: int = MAX_VACCINATIONS,
    waning_times: Sequence[float] = WANING_TIMES,
    waning_protections: Sequence[float] = WANING_PROTECTIONS,
    age_demographics: Sequence[float] = AGE_DEMOGRAPHICS,
    population_size: float = POPULATION,
    contact_matrix=None,
    season_amp: float = SEASON_AMP,
    season_peak: float = SEASON_PEAK,
    vaccination_season_change_day: float = VACCINATION_SEASON_CHANGE_DAY,
    daily_vax_rate: float = DAILY_VAX_RATE,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> SEIPParams:
    """``seip_odeparams(seip_config(...))`` with the default two strains,
    computed in float64 and cast to ``dtype``.

    K (vaccination tiers) is ``max_vaccinations + 1``, plus one with
    ``seasonal_vaccination``. The uptake is the constant ``daily_vax_rate``
    for every tier below the top, written as a degenerate spline (a-term
    only, one zero knot). With no ``device`` the tensors go to the card
    (raises where there is none); pass ``device="cpu"`` for the CPU.
    """
    device = _device.resolve(device)
    n_strain = len(STRAIN_R0S)
    n_age = len(age_demographics)
    n_dose = max_vaccinations + 1 + int(seasonal_vaccination)
    members = _full_hist_members(n_strain)
    n_hist = len(members)

    r0s = np.asarray(STRAIN_R0S, np.float64)
    inf_p = np.asarray(STRAIN_INFECTIOUS_PERIODS, np.float64)
    lat_p = np.asarray(STRAIN_LATENT_PERIODS, np.float64)
    introduced = [False, True]
    intro_time = np.asarray([INTRO_TIME if i else 0.0 for i in introduced])
    intro_scale = np.asarray([INTRO_SCALE if i else 1.0 for i in introduced])
    intro_perc = np.asarray([INTRO_PERCENTAGE if i else 0.0 for i in introduced])
    intro_age_mask = np.asarray([[1.0 if i else 0.0] * n_age for i in introduced])

    chi = np.zeros((n_strain, n_hist))
    hist_mask = np.zeros((n_strain, n_hist))
    eta = np.zeros((n_hist, n_strain, n_hist))
    index_of = {mem: j for j, mem in enumerate(members)}
    for j, mem in enumerate(members):
        for l in range(n_strain):
            if mem:
                chi[l, j] = max(1.0 if l == m else STRAIN_INTERACTION for m in mem)
            if l in mem:
                hist_mask[l, j] = 1.0
            eta[j, l, index_of[frozenset(mem | {l})]] = 1.0
    vax_eff = np.asarray([
        [min(step * k, cap) for k in range(n_dose)]
        for step, cap in zip(STRAIN_VAX_EFF_STEP, STRAIN_VAX_EFF_CAP)
    ])
    omega = np.asarray([0.0 if math.isinf(w) else 1.0 / w for w in waning_times])
    base_coeffs = np.zeros((n_age, n_dose, 4))
    base_coeffs[:, :-1, 0] = daily_vax_rate
    if contact_matrix is None:
        contact_matrix = default_contact_matrix(n_age)

    def cast(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return SEIPParams(
        beta=cast(r0s / inf_p),
        sigma=cast(1.0 / lat_p),
        gamma=cast(1.0 / inf_p),
        contact=cast(contact_matrix),
        pop=cast(np.asarray(age_demographics, np.float64) * population_size),
        season_amp=cast(season_amp),
        season_peak=cast(season_peak),
        intro_time=cast(intro_time),
        intro_scale=cast(intro_scale),
        intro_perc=cast(intro_perc),
        intro_age_mask=cast(intro_age_mask),
        vax_knots=cast(np.zeros((n_age, n_dose, 1))),
        vax_base_coeffs=cast(base_coeffs),
        vax_knot_coeffs=cast(np.zeros((n_age, n_dose, 1))),
        seasonal_vax_tau=cast(182.5 - float(vaccination_season_change_day)),
        omega=cast(omega),
        base_protection=cast(waning_protections),
        chi=cast(chi),
        vax_eff=cast(vax_eff),
        hist_mask=cast(hist_mask),
        min_homologous=cast(MIN_HOMOLOGOUS_IMMUNITY),
        eta_onehot=cast(eta),
        seasonal_vaccination=bool(seasonal_vaccination),
    )


def seip_initial_state(
    seasonal_vaccination: bool = False,
    *,
    max_vaccinations: int = MAX_VACCINATIONS,
    n_waning: int = len(WANING_TIMES),
    age_demographics: Sequence[float] = AGE_DEMOGRAPHICS,
    population_size: float = POPULATION,
    i0_prop: float = I0_PROP,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, ...]:
    """``(S, E, I, C)`` of ``SEIPInitializer``: everyone naive and
    unvaccinated in waning bin 0, ``i0_prop`` of each age infectious with
    the strains present at the start (the first; the second is introduced
    later). ``device`` as in :func:`seip_default_params`."""
    device = _device.resolve(device)
    n_strain = len(STRAIN_R0S)
    n_hist = 2**n_strain
    n_dose = max_vaccinations + 1 + int(seasonal_vaccination)
    pop = population_size * np.asarray(age_demographics, np.float64)
    n_age = pop.shape[0]
    S = np.zeros((n_age, n_hist, n_dose, n_waning))
    S[:, 0, 0, 0] = pop * (1.0 - i0_prop)
    seed_mask = np.asarray([1.0, 0.0])  # not introduced / introduced
    seed_mask = seed_mask / max(seed_mask.sum(), 1.0)
    I = np.zeros((n_age, n_hist, n_dose, n_strain))
    I[:, 0, 0, :] = pop[:, None] * i0_prop * seed_mask[None, :]
    zeros = np.zeros_like(I)
    return tuple(torch.as_tensor(x, dtype=dtype, device=device) for x in (S, zeros, I, zeros))


def _pad_axis(x: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """Zero-pad ``x`` along one axis (static widths)."""
    axis = axis % x.ndim
    pads = [0, 0] * (x.ndim - axis - 1) + [before, after]
    return F.pad(x, pads)


def _phi_seasonal(t, tau):
    """sin^1000 pulse around the vaccination-season change."""
    s = torch.sin(2.0 * math.pi * (t + tau) / 730.0)
    return s**1000


def _escape(p: SEIPParams) -> torch.Tensor:
    """Susceptibility multiplier ``(L, J, K, M)`` of the layered immunity."""
    ii = 1.0 - (1.0 - p.chi[:, :, None]) * (1.0 - p.vax_eff[:, None, :])  # (L, J, K)
    wib = ii[..., None] * p.base_protection  # (L, J, K, M)
    fi = (p.min_homologous * p.hist_mask)[:, :, None, None]
    return 1.0 - (wib + (1.0 - wib) * fi)


def _time_terms(t, p: SEIPParams, like: torch.Tensor):
    """``(season, external (L, A), nu (A, K))`` at day ``t``."""
    t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    season = 1.0 + p.season_amp * torch.cos(2.0 * math.pi * (t - p.season_peak) / 365.0)
    pulse = (
        p.intro_perc
        * torch.exp(-0.5 * ((t - p.intro_time) / p.intro_scale) ** 2)
        / (p.intro_scale * math.sqrt(2.0 * math.pi))
    )  # (L,)
    external = pulse[:, None] * p.intro_age_mask * p.pop[None, :]  # (L, A)
    nu = evaluate_cubic_spline(t, p.vax_knots, p.vax_base_coeffs, p.vax_knot_coeffs)
    return t, season, external, torch.clamp(nu, min=0.0)


def seip_ode(t, state, p: SEIPParams):
    """Fused SEIP right-hand side over ``(S, E, I, C)``.

    ``S`` is ``(A, J, K, M)``, ``E/I/C`` are ``(A, J, K, L)``.
    """
    S, E, I, C = state
    K, M = S.shape[2], S.shape[3]
    t, season, external, nu = _time_terms(t, p, S)

    # ---- force of infection ------------------------------------------------
    infectious = I.sum(dim=(1, 2)) + external.T  # (A, L)
    mixed = (p.contact[:, :, None] * infectious[None, :, :]).sum(dim=1)  # (A, L)
    lam = (p.beta[None, :] * season / p.pop[:, None]) * mixed  # (A, L)

    # ---- layered immunity ----------------------------------------------------
    esc = _escape(p).permute(1, 2, 3, 0)  # (J, K, M, L)
    new_exposed = lam[:, None, None, :] * (esc[None] * S[..., None]).sum(dim=3)  # (A,J,K,L)
    dS = -(lam[:, None, None, None, :] * esc[None]).sum(dim=-1) * S  # sum over l
    dE = new_exposed - p.sigma * E
    dI = p.sigma * E - p.gamma * I
    dC = new_exposed

    # ---- recovery through the immune-history transition ----------------------
    recovered = p.gamma * I  # (A, J, K, L)
    rec_to_hist = (recovered[..., None] * p.eta_onehot[None, :, None, :, :]).sum(dim=(1, 3))
    dS = dS + _pad_axis(rec_to_hist.permute(0, 2, 1)[..., None], 3, 0, M - 1)

    # ---- vaccination uptake (saturated per dose tier) --------------------------
    s_by_dose = S.sum(dim=(1, 3))  # (A, K)
    rate = torch.clamp(nu * p.pop[:, None] / torch.clamp(s_by_dose, min=1e-8), max=1.0)
    out_lower = rate[:, None, :-1, None] * S[:, :, :-1, :]  # (A, J, K-1, M)
    dS = dS - _pad_axis(out_lower, 2, 0, 1)
    dS = dS + _pad_axis(_pad_axis(out_lower.sum(dim=-1)[..., None], 3, 0, M - 1), 2, 1, 0)
    out_top = rate[:, None, -1, None] * S[:, :, -1, 1:]  # (A, J, M-1)
    dS = dS - _pad_axis(_pad_axis(out_top[:, :, None, :], 3, 1, 0), 2, K - 1, 0)
    dS = dS + _pad_axis(
        _pad_axis(out_top.sum(dim=-1)[:, :, None, None], 3, 0, M - 1), 2, K - 1, 0)

    # ---- seasonal vaccination reset (top tier -> previous tier) ----------------
    if p.seasonal_vaccination:
        phi = _phi_seasonal(t, p.seasonal_vax_tau)

        def season_shift(X):
            shift = phi * X[:, :, -1]
            return _pad_axis(torch.stack([shift, -shift], dim=2), 2, K - 2, 0)

        dS = dS + season_shift(S)
        dE = dE + season_shift(E)
        dI = dI + season_shift(I)

    # ---- waning chain m -> m+1 -------------------------------------------------
    wane_out = p.omega * S  # omega[-1] == 0
    dS = dS - wane_out
    dS = dS + _pad_axis(wane_out[..., :-1], 3, 1, 0)
    return (dS, dE, dI, dC)


def seip_ensemble_state(y0, batch: int):
    """Broadcast one initial state to a trailing ensemble axis (views)."""
    return tuple(a[..., None].expand(*a.shape, batch) for a in y0)


def seip_ensemble_params(base: SEIPParams, beta_scales) -> SEIPParams:
    """Per-member transmission scaling: ``beta`` becomes ``(L, B)``.

    ``beta_scales`` is ``(B,)`` (one scale shared across strains) or
    ``(L, B)`` (one per strain)."""
    scales = torch.as_tensor(beta_scales, dtype=base.beta.dtype, device=base.beta.device)
    if scales.ndim == 1:
        scales = scales[None, :]
    return base.replace(beta=base.beta[:, None] * scales)


def seip_ode_ensemble(t, state, p: SEIPParams):
    """Fused SEIP RHS over a trailing ensemble axis (scatter-free).

    state: ``S (A, J, K, M, B)``; ``E/I/C (A, J, K, L, B)``. ``p.beta`` is
    ``(L, B)``; every other parameter is shared across the ensemble.
    """
    S, E, I, C = state
    K, M = S.shape[2], S.shape[3]
    t, season, external, nu = _time_terms(t, p, S)

    infectious = I.sum(dim=(1, 2)) + external.T[..., None]  # (A, L, B)
    mixed = (p.contact[:, :, None, None] * infectious[None]).sum(dim=1)  # (A, L, B)
    lam = (p.beta[None, :, :] * season / p.pop[:, None, None]) * mixed

    esc = _escape(p).permute(1, 2, 3, 0)[..., None]  # (J, K, M, L, 1)
    new_exposed = lam[:, None, None] * (esc[None] * S[:, :, :, :, None, :]).sum(dim=3)
    dS = -(lam[:, None, None, None] * esc[None]).sum(dim=4) * S  # (A, J, K, M, B)
    dE = new_exposed - p.sigma[:, None] * E
    dI = p.sigma[:, None] * E - p.gamma[:, None] * I
    dC = new_exposed

    recovered = p.gamma[:, None] * I  # (A, J, K, L, B)
    rec_to_hist = (recovered[:, :, :, :, None, :]
                   * p.eta_onehot[None, :, None, :, :, None]).sum(dim=(1, 3))  # (A, K, H, B)
    dS = dS + _pad_axis(rec_to_hist.permute(0, 2, 1, 3)[:, :, :, None, :], 3, 0, M - 1)

    s_by_dose = S.sum(dim=(1, 3))  # (A, K, B)
    rate = torch.clamp(
        nu[:, :, None] * p.pop[:, None, None] / torch.clamp(s_by_dose, min=1e-8), max=1.0)
    out_lower = rate[:, None, :-1, None, :] * S[:, :, :-1, :, :]
    dS = dS - _pad_axis(out_lower, 2, 0, 1)
    dS = dS + _pad_axis(
        _pad_axis(out_lower.sum(dim=3)[:, :, :, None, :], 3, 0, M - 1), 2, 1, 0)
    out_top = rate[:, None, -1, None, :] * S[:, :, -1, 1:, :]  # (A, J, M-1, B)
    dS = dS - _pad_axis(_pad_axis(out_top[:, :, None, :, :], 3, 1, 0), 2, K - 1, 0)
    dS = dS + _pad_axis(
        _pad_axis(out_top.sum(dim=2)[:, :, None, None, :], 3, 0, M - 1), 2, K - 1, 0)

    if p.seasonal_vaccination:
        phi = _phi_seasonal(t, p.seasonal_vax_tau)

        def season_shift(X):
            shift = phi * X[:, :, -1]
            return _pad_axis(torch.stack([shift, -shift], dim=2), 2, K - 2, 0)

        dS = dS + season_shift(S)
        dE = dE + season_shift(E)
        dI = dI + season_shift(I)

    wane_out = p.omega[:, None] * S
    dS = dS - wane_out
    dS = dS + _pad_axis(wane_out[:, :, :, :-1, :], 3, 1, 0)
    return (dS, dE, dI, dC)


__all__ = [
    "SEIPParams",
    "default_contact_matrix",
    "seip_default_params",
    "seip_initial_state",
    "seip_ode",
    "seip_ode_ensemble",
    "seip_ensemble_state",
    "seip_ensemble_params",
]
