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

:func:`seip_config` builds the ``SimulationConfig``, :func:`seip_odeparams`
vectorises a (possibly sampled) config into :class:`SEIPParams`, and
:func:`seip_initial_state` runs its :class:`SEIPInitializer`. The
config-free forms :func:`seip_default_params` (a wrapper over the config)
and ``seip_initial_state(seasonal_vaccination, ...)`` keep their
signatures. Every constructor puts its tensors on the card unless the
caller names a device (``device="cpu"``); numbers are combined in float64
and cast to ``dtype`` at the end.
"""

from __future__ import annotations

import dataclasses
import math
from datetime import date
from itertools import combinations
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device
from .. import _validate as V
from ..config import (
    AgeBin,
    Bin,
    Compartment,
    Dimension,
    FullStratifiedImmuneHistoryDimension,
    Initializer,
    Params,
    SimulationConfig,
    SolverParams,
    Strain,
    TransmissionParams,
    VaccinationDimension,
    WaneDimension,
)
from ..config._model import Field
from ..struct import pytree_dataclass
from ..utils import vectorize_objects
from ..utils.splines import evaluate_cubic_spline
from ._values import f64, ordered_sum

#: defaults of :func:`seip_config`
WANING_TIMES = (70.0, 70.0, 70.0, math.inf)
WANING_PROTECTIONS = (1.0, 0.94, 0.83, 0.6)
AGE_EDGES = (0, 18, 50, 65, 99)
AGE_DEMOGRAPHICS = (0.25, 0.35, 0.25, 0.15)
POPULATION = 100_000
MAX_VACCINATIONS = 2
SEASON_AMP = 0.15
SEASON_PEAK = 0.0
VACCINATION_SEASON_CHANGE_DAY = 100.0
DAILY_VAX_RATE = 2e-3
I0_PROP = 1e-3


@pytree_dataclass(frozen=True, static_fieldnames=("idx", "seasonal_vaccination"))
class SEIPParams:
    """SEIP RHS parameters; the fields and shapes of the JAX ``SEIPParams``
    (``beta`` is ``(L,)``, or ``(L, B)`` in the ensemble form). ``idx``
    (the config's namespace, None for the config-free form) and
    ``seasonal_vaccination`` are static."""

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
    idx: Optional[SimpleNamespace] = None
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


def _initial_state(s_shape, e_shape, pop, i0_prop, seed_mask, dtype, device):
    """Everyone naive and unvaccinated in waning bin 0; ``i0_prop`` of each
    age infectious with the strains of ``seed_mask``; float64, then cast."""
    S = torch.zeros(s_shape, dtype=torch.float64, device=device)
    S[:, 0, 0, 0] = pop * (1.0 - i0_prop)
    seed = f64(seed_mask, device)
    seed = seed / torch.clamp(ordered_sum(seed), min=1.0)
    I = torch.zeros(e_shape, dtype=torch.float64, device=device)
    I[:, 0, 0, :] = pop[:, None] * i0_prop * seed[None, :]
    zeros = torch.zeros(e_shape, dtype=torch.float64, device=device)
    return tuple(x.to(dtype) for x in (S, zeros, I, zeros))


class SEIPInitializer(Initializer):
    """Fully-susceptible, unvaccinated, fresh-immunity start + seed infections."""

    age_demographics = Field(V.sequence_of(V.float_), AGE_DEMOGRAPHICS)
    i0_prop = Field(V.float_, I0_PROP)

    def get_initial_state(self, config: SimulationConfig, *, dtype: torch.dtype = torch.float32,
                          device: torch.device | str | None = None, **kwargs):
        """Initial (S, E, I, C) with layered immune-history strata."""
        device = _device.resolve(device)
        pop = self.population_size * f64(self.age_demographics, device)
        strains = config.parameters.transmission_params.strains
        # seed infections in naive/unvaccinated across non-introduced strains
        seed_mask = [0.0 if s.is_introduced else 1.0 for s in strains]
        return _initial_state(config.get_compartment("s").shape, config.get_compartment("e").shape,
                              pop, self.i0_prop, seed_mask, dtype, device)


def seip_config(
    strains: Optional[List[Strain]] = None,
    n_age: int = 4,
    max_vaccinations: int = MAX_VACCINATIONS,
    seasonal_vaccination: bool = False,
    waning_times=WANING_TIMES,
    waning_protections=WANING_PROTECTIONS,
    age_edges=AGE_EDGES,
    age_demographics=AGE_DEMOGRAPHICS,
    population_size: int = POPULATION,
    contact_matrix=None,
    season_amp: float = SEASON_AMP,
    season_peak: float = SEASON_PEAK,
    vaccination_season_change_day: float = VACCINATION_SEASON_CHANGE_DAY,
    solver_params: Optional[SolverParams] = None,
) -> SimulationConfig:
    """Build the full SEIP SimulationConfig (all dimension types in play):
    by default the strains alpha (R0 2.2) and delta (R0 3.0, introduced on
    day 60), cross-immunity 0.7."""
    n_dose = max_vaccinations + 1 + int(seasonal_vaccination)
    if strains is None:
        strains = [
            Strain(
                strain_name="alpha",
                r0=2.2,
                infectious_period=7.0,
                exposed_to_infectious=3.6,
                vaccine_efficacy={k: min(0.35 * k, 0.8) for k in range(n_dose)},
            ),
            Strain(
                strain_name="delta",
                r0=3.0,
                infectious_period=7.0,
                exposed_to_infectious=3.6,
                vaccine_efficacy={k: min(0.30 * k, 0.7) for k in range(n_dose)},
                is_introduced=True,
                introduction_time=60.0,
                introduction_percentage=0.02,
                introduction_scale=5.0,
            ),
        ]
    names = [s.strain_name for s in strains]
    interactions = {a: {b: (1.0 if a == b else 0.7) for b in names} for a in names}

    age_dim = Dimension(
        name="age",
        bins=[
            AgeBin(age_edges[i], age_edges[i + 1] - (0 if i == n_age - 1 else 1))
            for i in range(n_age)
        ],
    )
    hist_dim = FullStratifiedImmuneHistoryDimension(strains, name="hist")
    vax_dim = VaccinationDimension(
        max_ordinal_vaccinations=max_vaccinations,
        seasonal_vaccination=seasonal_vaccination,
    )
    wane_dim = WaneDimension(
        waiting_times=list(waning_times),
        base_protections=list(waning_protections),
    )
    strain_dim = Dimension(name="strain", bins=[Bin(name=n) for n in names])

    if contact_matrix is None:
        contact_matrix = default_contact_matrix(n_age)
    if not isinstance(contact_matrix, torch.Tensor):
        contact_matrix = torch.as_tensor(np.asarray(contact_matrix, np.float64))

    tp = TransmissionParams(
        strains=strains,
        strain_interactions=interactions,
        contact_matrix=contact_matrix,
        season_amp=season_amp,
        season_peak=season_peak,
        min_homologous_immunity=0.9,
        vaccination_season_change_day=vaccination_season_change_day,
    )
    return SimulationConfig(
        compartments=[
            Compartment(name="s", dimensions=[age_dim, hist_dim, vax_dim, wane_dim]),
            Compartment(name="e", dimensions=[age_dim, hist_dim, vax_dim, strain_dim]),
            Compartment(name="i", dimensions=[age_dim, hist_dim, vax_dim, strain_dim]),
            Compartment(name="c", dimensions=[age_dim, hist_dim, vax_dim, strain_dim]),
        ],
        initializer=SEIPInitializer(
            description="SEIP naive-population initializer",
            initialize_date=date(2022, 2, 11),
            population_size=population_size,
            age_demographics=age_demographics,
        ),
        parameters=Params(
            solver_params=solver_params or SolverParams(step_budget=1024),
            transmission_params=tp,
        ),
    )


def seip_odeparams(
    config: SimulationConfig,
    vax_spline_knots=None,
    vax_spline_base_coeffs=None,
    vax_spline_knot_coeffs=None,
    daily_vax_rate: float = DAILY_VAX_RATE,
    *,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> SEIPParams:
    """Vectorize a (possibly sampled) SEIP config into RHS tensors, in
    float64, then cast to ``dtype``; tensors in the config keep their graph.

    When spline coefficients are omitted, a constant ``daily_vax_rate``
    uptake is encoded as a degenerate spline (a-term only).
    """
    device = _device.resolve(device)
    tp = config.parameters.transmission_params
    strains = tp.strains
    L = len(strains)
    s_comp = config.get_compartment("s")
    A, J, K_plus_1, M = s_comp.shape

    def cast(x):
        return f64(x, device).to(dtype)

    r0s = f64(vectorize_objects(strains, target="r0"), device)
    inf_p = f64(vectorize_objects(strains, target="infectious_period"), device)
    lat_p = f64(vectorize_objects(strains, target="exposed_to_infectious"), device)

    # introductions (zeros when not introduced)
    intro_time = [s.introduction_time if s.is_introduced else 0.0 for s in strains]
    intro_scale = [s.introduction_scale if (s.is_introduced and s.introduction_scale is not None)
                   else 1.0 for s in strains]
    intro_perc = [s.introduction_percentage if (s.is_introduced and s.introduction_percentage is not None)
                  else 0.0 for s in strains]
    masks = []
    for s in strains:
        if s.introduction_ages_mask_vector is not None:
            masks.append(s.introduction_ages_mask_vector)
        else:
            masks.append([1] * A if s.is_introduced else [0] * A)

    # immune-history structure
    members = _full_hist_members(L)
    if len(members) != J:
        raise ValueError("seip_odeparams requires a FullStratifiedImmuneHistoryDimension")
    chi = np.zeros((L, J))
    hist_mask = np.zeros((L, J))
    names = [s.strain_name for s in strains]
    for j, mem in enumerate(members):
        for l_idx in range(L):
            if not mem:
                continue
            chi[l_idx, j] = max(tp.strain_interactions[names[l_idx]][names[m]] for m in mem)
            if l_idx in mem:
                hist_mask[l_idx, j] = 1.0
    # eta: recovery from (history j, strain l) lands in history j | {l}
    eta = np.zeros((J, L, J))
    index_of = {mem: j for j, mem in enumerate(members)}
    for j, mem in enumerate(members):
        for l_idx in range(L):
            eta[j, l_idx, index_of[frozenset(mem | {l_idx})]] = 1.0

    # vaccine efficacy (L, K+1)
    vax_eff = np.zeros((L, K_plus_1))
    for l_idx, s in enumerate(strains):
        if s.vaccine_efficacy:
            for dose, eff in s.vaccine_efficacy.items():
                if dose < K_plus_1:
                    vax_eff[l_idx, dose] = eff

    # waning
    wane_bins = s_comp.dimensions[3].bins
    omega = [0.0 if math.isinf(b.waiting_time) else 1.0 / b.waiting_time for b in wane_bins]
    base_protection = [b.base_protection for b in wane_bins]

    # vaccination splines
    if vax_spline_base_coeffs is None:
        base_coeffs = np.zeros((A, K_plus_1, 4))
        base_coeffs[:, :-1, 0] = daily_vax_rate  # constant uptake for k < K
        vax_spline_base_coeffs = base_coeffs
        vax_spline_knots = np.zeros((A, K_plus_1, 1))
        vax_spline_knot_coeffs = np.zeros((A, K_plus_1, 1))

    init = config.initializer
    pop = f64(init.age_demographics, device) * init.population_size

    tau = 182.5 - float(getattr(tp, "vaccination_season_change_day", 100.0))
    vax_dim = s_comp.dimensions[2]
    seasonal = bool(getattr(vax_dim, "seasonal_vaccination", False))

    return SEIPParams(
        beta=(r0s / inf_p).to(dtype),
        sigma=(1.0 / lat_p).to(dtype),
        gamma=(1.0 / inf_p).to(dtype),
        contact=cast(tp.contact_matrix),
        pop=pop.to(dtype),
        season_amp=cast(getattr(tp, "season_amp", 0.0)),
        season_peak=cast(getattr(tp, "season_peak", 0.0)),
        intro_time=cast(intro_time),
        intro_scale=cast(intro_scale),
        intro_perc=cast(intro_perc),
        intro_age_mask=cast(masks),
        vax_knots=cast(vax_spline_knots),
        vax_base_coeffs=cast(vax_spline_base_coeffs),
        vax_knot_coeffs=cast(vax_spline_knot_coeffs),
        seasonal_vax_tau=cast(tau),
        omega=cast(omega),
        base_protection=cast(base_protection),
        chi=cast(chi),
        vax_eff=cast(vax_eff),
        hist_mask=cast(hist_mask),
        min_homologous=cast(getattr(tp, "min_homologous_immunity", 0.9)),
        eta_onehot=cast(eta),
        idx=config.idx,
        seasonal_vaccination=seasonal,
    )


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
    without the config's ``idx`` (None).

    K (vaccination tiers) is ``max_vaccinations + 1``, plus one with
    ``seasonal_vaccination``. ``population_size`` is a whole number (the
    config's ``PositiveInt``); with more or fewer than 4 ages, the age bins
    are 10 years wide. With no ``device`` the tensors go to the card
    (raises where there is none); pass ``device="cpu"`` for the CPU.
    """
    device = _device.resolve(device)
    n_age = len(age_demographics)
    config = seip_config(
        n_age=n_age,
        max_vaccinations=max_vaccinations,
        seasonal_vaccination=seasonal_vaccination,
        waning_times=waning_times,
        waning_protections=waning_protections,
        age_edges=AGE_EDGES if n_age == len(AGE_EDGES) - 1 else tuple(10 * a for a in range(n_age + 1)),
        age_demographics=age_demographics,
        population_size=population_size,
        contact_matrix=contact_matrix,
        season_amp=season_amp,
        season_peak=season_peak,
        vaccination_season_change_day=vaccination_season_change_day,
    )
    params = seip_odeparams(config, daily_vax_rate=daily_vax_rate, dtype=dtype, device=device)
    return params.replace(idx=None)


def seip_initial_state(
    seasonal_vaccination=False,
    *,
    max_vaccinations: int = MAX_VACCINATIONS,
    n_waning: int = len(WANING_TIMES),
    age_demographics: Sequence[float] = AGE_DEMOGRAPHICS,
    population_size: float = POPULATION,
    i0_prop: float = I0_PROP,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, ...]:
    """The initial ``(S, E, I, C)``.

    Given a ``SimulationConfig`` (``seip_initial_state(config)``), its
    initializer's state. Otherwise the config-free form, the same
    computation for the two default strains: everyone naive and
    unvaccinated in waning bin 0, ``i0_prop`` of each age infectious with
    the strains present at the start (the first; the second is introduced
    later). ``device`` as in :func:`seip_default_params`.
    """
    if isinstance(seasonal_vaccination, SimulationConfig):
        config = seasonal_vaccination
        return config.initializer.get_initial_state(config, dtype=dtype, device=device)
    device = _device.resolve(device)
    n_strain = 2
    n_dose = max_vaccinations + 1 + int(seasonal_vaccination)
    pop = population_size * f64(age_demographics, device)
    n_age = pop.shape[0]
    return _initial_state((n_age, 2**n_strain, n_dose, n_waning), (n_age, 2**n_strain, n_dose, n_strain),
                          pop, i0_prop, [1.0, 0.0], dtype, device)


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


def _at_add(x: torch.Tensor, key, value) -> torch.Tensor:
    """``x.at[key].add(value)``: an out-of-place scatter-add of ``value``
    into the entries of ``x`` that the basic index ``key`` (slices, ints and
    one ``...``) selects, through ``index_put`` with accumulation."""
    key = key if isinstance(key, tuple) else (key,)
    if Ellipsis in key:
        at = key.index(Ellipsis)
        key = key[:at] + (slice(None),) * (x.ndim - len(key) + 1) + key[at + 1:]
    key = key + (slice(None),) * (x.ndim - len(key))
    ranges = [torch.arange(n, device=x.device)[k] for n, k in zip(x.shape, key)]
    kept = [r.ndim for r in ranges]  # 1 for a slice, 0 for an int
    n_kept = sum(kept)
    index, pos = [], 0
    for r in ranges:
        if r.ndim == 0:
            index.append(r)
            continue
        shape = [1] * n_kept
        shape[pos] = -1
        index.append(r.reshape(shape))
        pos += 1
    target = torch.broadcast_shapes(*(i.shape for i in index))
    return x.index_put(tuple(index), torch.broadcast_to(value, target).to(x.dtype), accumulate=True)


def seip_ode_scatter(t, state, p: SEIPParams):
    """The ``.at[slice].add`` form of :func:`seip_ode` (JAX's equivalence
    reference for the pad-based default): every flow increment is a
    scatter-add (:func:`_at_add`), every contraction an ``einsum``. Off
    every hot path."""
    S, E, I, C = state  # S: (A,J,K,M); E/I/C: (A,J,K,L)
    t, season, external, nu = _time_terms(t, p, S)
    infectious = I.sum(dim=(1, 2)) + external.T  # (A, L)
    mixed = p.contact @ infectious  # (A, L)
    lam = (p.beta[None, :] * season / p.pop[:, None]) * mixed  # (A, L)
    escape = _escape(p)  # (L, J, K, M)

    new_exposed = lam[:, None, None, :] * torch.einsum("ljkm,ajkm->ajkl", escape, S)
    dS = -torch.einsum("al,ljkm->ajkm", lam, escape) * S
    dE = new_exposed - p.sigma * E
    dI = p.sigma * E - p.gamma * I
    dC = new_exposed

    recovered = p.gamma * I
    rec_to_hist = torch.einsum("ajkl,jlh->ahk", recovered, p.eta_onehot)
    dS = _at_add(dS, (Ellipsis, 0), rec_to_hist)

    s_by_dose = S.sum(dim=(1, 3))
    rate = torch.clamp(nu * p.pop[:, None] / torch.clamp(s_by_dose, min=1e-8), max=1.0)
    out_lower = rate[:, None, :-1, None] * S[:, :, :-1, :]
    dS = _at_add(dS, (slice(None), slice(None), slice(None, -1), slice(None)), -out_lower)
    dS = _at_add(dS, (slice(None), slice(None), slice(1, None), 0), out_lower.sum(dim=-1))
    out_top = rate[:, None, -1, None] * S[:, :, -1, 1:]
    dS = _at_add(dS, (slice(None), slice(None), -1, slice(1, None)), -out_top)
    dS = _at_add(dS, (slice(None), slice(None), -1, 0), out_top.sum(dim=-1))

    if p.seasonal_vaccination:
        phi = _phi_seasonal(t, p.seasonal_vax_tau)
        top, below = (slice(None), slice(None), -1), (slice(None), slice(None), -2)
        dS = _at_add(_at_add(dS, top, -phi * S[:, :, -1]), below, phi * S[:, :, -1])
        dE = _at_add(_at_add(dE, top, -phi * E[:, :, -1]), below, phi * E[:, :, -1])
        dI = _at_add(_at_add(dI, top, -phi * I[:, :, -1]), below, phi * I[:, :, -1])

    wane_out = p.omega * S
    dS = dS - wane_out
    dS = _at_add(dS, (Ellipsis, slice(1, None)), wane_out[..., :-1])
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


def seip_ode_ensemble_scatter(t, state, p: SEIPParams):
    """The ``.at[slice].add`` form of :func:`seip_ode_ensemble` (JAX's
    equivalence reference), as :func:`seip_ode_scatter` over a trailing
    ensemble axis: ``S (A, J, K, M, B)``, ``E/I/C (A, J, K, L, B)``,
    ``p.beta`` ``(L, B)``. Off every hot path."""
    S, E, I, C = state
    t, season, external, nu = _time_terms(t, p, S)
    infectious = I.sum(dim=(1, 2)) + external.T[..., None]  # (A, L, B)
    mixed = torch.einsum("ac,clb->alb", p.contact, infectious)
    lam = (p.beta[None, :, :] * season / p.pop[:, None, None]) * mixed
    escape = _escape(p)  # (L, J, K, M)

    new_exposed = lam[:, None, None, :, :] * torch.einsum("ljkm,ajkmb->ajklb", escape, S)
    dS = -torch.einsum("alb,ljkm->ajkmb", lam, escape) * S
    dE = new_exposed - p.sigma[:, None] * E
    dI = p.sigma[:, None] * E - p.gamma[:, None] * I
    dC = new_exposed

    recovered = p.gamma[:, None] * I
    rec_to_hist = torch.einsum("ajklb,jlh->ahkb", recovered, p.eta_onehot)
    every = slice(None)
    dS = _at_add(dS, (every, every, every, 0, every), rec_to_hist)

    s_by_dose = S.sum(dim=(1, 3))  # (A, K, B)
    rate = torch.clamp(nu[:, :, None] * p.pop[:, None, None] / torch.clamp(s_by_dose, min=1e-8), max=1.0)
    out_lower = rate[:, None, :-1, None, :] * S[:, :, :-1, :, :]
    dS = _at_add(dS, (every, every, slice(None, -1), every, every), -out_lower)
    dS = _at_add(dS, (every, every, slice(1, None), 0, every), out_lower.sum(dim=3))
    out_top = rate[:, None, -1, None, :] * S[:, :, -1, 1:, :]
    dS = _at_add(dS, (every, every, -1, slice(1, None), every), -out_top)
    dS = _at_add(dS, (every, every, -1, 0, every), out_top.sum(dim=2))

    if p.seasonal_vaccination:
        phi = _phi_seasonal(t, p.seasonal_vax_tau)
        top, below = (every, every, -1), (every, every, -2)
        dS = _at_add(_at_add(dS, top, -phi * S[:, :, -1]), below, phi * S[:, :, -1])
        dE = _at_add(_at_add(dE, top, -phi * E[:, :, -1]), below, phi * E[:, :, -1])
        dI = _at_add(_at_add(dI, top, -phi * I[:, :, -1]), below, phi * I[:, :, -1])

    wane_out = p.omega[:, None] * S
    dS = dS - wane_out
    dS = _at_add(dS, (every, every, every, slice(1, None), every), wane_out[:, :, :, :-1, :])
    return (dS, dE, dI, dC)


__all__ = [
    "SEIPParams",
    "SEIPInitializer",
    "default_contact_matrix",
    "seip_config",
    "seip_odeparams",
    "seip_default_params",
    "seip_initial_state",
    "seip_ode",
    "seip_ode_ensemble",
    "seip_ode_scatter",
    "seip_ode_ensemble_scatter",
    "seip_ensemble_state",
    "seip_ensemble_params",
]
