"""Whole-solve SEIP ensembles: two CUDA C++ kernels and their plain versions.

Port of ``dynode_tpu/ops/seip_pallas.py``. The production SEIP state is 640
floats per member (``S (A, J, K, M)``, ``E/I/C (A, J, K, L)`` at
``(A, J, K, M, L) = (4, 4, 4, 4, 2)``); one initial state is shared by every
member, and each member has its own transmission scales, ``(B,)`` (one for
every strain) or ``(L, B)``.

- :func:`seip_ensemble_solve` runs constant-step RK4. CPU tensors go to
  :func:`seip_solve_reference`, CUDA tensors to ``csrc/seip_rk4.cu``, which
  first writes the time scalars of every stage time into a table
  (:func:`launch_seip_time_table`; plain version
  :func:`seip_time_table_reference`).
- :func:`seip_ensemble_solve_adaptive` runs Bogacki-Shampine 3(2) with one
  dt per lockstep block of ``block_b`` members. CPU tensors go to
  :func:`seip_solve_adaptive_reference`, CUDA tensors to ``csrc/seip_bs3.cu``.

The plain versions compute the kernels' RHS, a transcription of the JAX
kernel's ``_build_rhs`` (:func:`seip_kernel_rhs`): its expression order, its
host-formed constants (``float(beta[l] / pop[a])``, ``mask * pop``, the
escape table formed in float64 and then rounded) and its time scalars, with
the sums over the member's structure taken in the order of the kernels' warp
reductions (:func:`_halves`). ``models/seip.py::seip_ode_ensemble`` stays
the model's RHS; the tests hold the two against each other.

Saves come member-last, ``(T, *compartment, B)``, or with ``packed=True`` in
the JAX kernel's member-tile layout ``(T, *compartment, 8, B // 8)``
(:func:`pack_members`; ``B`` a multiple of 1,024), which the CUDA kernels
write directly.

The library's kernels are instantiated for the production shape
:data:`INSTANTIATED`. Every other shape -- any ``(A, J, K, M, L, seasonal)``
that ``models/seip.py::seip_config`` builds -- goes to a second pair of
CUDA kernels written for any shape (``csrc/shapes/seip_rk4_any.cu``,
``seip_bs3_any.cu`` on ``seip_any.cuh``), built for its shape at first use
(:func:`~._build.shape_library`). Their plain versions are this module's
too: at those shapes :func:`seip_kernel_rhs` and :func:`_member_norm` sum
over the member's structure in the general kernels' order
(:func:`is_production`). A shape whose CTA would need more shared memory
than the card has (:func:`check_kernel_shape`) raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import _device
from ..models.seip import SEIPParams
from . import _build
from .generic import _grid

SUB, LANE = 8, 128
BLOCK = SUB * LANE  # members per tile of the packed layout

#: (A, J, K, M, L, seasonal) the library's CUDA kernels are compiled for;
#: every other shape is built on its own (module docstring)
INSTANTIATED = ((4, 4, 4, 4, 2, True),)
#: most spline knots per (age, dose) the kernels take
MAX_KNOTS = 4
#: lockstep block widths the adaptive kernel is compiled for (warps per CTA):
#: the default, and 8 and 16, which the CPU tests use (16 is one block of
#: their 16 members, the JAX reference's single block). A sweep of a build
#: with 1 to 32 (``chip_sweep.py seip`` on an H100 80GB HBM3 at 700 W; 200
#: days, rtol 1e-4, atol 1e-3, C saves) gave 39.698 / 37.783 / 36.739 / 37.424 / 41.017 /
#: 51.954 ms at B = 32,768 (f32) and 81.470 / 74.243 / 71.451 / 73.278 /
#: 80.147 / 101.180 ms at B = 65,536 (bf16) for 1 / 2 / 4 / 8 / 16 / 32, with
#: 237 attempts per member at every width: the members' step sizes barely
#: differ, so the width moves the barrier and occupancy costs, not the work.
#: 1 and 32 (32 spills), slower in every call and used by no caller, are not
#: compiled.
ADAPTIVE_BLOCKS = (4, 8, 16)
#: members (warps) per CTA of the RK4 kernel, the one width it is compiled
#: for (``kWidth`` in ``csrc/seip_rk4.cu``), 16 warps per SM (at most 128
#: registers a thread): it writes whole 32-byte sectors of bf16 rows, and
#: float32 saves, which take no barrier, hardly care. A sweep of widths 4 /
#: 8 / 16 on an H100 80GB HBM3 at 700 W (B = 32,768, 200 days, dt = 0.5)
#: took 25.614 / 25.772 / 25.614 ms with C saved at the end points only,
#: 30.045 / 30.558 / 30.298 ms with C daily in float32 and 54.143 / 47.898 /
#: 35.569 ms with all four compartments daily in bf16; 20 and 24 warps per
#: SM (width 4; 96 and 80 registers, 244 and 472 bytes of spill stores) took
#: 32.870 and 52.547 ms against 28.820 ms with C saved.
RK4_WIDTH = 16
#: floats before nu(a, k) in a time row of the production shape: season, a
#: pulse per strain, phi (:func:`time_head` at any strain count)
TIME_HEAD = 4
#: members (warps) per CTA of the general RK4 kernel (``kWidth`` in
#: ``csrc/shapes/seip_rk4_any.cu``), and the widest lockstep block of the
#: general BS3 kernel (``kMaxBlock`` in ``seip_bs3_any.cu``)
ANY_RK4_WIDTH = 8
ANY_MAX_BLOCK = 16
#: shared memory a CTA may take on an H100 (227 KB)
MAX_SHARED_BYTES = 232448

#: members per lockstep block when the caller names none: the fastest above
SEIP_ADAPTIVE_BLOCK = 4
SAVE_DTYPES = (torch.float32, torch.bfloat16)
_BS3_ERR_ORDER = 3.0


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def pack_members(x: torch.Tensor) -> torch.Tensor:
    """``(..., B)`` member-last -> ``(..., 8, B // 8)`` tile layout: member
    ``g = blk * 1024 + sub * 128 + lane`` goes to ``[..., sub, blk * 128 + lane]``."""
    *lead, batch = x.shape
    if batch % BLOCK:
        raise ValueError(f"the packed layout needs a batch that is a multiple of {BLOCK}, got {batch}")
    nb = batch // BLOCK
    x = x.reshape(*lead, nb, SUB, LANE).movedim(-3, -2)  # (..., 8, nb, 128)
    return x.reshape(*lead, SUB, nb * LANE)


def unpack_members(x: torch.Tensor) -> torch.Tensor:
    """``(..., 8, B // 8)`` tile layout -> ``(..., B)`` member-last."""
    *lead, _, nl = x.shape
    nb = nl // LANE
    x = x.reshape(*lead, SUB, nb, LANE).movedim(-2, -3)  # (..., nb, 8, 128)
    return x.reshape(*lead, nb * SUB * LANE)


def time_head(n_strains: int) -> int:
    """Floats before nu(a, k) in a time row: season, one pulse per strain, phi."""
    return 2 + n_strains


def is_production(dims, seasonal: bool) -> bool:
    """Whether ``(A, J, K, M, L)`` and ``seasonal`` are the library kernels'
    shape (else the general kernels, and their sum order, serve it)."""
    return (*dims, bool(seasonal)) in INSTANTIATED


def _norm_scales(beta_scales, n_strains: int, dtype, device=None) -> torch.Tensor:
    """``beta_scales`` as the ``(L, B)`` per-strain-per-member form: a
    ``(B,)`` row is broadcast to every strain."""
    s = torch.as_tensor(beta_scales, dtype=dtype, device=device)
    if s.ndim == 1:
        s = s[None, :].expand(n_strains, s.shape[0])
    if s.ndim != 2 or s.shape[0] != n_strains:
        raise ValueError(
            f"beta_scales must be (B,) or (n_strains={n_strains}, B); got "
            f"{tuple(torch.as_tensor(beta_scales).shape)}"
        )
    return s


# ---------------------------------------------------------------------------
# static parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class SeipStatic:
    """Host (float64) copies of the SEIP parameters the kernels bake in."""

    dims: tuple  # (A, J, K, M, L)
    seasonal: bool
    escape: np.ndarray  # (L, J, K, M) susceptibility multiplier
    eta_to: tuple  # (J, L) -> target history
    beta: np.ndarray
    sigma: np.ndarray
    gamma: np.ndarray
    contact: np.ndarray
    pop: np.ndarray
    season_amp: float
    season_peak: float
    intro_time: np.ndarray
    intro_scale: np.ndarray
    intro_perc: np.ndarray
    intro_age_mask: np.ndarray
    vax_knots: np.ndarray
    vax_base_coeffs: np.ndarray
    vax_knot_coeffs: np.ndarray
    seasonal_vax_tau: float
    omega: np.ndarray


def _host(x) -> np.ndarray:
    return torch.as_tensor(x).detach().to("cpu", torch.float64).numpy()


def seip_static_params(p: SEIPParams) -> SeipStatic:
    """Host-fetch ``p`` into the kernels' static parameters.

    The escape table is formed in float64 (``models/seip.py``'s layered
    immunity) and rounded where it is used. Recovery is routed by target
    index, which equals the model's one-hot contraction only when
    ``eta_onehot`` is strictly one-hot: anything else raises ``ValueError``.
    """
    chi, vax_eff = _host(p.chi), _host(p.vax_eff)
    L, J = chi.shape
    A = _host(p.pop).shape[0]
    K = vax_eff.shape[1]
    M = _host(p.omega).shape[0]
    ii = 1.0 - (1.0 - chi[:, :, None]) * (1.0 - vax_eff[:, None, :])
    wib = ii[..., None] * _host(p.base_protection)  # (L, J, K, M)
    fi = (float(_host(p.min_homologous)) * _host(p.hist_mask))[:, :, None, None]
    escape = 1.0 - (wib + (1.0 - wib) * fi)
    eta = _host(p.eta_onehot)  # (J, L, J)
    if not (np.all(np.isin(eta, (0.0, 1.0))) and np.all(eta.sum(axis=-1) == 1.0)):
        raise ValueError("the SEIP kernels require a strictly one-hot eta_onehot transition")
    eta_to = tuple(tuple(int(np.argmax(eta[j, l])) for l in range(L)) for j in range(J))
    return SeipStatic(
        dims=(A, J, K, M, L),
        seasonal=bool(p.seasonal_vaccination),
        escape=escape,
        eta_to=eta_to,
        beta=_host(p.beta),
        sigma=_host(p.sigma),
        gamma=_host(p.gamma),
        contact=_host(p.contact),
        pop=_host(p.pop),
        season_amp=float(_host(p.season_amp)),
        season_peak=float(_host(p.season_peak)),
        intro_time=_host(p.intro_time),
        intro_scale=_host(p.intro_scale),
        intro_perc=_host(p.intro_perc),
        intro_age_mask=_host(p.intro_age_mask),
        vax_knots=_host(p.vax_knots),
        vax_base_coeffs=_host(p.vax_base_coeffs),
        vax_knot_coeffs=_host(p.vax_knot_coeffs),
        seasonal_vax_tau=float(_host(p.seasonal_vax_tau)),
        omega=_host(p.omega),
    )


def kernel_constants(P: SeipStatic) -> dict[str, np.ndarray]:
    """The float64 constants of the kernels' RHS, formed on the host as the
    JAX kernel forms them, in the order the C entry points read them."""
    A, J, K, M, L = P.dims
    return {
        "contact": P.contact,
        "lamc": P.beta[:, None] / P.pop[None, :],  # float(beta[l] / pop[a])
        "sigma": P.sigma,
        "gamma": P.gamma,
        "pop": P.pop,
        "season": np.array([P.season_amp, P.season_peak, P.seasonal_vax_tau]),
        "intro_time": P.intro_time,
        "intro_scale": P.intro_scale,
        "intro_perc": P.intro_perc,
        "intro_norm": P.intro_scale * math.sqrt(2.0 * math.pi),
        "intro_mask": P.intro_age_mask,
        "maskpop": P.intro_age_mask * P.pop[None, :],
        "vax_base": P.vax_base_coeffs,
        "vax_knots": P.vax_knots,
        "vax_kcoef": P.vax_knot_coeffs,
        "omega": P.omega,
        "escape": P.escape,
        "eta_to": np.asarray(P.eta_to, np.float64),
    }


class _Consts:
    """The kernel constants as tensors of the working dtype on one device
    (device tensors, so every operation rounds as on the card)."""

    def __init__(self, P: SeipStatic, dtype, device):
        self.P = P
        self.dims = P.dims
        self.dtype, self.device = dtype, device
        for name, value in kernel_constants(P).items():
            setattr(self, name, torch.as_tensor(value, dtype=dtype, device=device))
        self.intro_on = [float(v) != 0.0 for v in P.intro_perc]
        self.mask_on = [[float(v) != 0.0 for v in row] for row in P.intro_age_mask]
        self.omega_on = [float(v) != 0.0 for v in P.omega]
        self.general = not is_production(P.dims, P.seasonal)

    def c(self, value: float) -> torch.Tensor:
        """A Python float rounded to the working dtype, on the device."""
        return torch.tensor(value, dtype=self.dtype, device=self.device)


# ---------------------------------------------------------------------------
# the kernels' RHS, vectorised over members
# ---------------------------------------------------------------------------


def _halves(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` by halves: the order of a warp's xor-butterfly
    reduction with descending offsets (``v[i] + v[i + n/2]`` first)."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        if n % 2:
            return x.sum(dim)
        x = x.narrow(dim, 0, n // 2) + x.narrow(dim, n // 2, n // 2)
    return x.squeeze(dim)


def _seq_sum(parts) -> torch.Tensor:
    """Left-to-right sum of a sequence of tensors."""
    it = iter(parts)
    acc = next(it)
    for x in it:
        acc = acc + x
    return acc


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """``(A, J, K, X, B)`` -> ``(A, J * K/2, 2 * X, B)``: the kernels' lane
    (age, history, dose pair) and its 2 * X values (K odd: one dose per lane)."""
    A, J, K, X, B = x.shape
    pair = 2 if K % 2 == 0 else 1
    return x.reshape(A, J * (K // pair), pair * X, B)


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` by the square-and-multiply chain of ``jax.lax.integer_pow``."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _time_scalars(C: _Consts, t: torch.Tensor):
    """``(season, pulses, nu (A, K, T), phi)`` at times ``t`` (shape ``(T,)``)."""
    amp, peak, tau = C.season[0], C.season[1], C.season[2]
    two_pi = C.c(2.0 * math.pi)
    season = C.c(1.0) + amp * torch.cos(two_pi * (t - peak) / C.c(365.0))
    pulses = []
    for l, on in enumerate(C.intro_on):
        if on:
            z = (t - C.intro_time[l]) / C.intro_scale[l]
            pulses.append(C.intro_perc[l] * torch.exp(C.c(-0.5) * z * z) / C.intro_norm[l])
        else:
            pulses.append(None)
    base = C.vax_base[..., None]  # (A, K, 4, 1)
    v = base[:, :, 0] + base[:, :, 1] * t + base[:, :, 2] * t * t + base[:, :, 3] * t * t * t
    zero = C.c(0.0)
    for i in range(C.vax_knots.shape[-1]):
        d = t - C.vax_knots[:, :, i, None]
        v = v + C.vax_kcoef[:, :, i, None] * torch.where(d > zero, d * d * d, zero)
    nu = torch.maximum(v, zero)
    phi = None
    if C.P.seasonal:
        phi = _integer_pow(torch.sin(two_pi * (t + tau) / C.c(730.0)), 1000)
    return season, pulses, nu, phi


def rk4_stage_times(dt: float, n_steps: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(n_steps, 3)``: the stage times of RK4 step ``n`` as the kernel forms
    them in ``dtype``: ``float(n) * float(dt)``, then ``+ float(0.5 * dt)``
    and ``+ float(dt)``, each operation rounded once (``t_n + dt`` is not
    always ``float(n + 1) * dt``)."""
    np_t = np.dtype(str(dtype).removeprefix("torch."))
    t0 = np.arange(n_steps).astype(np_t) * np_t.type(dt)
    stages = np.stack([t0, t0 + np_t.type(0.5 * dt), t0 + np_t.type(dt)], axis=1)
    return torch.as_tensor(stages, device=device)


def _time_rows(C: _Consts, t: torch.Tensor) -> torch.Tensor:
    """``(T, time_head(L) + A * K)``: the time rows of the kernels at times
    ``t`` (``(T,)``): season, the pulse of each strain (0 where it has no
    introduction), phi (0 without seasonal vaccination), then ``nu[a, k]``."""
    A, J, K, M, L = C.dims
    season, pulses, nu, phi = _time_scalars(C, t)
    zero = torch.zeros_like(t)
    head = [season, *(zero if p is None else p for p in pulses), zero if phi is None else phi]
    return torch.cat([torch.stack(head, dim=1), nu.reshape(A * K, -1).T], dim=1)


def seip_time_table_reference(P: SeipStatic, *, dt: float, n_steps: int, device) -> torch.Tensor:
    """The plain version of the RK4 kernels' table kernel (``csrc/seip_rk4.cu``,
    ``csrc/shapes/seip_rk4_any.cu``): ``(3 * n_steps, time_head(L) + A * K)``
    float32, the time rows of the stage times of :func:`rk4_stage_times`,
    step by step."""
    C = _Consts(P, torch.float32, torch.device(device))
    return _time_rows(C, rk4_stage_times(dt, n_steps, device=C.device).reshape(-1))


def seip_kernel_rhs(C: _Consts, y, t: torch.Tensor, scale: torch.Tensor):
    """The kernels' SEIP RHS on member-last state, in the JAX kernel's order.

    ``y``: ``S (A, J, K, M, B)``, ``E/I/C (A, J, K, L, B)``; ``t``: ``(1,)``
    or one time per member ``(B,)``; ``scale``: ``(L, B)``. The sums over
    the member's structure follow the kernels' lanes: at the production
    shape (:func:`_lanes`) a lane's own values in order, then :func:`_halves`
    over lanes; at any other shape the general kernels' order
    (``csrc/shapes/seip_any.cuh``), sum_{j,k} I in cell order and
    sum_{j,m} S over m first, then over j.
    """
    S, E, I, _ = y
    A, J, K, M, L = C.dims
    season, pulses, nu, phi = _time_scalars(C, t)

    # ---- force of infection: sum_{j,k} I per (a, l), plus the pulse ----------
    if C.general:
        flat_i = I.reshape(A, J * K, L, -1)
        inf = _seq_sum(flat_i[:, jk] for jk in range(J * K))  # (A, L, B)
    else:
        lanes_i = _lanes(I)  # (A, lanes, pair * L, B)
        pair = lanes_i.shape[2] // L
        part = _seq_sum(lanes_i[:, :, q * L:(q + 1) * L] for q in range(pair))
        inf = _halves(part, 1)  # (A, L, B)
    inf = [[inf[a, l] for l in range(L)] for a in range(A)]
    for l in range(L):
        if pulses[l] is not None:
            for a in range(A):
                if C.mask_on[l][a]:
                    inf[a][l] = inf[a][l] + pulses[l] * C.maskpop[l, a]
    lam = []
    for a in range(A):
        lam.append([
            ((C.lamc[l, a] * season) * scale[l])
            * _seq_sum(C.contact[a, b] * inf[b][l] for b in range(A))
            for l in range(L)
        ])
    lam = torch.stack([torch.stack(row) for row in lam])  # (A, L, B)

    # ---- S: infection out; E/I/C: the exposure chain ---------------------------
    esc = C.escape  # (L, J, K, M)
    coeff = _seq_sum(esc[l][None, ..., None] * lam[:, l, None, None, None, :] for l in range(L))
    dS = -coeff * S  # (A, J, K, M, B)
    dE, dI, dC = [], [], []
    for l in range(L):
        acc = _seq_sum(esc[l, :, :, m][None, ..., None] * S[:, :, :, m] for m in range(M))
        ne = lam[:, l, None, None, :] * acc  # (A, J, K, B)
        dE.append(ne - C.sigma[l] * E[:, :, :, l])
        dC.append(ne)
        dI.append(C.sigma[l] * E[:, :, :, l] - C.gamma[l] * I[:, :, :, l])
    dE, dI, dC = (torch.stack(x, dim=3) for x in (dE, dI, dC))

    # ---- recovery into immune history eta(j, l), waning bin 0 -------------------
    for j in range(J):
        for l in range(L):
            h = C.P.eta_to[j][l]
            dS[:, h, :, 0] = dS[:, h, :, 0] + C.gamma[l] * I[:, j, :, l]

    # ---- vaccination uptake (saturated per dose tier) --------------------------
    by_m = _seq_sum(S[:, :, :, m] for m in range(M))  # (A, J, K, B)
    sbd = _seq_sum(by_m[:, j] for j in range(J)) if C.general else _halves(by_m, 1)  # (A, K, B)
    rate = torch.minimum(
        (nu * C.pop[:, None, None]) / torch.maximum(sbd, C.c(1e-8)), C.c(1.0))
    for kk in range(K):
        r = rate[:, None, kk, None, :]  # (A, 1, 1, B)
        if kk < K - 1:
            out = r * S[:, :, kk]  # (A, J, M, B)
            dS[:, :, kk] = dS[:, :, kk] - out
            dS[:, :, kk + 1, 0] = dS[:, :, kk + 1, 0] + _seq_sum(out[:, :, m] for m in range(M))
        elif M > 1:
            out = r * S[:, :, kk, 1:]
            dS[:, :, kk, 1:] = dS[:, :, kk, 1:] - out
            dS[:, :, kk, 0] = dS[:, :, kk, 0] + _seq_sum(out[:, :, m] for m in range(M - 1))

    # ---- seasonal vaccination reset (top tier -> previous tier) ----------------
    if phi is not None:
        for X, dX in ((S, dS), (E, dE), (I, dI)):
            shift = phi * X[:, :, K - 1]
            dX[:, :, K - 2] = dX[:, :, K - 2] + shift
            dX[:, :, K - 1] = dX[:, :, K - 1] - shift

    # ---- waning chain m -> m + 1 ------------------------------------------------
    for m in range(M - 1):
        if C.omega_on[m]:
            w = C.omega[m] * S[:, :, :, m]
            dS[:, :, :, m] = dS[:, :, :, m] - w
            dS[:, :, :, m + 1] = dS[:, :, :, m + 1] + w
    return dS, dE, dI, dC


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _check_save(save) -> tuple[int, ...]:
    save = tuple(sorted(set(int(i) for i in save)))
    if not save or not all(0 <= i < 4 for i in save):
        raise ValueError(f"save must select compartments among 0..3 (S, E, I, C), got {save}")
    return save


def _seip_grid(duration: float, dt: float, save_every: float) -> tuple[int, int]:
    """``(n_steps, save_stride)`` of the constant-step solve. On top of
    ``generic._grid``'s checks, ``save_every`` must be a whole number of
    ``dt`` steps: the JAX entry point rounds it and saves on another grid."""
    stride = int(round(save_every / dt))
    if stride < 1 or abs(stride * dt - save_every) > 1e-9 * max(1.0, save_every):
        raise ValueError("save_every must be a whole number of dt steps")
    return _grid(duration, dt, save_every)


def _n_saves_adaptive(duration: float, save_every: float) -> int:
    n_saves = int(round(duration / save_every)) + 1
    if abs((n_saves - 1) * save_every - duration) > 1e-6 * max(duration, 1.0):
        raise ValueError("duration must be a multiple of save_every")
    if n_saves < 2:
        raise ValueError("duration must cover at least one save interval")
    return n_saves


def _setup(y0, params, beta_scales, dtype):
    """Static parameters, constants, member-last y0 and (L, B) scales."""
    P = seip_static_params(params)
    y0 = tuple(torch.as_tensor(c) for c in y0)
    device = y0[0].device
    dtype = dtype or y0[0].dtype
    C = _Consts(P, dtype, device)
    scales = _norm_scales(beta_scales, P.dims[-1], dtype, device)
    batch = scales.shape[-1]
    y = tuple(c.to(dtype)[..., None].expand(*c.shape, batch) for c in y0)
    return P, C, y, scales


def seip_solve_reference(
    y0, params: SEIPParams, beta_scales, *, duration, dt=0.5, save_every=1.0,
    save: Sequence[int] = (0, 1, 2, 3), dtype: torch.dtype | None = None,
):
    """The plain version of the constant-step kernel: RK4 on
    :func:`seip_kernel_rhs` in the JAX kernel's stage order.

    Step ``n`` starts at ``float(n) * float(dt)``; ``0.5 * dt``, ``dt`` and
    ``dt / 6`` are Python doubles rounded once. Works in ``dtype`` (default:
    the dtype of ``y0``) on the device of ``y0``. Returns the compartments in
    ``save``, each ``(n_saves, *compartment, B)``.
    """
    save = _check_save(save)
    n_steps, stride = _seip_grid(duration, dt, save_every)
    _, C, y, scale = _setup(y0, params, beta_scales, dtype)
    t0, t_half, t_full = rk4_stage_times(dt, n_steps, C.dtype, C.device).unbind(1)
    h2, h, h6, two = C.c(0.5 * dt), C.c(dt), C.c(dt / 6.0), C.c(2.0)
    outs = [torch.empty((n_steps // stride + 1, *y[i].shape), dtype=C.dtype, device=C.device)
            for i in save]
    for o, i in zip(outs, save):
        o[0] = y[i]
    for step in range(n_steps):
        sl = slice(step, step + 1)
        k = seip_kernel_rhs(C, y, t0[sl], scale)
        ac = k
        st = tuple(a + h2 * b for a, b in zip(y, k))
        k = seip_kernel_rhs(C, st, t_half[sl], scale)
        ac = tuple(a + two * b for a, b in zip(ac, k))
        st = tuple(a + h2 * b for a, b in zip(y, k))
        k = seip_kernel_rhs(C, st, t_half[sl], scale)
        ac = tuple(a + two * b for a, b in zip(ac, k))
        st = tuple(a + h * b for a, b in zip(y, k))
        k = seip_kernel_rhs(C, st, t_full[sl], scale)
        ac = tuple(a + b for a, b in zip(ac, k))
        y = tuple(a + h6 * b for a, b in zip(y, ac))
        if (step + 1) % stride == 0:
            for o, i in zip(outs, save):
                o[(step + 1) // stride] = y[i]
    return tuple(outs)


def _member_norm(C: _Consts, err, y, y_new, atol, rtol) -> torch.Tensor:
    """Each member's scaled RMS error, summed in the kernel's order: a
    lane's values one after another (at the production shape its 20; at any
    other, S of its cells in turn, then E, I, C), then by halves over the 32
    lanes."""
    q = []
    for e, a, b in zip(err, y, y_new):
        r = e / (atol + rtol * torch.maximum(a.abs(), b.abs()))
        q.append(_cell_lanes(r * r) if C.general else _lanes(r * r))
    n_elems = sum(int(np.prod(c.shape[:-1])) for c in y)
    if C.general:  # (32, values, B) each
        q = torch.cat(q, dim=1)
        sq = _seq_sum(q[:, i] for i in range(q.shape[1]))
    else:  # (A, lanes, values, B) each
        q = torch.cat(q, dim=2)
        sq = _seq_sum(q[:, :, i] for i in range(q.shape[2])).reshape(-1, q.shape[-1])
    sq = _halves(sq, 0)  # (32, B) -> (B,)
    return torch.sqrt(sq * C.c(1.0 / n_elems))


def _cell_lanes(x: torch.Tensor) -> torch.Tensor:
    """``(A, J, K, X, B)`` -> ``(32, P * X, B)``: the general kernels' lanes,
    lane q holding cells q, q + 32, ... (P of them) of the flattened (a, j, k)
    cells, each cell's X values in order; cells past the member are zero,
    which adds nothing to a sum."""
    A, J, K, X, B = x.shape
    cells = A * J * K
    per_lane = -(-cells // 32)
    flat = x.reshape(cells, X, B)
    flat = torch.cat([flat, flat.new_zeros((per_lane * 32 - cells, X, B))])
    return flat.reshape(per_lane, 32, X, B).transpose(0, 1).reshape(32, per_lane * X, B)


def seip_solve_adaptive_reference(
    y0, params: SEIPParams, beta_scales, *, duration, save_every=1.0, rtol=1e-4, atol=1e-3,
    dt0=None, steps_per_save=8, block_b: int | None = None,
    save: Sequence[int] = (0, 1, 2, 3), dtype: torch.dtype | None = None,
):
    """The plain version of the adaptive kernel: lockstep BS3(2) per block.

    Members ``[i * block_b, (i + 1) * block_b)`` form block ``i``, with its
    own ``(t, dt)`` chain driven by the max over its members of each
    member's scaled RMS error (the last block may be short).
    ``block_b=None`` is one block of the whole batch, the JAX reference's
    single global block. It takes the kernel's decisions: the controller
    ``clip(0.9 * exp(log(norm) * (-1/3)), 0.2, 10)``, exact landing on save
    points, an accepted clamped step keeping its dt, the attempt budgets
    (``max(4 * steps_per_save, 32)`` in the first interval), and FSAL: after
    an accepted attempt the last stage ``f(t + dt, y_new)`` is the next
    attempt's first, recomputed only after a rejection. Unreached intervals
    save NaN.

    Returns ``(outs, stats)``: the compartments in ``save`` as
    ``(n_saves, *compartment, B)``, and per-block int32
    ``exhausted_intervals``, ``n_accepted`` and ``n_rejected``.
    """
    save = _check_save(save)
    n_saves = _n_saves_adaptive(duration, save_every)
    _, C, y, scale = _setup(y0, params, beta_scales, dtype)
    dev, batch = C.device, scale.shape[-1]
    block_b = batch if block_b is None else int(block_b)
    nb = -(-batch // block_b)
    block_of = torch.arange(batch, device=dev) // block_b
    k_first, k_rest = max(4 * int(steps_per_save), 32), int(steps_per_save)
    dt0 = float(save_every / 8.0 if dt0 is None else dt0)
    np_t = np.dtype(str(C.dtype).removeprefix("torch."))
    se = np_t.type(save_every)
    ends = torch.as_tensor(np.arange(n_saves).astype(np_t) * se, device=dev)
    eps = C.c(1e-6 * max(float(save_every), 1.0))
    atol_c, rtol_c = C.c(atol), C.c(rtol)
    c29, c572, c49 = C.c(2.0 / 9.0), C.c(5.0 / 72.0), C.c(4.0 / 9.0)
    half, three_q = C.c(0.5), C.c(0.75)
    three, twelve, nine, eight = C.c(3.0), C.c(12.0), C.c(9.0), C.c(8.0)
    tiny, nine_tenths, expo = C.c(1e-30), C.c(0.9), C.c(-1.0 / _BS3_ERR_ORDER)
    lo, hi, one = C.c(0.2), C.c(10.0), C.c(1.0)
    i32 = dict(dtype=torch.int32, device=dev)
    t = torch.zeros(nb, dtype=C.dtype, device=dev)
    dt = C.c(dt0).expand(nb).clone()
    kv = torch.zeros(nb, dtype=torch.bool, device=dev)
    na, nr, bad = (torch.zeros(nb, **i32) for _ in range(3))
    k = tuple(torch.zeros_like(c) for c in y)

    def per_member(v):  # (nb,) -> broadcastable against (..., B)
        return v[block_of]

    def block_max(norm_m):
        padded = torch.zeros(nb * block_b, dtype=C.dtype, device=dev)
        padded[:batch] = norm_m
        return padded.reshape(nb, block_b).amax(dim=1)  # a NaN wins

    outs = [torch.empty((n_saves, *y[i].shape), dtype=C.dtype, device=dev) for i in save]
    for o, i in zip(outs, save):
        o[0] = y[i]
    nan = C.c(float("nan"))
    for s in range(1, n_saves):
        s_end = ends[s]
        for _ in range(k_first if s == 1 else k_rest):
            remaining = s_end - t
            active = remaining > eps
            if not bool(active.any()):
                break
            h = torch.minimum(dt, remaining)
            landing = h >= remaining - eps
            stale = per_member(active & ~kv)
            if bool(stale.any()):
                fresh = seip_kernel_rhs(C, y, per_member(t), scale)
                k = tuple(torch.where(stale, f, o) for f, o in zip(fresh, k))
            hm = per_member(h)
            tm = per_member(t)
            ac = tuple(a + (hm * c29) * b for a, b in zip(y, k))
            er = tuple((hm * c572) * b for b in k)
            st = tuple(a + (half * hm) * b for a, b in zip(y, k))
            k2 = seip_kernel_rhs(C, st, tm + half * hm, scale)
            ac = tuple(a + (hm / three) * b for a, b in zip(ac, k2))
            er = tuple(a - (hm / twelve) * b for a, b in zip(er, k2))
            st = tuple(a + (three_q * hm) * b for a, b in zip(y, k2))
            k3 = seip_kernel_rhs(C, st, tm + three_q * hm, scale)
            ac = tuple(a + (hm * c49) * b for a, b in zip(ac, k3))
            er = tuple(a - (hm / nine) * b for a, b in zip(er, k3))
            k4 = seip_kernel_rhs(C, ac, tm + hm, scale)
            er = tuple(a + (hm / eight) * b for a, b in zip(er, k4))
            norm = block_max(_member_norm(C, er, y, ac, atol_c, rtol_c))
            ok = torch.isfinite(norm)
            safe = torch.maximum(norm, tiny)
            factor = torch.clamp(nine_tenths * torch.exp(torch.log(safe) * expo), lo, hi)
            factor = torch.where(ok, factor, lo)
            good = ok & (norm <= one)
            acc = active & good
            dt_new = torch.where(landing & good, dt, h * factor)
            dt = torch.where(active, dt_new, dt)
            acc_m, active_m = per_member(acc), per_member(active)
            y = tuple(torch.where(acc_m, a, o) for a, o in zip(ac, y))
            k = tuple(torch.where(active_m, a, o) for a, o in zip(k4, k))
            t = torch.where(acc, torch.where(landing, s_end, t + h), t)
            kv = torch.where(active, acc, kv)
            na = na + acc.to(torch.int32)
            nr = nr + (active & ~acc).to(torch.int32)
        reached = t >= s_end - eps
        bad = bad + (~reached).to(torch.int32)
        reached_m = per_member(reached)
        for o, i in zip(outs, save):
            o[s] = torch.where(reached_m, y[i], nan)
    stats = {"exhausted_intervals": bad, "n_accepted": na, "n_rejected": nr}
    return tuple(outs), stats


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _ceil4(n: int) -> int:
    return -(-n // 4) * 4


def any_shared_bytes(dims, kernel: str, block_b: int = ANY_MAX_BLOCK) -> int:
    """Dynamic shared memory of a CTA of the general kernels
    (``csrc/shapes/``): the constants at :data:`MAX_KNOTS` knots, then each
    warp's slab (its member's S, E, I and the sums over them) -- and for
    ``kernel == "bs3"`` the attempt's four time rows and the block's norms.
    """
    A, J, K, M, L = dims
    cells = A * J * K
    consts = _ceil4(A * A + 3 * L * A + 2 * L + A + 3 + 4 * L + A * K * (4 + 2 * MAX_KNOTS) + M
                    + L * J * K * M + J * L)
    slab = _ceil4(cells * (M + 2 * L) + 2 * A * L + A * K + L)
    if kernel == "rk4":
        return 4 * (consts + ANY_RK4_WIDTH * slab)
    row = time_head(L) + A * K
    return 4 * (consts + block_b * (slab + _ceil4(4 * row)) + 4 * ANY_MAX_BLOCK)


def check_kernel_shape(P: SeipStatic, block_b: int | None = None) -> None:
    """The kernels' limits (``ValueError`` naming the limit): at most
    :data:`MAX_KNOTS` spline knots; off the production shape, a CTA of the
    general kernels within :data:`MAX_SHARED_BYTES` of shared memory (RK4's
    :data:`ANY_RK4_WIDTH` members, or BS3's ``block_b``)."""
    if P.vax_knots.shape[-1] > MAX_KNOTS:
        raise ValueError(f"the SEIP kernels take at most {MAX_KNOTS} spline knots, "
                         f"got {P.vax_knots.shape[-1]}")
    if is_production(P.dims, P.seasonal):
        return
    kernel, width = ("rk4", ANY_RK4_WIDTH) if block_b is None else ("bs3", block_b)
    need = any_shared_bytes(P.dims, kernel, width)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"the general SEIP {kernel} kernel at (A, J, K, M, L) = {P.dims} needs {need:,} bytes of shared "
            f"memory for a CTA of {width} members, over the card's {MAX_SHARED_BYTES:,}")


def _shape(P: SeipStatic) -> tuple:
    return (*P.dims, int(P.seasonal))


def _device_constants(P: SeipStatic, device) -> torch.Tensor:
    """The general kernels' constants: :func:`_host_constants` on the card,
    where every CTA rounds them to float."""
    return torch.as_tensor(_host_constants(P), device=device)


def _comp_shapes(dims) -> list[tuple[int, ...]]:
    A, J, K, M, L = dims
    return [(A, J, K, M), (A, J, K, L), (A, J, K, L), (A, J, K, L)]


def _kernel_inputs(y0, P: SeipStatic, scales: torch.Tensor, device):
    """``(y0 flat f32, scales (L, B) f32, constants (n,) f64 host)``."""
    flat = torch.cat([torch.as_tensor(c).reshape(-1) for c in y0])
    y0_flat = flat.to(device=device, dtype=torch.float32).contiguous()
    return y0_flat, scales.to(torch.float32).contiguous(), _host_constants(P)


def _host_constants(P: SeipStatic) -> np.ndarray:
    """The constants the C entry points read, float64, in one array."""
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(v, np.float64).reshape(-1) for v in kernel_constants(P).values()]))


def _outputs(P: SeipStatic, save, n_saves, batch, save_dtype, packed, device):
    """Saves in the layout the kernel writes; pointers for the C ABI (0 where
    a compartment is not saved)."""
    outs, ptrs = [], [0, 0, 0, 0]
    for i in save:
        shape = (n_saves, *_comp_shapes(P.dims)[i])
        shape += (SUB, batch // SUB) if packed else (batch,)
        o = torch.empty(shape, dtype=save_dtype, device=device)
        outs.append(o)
        ptrs[i] = o.data_ptr()
    return tuple(outs), ptrs


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def launch_seip_time_table(P: SeipStatic, *, dt: float, n_steps: int, device) -> torch.Tensor:
    """Launch the RK4 kernels' table kernel on ``device`` (CUDA): the
    library's (``csrc/seip_rk4.cu``) at the production shape, the shape
    build of ``csrc/shapes/seip_rk4_any.cu`` at any other.
    ``(3 * n_steps, time_head(L) + A * K)`` float32 time rows of the RK4
    stage times, equal to :func:`seip_time_table_reference` bit for bit.

    Adds one to ``launch_seip_time_table.launches`` per launch.
    """
    check_kernel_shape(P)
    device = _device.require_hopper(device)
    A, _, K, _, L = P.dims
    table = torch.empty((3 * n_steps, time_head(L) + A * K), dtype=torch.float32, device=device)
    n_knots = P.vax_knots.shape[-1]
    if is_production(P.dims, P.seasonal):
        consts = _host_constants(P)
        lib = _build.load_library()
        with torch.cuda.device(device):
            rc = lib.dynode_seip_time_table(
                *P.dims, int(P.seasonal), n_knots, _ptr(consts), float(dt), n_steps,
                table.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    else:
        consts = _device_constants(P, device)
        lib = _build.shape_library("seip_rk4", _shape(P))
        with torch.cuda.device(device):
            rc = lib.dynode_seip_any_time_table(
                n_knots, consts.data_ptr(), float(dt), n_steps, table.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"seip time-table kernel launch failed: CUDA error {rc}")
    launch_seip_time_table.launches += 1
    return table


launch_seip_time_table.launches = 0


def launch_seip_rk4(
    y0, P: SeipStatic, scales: torch.Tensor, *, dt: float, n_steps: int, save_stride: int,
    save: tuple[int, ...], save_dtype: torch.dtype, packed: bool,
):
    """Launch the RK4 kernel: ``csrc/seip_rk4.cu`` at the production shape
    (:data:`RK4_WIDTH` members per CTA), the shape build of
    ``csrc/shapes/seip_rk4_any.cu`` at any other (:data:`ANY_RK4_WIDTH`).
    ``y0`` the shared initial state, ``scales`` ``(L, B)`` on a CUDA device;
    the time table first (:func:`launch_seip_time_table`, on the same
    stream), then the solve. Returns the saved compartments.

    Adds one to ``launch_seip_rk4.launches`` per launch of the solve.
    """
    check_kernel_shape(P)
    device = _device.require_hopper(scales.device)
    batch = scales.shape[-1]
    y0_flat, scales, consts = _kernel_inputs(y0, P, scales, device)
    outs, ptrs = _outputs(P, save, n_steps // save_stride + 1, batch, save_dtype, packed, device)
    table = launch_seip_time_table(P, dt=dt, n_steps=n_steps, device=device)
    tail = (y0_flat.data_ptr(), scales.data_ptr(), *ptrs, int(save_dtype == torch.bfloat16), int(packed),
            batch, float(dt), n_steps, save_stride)
    n_knots = P.vax_knots.shape[-1]
    if is_production(P.dims, P.seasonal):
        lib = _build.load_library()
        with torch.cuda.device(device):
            rc = lib.dynode_seip_rk4(*P.dims, int(P.seasonal), n_knots, _ptr(consts), table.data_ptr(), *tail,
                                     torch.cuda.current_stream(device).cuda_stream)
    else:
        consts = _device_constants(P, device)
        lib = _build.shape_library("seip_rk4", _shape(P))
        with torch.cuda.device(device):
            rc = lib.dynode_seip_any_rk4(n_knots, consts.data_ptr(), table.data_ptr(), *tail,
                                         torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"seip_rk4 kernel launch failed: CUDA error {rc}")
    launch_seip_rk4.launches += 1
    return outs


launch_seip_rk4.launches = 0


def launch_seip_bs3(
    y0, P: SeipStatic, scales: torch.Tensor, *, n_saves: int, save_every: float, rtol: float,
    atol: float, dt0: float, steps_per_save: int, block_b: int, save: tuple[int, ...],
    save_dtype: torch.dtype, packed: bool,
):
    """Launch the BS3 kernel, one CTA of ``block_b`` warps per lockstep
    block: ``csrc/seip_bs3.cu`` at the production shape, the shape build of
    ``csrc/shapes/seip_bs3_any.cu`` at any other. Returns ``(saved
    compartments, flags (nb, 3) int32)`` with the columns exhausted,
    accepted, rejected.

    Adds one to ``launch_seip_bs3.launches`` per launch.
    """
    if block_b not in ADAPTIVE_BLOCKS:
        raise ValueError(f"block_b must be one of {ADAPTIVE_BLOCKS}, got {block_b}")
    check_kernel_shape(P, block_b)
    device = _device.require_hopper(scales.device)
    batch = scales.shape[-1]
    y0_flat, scales, consts = _kernel_inputs(y0, P, scales, device)
    outs, ptrs = _outputs(P, save, n_saves, batch, save_dtype, packed, device)
    flags = torch.empty((-(-batch // block_b), 3), dtype=torch.int32, device=device)
    tail = (y0_flat.data_ptr(), scales.data_ptr(), *ptrs, flags.data_ptr(), int(save_dtype == torch.bfloat16),
            int(packed), batch, block_b, n_saves, float(save_every), float(rtol), float(atol), float(dt0),
            int(steps_per_save))
    n_knots = P.vax_knots.shape[-1]
    if is_production(P.dims, P.seasonal):
        lib = _build.load_library()
        with torch.cuda.device(device):
            rc = lib.dynode_seip_bs3(*P.dims, int(P.seasonal), n_knots, _ptr(consts), *tail,
                                     torch.cuda.current_stream(device).cuda_stream)
    else:
        consts = _device_constants(P, device)
        lib = _build.shape_library("seip_bs3", _shape(P))
        with torch.cuda.device(device):
            rc = lib.dynode_seip_any_bs3(n_knots, consts.data_ptr(), *tail,
                                         torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"seip_bs3 kernel launch failed: CUDA error {rc}")
    launch_seip_bs3.launches += 1
    return outs, flags


launch_seip_bs3.launches = 0


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _entry_setup(y0, params, beta_scales, save, save_dtype, packed):
    save = _check_save(save)
    if save_dtype not in SAVE_DTYPES:
        raise ValueError(f"save_dtype must be one of {SAVE_DTYPES}, got {save_dtype}")
    y0 = tuple(torch.as_tensor(c) for c in y0)
    scales = torch.as_tensor(beta_scales)
    device = _device.common_device(*y0, scales, params.beta)
    batch = int(scales.shape[-1])
    if packed and batch % BLOCK:
        raise ValueError(f"packed=True needs a batch that is a multiple of {BLOCK}, got {batch}")
    return save, y0, scales, device


def rk4_args(y0, params, beta_scales, *, duration, dt=0.5, save_every=1.0, save=(0, 1, 2, 3),
             save_dtype=torch.float32, packed=False):
    """:func:`seip_ensemble_solve`'s checks of its arguments (``ValueError``
    with the value): ``(save, y0, scales, device, (n_steps, save_stride))``."""
    return _entry_setup(y0, params, beta_scales, save, save_dtype, packed) + (_seip_grid(duration, dt, save_every),)


def bs3_args(y0, params, beta_scales, *, duration, save_every=1.0, rtol=1e-4, atol=1e-3, dt0=None,
             steps_per_save=8, save=(0, 1, 2, 3), save_dtype=torch.float32, packed=False, block_b=None):
    """:func:`seip_ensemble_solve_adaptive`'s checks of its arguments
    (``ValueError`` with the value): ``(save, y0, scales, device, n_saves,
    block_b)``."""
    setup = _entry_setup(y0, params, beta_scales, save, save_dtype, packed)
    n_saves = _n_saves_adaptive(duration, save_every)
    block_b = SEIP_ADAPTIVE_BLOCK if block_b is None else int(block_b)
    if block_b not in ADAPTIVE_BLOCKS:
        raise ValueError(f"block_b must be one of {ADAPTIVE_BLOCKS} (a power of two), got {block_b}")
    return setup + (n_saves, block_b)


def _finish(outs, save_dtype, packed):
    outs = tuple(o.to(save_dtype) for o in outs)
    return tuple(pack_members(o) for o in outs) if packed else outs


def seip_ensemble_solve(
    y0,
    params: SEIPParams,
    beta_scales,
    *,
    duration: float,
    dt: float = 0.5,
    save_every: float = 1.0,
    save: Sequence[int] = (0, 1, 2, 3),
    save_dtype: torch.dtype = torch.float32,
    packed: bool = False,
):
    """Solve a B-wide SEIP ensemble with constant-step RK4.

    ``y0``: the shared ``(S, E, I, C)``; ``beta_scales``: ``(B,)`` or
    ``(L, B)`` per-member transmission scales. Returns the compartments in
    ``save`` (ascending indices into ``(S, E, I, C)``), each
    ``(T, *compartment, B)``, or ``(T, *compartment, 8, B // 8)`` with
    ``packed=True`` (``B`` a multiple of 1,024). The state is float32;
    ``save_dtype=torch.bfloat16`` rounds only the saves. ``duration`` must
    be a multiple of ``save_every`` and that of ``dt``. CPU tensors run
    :func:`seip_solve_reference`, CUDA tensors ``csrc/seip_rk4.cu``.
    """
    save, y0, scales, device, (n_steps, stride) = rk4_args(
        y0, params, beta_scales, duration=duration, dt=dt, save_every=save_every, save=save,
        save_dtype=save_dtype, packed=packed)
    if not _device.uses_kernel(device):
        outs = seip_solve_reference(
            y0, params, scales, duration=duration, dt=dt, save_every=save_every, save=save,
            dtype=torch.float32)
        return _finish(outs, save_dtype, packed)
    P = seip_static_params(params)
    return launch_seip_rk4(
        y0, P, _norm_scales(scales, P.dims[-1], torch.float32, device), dt=float(dt),
        n_steps=n_steps, save_stride=stride, save=save, save_dtype=save_dtype, packed=packed)


def seip_ensemble_solve_adaptive(
    y0,
    params: SEIPParams,
    beta_scales,
    *,
    duration: float,
    save_every: float = 1.0,
    rtol: float = 1e-4,
    atol: float = 1e-3,
    dt0: float | None = None,
    steps_per_save: int = 8,
    save: Sequence[int] = (0, 1, 2, 3),
    save_dtype: torch.dtype = torch.float32,
    packed: bool = False,
    block_b: int | None = None,
):
    """Adaptive (lockstep-dt) SEIP ensemble: Bogacki-Shampine 3(2).

    One dt per block of ``block_b`` members (default
    :data:`SEIP_ADAPTIVE_BLOCK`; one of :data:`ADAPTIVE_BLOCKS`, checked on
    every device), driven by the block's max of each member's scaled RMS
    error; see :func:`seip_solve_adaptive_reference` for the controller.
    ``atol`` defaults to 1e-3, scaled for ~1e3-sized compartments. Saves as
    in :func:`seip_ensemble_solve`; NaN for intervals whose attempt budget
    ran out. Returns ``(outs, stats)`` with per-block int32
    ``exhausted_intervals`` (nonzero: raise ``steps_per_save``),
    ``n_accepted`` and ``n_rejected``. CPU tensors run the plain version,
    CUDA tensors ``csrc/seip_bs3.cu``.
    """
    save, y0, scales, device, n_saves, block_b = bs3_args(
        y0, params, beta_scales, duration=duration, save_every=save_every, save=save, save_dtype=save_dtype,
        packed=packed, block_b=block_b)
    dt0 = float(save_every / 8.0 if dt0 is None else dt0)
    kw = dict(save_every=float(save_every), rtol=float(rtol), atol=float(atol), dt0=dt0,
              steps_per_save=int(steps_per_save))
    if not _device.uses_kernel(device):
        outs, stats = seip_solve_adaptive_reference(
            y0, params, scales, duration=duration, block_b=block_b, save=save,
            dtype=torch.float32, **kw)
        return _finish(outs, save_dtype, packed), stats
    P = seip_static_params(params)
    outs, flags = launch_seip_bs3(
        y0, P, _norm_scales(scales, P.dims[-1], torch.float32, device), n_saves=n_saves,
        block_b=block_b, save=save, save_dtype=save_dtype, packed=packed, **kw)
    stats = {"exhausted_intervals": flags[:, 0], "n_accepted": flags[:, 1],
             "n_rejected": flags[:, 2]}
    return outs, stats


__all__ = [
    "ADAPTIVE_BLOCKS",
    "ANY_MAX_BLOCK",
    "ANY_RK4_WIDTH",
    "MAX_SHARED_BYTES",
    "BLOCK",
    "INSTANTIATED",
    "RK4_WIDTH",
    "SEIP_ADAPTIVE_BLOCK",
    "SeipStatic",
    "any_shared_bytes",
    "check_kernel_shape",
    "is_production",
    "launch_seip_bs3",
    "launch_seip_rk4",
    "launch_seip_time_table",
    "pack_members",
    "rk4_stage_times",
    "seip_ensemble_solve",
    "seip_ensemble_solve_adaptive",
    "seip_kernel_rhs",
    "seip_solve_adaptive_reference",
    "seip_solve_reference",
    "seip_static_params",
    "seip_time_table_reference",
    "time_head",
    "unpack_members",
]
