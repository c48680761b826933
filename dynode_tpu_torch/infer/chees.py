"""ChEES-HMC: jittered fixed-length HMC with cross-chain adaptation.

Port of ``dynode_tpu/infer/chees.py`` (Hoffman, Radul & Sountsov, "An
Adaptive-MCMC Scheme for Setting Trajectory Lengths in Hamiltonian Monte
Carlo", AISTATS 2021). One trajectory length is shared by the bank and
learned by Adam on the ChEES criterion, whose gradient is estimated across
the chains; every chain takes the same number of leapfrog steps (the
trajectory jittered by a shared Halton scalar), so a bank transition has
no padding waste. Step size and mass matrix are shared too, adapted from
pooled (window x chains) statistics: the metric is ``(D,)`` or ``(D, D)``
and the step size a scalar tensor, as in JAX.

The draws of a transition (momentum normals, then the accept uniforms) and
of the step-size search go through :class:`~.hmc.Draws`.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from .hmc import (
    MAX_DELTA_ENERGY,
    Draws,
    WelfordState,
    chol_of_inv,
    da_init,
    da_update,
    welford_covariance,
    welford_init,
)
from .util import init_to_median


class ChEES:
    """ChEES-HMC kernel configuration (drop-in kernel for ``MCMC``).

    - ``max_num_steps``: hard cap on leapfrog steps per transition.
    - ``trajectory_length``: fixed integration time; when ``None`` (default)
      it is learned during warmup via Adam on the ChEES criterion.
    - ``adapt_lr``: Adam learning rate for log-trajectory-length.
    - ``target_accept_prob`` defaults to 0.651, the optimal acceptance rate
      for jittered-HMC MH transitions.
    - ``batched_potential_fn``: as for :class:`~.mcmc.NUTS`.
    """

    def __init__(
        self,
        model: Callable,
        *,
        dense_mass: bool = False,
        target_accept_prob: float = 0.651,
        init_strategy: Callable = init_to_median,
        step_size: Optional[float] = None,
        adapt_step_size: bool = True,
        adapt_mass_matrix: bool = True,
        trajectory_length: Optional[float] = None,
        max_num_steps: int = 1024,
        adapt_lr: float = 0.025,
        center_potential: bool = True,
        batched_potential_fn: Optional[Callable] = None,
        **_ignored,
    ):
        self.model = model
        self.dense_mass = dense_mass
        self.target_accept_prob = target_accept_prob
        self.init_strategy = init_strategy
        self.step_size = step_size
        self.adapt_step_size = adapt_step_size
        self.adapt_mass_matrix = adapt_mass_matrix
        self.trajectory_length = trajectory_length
        self.max_num_steps = int(max_num_steps)
        self.adapt_lr = adapt_lr
        self.center_potential = center_potential
        self.batched_potential_fn = batched_potential_fn


# ---------------------------------------------------------------------------
# bank-level mass-matrix algebra ((C, D) batches, shared metric)
# ---------------------------------------------------------------------------


def velocity_bank(inv_mass, r):
    """M^{-1} r for a (C, D) momentum bank (inv_mass shared)."""
    if inv_mass.dim() == 1:
        return inv_mass * r
    return r @ inv_mass  # inv_mass symmetric


def kinetic_bank(inv_mass, r):
    """Per-chain kinetic energy of the momentum bank."""
    return 0.5 * torch.sum(r * velocity_bank(inv_mass, r), dim=-1)


def sample_momentum_bank(inv_mass, chol_inv, eps):
    """r ~ N(0, M) rows from standard normals ``eps`` (C, D); ``chol_inv``
    as in :func:`~.hmc.sample_momentum`, shared."""
    if inv_mass.dim() == 1:
        return eps / chol_inv
    return torch.linalg.solve_triangular(chol_inv.mT, eps.mT, upper=True).mT


_MASKS = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF))


def _halton(i):
    """Base-2 radical inverse (van der Corput) of i+1, in (0, 1), float32.

    JAX reverses the bits of a uint32; here the same swaps run on int64
    with every intermediate masked to 32 bits, which gives the same integer
    and so the same float32 value.
    """
    v = (torch.as_tensor(i, dtype=torch.int64) + 1) & 0xFFFFFFFF
    for shift, m in _MASKS:
        v = ((v >> shift) & m) | ((v & m) << shift)
    v = ((v >> 16) | (v << 16)) & 0xFFFFFFFF
    return v.to(torch.float32) * (2.0**-32)


# ---------------------------------------------------------------------------
# one bank transition
# ---------------------------------------------------------------------------


class ChEESBankState(NamedTuple):
    """Carry of the ChEES transition (the whole chain bank; no key: the
    bank draws from one generator)."""
    z: torch.Tensor  # (C, D)
    potential: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D)
    energy: torch.Tensor  # (C,)
    accept_prob: torch.Tensor  # (C,)
    num_steps: torch.Tensor  # (C,) int32 (shared value broadcast per chain)
    diverging: torch.Tensor  # (C,) bool
    iter_idx: int  # global Halton index


class _TransitionAux(NamedTuple):
    z_prop: torch.Tensor  # (C, D) trajectory endpoints (pre-MH)
    v_end: torch.Tensor  # (C, D) endpoint velocities M^{-1} r
    p_accept: torch.Tensor  # (C,)
    jitter: torch.Tensor  # () the Halton fraction used
    n_steps: int


def init_bank_state(pot_and_grad_bank, z0s) -> ChEESBankState:
    """Initial bank state (potential + gradient) at the given positions."""
    pe, grad = pot_and_grad_bank(z0s)
    C = z0s.shape[0]
    zerosC = torch.zeros(C, dtype=z0s.dtype, device=z0s.device)
    return ChEESBankState(
        z=z0s,
        potential=pe,
        grad=grad,
        energy=pe,
        accept_prob=zerosC,
        num_steps=torch.zeros(C, dtype=torch.int32, device=z0s.device),
        diverging=torch.zeros(C, dtype=torch.bool, device=z0s.device),
        iter_idx=0,
    )


def chees_transition(
    pot_and_grad_bank,
    inv_mass,
    chol_inv,
    eps,
    traj_len,
    max_num_steps: int,
    state: ChEESBankState,
    draws: Draws,
):
    """One jittered-HMC transition for the whole bank (lockstep L steps).

    The step count ``ceil(u * T / eps)`` is read on the host (one sync),
    since it is the loop's length."""
    dtype, dev = state.z.dtype, state.z.device
    C = state.z.shape[0]
    everyone = torch.ones(C, dtype=torch.bool, device=dev)
    r0 = sample_momentum_bank(inv_mass, chol_inv, draws.normal(state.z.shape, dtype, dev, active=everyone))
    energy0 = state.potential + kinetic_bank(inv_mass, r0)

    u = _halton(state.iter_idx).to(dtype=dtype, device=dev)
    n_steps = int(torch.clamp(torch.ceil(u * traj_len / eps).to(torch.int32), 1, max_num_steps))

    z, r, pe, g = state.z, r0, state.potential, state.grad
    for _ in range(n_steps):
        r_half = r - 0.5 * eps * g
        z = z + eps * velocity_bank(inv_mass, r_half)
        pe, g = pot_and_grad_bank(z)
        r = r_half - 0.5 * eps * g

    energy1 = pe + kinetic_bank(inv_mass, r)
    energy1 = torch.where(torch.isnan(energy1), math.inf, energy1)
    delta = energy1 - energy0
    p_accept = torch.clamp(torch.exp(-delta), max=1.0)
    diverging = delta > MAX_DELTA_ENERGY

    accept = draws.uniform(p_accept.shape, dtype, dev, active=everyone) < p_accept
    acc = accept[:, None]
    new_state = ChEESBankState(
        z=torch.where(acc, z, state.z),
        potential=torch.where(accept, pe, state.potential),
        grad=torch.where(acc, g, state.grad),
        energy=energy0,
        accept_prob=p_accept,
        num_steps=torch.full_like(state.num_steps, n_steps),
        diverging=diverging,
        iter_idx=state.iter_idx + 1,
    )
    aux = _TransitionAux(
        z_prop=z,
        v_end=velocity_bank(inv_mass, r),
        p_accept=p_accept,
        jitter=u,
        n_steps=n_steps,
    )
    return new_state, aux


# ---------------------------------------------------------------------------
# ChEES criterion gradient + Adam on log-trajectory-length
# ---------------------------------------------------------------------------


def chees_rate_grad(z_old, aux: _TransitionAux):
    """Estimated d ChEES / d t at t = jitter * T, averaged over the bank
    (paper eq. 10): each chain's term weighted by its acceptance
    probability; non-finite (divergent) endpoints are masked out before
    the bank means."""
    finite = torch.all(torch.isfinite(aux.z_prop) & torch.isfinite(aux.v_end), dim=-1)
    fw = finite.to(z_old.dtype)
    n_ok = torch.clamp(torch.sum(fw), min=1.0)
    z_prop = torch.where(finite[:, None], aux.z_prop, 0.0)
    v_end = torch.where(finite[:, None], aux.v_end, 0.0)
    xo = z_old - torch.mean(z_old, dim=0)
    xp = z_prop - torch.sum(z_prop, dim=0) / n_ok
    a = torch.sum(xp * xp, dim=-1) - torch.sum(xo * xo, dim=-1)
    per_chain = fw * a * torch.sum(xp * v_end, dim=-1)
    w = aux.p_accept / torch.clamp(torch.sum(fw * aux.p_accept), min=1e-6)
    return torch.sum(torch.where(finite, w * per_chain, 0.0))


class TrajAdaptState(NamedTuple):
    """Adam carry for log-trajectory-length (ChEES criterion) adaptation."""
    log_t: torch.Tensor
    log_t_avg: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    step: torch.Tensor


def traj_adapt_init(t0):
    """Fresh trajectory-adaptation state centered on ``t0``."""
    log_t = torch.log(t0)
    z = torch.zeros_like(log_t)
    return TrajAdaptState(log_t, log_t, z, z, z)


def traj_adapt_update(ts: TrajAdaptState, grad_log_t, lr=0.025, b1=0.9, b2=0.999, kappa=0.75):
    """Adam ASCENT step on log T, with DA-style iterate averaging."""
    grad_log_t = torch.where(torch.isfinite(grad_log_t), grad_log_t, 0.0)
    step = ts.step + 1.0
    m = b1 * ts.m + (1.0 - b1) * grad_log_t
    v = b2 * ts.v + (1.0 - b2) * grad_log_t**2
    mhat = m / (1.0 - b1**step)
    vhat = v / (1.0 - b2**step)
    log_t = ts.log_t + lr * mhat / (torch.sqrt(vhat) + 1e-8)
    w = step**-kappa
    log_t_avg = w * log_t + (1.0 - w) * ts.log_t_avg
    return TrajAdaptState(log_t, log_t_avg, m, v, step)


# ---------------------------------------------------------------------------
# pooled (cross-chain) adaptation helpers
# ---------------------------------------------------------------------------


def welford_update_bank(w: WelfordState, zb):
    """Fold a whole (C, D) bank of observations into one shared Welford
    state (Chan et al.'s parallel merge of the bank's batch moments)."""
    C = zb.shape[0]
    n_new = w.n + C
    mean_b = torch.mean(zb, dim=0)
    delta = mean_b - w.mean
    mean = w.mean + delta * (C / n_new)
    centered = zb - mean_b
    if w.m2.dim() == 2:
        m2_b = centered.T @ centered
        cross = torch.outer(delta, delta)
    else:
        m2_b = torch.sum(centered * centered, dim=0)
        cross = delta * delta
    m2 = w.m2 + m2_b + cross * (w.n * C / n_new)
    return WelfordState(mean, m2, n_new)


def find_reasonable_step_size_bank(pot_and_grad_bank, inv_mass, chol_inv, state: ChEESBankState, draws: Draws):
    """Double/halve a SHARED eps until the bank-mean 1-leapfrog accept
    probability crosses 0.5 (one host read per try)."""
    dtype, dev = state.z.dtype, state.z.device
    everyone = torch.ones(state.z.shape[0], dtype=torch.bool, device=dev)

    def accept_prob(eps):
        r0 = sample_momentum_bank(inv_mass, chol_inv, draws.normal(state.z.shape, dtype, dev, active=everyone))
        e0 = state.potential + kinetic_bank(inv_mass, r0)
        r_half = r0 - 0.5 * eps * state.grad
        z1 = state.z + eps * velocity_bank(inv_mass, r_half)
        pe1, g1 = pot_and_grad_bank(z1)
        r1 = r_half - 0.5 * eps * g1
        e1 = pe1 + kinetic_bank(inv_mass, r1)
        e1 = torch.where(torch.isnan(e1), math.inf, e1)
        return torch.mean(torch.clamp(torch.exp(e0 - e1), max=1.0))

    eps = torch.ones((), dtype=dtype, device=dev)
    going_up = bool(accept_prob(eps) > 0.5)
    for _ in range(64):
        eps = eps * 2.0 if going_up else eps * 0.5
        p = accept_prob(eps)
        if bool(p <= 0.5) if going_up else bool(p >= 0.5):
            break
    return eps


# ---------------------------------------------------------------------------
# warmup / sampling parts (bank-level; consumed by MCMC._run_chees)
# ---------------------------------------------------------------------------


class _ChEESCarry(NamedTuple):
    state: ChEESBankState
    da: object
    ts: TrajAdaptState
    wf: WelfordState
    inv_mass: torch.Tensor
    chol: torch.Tensor


def make_chees_parts(kernel: ChEES, pot_and_grad_bank, D: int, dtype, device, draws: Draws):
    """(init_bank, warmup_step, sample_step) bank-level building blocks.

    ``pot_and_grad_bank`` maps (C, D) positions to (potentials, gradients).
    ``warmup_step(carry, slow, end)`` runs one adapting transition;
    ``sample_step(state, inv_mass, chol, eps, traj)`` one sampling
    transition and its collected fields.
    """
    max_steps = kernel.max_num_steps
    target = kernel.target_accept_prob
    lr = kernel.adapt_lr
    dense = kernel.dense_mass

    def fresh_welford():
        return welford_init(D, dense, dtype, device=device)

    def init_bank(z0s):
        state = init_bank_state(pot_and_grad_bank, z0s)
        if dense:
            inv_mass = torch.eye(D, dtype=dtype, device=device)
        else:
            inv_mass = torch.ones(D, dtype=dtype, device=device)
        chol = chol_of_inv(inv_mass, dense)
        if kernel.step_size is not None:
            eps0 = torch.tensor(kernel.step_size, dtype=dtype, device=device)
        else:
            eps0 = find_reasonable_step_size_bank(pot_and_grad_bank, inv_mass, chol, state, draws)
        if kernel.trajectory_length is not None:
            t0 = torch.tensor(kernel.trajectory_length, dtype=dtype, device=device)
        else:
            # start at 8 leapfrogs rather than the paper's 1: Adam on log-T
            # moves at most ~lr nats per iteration, so a short warmup
            # cannot climb several nats from a tiny init
            t0 = 8.0 * eps0
        return _ChEESCarry(state, da_init(eps0), traj_adapt_init(t0), fresh_welford(), inv_mass, chol)

    def warmup_step(carry: _ChEESCarry, slow: bool, end: bool) -> _ChEESCarry:
        state, da, ts, wf, inv_mass, chol = carry
        eps = torch.exp(da.log_eps) if kernel.adapt_step_size else torch.exp(da.log_eps_avg)
        traj = torch.maximum(torch.exp(ts.log_t), eps)
        z_old = state.z
        state, aux = chees_transition(pot_and_grad_bank, inv_mass, chol, eps, traj, max_steps, state, draws)
        if kernel.adapt_step_size:
            da = da_update(da, torch.mean(aux.p_accept), target=target)
        if kernel.trajectory_length is None:
            # d/d logT = (dt/d logT) * d/dt = (u * T) * chees_rate_grad
            g = chees_rate_grad(z_old, aux) * aux.jitter * traj
            ts = traj_adapt_update(ts, g, lr=lr)
            # keep T within the integrable range for the current eps
            hi = torch.log(eps * max_steps)
            lo = torch.log(eps)
            ts = ts._replace(
                log_t=torch.minimum(torch.maximum(ts.log_t, lo), hi),
                log_t_avg=torch.minimum(torch.maximum(ts.log_t_avg, lo), hi),
            )
        if kernel.adapt_mass_matrix:
            if slow:
                wf = welford_update_bank(wf, state.z)
            if end:
                inv_mass = welford_covariance(wf)
                chol = chol_of_inv(inv_mass, dense)
                wf = fresh_welford()
                if kernel.adapt_step_size:
                    # the metric changed: restart step-size averaging around
                    # a re-searched eps; the trajectory length carries over
                    eps_new = find_reasonable_step_size_bank(pot_and_grad_bank, inv_mass, chol, state, draws)
                    da = da_init(eps_new)
        return _ChEESCarry(state, da, ts, wf, inv_mass, chol)

    def sample_step(state, inv_mass, chol, eps, traj):
        state, _ = chees_transition(pot_and_grad_bank, inv_mass, chol, eps, traj, max_steps, state, draws)
        out = {
            "z": state.z,
            "potential_energy": state.potential,
            "energy": state.energy,
            "accept_prob": state.accept_prob,
            "num_steps": state.num_steps,
            "diverging": state.diverging,
        }
        return state, out

    return init_bank, warmup_step, sample_step


__all__ = [
    "ChEES",
    "ChEESBankState",
    "chees_transition",
    "chees_rate_grad",
    "make_chees_parts",
    "init_bank_state",
    "welford_update_bank",
    "find_reasonable_step_size_bank",
    "traj_adapt_init",
    "traj_adapt_update",
    "TrajAdaptState",
    "velocity_bank",
    "kinetic_bank",
    "sample_momentum_bank",
]
