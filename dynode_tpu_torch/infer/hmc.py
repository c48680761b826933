"""Iterative multinomial NUTS for a bank of chains, with warmup adaptation.

Port of ``dynode_tpu/infer/hmc.py``. The JAX functions are written for one
chain and vmapped; these are written for a **bank**: every chain has its
own step size and mass matrix, with shapes ``(C,)``, ``(C, D)`` and, for a
dense metric, ``(C, D, D)`` (a diagonal one is ``(C, D)``). A bank of one
chain is the JAX function's chain.

- **Lockstep tree building.** JAX's ``while_loop`` under ``vmap`` runs
  until every chain is done and masks the finished ones. Here one Python
  loop drives the bank with a per-chain ``active`` mask and a per-chain
  stack pointer into a ``(C, L, D)`` merge stack (pushed and merged by
  indexing on ``arange(C)``). The loop stops when no chain is active: one
  host sync per leaf (and per doubling), which is noise next to the
  leapfrog's potential and gradient.
- **Draws** go through one seam, :class:`Draws`: the momentum normals, the
  direction bits, the merge and bias uniforms. It is given the mask of
  chains that still draw; the generator-backed seam draws for the whole
  bank and ignores the mask. Each chain takes JAX's count and order of
  draws: one uniform for every one of the ``max_depth + 1`` merge slots
  of every leaf, merged or not, and the bias uniform after the subtree's
  merges. The random streams themselves are PyTorch's, not JAX's.
- **Warmup**: Stan-style windows (fast / doubling-slow / fast) with Welford
  covariance estimation and dual-averaging step-size adaptation.

``pot_and_grad(z)`` maps the ``(C, D)`` positions to ``(C,)`` potentials and
their ``(C, D)`` gradients, detached.
"""

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

MAX_DELTA_ENERGY = 1000.0


# ---------------------------------------------------------------------------
# the seam of every draw
# ---------------------------------------------------------------------------


class Draws:
    """The one place the samplers draw random numbers.

    ``active`` is the ``(C,)`` mask of chains whose draws count; this
    generator-backed seam draws for every chain and ignores it. A seam that
    replays recorded draws (the tests') hands each active chain its next
    one.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, dtype, device, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Standard normals of ``shape`` (momenta)."""
        return torch.randn(shape, generator=self.generator, dtype=dtype, device=device)

    def uniform(self, shape, dtype, device, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Uniforms on [0, 1) of ``shape`` (merge, bias and accept tests)."""
        return torch.rand(shape, generator=self.generator, dtype=dtype, device=device)

    def bernoulli(self, shape, device, active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fair coin flips of ``shape`` as bools (the doubling direction)."""
        return torch.rand(shape, generator=self.generator, device=device) < 0.5


# ---------------------------------------------------------------------------
# mass matrix algebra: diagonal if inv_mass has r's rank, dense if one more
# ---------------------------------------------------------------------------


def _dense(inv_mass, r) -> bool:
    return inv_mass.dim() == r.dim() + 1


def velocity(inv_mass, r):
    """M^{-1} r, chain by chain."""
    if not _dense(inv_mass, r):
        return inv_mass * r
    return (inv_mass @ r.unsqueeze(-1)).squeeze(-1)


def kinetic_energy(inv_mass, r):
    """Momentum kinetic energy under the inverse mass matrix, per chain."""
    return 0.5 * torch.sum(r * velocity(inv_mass, r), dim=-1)


def sample_momentum(inv_mass, chol_inv, eps):
    """r ~ N(0, M) from standard normals ``eps``, where M = inv_mass^{-1}.

    Diagonal: ``chol_inv = sqrt(inv_mass)`` and r = eps / chol_inv. Dense:
    ``chol_inv = L`` with inv_mass = L L^T, and r = L^{-T} eps.
    """
    if not _dense(inv_mass, eps):
        return eps / chol_inv
    return torch.linalg.solve_triangular(chol_inv.mT, eps.unsqueeze(-1), upper=True).squeeze(-1)


def chol_of_inv(inv_mass, dense: bool):
    """Factor used to draw momenta for the given mass matrix: the Cholesky
    factor of a dense ``inv_mass`` (``(..., D, D)``), ``sqrt(inv_mass)`` of
    a diagonal one (``(..., D)``)."""
    if dense:
        return torch.linalg.cholesky(inv_mass)
    return torch.sqrt(inv_mass)


def is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion on the momentum sum, per chain."""
    r_sum_c = r_sum - 0.5 * (r_left + r_right)
    at_left = torch.sum(velocity(inv_mass, r_left) * r_sum_c, dim=-1) <= 0
    at_right = torch.sum(velocity(inv_mass, r_right) * r_sum_c, dim=-1) <= 0
    return at_left | at_right


# ---------------------------------------------------------------------------
# leapfrog
# ---------------------------------------------------------------------------


class IntegratorState(NamedTuple):
    """Leapfrog carry: position, momentum, potential, gradient."""
    z: torch.Tensor
    r: torch.Tensor
    potential: torch.Tensor
    grad: torch.Tensor


def leapfrog(pot_and_grad: Callable, inv_mass, eps, state: IntegratorState):
    """One leapfrog step of every chain; ``eps`` is ``(C,)`` (signed)."""
    e = eps.unsqueeze(-1)
    r_half = state.r - 0.5 * e * state.grad
    z_new = state.z + e * velocity(inv_mass, r_half)
    pe_new, grad_new = pot_and_grad(z_new)
    r_new = r_half - 0.5 * e * grad_new
    return IntegratorState(z_new, r_new, pe_new, grad_new)


def _where(mask, a, b):
    """``where(mask, a, b)`` with the ``(C,)`` mask broadcast over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


def _where_state(mask, a: IntegratorState, b: IntegratorState) -> IntegratorState:
    return IntegratorState(*(_where(mask, x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# iterative subtree construction (binary-counter merge stack)
# ---------------------------------------------------------------------------


_STACK_FIELDS = ("r_left", "r_right", "r_sum", "log_w", "prop_z", "prop_pe", "prop_grad")


def _ctz(i: int) -> int:
    """Count trailing zeros of a positive int, by integer bit operations."""
    return (i & -i).bit_length() - 1


def _build_subtree(
    pot_and_grad,
    inv_mass,
    eps_signed,
    depth: int,
    edge: IntegratorState,
    energy0,
    max_depth: int,
    draws: Draws,
    active: torch.Tensor,
):
    """Take 2^depth leapfrogs from ``edge`` for every ``active`` chain,
    merging with U-turn checks.

    Returns (stack-bottom entry, far-end state, valid, diverging,
    sum_accept, n_leaves); the entries of inactive chains are meaningless.
    ``valid`` is False when the subtree turned or diverged.
    """
    C, D = edge.z.shape
    dtype, dev = edge.z.dtype, edge.z.device
    L = max_depth + 1
    stack = {
        name: torch.zeros((C, L, D) if name in ("r_left", "r_right", "r_sum", "prop_z", "prop_grad") else (C, L),
                          dtype=dtype, device=dev)
        for name in _STACK_FIELDS
    }
    rows = torch.arange(C, device=dev)
    i = torch.zeros(C, dtype=torch.int32, device=dev)
    sp = torch.zeros(C, dtype=torch.int64, device=dev)
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverging = torch.zeros(C, dtype=torch.bool, device=dev)
    sum_acc = torch.zeros(C, dtype=dtype, device=dev)
    cur = edge
    # the chains still going have all taken ``leaf`` leaves, so the merge
    # count after a leaf, ctz(leaf), is one host int for all of them
    for leaf in range(1, (1 << depth) + 1):
        going = active & ~turning & ~diverging
        if not bool(going.any()):  # one host sync per leaf
            break
        new = leapfrog(pot_and_grad, inv_mass, eps_signed, cur)
        energy = new.potential + kinetic_energy(inv_mass, new.r)
        energy = torch.where(torch.isnan(energy), math.inf, energy)
        delta = energy - energy0
        diverging = torch.where(going, delta > MAX_DELTA_ENERGY, diverging)
        sum_acc = torch.where(going, sum_acc + torch.clamp(torch.exp(-delta), max=1.0), sum_acc)
        i = i + going.to(i.dtype)

        # push the leaf
        pushed = {"r_left": new.r, "r_right": new.r, "r_sum": new.r, "log_w": -delta,
                "prop_z": new.z, "prop_pe": new.potential, "prop_grad": new.grad}
        for name in _STACK_FIELDS:
            arr = stack[name]
            arr[rows, sp] = _where(going, pushed[name], arr[rows, sp])
        sp = sp + going.to(sp.dtype)

        # binary-counter merges: after leaf i, merge ctz(i) times; every
        # one of the L slots draws its uniform, merged or not, as in JAX
        u_slots = draws.uniform((C, L), dtype, dev, active=going)
        for j in range(_ctz(leaf)):
            u = u_slots[:, j]
            do = going
            ai = torch.clamp(sp - 2, min=0)  # older (left-in-integration-order) subtree
            bi = torch.clamp(sp - 1, min=0)  # newer
            a = {name: stack[name][rows, ai] for name in _STACK_FIELDS}
            b = {name: stack[name][rows, bi] for name in _STACK_FIELDS}
            r_sum_m = a["r_sum"] + b["r_sum"]
            turn_m = is_turning(inv_mass, a["r_left"], b["r_right"], r_sum_m)
            log_w_m = torch.logaddexp(a["log_w"], b["log_w"])
            take_b = u < torch.exp(b["log_w"] - log_w_m)
            merged = {
                "r_left": a["r_left"],
                "r_right": b["r_right"],
                "r_sum": r_sum_m,
                "log_w": log_w_m,
                "prop_z": _where(take_b, b["prop_z"], a["prop_z"]),
                "prop_pe": _where(take_b, b["prop_pe"], a["prop_pe"]),
                "prop_grad": _where(take_b, b["prop_grad"], a["prop_grad"]),
            }
            for name in _STACK_FIELDS:
                stack[name][rows, ai] = _where(do, merged[name], a[name])
            sp = sp - do.to(sp.dtype)
            turning = turning | (do & turn_m)
        cur = _where_state(going, new, cur)

    valid = ~turning & ~diverging
    entry = {name: stack[name][:, 0] for name in _STACK_FIELDS}
    return entry, cur, valid, diverging, sum_acc, i


# ---------------------------------------------------------------------------
# one NUTS transition
# ---------------------------------------------------------------------------


class HMCState(NamedTuple):
    """The bank's NUTS carry across transitions (JAX's per-chain
    ``HMCState`` stacked on a leading chain axis, without keys: the bank
    draws from one generator)."""
    z: torch.Tensor
    potential: torch.Tensor
    grad: torch.Tensor
    energy: torch.Tensor
    accept_prob: torch.Tensor
    num_steps: torch.Tensor
    diverging: torch.Tensor


def init_state(pot_and_grad, z0) -> HMCState:
    """Initial bank state (potential and gradient evaluated) at ``z0``."""
    pe, grad = pot_and_grad(z0)
    C = z0.shape[0]
    return HMCState(
        z=z0,
        potential=pe,
        grad=grad,
        energy=pe,
        accept_prob=torch.zeros(C, dtype=z0.dtype, device=z0.device),
        num_steps=torch.zeros(C, dtype=torch.int32, device=z0.device),
        diverging=torch.zeros(C, dtype=torch.bool, device=z0.device),
    )


def nuts_transition(
    pot_and_grad,
    inv_mass,
    chol_inv,
    step_size,
    max_depth: int,
    state: HMCState,
    draws: Draws,
) -> HMCState:
    """One NUTS transition of the bank: iterative tree doubling with
    multinomial sampling, every chain with its own ``step_size`` ``(C,)``."""
    C, D = state.z.shape
    dtype, dev = state.z.dtype, state.z.device
    everyone = torch.ones(C, dtype=torch.bool, device=dev)
    r0 = sample_momentum(inv_mass, chol_inv, draws.normal((C, D), dtype, dev, active=everyone))
    energy0 = state.potential + kinetic_energy(inv_mass, r0)
    start = IntegratorState(state.z, r0, state.potential, state.grad)

    minus = plus = start
    r_sum = r0
    log_w = torch.zeros(C, dtype=dtype, device=dev)
    prop_z, prop_pe, prop_grad = state.z, state.potential, state.grad
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverging = torch.zeros(C, dtype=torch.bool, device=dev)
    sum_acc = torch.zeros(C, dtype=dtype, device=dev)
    n_leaves = torch.zeros(C, dtype=torch.int32, device=dev)
    depth = 0
    while depth < max_depth:
        act = ~turning & ~diverging
        if not bool(act.any()):  # one host sync per doubling
            break
        go_right = draws.bernoulli((C,), dev, active=act)
        edge = _where_state(go_right, plus, minus)
        eps_signed = torch.where(go_right, step_size, -step_size)
        entry, far, valid, div_s, sum_a, nl = _build_subtree(
            pot_and_grad, inv_mass, eps_signed, depth, edge, energy0, max_depth, draws, act,
        )
        sum_acc = torch.where(act, sum_acc + sum_a, sum_acc)
        n_leaves = torch.where(act, n_leaves + nl, n_leaves)
        diverging = diverging | (act & div_s)

        # biased progressive sampling toward the new subtree
        u = draws.uniform((C,), dtype, dev, active=act)
        take_new = (u < torch.exp(entry["log_w"] - log_w)) & valid & act
        prop_z = _where(take_new, entry["prop_z"], prop_z)
        prop_pe = _where(take_new, entry["prop_pe"], prop_pe)
        prop_grad = _where(take_new, entry["prop_grad"], prop_grad)
        ok = valid & act
        log_w = torch.where(ok, torch.logaddexp(log_w, entry["log_w"]), log_w)

        plus = _where_state(ok & go_right, far, plus)
        minus = _where_state(ok & ~go_right, far, minus)
        r_sum_new = r_sum + entry["r_sum"]
        turn_glob = is_turning(inv_mass, minus.r, plus.r, r_sum_new)
        turning = torch.where(act, ~valid | (valid & turn_glob), turning)
        r_sum = _where(ok, r_sum_new, r_sum)
        depth += 1

    accept_prob = sum_acc / torch.clamp(n_leaves, min=1).to(dtype)
    return HMCState(
        z=prop_z,
        potential=prop_pe,
        grad=prop_grad,
        energy=energy0,
        accept_prob=accept_prob,
        num_steps=n_leaves,
        diverging=diverging,
    )


# ---------------------------------------------------------------------------
# step-size search + dual averaging + Welford (warmup adaptation)
# ---------------------------------------------------------------------------


def find_reasonable_step_size(pot_and_grad, inv_mass, chol_inv, state, draws: Draws):
    """Double/halve each chain's eps until its 1-leapfrog accept prob
    crosses 0.5 (at most 64 times); ``(C,)``."""
    C, D = state.z.shape
    dtype, dev = state.z.dtype, state.z.device

    def accept_prob(eps, active):
        r0 = sample_momentum(inv_mass, chol_inv, draws.normal((C, D), dtype, dev, active=active))
        st = IntegratorState(state.z, r0, state.potential, state.grad)
        new = leapfrog(pot_and_grad, inv_mass, eps, st)
        e0 = st.potential + kinetic_energy(inv_mass, r0)
        e1 = new.potential + kinetic_energy(inv_mass, new.r)
        e1 = torch.where(torch.isnan(e1), math.inf, e1)
        return torch.exp(e0 - e1)

    eps = torch.ones(C, dtype=dtype, device=dev)
    p0 = accept_prob(eps, torch.ones(C, dtype=torch.bool, device=dev))
    going_up = p0 > 0.5
    crossed = torch.zeros(C, dtype=torch.bool, device=dev)
    for _ in range(64):
        act = ~crossed
        if not bool(act.any()):
            break
        eps_new = torch.where(going_up, eps * 2.0, eps * 0.5)
        p = accept_prob(eps_new, act)
        c = torch.where(going_up, p <= 0.5, p >= 0.5)
        eps = torch.where(act, eps_new, eps)
        crossed = torch.where(act, c, crossed)
    return eps


class DAState(NamedTuple):
    """Dual-averaging carry for step-size adaptation (one entry per chain)."""
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def da_init(eps):
    """Fresh dual-averaging state anchored at ``mu = log(10 * eps0)``."""
    log_eps = torch.log(eps)
    return DAState(
        log_eps=log_eps,
        log_eps_avg=log_eps,
        h_avg=torch.zeros_like(log_eps),
        t=torch.zeros_like(log_eps),
        mu=torch.log(10.0 * eps),
    )


def da_update(da: DAState, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    """Dual-averaging update toward the target acceptance statistic."""
    t = da.t + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * da.h_avg + (target - accept_prob) / (t + t0)
    log_eps = da.mu - torch.sqrt(t) / gamma * h_avg
    # bound adaptation to +-3 nats around the window's anchor (mu = log(10 e0))
    log_eps = torch.minimum(torch.maximum(log_eps, da.mu - 3.0 - math.log(10.0)), da.mu + 3.0)
    w = t**-kappa
    log_eps_avg = w * log_eps + (1.0 - w) * da.log_eps_avg
    return DAState(log_eps, log_eps_avg, h_avg, t, da.mu)


class WelfordState(NamedTuple):
    """Streaming (co)variance accumulator carry (leading chain axes allowed)."""
    mean: torch.Tensor
    m2: torch.Tensor  # (..., D) or (..., D, D)
    n: torch.Tensor  # (...)


def welford_init(D, dense, dtype, batch=(), device=None):
    """Zeroed Welford accumulator (diagonal or dense) over ``batch`` chains."""
    batch = tuple(batch)
    m2 = torch.zeros(batch + ((D, D) if dense else (D,)), dtype=dtype, device=device)
    return WelfordState(torch.zeros(batch + (D,), dtype=dtype, device=device), m2,
                        torch.zeros(batch, dtype=dtype, device=device))


def welford_update(w: WelfordState, x):
    """Fold one sample per chain into the Welford accumulator."""
    n = w.n + 1.0
    delta = x - w.mean
    mean = w.mean + delta / n.unsqueeze(-1)
    delta2 = x - mean
    if w.m2.dim() == w.mean.dim() + 1:
        m2 = w.m2 + delta.unsqueeze(-1) * delta2.unsqueeze(-2)
    else:
        m2 = w.m2 + delta * delta2
    return WelfordState(mean, m2, n)


def welford_covariance(w: WelfordState):
    """Regularized covariance estimate (Stan's shrinkage toward 1e-3 I)."""
    n = torch.clamp(w.n, min=2.0)
    dense = w.m2.dim() == w.mean.dim() + 1
    n = n.reshape(n.shape + ((1, 1) if dense else (1,)))
    cov = w.m2 / (n - 1.0)
    shrink = n / (n + 5.0)
    if dense:
        eye = torch.eye(w.m2.shape[-1], dtype=w.m2.dtype, device=w.m2.device)
        return shrink * cov + 1e-3 * (1.0 - shrink) * eye
    return shrink * cov + 1e-3 * (1.0 - shrink)


def build_warmup_schedule(num_warmup: int) -> Tuple[np.ndarray, np.ndarray]:
    """(is_in_slow_window, is_window_end) flags per warmup step (Stan scheme)."""
    in_slow = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return in_slow, window_end
    if num_warmup >= 150:
        init_buf, term_buf, first_window = 75, 50, 25
    else:
        init_buf = int(0.15 * num_warmup)
        term_buf = int(0.1 * num_warmup)
        first_window = num_warmup - init_buf - term_buf
    pos = init_buf
    window = first_window
    slow_end = num_warmup - term_buf
    while pos < slow_end:
        end = pos + window
        if end + 2 * window > slow_end:
            end = slow_end  # absorb the remainder into the final window
        in_slow[pos:end] = True
        window_end[end - 1] = True
        pos = end
        window *= 2
    return in_slow, window_end


__all__ = [
    "Draws",
    "IntegratorState",
    "HMCState",
    "init_state",
    "nuts_transition",
    "leapfrog",
    "velocity",
    "kinetic_energy",
    "sample_momentum",
    "chol_of_inv",
    "is_turning",
    "find_reasonable_step_size",
    "DAState",
    "da_init",
    "da_update",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_covariance",
    "build_warmup_schedule",
    "MAX_DELTA_ENERGY",
]
