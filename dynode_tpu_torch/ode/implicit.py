"""Implicit (ESDIRK) solvers for stiff compartmental systems.

Port of ``dynode_tpu/ode/implicit.py``: L-stable singly-diagonally-implicit
RK schemes driven by a simplified Newton iteration.

- **One Jacobian per step, one LU per distinct diagonal.** ``J = df/dy`` is
  taken once at the step start, and ``I - dt*g*J`` is factored once per
  distinct diagonal entry with ``torch.linalg.lu_factor_ex``, whose
  ``_ex`` form makes no host sync for its error check: a singular matrix
  gives inf or NaN, as JAX's ``lu_factor`` does, and the PID controller
  rejects that step (``nan <= 1`` is false).
- **The Jacobian's mode.** JAX takes ``J`` by forward mode (``jacfwd``).
  The port does so while autograd records the solve (a gradient through
  it), since ``torch.func``'s reverse mode cannot run under the
  saved-tensor hooks of the engine's checkpoints; otherwise it takes the
  same matrix by reverse mode, one ``torch.func.vjp`` whose pullback is
  mapped over the basis vectors, because PyTorch's forward mode under a
  ``vmap`` runs each operation of the RHS through a Python decomposition
  (the parameters' zero tangents), which costs more than the rest of the
  step. The two matrices differ by rounding (about 1e-17), which the
  Newton iteration, converging to the same fixed point, does not carry
  into the stages.
- **Fixed-trip Newton.** ``newton_iters`` iterations (default 6) in a
  Python loop, where JAX runs a ``fori_loop``: no data-dependent control
  flow, so a step is differentiable by autograd through the iterations and
  a bank of members stays in lockstep.
- **A flat state.** The linear algebra runs on the state's leaves side by
  side in one vector (the port's flatten of the state tuple, in the
  promoted dtype, as ``ravel_pytree``); the engine keeps seeing tuples.

**The batch.** ``t`` and ``dt`` are tensors whose shape leads every leaf
of the state: ``()`` for one solve, ``(B,)`` for a batch-leading ensemble
(``diffeqsolve(batched=True)``), ``(B, S)`` for the buffered engine's
dense output of one. Each entry of that batch shape is its own system: its
own ``n x n`` Jacobian, built from its own ``dt``, and its own LU, as
under JAX's ``vmap(simulate)``. A batch-leading ensemble maps one
member's whole step over its members with one ``torch.func.vmap`` (the
engine's term carries the member's RHS as ``ODETerm.member_fn``), so the
map's set-up is paid once a step rather than at each of the dozen RHS
calls of the Newton iterations. A lane-major ensemble
(``simulate_ensemble(layout="lane_major")``) is one system whose state
holds every member, as in JAX: its Jacobian is dense in the members,
``(R*B) x (R*B)``, so that layout suits only small ensembles here.

Both solvers are stiffly accurate (the last stage row equals ``b``), so the
last stage derivative is ``f(t1, y1)`` and the engine's FSAL carry applies.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.utils._pytree as pytree

from .solvers import AbstractSolver, ODETerm, _bcast, _flatten, _unflatten


def _jacobian(fvec, yflat: torch.Tensor, forward: bool) -> torch.Tensor:
    """``d fvec / d y`` of each system of the batch: ``(*batch, n, n)`` from
    ``yflat`` ``(*batch, n)``: one tangent (``forward``) or one pullback
    per basis vector, the vector the same for every system, so that each
    system's Jacobian is its own block of the batch's (the systems do not
    couple)."""
    n = yflat.shape[-1]
    eye = torch.eye(n, dtype=yflat.dtype, device=yflat.device)
    if forward:
        def column(v):
            return torch.func.jvp(fvec, (yflat,), (v.expand(yflat.shape),))[1]

        # cols[j, ..., i] = d f_i / d y_j
        return torch.func.vmap(column)(eye).movedim(0, -1)

    _, pullback = torch.func.vjp(fvec, yflat)

    def row(v):
        return pullback(v.expand(yflat.shape))[0]

    # rows[i, ..., j] = d f_i / d y_j
    return torch.func.vmap(row)(eye).movedim(0, -2)


class AbstractImplicitSolver(AbstractSolver):
    """ESDIRK base: an explicit first stage, a shared diagonal ``g`` after.

    Subclasses define the tableau attributes of :class:`AbstractSolver`
    (``c``, strictly lower ``a``, ``b``, ``e``) and ``diag``, the diagonal
    entry of each stage (0.0 marks an explicit stage).
    """

    diag: tuple
    newton_iters: int = 6

    def step_inc(self, term: ODETerm, t, dt, y, args, f0=None, error: bool = True):
        """:meth:`step` in increment form, ``inc = y1 - y``: the stages solve
        for ``y1`` itself, so the increment is the difference (compensated
        summation degrades to it rather than being refused), as in JAX."""
        y1, err, f1 = self.step(term, t, dt, y, args, f0=f0, error=error)
        return tuple(a - b for a, b in zip(y1, y)), err, f1

    def step(self, term: ODETerm, t, dt, y, args, f0=None, error: bool = True):
        """One ESDIRK step: simplified-Newton stage solves and the embedded
        error estimate (None with ``error=False``).

        For a batch-leading ensemble (a term with a ``member_fn``, the one
        member's RHS that the engine maps over the members) the whole step
        of one member is mapped over the members with one
        ``torch.func.vmap``: the same arithmetic as a dozen mapped RHS
        calls, without paying ``vmap``'s set-up on each, and each member
        its own linear system.
        """
        y = tuple(y)
        recording = torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in (*y, *pytree.tree_leaves(args)))
        if term.member_fn is not None:
            return self._member_step(term.member_fn, t, dt, y, args, f0, error, recording)
        return self._step(term, t, dt, y, args, f0, error, recording)

    def _member_step(self, fn, t, dt, y, args, f0, error: bool, recording: bool):
        """:meth:`_step` of one member (``fn`` its RHS), mapped over the
        leading member axis of the state, ``f0`` and every tensor of
        ``args``, and of ``t`` and ``dt`` where they have one (the
        constant-step engine shares a 0-d ``t`` and ``dt``)."""
        leaves, spec = pytree.tree_flatten(args)
        n_y, carry = len(y), f0 is not None
        term = ODETerm(fn)

        def one(t_m, dt_m, *flat):
            f0_m = flat[n_y:2 * n_y] if carry else None
            a_m = pytree.tree_unflatten(list(flat[n_y * (1 + carry):]), spec)
            y1, err, f1 = self._step(term, t_m, dt_m, flat[:n_y], a_m, f0_m, error, recording)
            return y1 + (err or ()) + (f1 or ())

        def member_dim(x):
            return 0 if torch.is_tensor(x) and x.dim() else None

        dims = (member_dim(t), member_dim(dt)) + (0,) * (n_y * (1 + carry)) + tuple(
            0 if isinstance(x, torch.Tensor) else None for x in leaves)
        out = torch.func.vmap(one, in_dims=dims)(t, dt, *y, *(f0 or ()), *leaves)
        y1, rest = out[:n_y], out[n_y:]
        err = rest[:n_y] if self.e is not None and error else None
        f1 = rest[-n_y:] if self.fsal else None
        return y1, err, f1

    def _step(self, term: ODETerm, t, dt, y, args, f0, error: bool, recording: bool):
        """One step of the systems of ``dt``'s batch shape; ``recording``:
        autograd records the solve (the Jacobian's mode, :func:`_jacobian`)."""
        nb = dt.dim() if torch.is_tensor(dt) else 0
        yflat = _flatten(y, nb)

        def fvec(s, zflat):
            return _flatten(term.vf(s, _unflatten(zflat, y, nb), args), nb)

        def scaled(coeff, k):
            return _bcast(dt * coeff, k) * k

        # simplified Newton: one Jacobian at the step start for every stage,
        # one LU per distinct diagonal value
        jac = _jacobian(lambda z: fvec(t, z), yflat, forward=recording)
        eye = torch.eye(yflat.shape[-1], dtype=yflat.dtype, device=yflat.device)
        lu_cache = {}

        ks = []
        for i in range(self.stages):
            ti = t + self.c[i] * dt
            pred = yflat
            if i >= 1:
                for j, aij in enumerate(self.a[i - 1]):
                    if aij != 0.0:
                        pred = pred + scaled(aij, ks[j])
            g = float(self.diag[i])
            if g == 0.0:
                if i == 0 and f0 is not None:
                    k = _flatten(f0, nb)
                else:
                    k = fvec(ti, pred)
            else:
                dtg = dt * g
                if g not in lu_cache:
                    lu, piv, _ = torch.linalg.lu_factor_ex(eye - _bcast(dtg, jac) * jac)
                    lu_cache[g] = (lu, piv)
                lu, piv = lu_cache[g]
                k = ks[-1] if ks else fvec(t, yflat)
                dtg = _bcast(dtg, k)
                for _ in range(self.newton_iters):
                    resid = k - fvec(ti, pred + dtg * k)
                    k = k - torch.linalg.lu_solve(lu, piv, resid.unsqueeze(-1)).squeeze(-1)
            ks.append(k)

        y1 = yflat
        for j, bj in enumerate(self.b):
            if bj != 0.0:
                y1 = y1 + scaled(bj, ks[j])
        err = None
        if self.e is not None and error:
            errflat = torch.zeros_like(yflat)
            for j, ej in enumerate(self.e):
                if ej != 0.0:
                    errflat = errflat + scaled(ej, ks[j])
            err = _unflatten(errflat, y, nb)
        f1 = _unflatten(ks[-1], y, nb) if self.fsal else None
        return _unflatten(y1, y, nb), err, f1


class ImplicitEuler(AbstractImplicitSolver):
    """Backward Euler 1(1), L-stable and stiffly accurate.

    The embedded estimate is the implicit-minus-explicit Euler difference
    ``dt*(k_impl - k_expl)`` = O(dt^2), the usual cheap estimator of a
    first-order implicit method.
    """

    c = (0.0, 1.0)
    a = ((0.0,),)
    diag = (0.0, 1.0)
    b = (0.0, 1.0)
    e = (-1.0, 1.0)
    order = 1
    err_order = 2
    fsal = True


def _trbdf2_tableau():
    """TR-BDF2 as a 3-stage stiffly accurate ESDIRK (gamma = 2 - sqrt(2)).

    Stage 2 is one trapezoidal half-step to t + gamma*dt; stage 3 is the
    BDF2 corrector to t + dt. The embedded weights solve the 3rd-order
    quadrature conditions (Vandermonde at the nodes c = [0, gamma, 1]), an
    O(dt^3)-different companion for the error estimate. The same float64
    numbers as the JAX package's.
    """
    gamma = 2.0 - math.sqrt(2.0)
    d = gamma / 2.0
    w = math.sqrt(2.0) / 4.0
    c = (0.0, gamma, 1.0)
    a = ((d,), (w, w))
    diag = (0.0, d, d)
    b = (w, w, d)
    # bhat: sum bhat = 1, sum bhat*c = 1/2, sum bhat*c^2 = 1/3
    vander = np.vander(np.array(c), increasing=True).T  # rows: c^0, c^1, c^2
    bhat = np.linalg.solve(vander, np.array([1.0, 1.0 / 2.0, 1.0 / 3.0]))
    e = tuple(float(bi - bh) for bi, bh in zip(b, bhat))
    return c, a, diag, b, e


_TRBDF2_C, _TRBDF2_A, _TRBDF2_DIAG, _TRBDF2_B, _TRBDF2_E = _trbdf2_tableau()


class TRBDF2(AbstractImplicitSolver):
    """TR-BDF2 2(3): the L-stable one-step ESDIRK, the workhorse stiff solver.

    The trapezoidal rule to ``t + (2-sqrt(2))*dt``, then BDF2 to ``t + dt``
    (Bank et al. 1985, in its ESDIRK form). For compartmental models with
    fast transients (rapid waning chains, near-equilibrium seasonal forcing)
    where Tsit5's stability limit, not its accuracy, pins the step size.
    """

    c = _TRBDF2_C
    a = _TRBDF2_A
    diag = _TRBDF2_DIAG
    b = _TRBDF2_B
    e = _TRBDF2_E
    order = 2
    err_order = 3
    fsal = True


__all__ = ["AbstractImplicitSolver", "ImplicitEuler", "TRBDF2"]
