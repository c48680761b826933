"""Explicit Runge-Kutta solvers: Butcher tableaus and the RK step.

Port of ``dynode_tpu/ode/solvers.py`` (Euler, Heun, Bosh3, Tsit5, Dopri5)
and the classic RK4 tableau of ``dynode_tpu/ops/generic_pallas.py``. Each
solver is a class in JAX's form: its tableau is class attributes
(``Tsit5.a``, ``Tsit5.b``, ... are the same Python floats as the JAX
classes', bit for bit, because the kernels and their plain versions round
each coefficient to float32 where the JAX kernels do), and an instance
(``Tsit5()``) is what :func:`~dynode_tpu_torch.ode.integrate.diffeqsolve`
and ``SolverParams`` take.

:meth:`AbstractSolver.step` works on a tuple of tensors. ``t`` and ``dt``
are tensors of a batch shape that leads every leaf of the state (``()``
for one solve, ``(B,)`` for a batch-leading ensemble); each coefficient
``dt * a_ij`` is formed first and broadcast over the state, in the JAX
order of operations. The stage sums run once over the whole state, its
leaves side by side in one tensor, rather than leaf by leaf as JAX's
``tree_map`` does: each element takes the same operations in the same
order, in a fifth of the launches for a five-compartment model.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


class ODETerm:
    """Wraps a vector field ``f(t, y, args) -> dy/dt``."""

    def __init__(self, vector_field: Callable, member_fn: Optional[Callable] = None):
        self.vector_field = vector_field
        #: where ``vector_field`` maps one member's RHS over a leading
        #: member axis (a batch-leading ensemble), that RHS: an implicit
        #: solver maps its whole step over the members with it
        self.member_fn = member_fn

    def vf(self, t, y, args):
        """Evaluate the vector field at ``(t, y, args)``."""
        return self.vector_field(t, y, args)


def _bcast(coeff, leaf):
    """``coeff`` (a tensor of the batch shape, or a number) shaped to
    broadcast over ``leaf``, whose leading dimensions are that batch shape."""
    if not hasattr(coeff, "dim") or coeff.dim() in (0, leaf.dim()):
        return coeff
    return coeff.reshape(coeff.shape + (1,) * (leaf.dim() - coeff.dim()))


def _scalars(tree, nb: int) -> bool:
    """Whether every leaf is one number per member (no dimension past the
    ``nb`` batch dimensions): then one stack or unbind moves them all."""
    return all(leaf.dim() == nb for leaf in tree)


def _flatten(tree, nb: int):
    """The leaves of ``tree`` side by side in one tensor, each flattened past
    its ``nb`` leading batch dimensions."""
    if _scalars(tree, nb) and len({leaf.dtype for leaf in tree}) == 1:
        return torch.stack(tuple(tree), dim=-1)
    return torch.cat([leaf.reshape(leaf.shape[:nb] + (-1,)) for leaf in tree], dim=-1)


def _unflatten(flat, like, nb: int):
    """:func:`_flatten` undone: views of ``flat`` shaped as the leaves of ``like``."""
    if _scalars(like, nb):
        return flat.unbind(-1)
    sizes = [math.prod(leaf.shape[nb:]) for leaf in like]
    return tuple(part.reshape(leaf.shape) for part, leaf in zip(flat.split(sizes, dim=-1), like))


def _muladd(acc, scaled):
    """``acc + sum_i coeff_i * k_i`` over flattened states, in the order of
    ``scaled``; ``acc=None`` starts from the first product."""
    for coeff, k in scaled:
        term = _bcast(coeff, k) * k
        acc = term if acc is None else acc + term
    return acc


class AbstractSolver:
    """An explicit RK solver defined by its Butcher tableau.

    ``c``, ``a``, ``b``: nodes, stage rows and weights; ``e = b - bhat`` the
    embedded error weights (``err = dt * sum_j e_j k_j``) or None;
    ``order``; ``err_order``, the controller's exponent order; ``fsal``:
    the last stage is ``f(t1, y1)`` and is carried to the next step.
    """

    c: tuple
    a: tuple
    b: tuple
    e: Optional[tuple]
    order: int
    err_order: int
    fsal: bool = False

    @property
    def stages(self) -> int:
        """Number of RK stages (length of ``b``)."""
        return len(self.b)

    def __hash__(self):
        return hash(type(self))

    def __eq__(self, other):
        return type(self) is type(other)

    def _stages_and_err(self, term: ODETerm, t, dt, y, args, f0, error: bool):
        """``(flat stages, flat y, err, f1)`` of one step from ``(t, y)``."""
        nb = dt.dim() if torch.is_tensor(dt) else 0
        y_flat = _flatten(y, nb)
        k = f0 if self.fsal and f0 is not None else term.vf(t, y, args)
        ks = [_flatten(k, nb)]
        for i in range(1, self.stages):
            coeffs = [(dt * aij, ks[j]) for j, aij in enumerate(self.a[i - 1]) if aij != 0.0]
            y_stage = _unflatten(_muladd(y_flat, coeffs), y, nb) if coeffs else y
            k = term.vf(t + self.c[i] * dt, y_stage, args)
            ks.append(_flatten(k, nb))
        err = None
        if self.e is not None and error:
            flat = _muladd(None, [(dt * ej, ks[j]) for j, ej in enumerate(self.e) if ej != 0.0])
            err = _unflatten(flat, y, nb)
        # the last stage's own leaves, bit for bit: it is the next step's f0
        f1 = k if self.fsal else None
        return ks, y_flat, err, f1, nb

    def _update(self, dt, ks, acc):
        return _muladd(acc, [(dt * bj, ks[j]) for j, bj in enumerate(self.b) if bj != 0.0])

    def step(self, term: ODETerm, t, dt, y, args, f0=None, error: bool = True):
        """Advance one step: ``(y1, err, f1)``.

        ``f0`` is the FSAL carry ``f(t, y)`` (evaluated when None); ``err``
        is None for a solver without an error estimate, or with
        ``error=False`` (a constant step, which does not read it), ``f1``
        None for a solver that is not FSAL.
        """
        ks, y_flat, err, f1, nb = self._stages_and_err(term, t, dt, y, args, f0, error)
        return _unflatten(self._update(dt, ks, y_flat), y, nb), err, f1

    def step_inc(self, term: ODETerm, t, dt, y, args, f0=None, error: bool = True):
        """Like :meth:`step`, but returns the increment
        ``inc = dt * sum_j b_j k_j`` (``y1 = y + inc``) in place of ``y1``:
        what compensated summation adds, since ``y1 - y`` has lost the low
        bits it needs."""
        ks, _, err, f1, nb = self._stages_and_err(term, t, dt, y, args, f0, error)
        return _unflatten(self._update(dt, ks, None), y, nb), err, f1


class Euler(AbstractSolver):
    """Forward Euler (no error estimate; constant-step only)."""

    c = (0.0,)
    a = ()
    b = (1.0,)
    e = None
    order = 1
    err_order = 2
    fsal = False


class Heun(AbstractSolver):
    """Heun 2(1) with embedded Euler error estimate."""

    c = (0.0, 1.0)
    a = ((1.0,),)
    b = (0.5, 0.5)
    e = (-0.5, 0.5)
    order = 2
    err_order = 2
    fsal = False


class Bosh3(AbstractSolver):
    """Bogacki-Shampine 3(2), FSAL."""

    c = (0.0, 0.5, 0.75, 1.0)
    a = ((0.5,), (0.0, 0.75), (2 / 9, 1 / 3, 4 / 9))
    b = (2 / 9, 1 / 3, 4 / 9, 0.0)
    _bhat = (7 / 24, 1 / 4, 1 / 3, 1 / 8)
    e = tuple(bi - bh for bi, bh in zip(b, _bhat))
    order = 3
    err_order = 3
    fsal = True


class Tsit5(AbstractSolver):
    """Tsitouras 5(4), FSAL -- the default solver."""

    c = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
    a = (
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (
            5.325864828439257,
            -11.748883564062828,
            7.4955393428898365,
            -0.09249506636175525,
        ),
        (
            5.86145544294642,
            -12.92096931784711,
            8.159367898576159,
            -0.071584973281401,
            -0.028269050394068383,
        ),
        (
            0.09646076681806523,
            0.01,
            0.4798896504144996,
            1.379008574103742,
            -3.290069515436081,
            2.324710524099774,
        ),
    )
    b = (
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    )
    e = (
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    )
    order = 5
    err_order = 5
    fsal = True


class Dopri5(AbstractSolver):
    """Dormand-Prince 5(4), FSAL."""

    c = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
    a = (
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    )
    b = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
    _bhat = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
    e = tuple(bi - bh for bi, bh in zip(b, _bhat))
    order = 5
    err_order = 5
    fsal = True


# classic RK4 (the SEIP kernel's scheme: diagonal tableau, 4 live groups)
RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
RK4_C = (0.0, 0.5, 0.5, 1.0)

#: method -> (a, b, c, n_stages) of the constant-step kernels. FSAL schemes
#: are cut to the stages that reach the update: Tsit5's 7th and Bosh3's 4th
#: stage have b == 0 and feed only the embedded error estimate.
METHODS = {
    "tsit5": (Tsit5.a, Tsit5.b, Tsit5.c, 6),
    "bosh3": (Bosh3.a, Bosh3.b, Bosh3.c, 3),
    "rk4": (RK4_A, RK4_B, RK4_C, 4),
}

#: adaptive method -> (a, b, e, c, n_stages, err_order) of the adaptive
#: kernels' embedded pair. Both are FSAL: the last stage is f(t + dt, y_new),
#: has b == 0 and feeds only the error estimate. bosh3 is the default of the
#: adaptive solve.
ADAPTIVE_METHODS = {
    "tsit5": (Tsit5.a, Tsit5.b, Tsit5.e, Tsit5.c, 7, float(Tsit5.err_order)),
    "bosh3": (Bosh3.a, Bosh3.b, Bosh3.e, Bosh3.c, 4, float(Bosh3.err_order)),
}

__all__ = [
    "ODETerm", "AbstractSolver", "Euler", "Heun", "Bosh3", "Tsit5", "Dopri5",
    "RK4_A", "RK4_B", "RK4_C", "METHODS", "ADAPTIVE_METHODS",
]
