"""Explicit Runge-Kutta tableaus as plain float tuples.

Port of the tableaus of ``dynode_tpu/ode/solvers.py`` (Euler, Heun, Bosh3,
Tsit5, Dopri5) and the classic RK4 tableau of
``dynode_tpu/ops/generic_pallas.py``. The coefficients are the same Python floats, bit for bit (the tests compare them
with the JAX classes), because both the kernels and their plain versions
round each coefficient to float32 exactly where the JAX kernels do.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Tableau:
    """Butcher tableau: nodes ``c``, stage rows ``a``, weights ``b``.

    ``e`` (``b - bhat``) is the embedded error weight row, where the scheme
    has one.
    """

    c: tuple[float, ...]
    a: tuple[tuple[float, ...], ...]
    b: tuple[float, ...]
    e: tuple[float, ...] | None
    order: int
    err_order: int
    fsal: bool


_BOSH3_B = (2 / 9, 1 / 3, 4 / 9, 0.0)
_BOSH3_BHAT = (7 / 24, 1 / 4, 1 / 3, 1 / 8)

#: Bogacki-Shampine 3(2), FSAL
Bosh3 = Tableau(
    c=(0.0, 0.5, 0.75, 1.0),
    a=((0.5,), (0.0, 0.75), (2 / 9, 1 / 3, 4 / 9)),
    b=_BOSH3_B,
    e=tuple(bi - bh for bi, bh in zip(_BOSH3_B, _BOSH3_BHAT)),
    order=3,
    err_order=3,
    fsal=True,
)

#: Tsitouras 5(4), FSAL -- the default solver
Tsit5 = Tableau(
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    a=(
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
    ),
    b=(
        0.09646076681806523,
        0.01,
        0.4798896504144996,
        1.379008574103742,
        -3.290069515436081,
        2.324710524099774,
        0.0,
    ),
    e=(
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    ),
    order=5,
    err_order=5,
    fsal=True,
)

#: forward Euler (no error estimate; constant-step only)
Euler = Tableau(c=(0.0,), a=(), b=(1.0,), e=None, order=1, err_order=2, fsal=False)

#: Heun 2(1) with embedded Euler error estimate
Heun = Tableau(
    c=(0.0, 1.0), a=((1.0,),), b=(0.5, 0.5), e=(-0.5, 0.5), order=2, err_order=2, fsal=False,
)

_DOPRI5_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI5_BHAT = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)

#: Dormand-Prince 5(4), FSAL
Dopri5 = Tableau(
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    a=(
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b=_DOPRI5_B,
    e=tuple(bi - bh for bi, bh in zip(_DOPRI5_B, _DOPRI5_BHAT)),
    order=5,
    err_order=5,
    fsal=True,
)

# classic RK4 (the SEIP kernel's scheme: diagonal tableau, 4 live groups)
RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
RK4_C = (0.0, 0.5, 0.5, 1.0)

#: method -> (a, b, c, n_stages) of the constant-step update. FSAL schemes
#: are cut to the stages that reach the update: Tsit5's 7th and Bosh3's 4th
#: stage have b == 0 and feed only the embedded error estimate.
METHODS = {
    "tsit5": (Tsit5.a, Tsit5.b, Tsit5.c, 6),
    "bosh3": (Bosh3.a, Bosh3.b, Bosh3.c, 3),
    "rk4": (RK4_A, RK4_B, RK4_C, 4),
}

#: adaptive method -> (a, b, e, c, n_stages, err_order) of the embedded pair.
#: Both are FSAL: the last stage is f(t + dt, y_new), has b == 0 and feeds
#: only the error estimate. bosh3 is the default of the adaptive solve.
ADAPTIVE_METHODS = {
    "tsit5": (Tsit5.a, Tsit5.b, Tsit5.e, Tsit5.c, 7, float(Tsit5.err_order)),
    "bosh3": (Bosh3.a, Bosh3.b, Bosh3.e, Bosh3.c, 4, float(Bosh3.err_order)),
}

__all__ = [
    "Tableau", "Euler", "Heun", "Bosh3", "Tsit5", "Dopri5",
    "RK4_A", "RK4_B", "RK4_C", "METHODS", "ADAPTIVE_METHODS",
]
