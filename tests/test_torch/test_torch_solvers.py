"""The port's RK tableaus are the JAX package's, bit for bit.

Tolerance: none. The kernels narrow each coefficient to float32 where the
JAX kernels do, so the Python floats must be identical.
"""

import numpy as np
import pytest

import dynode_tpu.ode.solvers as jsolvers
import dynode_tpu.ops.generic_pallas as gp
from dynode_tpu_torch.ode import solvers as tsolvers


@pytest.mark.parametrize("name", ["Euler", "Heun", "Bosh3", "Tsit5", "Dopri5"])
def test_tableau_equals_jax(name):
    jax_tab = getattr(jsolvers, name)
    port = getattr(tsolvers, name)
    assert port.a == jax_tab.a
    assert port.b == jax_tab.b
    assert port.e == jax_tab.e
    assert port.c == tuple(float(x) for x in np.asarray(jax_tab.c))
    assert (port.order, port.err_order, port.fsal) == (
        jax_tab.order, jax_tab.err_order, jax_tab.fsal,
    )


def test_rk4_equals_jax():
    assert tsolvers.RK4_A == gp._RK4_A
    assert tsolvers.RK4_B == gp._RK4_B
    assert tsolvers.RK4_C == gp._RK4_C


@pytest.mark.parametrize("method", ["tsit5", "bosh3", "rk4"])
def test_methods_table_equals_jax(method):
    a, b, c, n = tsolvers.METHODS[method]
    ja, jb, jc, jn = gp._METHODS[method]
    assert (a, b, n) == (ja, jb, jn)
    assert tuple(c) == tuple(jc)
