"""The JAX package's examples and their ports, loaded side by side.

``examples/`` and ``examples_torch/`` hold scripts of the same names that
import each other by bare name (``_bootstrap``, ``sir_age_stratified``,
``seip_fit``), so each directory's modules are imported in turn, with
the other's moved out of ``sys.modules``, and kept apart here. The JAX
scripts read ``DYNODE_FAST_EXAMPLES`` when imported; they are imported
with it set, so their module-level counts are the FAST ones. Also the
subprocess runner and the comparisons the example tests share.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynode_tpu.infer.util import log_density as jlog_density
from dynode_tpu_torch.infer.util import log_density as tlog_density

REPO = Path(__file__).resolve().parents[2]
DIRS = {"jax": REPO / "examples", "torch": REPO / "examples_torch"}
NAMES = {p.stem for d in DIRS.values() for p in d.glob("*.py")}
SIMULATIONS = ("sir", "sir_age_stratified", "sir_age_risk_stratified", "seirs", "seirs_seasonal_forcing",
               "seirs_multi_strain_age_stratified", "seip", "seirs_stiff_waning")
_LOADED: dict = {}


def load(which: str, name: str):
    """Module ``name`` of ``examples/`` (``which="jax"``) or of
    ``examples_torch/`` (``"torch"``)."""
    if (which, name) not in _LOADED:
        saved = {n: sys.modules.pop(n) for n in NAMES if n in sys.modules}
        fast = os.environ.get("DYNODE_FAST_EXAMPLES")
        os.environ["DYNODE_FAST_EXAMPLES"] = "1"
        sys.path.insert(0, str(DIRS[which]))
        try:
            importlib.import_module(name)
            loaded = {n: sys.modules.pop(n) for n in NAMES if n in sys.modules}
        finally:
            sys.path.remove(str(DIRS[which]))
            sys.modules.update(saved)
            if fast is None:
                del os.environ["DYNODE_FAST_EXAMPLES"]
            else:
                os.environ["DYNODE_FAST_EXAMPLES"] = fast
        for n, mod in loaded.items():
            _LOADED.setdefault((which, n), mod)
    return _LOADED[(which, name)]


def start_script(name: str, cwd, *args, fast: bool = False) -> subprocess.Popen:
    """Start ``python examples_torch/<name>.py *args`` in ``cwd``, headless;
    ``communicate()`` collects its output."""
    env = {k: v for k, v in os.environ.items() if k != "DYNODE_FAST_EXAMPLES"}
    env.update(MPLBACKEND="Agg", OMP_NUM_THREADS="1")
    if fast:
        env["DYNODE_FAST_EXAMPLES"] = "1"
    return subprocess.Popen([sys.executable, str(DIRS["torch"] / f"{name}.py"), *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def rel(got, want) -> float:
    """max |got - want| / max |want| (0 for two zero arrays)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.max(np.abs(want)) if want.size else 0.0
    err = np.max(np.abs(got - want)) if want.size else 0.0
    return float(err / scale) if scale > 0 else float(err)


#: the joint log density and its gradient: within this of JAX's, float64
TOL_LOG_DENSITY = 1e-10


def hold_log_density(jmodel, jkwargs, tmodel, tkwargs, positions):
    """The joint log density and its gradient w.r.t. each site of the
    positions, JAX's and the port's, within ``TOL_LOG_DENSITY`` of JAX's
    largest, in float64."""
    def jlp(p):
        return jlog_density(jmodel, (), jkwargs, p)[0]

    want, wgrad = jax.value_and_grad(jlp)({k: jnp.asarray(v) for k, v in positions.items()})
    tpos = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in positions.items()}
    lp = tlog_density(tmodel, (), tkwargs, tpos)[0]
    lp.backward()
    got = lp.item()
    assert lp.dtype == torch.float64 and np.isfinite(float(want))
    assert abs(got - float(want)) <= TOL_LOG_DENSITY * abs(float(want)), (got, float(want))
    for k in positions:
        w, g = np.asarray(wgrad[k]), tpos[k].grad.numpy()
        assert np.max(np.abs(g - w)) <= TOL_LOG_DENSITY * np.max(np.abs(w)), (k, g, w)


def finite(samples: dict, n: int):
    """Every site of ``samples`` holds ``n`` finite draws."""
    for name, v in samples.items():
        assert v.shape[0] == n and bool(torch.isfinite(v).all()), name
