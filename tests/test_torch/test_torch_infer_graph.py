"""The generic potential of ``MCMC`` as it is captured into a CUDA graph on
the card, checked on the CPU.

On a card, ``MCMC.run`` of a model with no batched potential captures the
chain-mapped potential and gradient (``torch.func.vmap`` of
``grad_and_value``) into one CUDA graph and replays it. A capture forbids
host reads of device values and copies from the host, which the CPU
cannot show directly, so here:

- (a) the potential of every model that an example of ``examples_torch/``
  fits by NUTS or ChEES, and of the golden SEIP model, runs under a
  ``TorchDispatchMode`` that raises on the host reads (``aten.item``'s
  ``_local_scalar_dense``, ``nonzero``, ``equal``) and on any tensor made
  from host data (``lift_fresh``) outside the port's placement helpers,
  which build it once outside the transform and keep its copy on the card
  (the mode composes with ``torch.func`` on this torch);
- (a2) the port's generic potential and gradient of the golden SEIP model
  equal ``jax.vmap(jax.value_and_grad)`` of the JAX package's within 1e-10
  (value, relative) and 1e-8 (gradient, of its largest) in float64;
- (b) the engine's rewritten constants equal the former ones on CPU
  tensors, and a tensor on another device is never read on the host;
- (c) on CPU tensors, and for the sequential method, ``MCMC`` runs the
  eager map, and a wrapper of ``mcmc.generic_pot_and_grad`` sees every
  evaluation of the bank.
"""

import importlib.util
import math
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
import torch_golden_seip as golden
import dynode_tpu.dist as jdist
from dynode_tpu.infer import util as jutil
from dynode_tpu_torch import _device, dist
from dynode_tpu_torch.infer import MCMC, NUTS, ChEES, handlers, mcmc
from dynode_tpu_torch.infer import util as tutil
from dynode_tpu_torch.ode import integrate
from dynode_tpu_torch.ode.controllers import ClipStepSizeController, ConstantStepSize, PIDController
from example_twins import load

CPU = torch.device("cpu")
F64 = torch.float64
CAPTURE_DAYS = 3  # (a): the fit window of each model
#: (a): the fits of examples_torch/ by NUTS or ChEES (svi_multistart's ChEES
#: bank fits sir_infer_parameters' model), by chip_smoke.fit_models' labels
FITS = ["ensemble_scenarios", "hierarchical_strains", "seip_fit", "sir_infer_parameters",
        "model_selection poisson", "model_selection negbin", "golden_seip"]
HOST_READS = {"aten._local_scalar_dense.default", "aten.nonzero.default", "aten.equal.default"}
#: the port's functions that build host data into a tensor kept on the card
PLACEMENT = {"from_host", "_save_grid"}


class NoHostTraffic(TorchDispatchMode):
    """Raise on a host read, and on a tensor made from host data outside
    the placement helpers: what a CUDA-graph capture forbids on the card."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in HOST_READS:
            raise AssertionError(f"host read {func}")
        if str(func) == "aten.lift_fresh.default":
            names = {frame.name for frame in traceback.extract_stack()}
            if not names & PLACEMENT:
                raise AssertionError(f"a tensor made from host data at {traceback.extract_stack()[-3]}")
        return func(*args, **(kwargs or {}))


def _fit_model(label: str, days: int):
    """(model, keyword arguments) of fit ``label`` on CPU tensors in float64
    over ``days``."""
    if label == "golden_seip":
        _, base, y0, sp = golden.build_fit(CPU)
        obs = np.random.default_rng(0).poisson(20.0, (days, 2)).astype(np.float64)
        return golden.make_model(base, y0, sp, days=days), {"obs_data": torch.as_tensor(obs)}
    name = label.split()[0]
    for got, model, kwargs in chip_smoke.fit_models(name, load("torch", name), CPU, days, F64):
        if got == label:
            return model, kwargs
    raise KeyError(label)


@pytest.mark.parametrize("label", FITS)
def test_generic_potential_makes_no_host_read_or_copy(label):
    model, kwargs = _fit_model(label, CAPTURE_DAYS)
    flat, z = chip_smoke.bank_potential(model, kwargs, 2, CPU)
    pot_and_grad = mcmc.generic_pot_and_grad(flat)
    want = pot_and_grad(z)
    with NoHostTraffic():
        pe, grad = pot_and_grad(z)
    assert pe.shape == (2,) and grad.shape == z.shape
    assert torch.equal(pe, want[0]) and torch.equal(grad, want[1])
    assert bool(torch.isfinite(pe).all() and torch.isfinite(grad).all())


def _jax_golden():
    """``tests/test_infer/test_seip_quadrature.py``, the JAX package's
    golden SEIP fit, loaded from its file."""
    path = Path(__file__).resolve().parents[1] / "test_infer" / "test_seip_quadrature.py"
    spec = importlib.util.spec_from_file_location("jax_seip_quadrature", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_golden_seip_generic_potential_matches_jax(monkeypatch):
    """2 chains, 10 days, the golden's pinned counts, no centring: value
    within 1e-10 of JAX's, gradient within 1e-8 of its largest."""
    days = 10
    jm = _jax_golden()
    monkeypatch.setattr(jm, "FIT_DAYS", days)
    obs = np.load(golden.GOLDEN)["obs"][:days]
    bounds = dict(low=golden.PRIOR_LO, high=golden.PRIOR_HI)  # the prior's support, its bijection each side's
    _, jbase, jy0, jsp = jm.build_fit()
    jmodel, jkwargs = jm.make_model(jbase, jy0, jsp), {"obs_data": jnp.asarray(obs)}
    jtransforms = {"beta_scales": jdist.biject_to(jdist.TruncatedNormal(1.0, 1.0, **bounds).support)}
    jflat, jflat0, _ = jutil.flatten_potential(jutil.make_potential_fn(jmodel, (), jkwargs, jtransforms),
                                               {"beta_scales": jnp.zeros(2)})

    _, base, y0, sp = golden.build_fit(CPU)
    tmodel, tkwargs = golden.make_model(base, y0, sp, days=days), {"obs_data": torch.as_tensor(obs)}
    ttransforms = {"beta_scales": dist.biject_to(dist.TruncatedNormal(1.0, 1.0, **bounds).support)}
    tflat, _, _ = tutil.flatten_potential(tutil.make_potential_fn(tmodel, (), tkwargs, ttransforms),
                                          {"beta_scales": torch.zeros(2, dtype=F64)})

    z = np.random.default_rng(4).normal(0.0, 0.5, (2, jflat0.shape[0]))
    want_pe, want_grad = jax.jit(jax.vmap(jax.value_and_grad(jflat)))(jnp.asarray(z))
    pe, grad = mcmc.generic_pot_and_grad(tflat)(torch.as_tensor(z))
    want_pe, want_grad = np.asarray(want_pe), np.asarray(want_grad)
    assert pe.dtype == F64 and np.all(np.isfinite(want_pe))
    assert np.max(np.abs(pe.numpy() - want_pe) / np.abs(want_pe)) <= 1e-10
    assert np.max(np.abs(grad.numpy() - want_grad)) <= 1e-8 * np.max(np.abs(want_grad))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_engine_constants_equal_the_former_ones_on_cpu_tensors(dtype):
    """``_jump_grid``, ``_init_dt``, ``_save_grid`` and the ``[t0, t1]``
    grid against the expressions they replace."""
    like = torch.zeros((), dtype=dtype)
    ctl = ClipStepSizeController(PIDController(1e-3, 1e-6), jump_ts=[7.5, 2.0])
    assert torch.equal(integrate._jump_grid(ctl, like), torch.tensor((2.0, 7.5, float("inf")), dtype=dtype))
    assert integrate._jump_grid(ClipStepSizeController(PIDController(1e-3, 1e-6)), like) is None

    t0 = torch.zeros(3, dtype=dtype)
    for dt0 in (0.1, torch.tensor(0.1, dtype=F64)):
        got = integrate._init_dt(ConstantStepSize(), None, None, t0, None, None, None, None, dt0)
        assert torch.equal(got, torch.as_tensor(dt0, dtype=dtype).expand(3))

    for ts in (np.linspace(0.0, 5.0, 11), [0.0, 0.3, 1.7], torch.linspace(0.0, 2.0, 5, dtype=F64)):
        grid, values = integrate._save_grid(ts, dtype, CPU)
        former = torch.as_tensor(np.asarray(ts.cpu() if torch.is_tensor(ts) else ts, dtype=np.float64)).to(dtype)
        assert torch.equal(grid, former) and np.array_equal(values, former.double().numpy())

    for t0, t1 in ((0.0, 2.5), (1, 100), (torch.tensor(0.5, dtype=F64), torch.tensor(7.25, dtype=F64))):
        t0_arr, t1_arr = _device.scalar(t0, dtype, CPU), _device.scalar(t1, dtype, CPU)  # as diffeqsolve
        got = integrate._end_grid(t0, t1, t0_arr, t1_arr, dtype, CPU)
        assert torch.equal(got, torch.stack([t0_arr, t1_arr]).cpu())


def test_a_tensor_on_another_device_is_never_read_on_the_host():
    """A 0-d time or a save grid on a device other than the CPU (``meta``
    here: it has no values) is dynamic: no float() of it, and the grid
    stays where it is, with no host values (the buffered engine's route)."""
    t = torch.zeros((), device="meta")
    assert integrate._static_float(t) is None
    assert integrate._static_float(torch.tensor(2.5)) == 2.5
    grid, values = integrate._save_grid(torch.linspace(0.0, 1.0, 4, device="meta"), torch.float32, "meta")
    assert values is None and grid.device.type == "meta" and grid.dtype == torch.float32
    assert integrate._end_grid(t, t, t, t, torch.float32, "meta").device.type == "meta"


def test_generic_pot_and_grad_is_graphed_on_a_card_only():
    """A CUDA device gives a :class:`GraphedPotential` (built, not yet
    captured: no card is touched); None or the CPU gives the eager map."""
    def flat(z):
        return (z * z).sum()

    assert not isinstance(mcmc.generic_pot_and_grad(flat), mcmc.GraphedPotential)
    assert not isinstance(mcmc.generic_pot_and_grad(flat, CPU), mcmc.GraphedPotential)
    graph = mcmc.generic_pot_and_grad(flat, torch.device("cuda"))
    assert isinstance(graph, mcmc.GraphedPotential) and graph.graph is None and graph.replays == 0
    graph.release()
    assert graph.graph is None and graph.constants == {}


def _normal_model(obs):
    mu = handlers.sample("mu", dist.Normal(torch.zeros((), dtype=obs.dtype), 1.0))
    handlers.sample("obs", dist.Normal(mu, 1.0), obs=obs)


@pytest.mark.parametrize("kind, method", [("nuts", "vectorized"), ("chees", "vectorized"), ("nuts", "sequential")])
def test_cpu_and_sequential_runs_are_eager_and_every_call_is_seen(monkeypatch, kind, method):
    """On CPU tensors (and sequentially) ``MCMC`` asks the seam for no graph
    and keeps none; ``chip_smoke.counting_gradients``' wrapper counts one
    call per bank evaluation (each runs the flat potential once under the
    vmap), and the draws equal an unwrapped run's."""
    obs = torch.as_tensor(np.random.default_rng(1).normal(0.4, 1.0, 16))
    plain = mcmc.generic_pot_and_grad
    asked, flat_calls = [], [0]

    def recording(flat_potential, graph_device=None):
        asked.append(graph_device)

        def flat(z):
            flat_calls[0] += 1
            return flat_potential(z)

        return plain(flat, graph_device)

    def run():
        kernel = NUTS(_normal_model, max_tree_depth=3) if kind == "nuts" else ChEES(_normal_model)
        mc = MCMC(kernel, num_warmup=6, num_samples=4, num_chains=4, chain_method=method)
        return mc.run(torch.Generator().manual_seed(2), obs=obs)

    want = run().get_samples()["mu"]
    mcmc.clear_exec_cache()  # the wrapped run builds its potential anew, not from the first run's entry
    monkeypatch.setattr(mcmc, "generic_pot_and_grad", recording)
    with chip_smoke.counting_gradients() as seen:
        mc = run()
    assert asked == [None] and seen["graphs"] == [] and mc.graphs == [] and mc.graph is None
    assert seen["calls"] == flat_calls[0] > 0
    assert torch.equal(mc.get_samples()["mu"], want)
    assert math.isfinite(float(want.mean()))
