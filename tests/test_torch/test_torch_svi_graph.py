"""The SVI step as it is captured into a CUDA graph on the card, checked on
the CPU.

On a card, ``SVI.run`` and ``SVI.run_multistart`` capture their step into
one CUDA graph (``infer.graphs.GraphedStep``) and replay it; on CPU tensors
``GraphedStep`` steps the same static buffers by calling the function,
which these tests force with ``svi._graphed = lambda device: True``:

- (a) the captured step (``SVI.update``'s, and the bank's vmapped step) of
  ``chip_smoke.fit_model`` and of ``examples_torch/sir_infer_parameters``'
  model (which ``svi_multistart`` fits too), under each guide, runs under
  ``test_torch_infer_graph``'s ``NoHostTraffic``: no host read, no tensor
  made from host data (the ODE engine takes its card route there, masking
  finished steps where CPU tensors read the done mask on the host);
- (b) the static-buffer loop equals the eager loop bit for bit over 3
  steps, for ``run`` and ``run_multistart`` (with and without a mesh):
  losses, parameters, optimizer state and final ELBOs, and the seam is
  left at the same position;
- (c) a ``run`` given another SVI's ``init_state`` traces the guide's draw
  signature without drawing from the run's seam.
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import chip_smoke
from dynode_tpu_torch import dist
from dynode_tpu_torch.infer import (
    SVI,
    Adam,
    AutoDelta,
    AutoMultivariateNormal,
    AutoNormal,
    ClippedAdam,
    Trace_ELBO,
    handlers,
)
from dynode_tpu_torch.infer import svi as svi_mod
from dynode_tpu_torch.ode import integrate
from dynode_tpu_torch.parallel import create_mesh
from example_twins import load
from test_torch_infer_graph import NoHostTraffic

CPU = torch.device("cpu")
F64 = torch.float64
DAYS = 3  # (a): the fit window of each model
GUIDES = {"mvn": AutoMultivariateNormal, "normal": AutoNormal, "delta": AutoDelta}


class CheckedStep(svi_mod.GraphedStep):
    """A ``GraphedStep`` whose captured part (the step and the copy of its
    state into the buffers) runs under ``NoHostTraffic``."""

    def _body(self):
        with NoHostTraffic():
            return super()._body()


def _model(label):
    """(model, keyword arguments) of an SVI fit on CPU tensors in float64."""
    if label == "fit_model":
        obs = chip_smoke.bench_nuts_obs()[:DAYS]
        return chip_smoke.fit_model(days=DAYS, dtype=F64, device=CPU), {"obs": torch.as_tensor(obs, dtype=F64)}
    ((_, model, kwargs),) = chip_smoke.fit_models(label, load("torch", label), CPU, DAYS, F64)
    return model, kwargs


@pytest.mark.parametrize("guide", list(GUIDES))
@pytest.mark.parametrize("label", ["fit_model", "sir_infer_parameters"])
def test_the_captured_svi_step_makes_no_host_read_or_copy(monkeypatch, label, guide):
    monkeypatch.setattr(svi_mod, "GraphedStep", CheckedStep)
    monkeypatch.setattr(integrate, "_host_skips", lambda device: False)
    model, kwargs = _model(label)
    svi = SVI(model, GUIDES[guide](model), ClippedAdam(0.1) if guide == "delta" else Adam(0.1), Trace_ELBO())
    svi._graphed = lambda device: True
    one = svi.run(torch.Generator().manual_seed(0), 1, **kwargs)
    bank = svi.run_multistart(torch.Generator().manual_seed(0), num_steps=1, num_starts=2, final_particles=1,
                              **kwargs)
    assert [g.replays for g in svi.graphs] == [1] and isinstance(svi.graphs[0], CheckedStep)
    assert bool(torch.isfinite(one.losses).all() and torch.isfinite(bank.all_losses).all())
    assert bool(torch.isfinite(bank.final_elbos).all())


def _toy(obs):
    mu = handlers.sample("mu", dist.Normal(torch.zeros((), dtype=obs.dtype), 1.0))
    sigma = handlers.sample("sigma", dist.LogNormal(torch.zeros((), dtype=obs.dtype), 0.5))
    handlers.sample("obs", dist.Normal(mu, sigma), obs=obs)


OBS = torch.as_tensor(np.random.default_rng(5).normal(0.7, 1.3, 24))


def _svi(graphed: bool, guide=None, particles: int = 1) -> SVI:
    svi = SVI(_toy, guide or AutoMultivariateNormal(_toy), Adam(0.1), Trace_ELBO(num_particles=particles))
    svi._graphed = lambda device: graphed
    return svi


def _equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("particles", [1, 2])
def test_static_buffer_run_equals_the_eager_loop(particles):
    out = {}
    for graphed in (False, True):
        gen = torch.Generator().manual_seed(3)
        svi = _svi(graphed, particles=particles)
        result = svi.run(gen, 3, obs=OBS)
        out[graphed] = (result.losses, result.params, result.state.opt_state, torch.randn(4, generator=gen))
        assert len(svi.graphs) == int(graphed)
    (losses, params, opt_state, after), want = out[True], out[False]
    assert losses.shape == (3,) and torch.equal(losses, want[0])
    assert _equal(params, want[1]) and _equal(opt_state, want[2]) and int(opt_state.count) == 3
    assert torch.equal(after, want[3])  # the seam was left where the eager loop leaves it


@pytest.mark.parametrize("shards", [1, 2])
def test_static_buffer_multistart_equals_the_eager_loop(shards):
    out = {}
    for graphed in (False, True):
        gen = torch.Generator().manual_seed(4)
        svi = _svi(graphed)
        opt = []
        plain = svi._bank_fns

        def recording(*args, **kwargs):
            step, elbo = plain(*args, **kwargs)

            def step_seen(state, noise):
                new, loss = step(state, noise)
                opt.append(new[1])
                return new, loss

            return step_seen, elbo

        svi._bank_fns = recording
        mesh = None if shards == 1 else create_mesh(("start",), devices=[torch.device("cpu", i) for i in range(2)])
        result = svi.run_multistart(gen, num_steps=3, num_starts=4, final_particles=2, mesh=mesh, obs=OBS)
        last = pytree.tree_map(lambda *x: torch.cat(x), *opt[-shards:])  # the shards' last optimizer states
        out[graphed] = (result, last, torch.randn(4, generator=gen))
        assert len(svi.graphs) == (shards if graphed else 0)
        if graphed:  # the graphs' state buffers hold it
            assert _equal(pytree.tree_map(lambda *x: torch.cat(x), *[g.state[1] for g in svi.graphs]), last)
    (got, got_opt, got_after), (want, want_opt, want_after) = out[True], out[False]
    assert got.all_losses.shape == (4, 3) and torch.equal(got.all_losses, want.all_losses)
    assert _equal(got.all_params, want.all_params) and torch.equal(got.final_elbos, want.final_elbos)
    assert int(got.best_idx) == int(want.best_idx)
    assert _equal(got_opt, want_opt) and got_opt.count.tolist() == [3] * 4
    assert torch.equal(got_after, want_after)


def test_a_foreign_init_state_traces_its_signature_without_drawing_from_the_seam():
    owner = _svi(False, AutoNormal(_toy))
    state = owner.init(torch.Generator().manual_seed(6), obs=OBS)
    foreign = _svi(True, owner.guide)
    assert foreign._signature is None
    before = state.rng_key.generator.get_state()
    signature = foreign._draw_signature(state.params, CPU, (), {"obs": OBS})
    assert signature == owner._signature and torch.equal(state.rng_key.generator.get_state(), before)

    copy = torch.Generator().set_state(before)
    eager = owner.run(None, 3, init_state=state._replace(rng_key=svi_mod.draw_seam(copy, CPU)), obs=OBS)
    graphed = foreign.run(None, 3, init_state=state, obs=OBS)
    assert foreign._signature is None and len(foreign.graphs) == 1
    assert torch.equal(graphed.losses, eager.losses) and _equal(graphed.params, eager.params)
    assert torch.equal(state.rng_key.generator.get_state(), copy.get_state())
