"""SVI of the port (``infer.svi``) against the JAX package, on the CPU.

- ``Adam`` and ``ClippedAdam`` against optax's ``adam`` and
  ``chain(clip_by_global_norm, adam)`` over 50 steps of seeded gradients,
  within 1e-12 in float64.
- The autoguides' initial parameters, and ``Trace_ELBO``, ``SVI.update`` /
  ``run``, ``run_multistart`` and ``chees_warm_start_from_guide`` given the
  JAX package's draws (recorded under ``jax.disable_jit()``, ``jax.vmap``
  run member by member, and replayed through the port's draw seam): losses,
  parameters, final ELBOs and the winner within 1e-10.
- A non-finite final ELBO never wins.

The guides start at the prior mean (``init_to_mean``): the set-up draws of
``init_to_median`` come from each package's own stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dynode_tpu.dist as jdist
import dynode_tpu.infer.svi as jsvi
from dynode_tpu.infer import handlers as jh
from dynode_tpu.infer.util import init_to_mean as j_init_to_mean
from dynode_tpu_torch import dist
from dynode_tpu_torch.infer import handlers, init_to_mean
from dynode_tpu_torch.infer import svi as tsvi
from torch_infer_draws import Replay, record

F64 = torch.float64
TOL = 1e-10
OBS = np.array([1.3, 0.4, 2.2, 1.7, 0.9, 1.1])
GUIDES = ["AutoMultivariateNormal", "AutoNormal", "AutoDelta"]


def t_model(obs=None):
    mu = handlers.sample("mu", dist.Normal(torch.tensor(0.0, dtype=F64), torch.tensor(3.0, dtype=F64)))
    sd = handlers.sample("sd", dist.LogNormal(torch.tensor(0.0, dtype=F64), torch.tensor(0.5, dtype=F64)))
    with handlers.plate("data", len(OBS)):
        handlers.sample("y", dist.Normal(mu, sd), obs=obs)


def j_model(obs=None):
    mu = jh.sample("mu", jdist.Normal(0.0, 3.0))
    sd = jh.sample("sd", jdist.LogNormal(0.0, 0.5))
    with jh.plate("data", len(OBS)):
        jh.sample("y", jdist.Normal(mu, sd), obs=obs)


def _guides(name):
    tg = getattr(tsvi, name)(t_model, init_loc_fn=init_to_mean)
    jg = getattr(jsvi, name)(j_model, init_loc_fn=j_init_to_mean)
    jg._setup(obs=jnp.asarray(OBS))  # its set-up trace draws from its own key: outside the recording
    return tg, jg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(want), rtol=tol, atol=tol * 1e-3)


class Seam:
    """The port's draw seam fed with a JAX recording: the draws of ``first``
    in order for calls that are not a bank's, then one stream per member."""

    device = torch.device("cpu")

    def __init__(self, first, streams=()):
        self.first = list(first)
        self.rest = Replay(streams)

    def normal(self, shape, dtype, device, active=None):
        if self.first:
            x = np.asarray(self.first.pop(0))
            assert x.shape == tuple(shape), (x.shape, shape)
            return torch.as_tensor(np.array(x), dtype=dtype)
        return self.rest.normal(shape, dtype, device)

    def done(self):
        return not self.first and self.rest.done()


@pytest.mark.parametrize("clipped", [False, True])
def test_adam_and_clipped_adam_match_optax(clipped):
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=3), "b": rng.normal(size=(2, 2))}
    if clipped:
        t_opt, j_opt = tsvi.ClippedAdam(0.05, clip_norm=2.0), optax.chain(optax.clip_by_global_norm(2.0), optax.adam(0.05))
    else:
        t_opt, j_opt = tsvi.Adam(0.05), optax.adam(0.05)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = t_opt.init(tp), j_opt.init(jp)
    clipped_steps = 0
    for step in range(50):
        grads = {k: rng.normal(scale=1.0 + 2.0 * (step % 3), size=np.shape(v)) for k, v in params.items()}
        clipped_steps += np.sqrt(sum(np.sum(g * g) for g in grads.values())) >= 2.0
        t_up, ts = t_opt.update({k: torch.as_tensor(g) for k, g in grads.items()}, ts, tp)
        j_up, js = j_opt.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        tp = tsvi._apply_updates(tp, t_up)
        jp = optax.apply_updates(jp, j_up)
    assert int(ts.count) == 50 and ts.count.dtype == torch.int32
    assert not clipped or 0 < clipped_steps < 50
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-12, atol=1e-14)


def test_an_optimizer_needs_init_and_update():
    with pytest.raises(TypeError, match="init"):
        tsvi.SVI(t_model, tsvi.AutoNormal(t_model), object())


@pytest.mark.parametrize("name", GUIDES)
def test_autoguide_init_params_match_jax(name):
    tg, jg = _guides(name)
    state = tsvi.SVI(t_model, tg, tsvi.Adam(0.1)).init(torch.Generator().manual_seed(0), obs=torch.as_tensor(OBS))
    jstate = jsvi.SVI(j_model, jg, jsvi.Adam(0.1)).init(jax.random.PRNGKey(0), obs=jnp.asarray(OBS))
    assert list(state.params) == list(jstate.params)
    for k in state.params:
        _close(state.params[k], jstate.params[k], 1e-14)
    assert tg._dim == jg._dim == 2


@pytest.mark.parametrize("name", GUIDES)
def test_svi_run_matches_jax_given_its_draws(name, monkeypatch):
    """``SVI.run`` (init, then ``update`` per step: ``Trace_ELBO``'s
    particle, the gradient, Adam) over 5 steps: every loss and the final
    parameters within 1e-10."""
    tg, jg = _guides(name)
    jsvi_ = jsvi.SVI(j_model, jg, jsvi.Adam(0.1), jsvi.Trace_ELBO())
    jres, draws = record(monkeypatch, jsvi_.run, jax.random.PRNGKey(3), 5, obs=jnp.asarray(OBS))
    assert len(draws) == (6 if name != "AutoDelta" else 0)  # the init trace's draw, then one per step
    seam = Seam(draws)
    res = tsvi.SVI(t_model, tg, tsvi.Adam(0.1), tsvi.Trace_ELBO()).run(seam, 5, obs=torch.as_tensor(OBS))
    assert seam.done()
    _close(res.losses, jres.losses)
    for k in res.params:
        _close(res.params[k], jres.params[k])


def test_trace_elbo_particles_match_jax(monkeypatch):
    tg, jg = _guides("AutoMultivariateNormal")
    params = {"auto_loc": np.array([0.8, -0.2]), "auto_scale_tril": np.array([[-1.0, 0.0], [0.3, -1.5]])}
    jloss, draws = record(monkeypatch, jsvi.Trace_ELBO(num_particles=3).loss, jax.random.PRNGKey(1),
                          {k: jnp.asarray(v) for k, v in params.items()}, j_model, jg, sequential=True,
                          obs=jnp.asarray(OBS))
    assert len(draws) == 3
    tloss = tsvi.Trace_ELBO(num_particles=3).loss(Seam(draws), {k: torch.as_tensor(v) for k, v in params.items()},
                                                  t_model, tg, obs=torch.as_tensor(OBS))
    _close(tloss, jloss)


@pytest.mark.parametrize("name", ["AutoMultivariateNormal", "AutoNormal"])
def test_run_multistart_matches_jax_given_its_draws(name, monkeypatch):
    """4 starts x 5 steps, 3 final particles: the jitter, every start's
    losses and final parameters, the final ELBOs and the winner."""
    starts, steps, particles = 4, 5, 3
    tg, jg = _guides(name)
    jsvi_ = jsvi.SVI(j_model, jg, jsvi.Adam(0.1))
    jres, draws = record(monkeypatch, jsvi_.run_multistart, jax.random.PRNGKey(7), steps, starts,
                         init_jitter=0.7, final_particles=particles, sequential=True, obs=jnp.asarray(OBS))
    # the init trace's draw; per start its jitter and one draw per step; per start its final particles
    per_start = 1 + steps
    assert len(draws) == 1 + starts * (per_start + particles)
    finals = 1 + starts * per_start
    streams = [draws[1 + i * per_start: 1 + (i + 1) * per_start] + draws[finals + i * particles: finals + (i + 1) * particles]
               for i in range(starts)]
    seam = Seam(draws[:1], streams)
    res = tsvi.SVI(t_model, tg, tsvi.Adam(0.1)).run_multistart(seam, steps, starts, init_jitter=0.7,
                                                                 final_particles=particles, obs=torch.as_tensor(OBS))
    assert seam.done()
    _close(res.all_losses, jres.all_losses)
    _close(res.final_elbos, jres.final_elbos)
    for k in res.all_params:
        _close(res.all_params[k], jres.all_params[k])
        _close(res.params[k], jres.params[k])
    assert int(res.best_idx) == int(jres.best_idx)
    _close(res.losses, jres.losses)


def test_a_non_finite_elbo_never_wins():
    """Starts jittered past x = 2 meet a +inf factor: their final ELBO is
    +inf (or NaN), which must not win the ranking."""

    def model():
        x = handlers.sample("x", dist.Normal(torch.tensor(0.0, dtype=F64), torch.tensor(1.0, dtype=F64)))
        handlers.factor("wall", torch.where(x > 2.0, torch.tensor(float("inf"), dtype=F64), torch.zeros((), dtype=F64)))

    svi = tsvi.SVI(model, tsvi.AutoNormal(model, init_loc_fn=init_to_mean), tsvi.Adam(0.01))
    res = svi.run_multistart(torch.Generator().manual_seed(0), num_steps=2, num_starts=16, init_jitter=3.0)
    bad = ~torch.isfinite(res.final_elbos)
    assert bad.any() and (~bad).any()
    assert bool(torch.isfinite(res.final_elbos[res.best_idx]))
    assert float(res.final_elbos[res.best_idx]) == float(res.final_elbos[~bad].max())


def test_run_multistart_refuses_a_mesh():
    """A mesh that is not the port's ``Mesh``, or whose axis the starts do
    not divide over, is refused before anything runs."""
    from dynode_tpu_torch.parallel import create_mesh

    svi = tsvi.SVI(t_model, tsvi.AutoNormal(t_model), tsvi.Adam(0.1))
    with pytest.raises(TypeError, match="Mesh"):
        svi.run_multistart(0, 2, 2, mesh=object(), obs=torch.as_tensor(OBS))
    mesh = create_mesh(("start",), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="width 6 must divide over the 4-device"):
        svi.run_multistart(0, 2, 6, mesh=mesh, obs=torch.as_tensor(OBS))


@pytest.mark.parametrize("name", GUIDES)
def test_chees_warm_start_from_guide_matches_jax(name, monkeypatch):
    tg, jg = _guides(name)
    params = {"auto_loc": np.array([0.8, -0.2]), "auto_scale_tril": np.array([[-1.0, 0.0], [0.3, -1.5]]),
              "auto_log_scale": np.array([-0.5, -1.2])}
    jitter = 0.3 if name == "AutoDelta" else 0.0
    (jstate, jtuned), draws = record(monkeypatch, jsvi.chees_warm_start_from_guide, jg,
                                     {k: jnp.asarray(v) for k, v in params.items()}, 6, jax.random.PRNGKey(2),
                                     init_jitter=jitter)
    tg._setup(obs=torch.as_tensor(OBS))
    state, tuned = tsvi.chees_warm_start_from_guide(tg, {k: torch.as_tensor(v) for k, v in params.items()}, 6,
                                                    Seam(draws), init_jitter=jitter)
    _close(state.z, jstate.z)
    assert state.iter_idx == 0 and state.num_steps.dtype == torch.int32
    for got, want in zip(tuned, jtuned):
        _close(got, want)
    if name == "AutoDelta":
        with pytest.raises(ValueError, match="init_jitter"):
            tsvi.chees_warm_start_from_guide(tg, {k: torch.as_tensor(v) for k, v in params.items()}, 6, 0)


@pytest.mark.parametrize("name", GUIDES)
def test_sharded_bank_matches_unsharded(name):
    """``run_multistart(mesh=)`` (``test_svi_multistart.py``'s mesh case):
    the bank's draws are made whole, then each of 8 CPU devices steps its
    2 starts. The split bank equals the unsplit one bit for bit: the same
    winner, ELBOs, parameters and losses (JAX holds its split bank within
    1e-5)."""
    from dynode_tpu_torch.parallel import create_mesh

    mesh = create_mesh(("start",), devices=[torch.device("cpu", i) for i in range(8)])
    svi = tsvi.SVI(t_model, getattr(tsvi, name)(t_model), tsvi.Adam(0.05))
    kw = dict(num_steps=20, num_starts=16, init_jitter=2.0, obs=torch.as_tensor(OBS))
    a = svi.run_multistart(torch.Generator().manual_seed(2), **kw)
    b = svi.run_multistart(torch.Generator().manual_seed(2), mesh=mesh, **kw)
    assert int(a.best_idx) == int(b.best_idx)
    assert torch.equal(a.final_elbos, b.final_elbos) and torch.equal(a.all_losses, b.all_losses)
    for k in a.all_params:
        assert torch.equal(a.all_params[k], b.all_params[k]), k
