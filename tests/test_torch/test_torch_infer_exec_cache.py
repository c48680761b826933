"""The cross-run caches of the port's inference, on the CPU.

The port's counterparts of ``tests/test_infer/test_exec_cache.py`` (the
MCMC cache, ``infer/mcmc.py``'s ``_EXEC_CACHE``) and
``tests/test_infer/test_svi_multistart_cache.py`` (``SVI``'s
``_multistart_cache``), case for case with the same assertions, where
JAX's jitted programs are the port's cache entry (the trace, the flat
potential and the bank's potential parts; the SVI bank's functions and
graphs), checked by identity:

- a repeated run hits (NUTS and ChEES, ``steps_per_call`` None and 25);
- a new ``obs`` misses and the posterior follows it; an equal-valued copy
  misses; a fresh ``MCMC`` with the same model and arguments hits; a
  configuration change misses; a mesh entry is another than the
  unsharded one and is hit again;
- SVI: repeat fits hit, a new ``obs`` misses and its fit follows it,
  another bank shape is another entry, ``init_jitter`` recaptures nothing.

And the port's own: an argument changed in place (a tensor, a numpy
array) warns and misses; past 8 entries the least recently used is
dropped and its graphs released (a :class:`GraphedPotential` whose calls
run eagerly stands in for the card's); a hit at seed s gives the samples
of a miss at seed s (float64, within 1e-5: the entry's centres shift the
potential by a constant, which only rounding sees; bit for bit
uncentred); a kept SVI bank's graphs (the static-buffer loop, run on CPU
tensors) are reused, its result equals a fresh instance's bit for bit,
and an earlier result is not overwritten by the next run.
"""

import numpy as np
import pytest
import torch

from dynode_tpu_torch import dist
from dynode_tpu_torch.infer import MCMC, NUTS, SVI, Adam, AutoNormal, ChEES, Trace_ELBO, handlers
from dynode_tpu_torch.infer import mcmc as tm
from dynode_tpu_torch.infer import svi as tsvi
from dynode_tpu_torch.parallel import create_mesh

F64 = torch.float64
CPU2 = [torch.device("cpu", i) for i in range(2)]


def model(obs=None):
    mu = handlers.sample("mu", dist.Normal(torch.zeros((), dtype=obs.dtype), 10.0))
    handlers.sample("obs", dist.Normal(mu, 1.0), obs=obs)


def numpy_model(obs_np=None):
    model(obs=torch.as_tensor(obs_np))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _mcmc(kernel_cls, fn=model, warmup=20, samples=20, **kw):
    kern = ChEES(fn, max_num_steps=64) if kernel_cls is ChEES else NUTS(fn, max_tree_depth=5)
    return MCMC(kern, num_warmup=warmup, num_samples=samples, num_chains=16, **kw)


def _obs(value):
    return torch.full((8,), value, dtype=F64)


def _entry():
    (entry,) = [e for e in tm._EXEC_CACHE.values() if "parts" in e]
    return entry


def _programs(entry) -> dict:
    """The ids of what a run builds once and a hit reuses: JAX's ``jits``."""
    return {"flat_pot": id(entry["flat_pot"]), "tr": id(entry["tr"]),
            **{str(k): id(v) for k, v in entry["parts"].items()}}


def _mean(mc) -> float:
    return float(mc.get_samples()["mu"].mean())


@pytest.mark.parametrize("kernel_cls", [NUTS, ChEES])
@pytest.mark.parametrize("steps_per_call", [None, 25])
def test_second_run_reuses_the_cached_entry(kernel_cls, steps_per_call):
    obs = _obs(3.0)
    mc = _mcmc(kernel_cls, steps_per_call=steps_per_call)
    mc.run(_gen(0), obs=obs)
    assert len(tm._EXEC_CACHE) == 1
    programs = _programs(_entry())
    assert len(programs) == 3  # the trace, the flat potential and one bank part
    mc.run(_gen(1), obs=obs)
    assert len(tm._EXEC_CACHE) == 1
    assert _programs(_entry()) == programs
    assert abs(_mean(mc) - 3.0) < 0.5


@pytest.mark.parametrize("kernel_cls", [NUTS, ChEES])
def test_new_obs_array_is_not_served_a_stale_entry(kernel_cls):
    mc = _mcmc(kernel_cls, steps_per_call=25)
    mc.run(_gen(0), obs=_obs(3.0))
    m1 = _mean(mc)
    mc.run(_gen(0), obs=_obs(-4.0))
    m2 = _mean(mc)
    assert len(tm._EXEC_CACHE) == 2
    assert abs(m1 - 3.0) < 0.5 and abs(m2 + 4.0) < 0.5


def test_equal_valued_copy_is_still_a_miss():
    obs = _obs(3.0)
    mc = _mcmc(NUTS, steps_per_call=25)
    mc.run(_gen(0), obs=obs)
    mc.run(_gen(1), obs=obs.clone())
    assert len(tm._EXEC_CACHE) == 2


def test_fresh_instance_same_model_and_args_hits_cache():
    obs = _obs(3.0)
    _mcmc(NUTS, steps_per_call=25).run(_gen(0), obs=obs)
    programs = _programs(_entry())
    m2 = _mcmc(NUTS, steps_per_call=25)
    m2.run(_gen(1), obs=obs)
    assert len(tm._EXEC_CACHE) == 1
    assert _programs(_entry()) == programs
    assert abs(_mean(m2) - 3.0) < 0.5


def test_config_change_is_a_miss():
    obs = _obs(3.0)
    _mcmc(NUTS, steps_per_call=25).run(_gen(0), obs=obs)
    _mcmc(NUTS, steps_per_call=None).run(_gen(0), obs=obs)
    assert len(tm._EXEC_CACHE) == 2


def test_mesh_sharded_run_caches_and_is_distinct_from_unsharded():
    obs = _obs(3.0)
    mesh = create_mesh(("chains",), devices=CPU2)
    m_unsharded = _mcmc(NUTS, steps_per_call=25)
    m_unsharded.run(_gen(0), obs=obs)
    m_sharded = _mcmc(NUTS, steps_per_call=25, mesh=mesh, chain_axis="chains")
    m_sharded.run(_gen(0), obs=obs)
    assert len(tm._EXEC_CACHE) == 2
    programs = _programs(list(tm._EXEC_CACHE.values())[-1])
    m_sharded.run(_gen(1), obs=obs)
    assert len(tm._EXEC_CACHE) == 2
    assert _programs(list(tm._EXEC_CACHE.values())[-1]) == programs
    # identical seed => identical draws, sharded or not (a hit takes a miss's draws)
    a = m_unsharded.get_samples(group_by_chain=True)["mu"].numpy()
    m_sharded.run(_gen(0), obs=obs)
    b = m_sharded.get_samples(group_by_chain=True)["mu"].numpy()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_argument_changed_in_place_warns_and_misses(kind):
    if kind == "tensor":
        fn, arg = model, _obs(3.0)
    else:
        fn, arg = numpy_model, np.full((8,), 3.0)
    key = "obs" if kind == "tensor" else "obs_np"
    mc = _mcmc(NUTS, fn=fn)
    mc.run(_gen(0), **{key: arg})
    assert abs(_mean(mc) - 3.0) < 0.5
    arg[:] = -4.0
    with pytest.warns(UserWarning, match="mutated in place"):
        mc.run(_gen(0), **{key: arg})
    assert len(tm._EXEC_CACHE) == 1  # the changed entry was replaced
    assert abs(_mean(mc) + 4.0) < 0.5


class EagerGraph(tm.GraphedPotential):
    """A graph's stand-in on the CPU: its calls run the potential eagerly,
    and its release is recorded."""

    released = False

    def __call__(self, zb):
        self.replays += 1
        return self.pot_and_grad(zb)

    def release(self):
        self.released = True
        super().release()


def test_eviction_past_eight_entries_releases_the_dropped_entry(monkeypatch):
    plain = tm.generic_pot_and_grad
    monkeypatch.setattr(tm, "generic_pot_and_grad", lambda flat, graph_device=None: EagerGraph(plain(flat)))
    obs = [_obs(float(i)) for i in range(tm._EXEC_CACHE_SIZE + 1)]
    graphs = []
    for o in obs:
        mc = _mcmc(NUTS, warmup=2, samples=2)
        mc.run(_gen(0), obs=o)
        graphs.append(mc.graph)
    assert tm._EXEC_CACHE_SIZE == 8 and len(tm._EXEC_CACHE) == 8
    assert all(isinstance(g, EagerGraph) and g.replays > 0 for g in graphs)
    assert graphs[0].released and not any(g.released for g in graphs[1:])
    assert not any(x is obs[0] for e in tm._EXEC_CACHE.values() for x in e["objects"])
    mc = _mcmc(NUTS, warmup=2, samples=2)
    mc.run(_gen(0), obs=obs[-1])  # a hit: the most recent entry's graph again
    assert mc.graph is graphs[-1] and len(tm._EXEC_CACHE) == 8
    tm.clear_exec_cache()
    assert not tm._EXEC_CACHE and all(g.released for g in graphs)


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("kernel_cls", [NUTS, ChEES])
def test_a_hit_at_a_seed_gives_the_samples_of_a_miss_at_it(kernel_cls, center):
    """A hit takes the draws a miss takes. Uncentred the potential is the
    same function, so the samples are equal bit for bit; centred, the hit's
    centres (from the first run's trace) shift the potential by a constant,
    whose rounding the warmup's adaptation carries to about 1e-7 over 60
    transitions: within 1e-5."""
    def make():
        kern = (ChEES(model, max_num_steps=64, center_potential=center) if kernel_cls is ChEES
                else NUTS(model, max_tree_depth=5, center_potential=center))
        return MCMC(kern, num_warmup=20, num_samples=20, num_chains=16)

    obs = _obs(3.0)
    make().run(_gen(5), obs=obs)
    hit = make()
    hit.run(_gen(6), obs=obs)
    assert len(tm._EXEC_CACHE) == 1
    tm.clear_exec_cache()
    miss = make()
    miss.run(_gen(6), obs=obs)
    a, b = hit.get_samples(group_by_chain=True)["mu"], miss.get_samples(group_by_chain=True)["mu"]
    assert a.dtype == F64 and a.shape == (16, 20)
    if center:
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5)
    else:
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# run_multistart's kept bank
# ---------------------------------------------------------------------------


def _svi():
    return SVI(model, AutoNormal(model), Adam(step_size=0.1), Trace_ELBO())


def _loc(result) -> float:
    return float(result.params["auto_loc"][0])


def test_repeat_fits_reuse_the_kept_bank():
    svi = _svi()
    obs = torch.full((16,), 3.0, dtype=F64)
    r1 = svi.run_multistart(_gen(0), num_steps=200, num_starts=4, obs=obs)
    assert len(svi._multistart_cache) == 1
    fn_id = id(next(iter(svi._multistart_cache.values()))["fns"])
    r2 = svi.run_multistart(_gen(7), num_steps=200, num_starts=4, obs=obs)
    assert len(svi._multistart_cache) == 1
    assert id(next(iter(svi._multistart_cache.values()))["fns"]) == fn_id
    for r in (r1, r2):
        assert abs(_loc(r) - 3.0) < 0.3
    # init_jitter stays outside the kept bank: changing it builds nothing
    svi.run_multistart(_gen(9), num_steps=200, num_starts=4, init_jitter=0.5, obs=obs)
    assert len(svi._multistart_cache) == 1
    assert id(next(iter(svi._multistart_cache.values()))["fns"]) == fn_id


def test_new_obs_object_misses_and_result_follows_data():
    svi = _svi()
    r1 = svi.run_multistart(_gen(0), num_steps=200, num_starts=4, obs=torch.full((16,), 3.0, dtype=F64))
    r2 = svi.run_multistart(_gen(0), num_steps=200, num_starts=4, obs=torch.full((16,), -4.0, dtype=F64))
    assert len(svi._multistart_cache) == 2
    assert abs(_loc(r1) - 3.0) < 0.3 and abs(_loc(r2) + 4.0) < 0.3


def test_different_bank_shape_is_a_separate_entry():
    svi = _svi()
    obs = torch.full((16,), 3.0, dtype=F64)
    svi.run_multistart(_gen(0), num_steps=50, num_starts=4, obs=obs)
    svi.run_multistart(_gen(0), num_steps=50, num_starts=8, obs=obs)
    assert len(svi._multistart_cache) == 2


def _graphed_svi(monkeypatch):
    """An SVI whose runs take the card's route on CPU tensors: the
    static-buffer loop of :class:`~dynode_tpu_torch.infer.graphs.GraphedStep`
    (no capture on the CPU)."""
    svi = _svi()
    monkeypatch.setattr(svi, "_graphed", lambda device: True)
    return svi


def test_kept_bank_replays_its_graphs_and_results_are_not_aliased(monkeypatch):
    obs = torch.full((16,), 3.0, dtype=F64)
    svi = _graphed_svi(monkeypatch)
    r1 = svi.run_multistart(_gen(0), num_steps=20, num_starts=4, obs=obs)
    (graph,) = svi.graphs
    kept = {k: v.clone() for k, v in r1.all_params.items()}
    assert graph.replays == 20 and graph.state is not None and graph.draws is not None
    assert not any(r1.all_params[k] is v for k, v in graph.state[0].items())
    r2 = svi.run_multistart(_gen(1), num_steps=20, num_starts=4, init_jitter=0.5, obs=obs)
    assert svi.graphs == [graph] and graph.replays == 40 and graph.captures == 0
    for k, v in kept.items():
        assert torch.equal(r1.all_params[k], v)  # the second run wrote its own buffers' copies
    fresh = _graphed_svi(monkeypatch).run_multistart(_gen(1), num_steps=20, num_starts=4, init_jitter=0.5, obs=obs)
    assert torch.equal(r2.all_losses, fresh.all_losses) and torch.equal(r2.final_elbos, fresh.final_elbos)
    for k in r2.all_params:
        assert torch.equal(r2.all_params[k], fresh.all_params[k])


def test_svi_argument_changed_in_place_warns_and_misses():
    svi = _svi()
    obs = torch.full((16,), 3.0, dtype=F64)
    svi.run_multistart(_gen(0), num_steps=100, num_starts=4, obs=obs)
    obs.fill_(-4.0)
    with pytest.warns(UserWarning, match="mutated in place"):
        r = svi.run_multistart(_gen(0), num_steps=100, num_starts=4, obs=obs)
    assert len(svi._multistart_cache) == 1 and abs(_loc(r) + 4.0) < 0.3


def test_svi_eviction_past_eight_entries_releases_the_dropped_bank(monkeypatch):
    svi = _graphed_svi(monkeypatch)
    obs = torch.full((16,), 3.0, dtype=F64)
    graphs = []
    for steps in range(1, tsvi._EXEC_CACHE_SIZE + 2):
        svi.run_multistart(_gen(0), num_steps=steps, num_starts=2, obs=obs)
        graphs.append(svi.graphs[0])
    assert len(svi._multistart_cache) == 8
    assert graphs[0].draws is None and graphs[0].state is None  # released with its buffers
    assert all(g.draws is not None and g.state is not None for g in graphs[1:])
