"""The port's ``MCMC`` runner (``infer.mcmc``), on the CPU.

- Whole runs of NUTS (dense and diagonal) and ChEES on a correlated
  Gaussian with a known answer: every coordinate's mean and variance
  within 5 Monte-Carlo standard errors (the mean's SE from the bulk ESS,
  the variance's from sqrt(2) var / sqrt(ESS)).
- Chunked (``steps_per_call``) and monolithic runs give equal draws; the
  model's generic potential (``torch.func.vmap``) and the same density
  given as ``batched_potential_fn`` give the same draws within 1e-10.
- A warm start from a JAX ``MCMC.warm_start_state()`` (the JAX state types,
  as numpy) through ``convert.warm_start_from_numpy``.
- ``_rescue_stuck_chains`` on given arrays equals JAX's (1e-12), and the
  JAX error messages and warnings of ``run`` (``dynode_tpu/infer/mcmc.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.infer.chees as jchees
import dynode_tpu.infer.hmc as jhmc
import dynode_tpu.infer.mcmc as jmcmc
from dynode_tpu.infer import handlers as jh
from dynode_tpu_torch import convert, dist
from dynode_tpu_torch.infer import MCMC, NUTS, ChEES, handlers
from dynode_tpu_torch.infer.diagnostics import ess_bulk

D = 3
MU = np.array([1.0, -2.0, 0.5])
COV = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.4], [0.2, -0.4, 0.5]])
L = np.linalg.cholesky(COV)
PREC = np.linalg.inv(COV)


def model(mu=None):
    handlers.sample("x", dist.MultivariateNormal(torch.as_tensor(MU), torch.as_tensor(L)))


def gaussian_potential(zb):
    """The same density, natively over a (C, 3) bank."""
    d = zb - torch.as_tensor(MU)
    return 0.5 * torch.sum(d * (d @ torch.as_tensor(PREC)), dim=-1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


KERNELS = {
    "nuts_dense": lambda: NUTS(model, dense_mass=True, max_tree_depth=4, batched_potential_fn=gaussian_potential),
    "nuts_diag": lambda: NUTS(model, dense_mass=False, max_tree_depth=4, batched_potential_fn=gaussian_potential),
    "chees": lambda: ChEES(model, dense_mass=True, batched_potential_fn=gaussian_potential),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_whole_run_recovers_the_gaussian_within_5_mc_se(kernel):
    mcmc = MCMC(KERNELS[kernel](), num_warmup=80, num_samples=80, num_chains=16, steps_per_call=40)
    mcmc.run(_gen(1))
    x = mcmc.get_samples(group_by_chain=True)["x"].numpy()  # (chains, draws, 3)
    assert x.shape == (16, 80, 3)
    for k in range(D):
        ess = ess_bulk(x[:, :, k])
        flat = x[:, :, k].reshape(-1)
        se_mean = flat.std() / math.sqrt(ess)
        se_var = math.sqrt(2.0) * COV[k, k] / math.sqrt(ess)
        assert abs(flat.mean() - MU[k]) < 5 * se_mean, (k, flat.mean(), se_mean)
        assert abs(flat.var() - COV[k, k]) < 5 * se_var, (k, flat.var(), se_var)
    extra = mcmc.get_extra_fields()
    assert int(extra["diverging"].sum()) == 0
    assert extra["num_steps"].shape == (16 * 80,) and extra["step_size"].shape == (16,)


@pytest.mark.parametrize("kernel", ["nuts_dense", "chees"])
def test_chunked_and_monolithic_runs_give_equal_draws(kernel):
    runs = []
    for steps in (None, 7):
        mcmc = MCMC(KERNELS[kernel](), num_warmup=25, num_samples=10, num_chains=4, steps_per_call=steps)
        mcmc.run(_gen(2))
        assert mcmc._n_rescued == 0
        runs.append(mcmc.get_samples()["x"])
    assert torch.equal(runs[0], runs[1])


def test_generic_and_batched_potentials_give_the_same_draws():
    draws = []
    for batched in (None, gaussian_potential):
        mcmc = MCMC(NUTS(model, max_tree_depth=3, batched_potential_fn=batched), num_warmup=6, num_samples=6,
                    num_chains=4)
        mcmc.run(_gen(3))
        draws.append(mcmc.get_samples()["x"])
    torch.testing.assert_close(draws[0], draws[1], rtol=1e-10, atol=1e-12)


def _jax_warm_start(kind, chains):
    """A JAX ``warm_start_state()`` value: JAX's own state types, built
    from seeded arrays, with per-chain keys (NUTS) or a bank key (ChEES)."""
    rng = np.random.default_rng(4)
    z = jnp.asarray(MU + rng.normal(size=(chains, D)) @ L.T)
    fields = dict(z=z, potential=jnp.zeros(chains), grad=jnp.zeros((chains, D)), energy=jnp.zeros(chains),
                  accept_prob=jnp.full(chains, 0.8), num_steps=jnp.full(chains, 3, jnp.int32),
                  diverging=jnp.zeros(chains, bool))
    inv = jnp.asarray(COV)
    if kind == "nuts":
        state = jhmc.HMCState(**fields, rng_key=jax.random.split(jax.random.PRNGKey(0), chains))
        tuned = (jnp.broadcast_to(inv, (chains, D, D)), jnp.broadcast_to(jnp.linalg.cholesky(inv), (chains, D, D)),
                 jnp.full(chains, 0.6))
    else:
        state = jchees.ChEESBankState(**fields, iter_idx=jnp.int32(40), rng_key=jax.random.PRNGKey(0))
        tuned = (inv, jnp.linalg.cholesky(inv), jnp.asarray(0.6), jnp.asarray(2.4))
    return jax.tree_util.tree_map(np.asarray, state), tuple(np.asarray(t) for t in tuned)


@pytest.mark.parametrize("kind", ["nuts", "chees"])
def test_warm_start_from_a_converted_jax_state(kind):
    chains = 8
    saved = _jax_warm_start(kind, chains)
    warm = convert.warm_start_from_numpy(saved, device="cpu")
    assert len(warm[1]) == (3 if kind == "nuts" else 4)
    np.testing.assert_array_equal(warm[0].z.numpy(), saved[0].z)
    if kind == "chees":
        assert warm[0].iter_idx == 40
    kernel = KERNELS["nuts_dense" if kind == "nuts" else "chees"]()
    mcmc = MCMC(kernel, num_warmup=100, num_samples=40, num_chains=chains)
    mcmc.run(_gen(5), warm_start=warm)
    x = mcmc.get_samples(group_by_chain=True)["x"]
    assert x.shape == (chains, 40, D) and bool(torch.isfinite(x).all())
    # the saved step size and metric are used as they are: no warmup ran
    torch.testing.assert_close(mcmc.get_extra_fields()["step_size"],
                               torch.full((chains,), 0.6, dtype=torch.float64))
    # the energies were re-anchored on this run's potential
    pe = gaussian_potential(torch.as_tensor(np.array(saved[0].z)))
    assert float(pe.abs().max()) > 0
    # a width or kernel mismatch is refused with JAX's messages
    with pytest.raises(ValueError, match="warm_start width mismatch"):
        MCMC(KERNELS["chees" if kind == "chees" else "nuts_dense"](), num_warmup=0, num_samples=1,
             num_chains=4).run(_gen(), warm_start=warm)
    with pytest.raises(ValueError, match="warm_start kernel mismatch"):
        MCMC(KERNELS["nuts_dense" if kind == "chees" else "chees"](), num_warmup=0, num_samples=1,
             num_chains=chains).run(_gen(), warm_start=warm)


def test_rescue_stuck_chains_matches_jax():
    C = 8
    rng = np.random.default_rng(6)
    z, grad = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    pot, energy = rng.normal(size=C), rng.normal(size=C)
    pot[5] = np.nan
    eps = rng.uniform(0.1, 0.3, C)
    eps[2] = 1e-5  # collapsed step size
    inv = np.stack([COV * (1 + 0.1 * c) for c in range(C)])
    chol = np.linalg.cholesky(inv)
    jm = jmcmc.MCMC(jmcmc.NUTS(lambda: None), num_warmup=1, num_samples=1, num_chains=C)
    jstate = jhmc.HMCState(jnp.asarray(z), jnp.asarray(pot), jnp.asarray(grad), jnp.asarray(energy),
                           jnp.zeros(C), jnp.zeros(C, jnp.int32), jnp.zeros(C, bool),
                           jax.random.split(jax.random.PRNGKey(0), C))
    want = jm._rescue_stuck_chains(jstate, jnp.asarray(inv), jnp.asarray(chol), jnp.asarray(eps))
    tm = MCMC(NUTS(model), num_warmup=1, num_samples=1, num_chains=C)
    from dynode_tpu_torch.infer.hmc import HMCState

    tstate = HMCState(*(torch.as_tensor(np.asarray(x)) for x in jstate[:7]))
    got = tm._rescue_stuck_chains(tstate, torch.as_tensor(inv), torch.as_tensor(chol), torch.as_tensor(eps))
    assert tm._n_rescued == jm._n_rescued == 2
    for field in ("z", "potential", "grad", "energy"):
        np.testing.assert_allclose(getattr(got[0], field).numpy(), np.asarray(getattr(want[0], field)), rtol=1e-12)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def _messages(fn_jax, fn_torch, exc=ValueError):
    with pytest.raises(exc) as ej:
        fn_jax()
    with pytest.raises(exc) as et:
        fn_torch()
    assert str(et.value) == str(ej.value)


def _jmodel():
    jh.sample("x", __import__("dynode_tpu.dist", fromlist=["Normal"]).Normal(0.0, 1.0))


def test_errors_match_jax():
    _messages(lambda: jmcmc.MCMC(jmcmc.NUTS(_jmodel), num_warmup=1, num_samples=1, chain_method="pmap"),
              lambda: MCMC(NUTS(model), num_warmup=1, num_samples=1, chain_method="pmap"))
    _messages(lambda: jmcmc.MCMC(jchees.ChEES(_jmodel), num_warmup=1, num_samples=1,
                                 chain_method="sequential").run(jax.random.PRNGKey(0)),
              lambda: MCMC(ChEES(model), num_warmup=1, num_samples=1, chain_method="sequential").run(0))
    _messages(lambda: jmcmc.MCMC(jmcmc.NUTS(_jmodel), num_warmup=1, num_samples=1, chain_method="sequential",
                                 steps_per_call=2).run(jax.random.PRNGKey(0)),
              lambda: MCMC(NUTS(model), num_warmup=1, num_samples=1, chain_method="sequential",
                           steps_per_call=2).run(0))
    _messages(lambda: jmcmc.MCMC(jmcmc.NUTS(lambda: None), num_warmup=1, num_samples=1).run(jax.random.PRNGKey(0)),
              lambda: MCMC(NUTS(lambda: None), num_warmup=1, num_samples=1).run(_gen()))
    with pytest.raises(TypeError, match="Mesh"):
        MCMC(NUTS(model), num_warmup=1, num_samples=1, mesh=object())


def test_parallel_and_narrow_chees_warn_and_run():
    with pytest.warns(UserWarning, match="fell back to a plain vectorized"):
        MCMC(NUTS(model, max_tree_depth=2, batched_potential_fn=gaussian_potential), num_warmup=2, num_samples=2,
             num_chains=2, chain_method="parallel").run(_gen())
    with pytest.warns(UserWarning, match=r"ChEES with num_chains=4 \(< 8\)"):
        MCMC(ChEES(model, batched_potential_fn=gaussian_potential), num_warmup=2, num_samples=2,
             num_chains=4).run(_gen())


def test_sequential_runs_each_chain_alone():
    mcmc = MCMC(NUTS(model, max_tree_depth=3, batched_potential_fn=gaussian_potential), num_warmup=5,
                num_samples=5, num_chains=3, chain_method="sequential")
    mcmc.run(_gen(7))
    assert mcmc.get_samples(group_by_chain=True)["x"].shape == (3, 5, D)
    state, tuned = mcmc.warm_start_state()
    assert state.z.shape == (3, D) and tuned[0].shape == (3, D, D) and tuned[2].shape == (3,)


def test_deterministic_sites_summary_consensus_and_stuck_warning(capsys):
    def det_model():
        x = handlers.sample("x", dist.Normal(torch.zeros(2, dtype=torch.float64), 1.0))
        handlers.deterministic("x2", x * 2.0)

    mcmc = MCMC(NUTS(det_model, max_tree_depth=3), num_warmup=12, num_samples=8, num_chains=4)
    mcmc.run(_gen(8), consensus_check=2)
    torch.testing.assert_close(mcmc.deterministic_samples()["x2"], 2.0 * mcmc.get_samples()["x"])
    assert set(mcmc.consensus_report) == {"x"}
    mcmc.print_summary()
    assert "x_0" in capsys.readouterr().out
    frozen = MCMC(NUTS(model, max_tree_depth=2, step_size=1e-12, adapt_step_size=False,
                       batched_potential_fn=gaussian_potential), num_warmup=0, num_samples=5, num_chains=4)
    with pytest.warns(UserWarning, match="near-\\)constant samples"):
        frozen.run(_gen(9))


CPU8 = [torch.device("cpu", i) for i in range(8)]


def elementwise_potential(zb):
    """The Gaussian's density with a diagonal precision, elementwise."""
    d = zb - torch.as_tensor(MU)
    return 0.5 * torch.sum(d * d * torch.as_tensor(np.diag(PREC)), dim=-1)


@pytest.mark.parametrize("kernel", ["nuts_generic", "nuts_batched", "chees_generic"])
def test_sharded_bank_matches_unsharded(kernel):
    """``MCMC(mesh=)`` splits the bank's potential and gradient over 8 CPU
    devices; the sampler's state and its bank-wide reductions stay on the
    first. So the split bank does the unsplit bank's arithmetic: equal
    draws and statistics bit for bit (JAX promises its split bank only in
    distribution, ``test_mesh.py``). The model's generic potential, and a
    batched one that is elementwise over the chains: a matrix product's
    rounding may change with the number of rows on the CPU."""
    from dynode_tpu_torch.parallel import create_mesh

    make = {
        "nuts_generic": lambda: NUTS(model, max_tree_depth=4),
        "nuts_batched": lambda: NUTS(model, max_tree_depth=4, batched_potential_fn=elementwise_potential),
        "chees_generic": lambda: ChEES(model),
    }[kernel]
    mesh = create_mesh(("chains",), devices=CPU8)
    runs = []
    for m in (None, mesh):
        mc = MCMC(make(), num_warmup=30, num_samples=20, num_chains=16, mesh=m, chain_axis="chains")
        mc.run(_gen(4))
        runs.append(mc)
    assert torch.equal(runs[0].get_samples()["x"], runs[1].get_samples()["x"])
    for key, val in runs[0].get_extra_fields().items():
        assert torch.equal(val, runs[1].get_extra_fields()[key]), key
    assert runs[1].mesh is mesh


def test_sharded_chains_mcmc():
    """``test_mesh.py``'s case: NUTS with ``mesh=`` over 8 devices, 8
    chains of a Normal-mean model; the posterior mean within 0.1."""
    from dynode_tpu_torch.parallel import create_mesh

    data = torch.as_tensor(np.random.RandomState(0).randn(64) + 0.5, dtype=torch.float32)

    def mean_model(obs=None):
        mu = handlers.sample("mu", dist.Normal(0.0, 1.0))
        handlers.sample("x", dist.Normal(mu, 1.0), obs=obs)

    mc = MCMC(NUTS(mean_model, max_tree_depth=6), num_warmup=50, num_samples=50, num_chains=8,
              mesh=create_mesh(("chain",), devices=CPU8))
    mc.run(_gen(0), obs=data)
    samples = mc.get_samples(group_by_chain=True)["mu"]
    assert samples.shape == (8, 50)
    assert abs(float(samples.mean()) - float(data.mean()) * 64 / 65) < 0.1
    with pytest.raises(ValueError, match="chain bank width 6 must divide over the 8-device"):
        MCMC(NUTS(mean_model), num_warmup=1, num_samples=1, num_chains=6,
             mesh=create_mesh(("chain",), devices=CPU8)).run(_gen(0), obs=data)


def test_graph_cache_key_includes_the_mesh():
    """``test_exec_cache.py``'s mesh case for the port's cache of CUDA
    graphs: a split bank's shard graph is another entry than a whole
    bank's of the same width, one per device and width of that mesh, and
    a repeated split run is served the same graph. (The graph is captured
    at its first call, on the card; the cache is checked here.)"""
    from dynode_tpu_torch.infer import mcmc as tm
    from dynode_tpu_torch.parallel import create_mesh

    tm._EXEC_CACHE.clear()
    mesh = create_mesh(("chains",), devices=CPU8[:2])
    dev = torch.device("cuda", 0)
    whole = tm.graphed_potential(gaussian_potential, 8, D, torch.float64, dev)
    shard = tm.graphed_potential(gaussian_potential, 8, D, torch.float64, dev, mesh=(mesh.key(), "chains"))
    assert shard is not whole and len(tm._EXEC_CACHE) == 2
    again = tm.graphed_potential(gaussian_potential, 8, D, torch.float64, dev, mesh=(mesh.key(), "chains"))
    assert again is shard and len(tm._EXEC_CACHE) == 2
    other = create_mesh(("chains",), devices=CPU8[:4])
    assert tm.graphed_potential(gaussian_potential, 8, D, torch.float64, dev,
                                mesh=(other.key(), "chains")) is not shard
    tm._EXEC_CACHE.clear()


def test_parallel_warning_states_sharded_when_mesh_created(monkeypatch):
    """``chain_method="parallel"`` with several cards and a chain count
    that divides them builds a mesh over every card and says so in JAX's
    words (``test_advice_regressions_r4.py``); here 8 CPU devices stand in
    for the cards. With an explicit mesh it warns the same; a chain count
    that does not divide the cards falls back to the unsplit bank."""
    from dynode_tpu_torch.infer import mcmc as tm
    from dynode_tpu_torch.parallel import create_mesh

    monkeypatch.setattr(tm, "default_device_count", lambda: 8)
    monkeypatch.setattr(tm, "create_mesh", lambda axes: create_mesh(axes, devices=CPU8))
    mesh = create_mesh(("chain",), devices=CPU8)
    for given in (None, mesh):
        mc = MCMC(NUTS(model, max_tree_depth=2, batched_potential_fn=elementwise_potential), num_warmup=2,
                  num_samples=2, num_chains=16, chain_method="parallel", mesh=given, rescue_stuck_chains=False)
        with pytest.warns(UserWarning, match="mesh-sharded vectorized"):
            mc.run(_gen())
        assert mc.mesh.shape == {"chain": 8} and (given is None or mc.mesh is given)
    mc = MCMC(NUTS(model, max_tree_depth=2, batched_potential_fn=elementwise_potential), num_warmup=2,
              num_samples=2, num_chains=3, chain_method="parallel", rescue_stuck_chains=False)
    with pytest.warns(UserWarning, match="fell back to a plain vectorized"):
        mc.run(_gen())
    assert mc.mesh is None
