"""The port's meshes and split entry points against the JAX package's.

Mirrors ``tests/test_parallel/test_mesh.py``, ``test_sharded_kernels.py``
and ``test_distributed.py`` on a mesh of 8 CPU devices (``cpu:0`` to
``cpu:7``: the port's split logic runs the same as over cards, and the
indices say where each shard was sent). JAX's side runs on its 8 virtual
CPU devices (the repository's conftest).

- A split equals the unsplit call bit for bit for the constant-step
  kernel entries and ``simulate_ensemble``; the adaptive kernel entries
  too when ``block_b`` divides the per-device batch, and within the solve
  tolerance (JAX's own: atol 5e-4 generic, rtol 5e-3 SEIP) when it does
  not.
- On CPU tensors, PyTorch computes float64 ``pow`` (the PID controller's
  factor) with a vectorized kernel over whole groups of 16 elements and a
  scalar loop over the rest, which differ in the last bit on rare inputs.
  So an adaptive batch-leading split is bit for bit where every shard is
  a whole number of such groups (16 members a device here), and within
  1e-12 with the same steps elsewhere (2 members a device). Each shard
  equals the unsplit solve of its own members bit for bit in every case,
  which shows the split itself exact. The card computes each element
  alike at any width.
- The port's split results against JAX's on its own mesh, within the
  tolerances the port already holds each entry to (atol 1e-6 for the
  float32 generic kernels, 1e-6 relative for SEIP, 1e-10 and equal steps
  for float64 ``simulate_ensemble``).
- The ``ValueError`` of a batch that does not divide, the refused
  ``packed=True``, the refused adaptive ``lane_major`` split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

import dynode_tpu.parallel as jpar
import dynode_tpu_torch.parallel as tpar
from dynode_tpu.ops import sharded as jsh
from dynode_tpu_torch.ops import generic as tgen
from dynode_tpu_torch.ops import sharded as tsh
from dynode_tpu_torch.parallel import mesh as tmesh

CPU8 = [torch.device("cpu", i) for i in range(8)]
F64 = torch.float64


def _mesh(axis="ensemble"):
    return tpar.create_mesh((axis,), devices=CPU8)


def _jmesh(axis="ensemble"):
    return jpar.create_mesh((axis,))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_create_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tpar.create_mesh(("chain",))
    assert tpar.default_device_count() == 0


@pytest.mark.parametrize("names, sizes", [(("chain",), None), (("chain", "ensemble"), (4, -1)),
                                          (("chain", "ensemble"), (2, 4))])
def test_create_mesh_shapes_match_jax(names, sizes):
    got = tpar.create_mesh(names, axis_sizes=sizes, devices=CPU8)
    want = jpar.create_mesh(names, axis_sizes=sizes)
    assert got.shape == dict(want.shape)
    assert got.axis_names == want.axis_names
    assert [d.index for d in got.devices.flat] == [d.id for d in want.devices.flat]


def test_create_mesh_bad_sizes():
    with pytest.raises(ValueError, match="multiply to the device count 8"):
        tpar.create_mesh(("chain",), axis_sizes=(3,), devices=CPU8)
    with pytest.raises(ValueError, match="cannot be inferred"):
        tpar.create_mesh(("a", "b"), axis_sizes=(3, -1), devices=CPU8)


@pytest.mark.parametrize("batch", [1, 8, 10, 16, 17])
def test_host_batch_rounds_up_as_jax(batch):
    assert tpar.host_batch(_mesh(), batch, "ensemble") == jpar.host_batch(_jmesh(), batch, "ensemble")


def test_shardings_and_device_put():
    mesh = tpar.create_mesh(("chain", "ensemble"), axis_sizes=(4, 2), devices=CPU8)
    assert tpar.replicated(mesh).is_fully_replicated
    assert tpar.shard_batch(mesh, "chain").num_shards == 4
    assert tpar.ensemble_sharding(mesh).num_shards == 2
    assert tpar.shard_batch(mesh, ("chain", "ensemble")).num_shards == 8
    with pytest.raises(ValueError, match="not one of"):
        tpar.shard_batch(mesh, "start")
    tree = {"a": torch.arange(8.0), "b": (torch.arange(16).reshape(8, 2), None)}
    pieces = tpar.device_put_sharded_tree(tree, tpar.shard_batch(mesh, "chain"))
    assert len(pieces) == 4
    for s, piece in enumerate(pieces):
        assert torch.equal(piece["a"], tree["a"][2 * s: 2 * s + 2])
        assert torch.equal(piece["b"][0], tree["b"][0][2 * s: 2 * s + 2]) and piece["b"][1] is None
    copies = tpar.device_put_sharded_tree(tree, tpar.replicated(mesh))
    assert len(copies) == 8 and all(torch.equal(c["a"], tree["a"]) for c in copies)
    f = lambda x: x  # noqa: E731
    assert tpar.jit_donated(f, donate_argnums=(0,)) is f


def test_shard_plan_order_and_checks():
    """The split axes lead in their order; a copy over the other axes is
    the first; the batch must divide (the numbers in the message)."""
    mesh = tpar.create_mesh(("chain", "ensemble"), axis_sizes=(4, 2), devices=CPU8)
    plan = tmesh.shard_plan(mesh, "ensemble", 6)
    assert [d.index for d in plan.devices] == [0, 1] and plan.width == 3
    plan = tmesh.shard_plan(mesh, ("ensemble", "chain"), 16)
    assert [d.index for d in plan.devices] == [0, 2, 4, 6, 1, 3, 5, 7]
    assert plan.local == tuple(range(8)) and not plan.spans_processes and plan.home == torch.device("cpu")
    assert plan.place(3) == torch.device("cpu")
    with pytest.raises(ValueError, match=r"width 30 must divide over the 8-device .*\(30 = 3 x 8 \+ 6\)"):
        tmesh.shard_plan(_mesh(), "ensemble", 30)


def test_initialize_distributed_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert jpar.initialize_distributed() is False
    with pytest.raises(ValueError, match="together"):
        tpar.initialize_distributed(coordinator_address="localhost:1")


def test_hybrid_mesh_single_slice_and_forced_split_match_jax():
    got = tpar.create_hybrid_mesh(("slice", "chain"), devices=CPU8)
    want = jpar.create_hybrid_mesh(("slice", "chain"))
    assert got.axis_names == want.axis_names and got.devices.shape == want.devices.shape == (1, 8)
    got = tpar.create_hybrid_mesh(("slice", "chain"), num_slices=2, devices=CPU8)
    want = jpar.create_hybrid_mesh(("slice", "chain"), num_slices=2, devices=jax.devices())
    assert got.devices.shape == want.devices.shape == (2, 4)
    assert [d.index for d in got.devices.flat] == [d.id for d in want.devices.flat]
    with pytest.raises(ValueError, match="dcn_axis"):
        tpar.create_hybrid_mesh(("a", "b"), dcn_axis="slice", devices=CPU8)


def test_hybrid_mesh_runs_a_split_program():
    mesh = tpar.create_hybrid_mesh(("slice", "chain"), devices=CPU8)
    x = torch.arange(32.0).reshape(32, 1)
    plan = tmesh.shard_plan(mesh, "chain", 32)
    outs = tmesh.run_shards(plan, lambda s: (tmesh.split(x, plan, s) * 2).sum(dim=1))
    assert torch.equal(tmesh.gather_shards(plan, outs), x[:, 0] * 2)


# ---------------------------------------------------------------------------
# the four split kernel entries (plain versions on the CPU)
# ---------------------------------------------------------------------------


def _sir_rows(xp, batch):
    y0 = np.stack([np.full(batch, 0.9), np.full(batch, 0.1), np.zeros(batch)]).astype(np.float32)
    p = np.stack([np.linspace(0.5, 1.5, batch), np.full(batch, 0.3)]).astype(np.float32)

    def rhs(y, p, t):
        s, i, r = y
        beta, gamma = p
        inf = beta * s * i
        rec = gamma * i
        return [-inf, inf - rec, rec]

    return rhs, y0, p


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture
def shard_devices(monkeypatch):
    """The devices each shard of a split entry was sent to, in call order."""
    seen = []
    orig = tsh.split

    def recording(x, plan, s, dim=0):
        seen.append(plan.devices[s])
        return orig(x, plan, s, dim)

    monkeypatch.setattr(tsh, "split", recording)
    return seen


@pytest.mark.parametrize("extra", [{}, {"save_rows": (2,), "save_dtype": torch.bfloat16}],
                         ids=["all_rows", "row2_bf16"])
def test_const_kernel_split_bit_identical(extra, shard_devices):
    rhs, y0, p = _sir_rows(np, 64)
    single = tgen.ensemble_solve_kernel(rhs, _t(y0), _t(p), duration=20.0, dt=0.5, **extra)
    split = tsh.ensemble_solve_kernel_sharded(rhs, _t(y0), _t(p), mesh=_mesh(), duration=20.0, dt=0.5, **extra)
    assert split.shape == single.shape and split.dtype == single.dtype and split.device.type == "cpu"
    assert torch.equal(split, single)
    # y0 and p of each shard, on the shards' devices in mesh order
    assert [d.index for d in shard_devices] == [s for s in range(8) for _ in range(2)]
    jkw = {"save_rows": extra["save_rows"], "save_dtype": jnp.bfloat16} if extra else {}
    want = jsh.ensemble_solve_kernel_sharded(rhs, jnp.asarray(y0), jnp.asarray(p), mesh=_jmesh(),
                                             duration=20.0, dt=0.5, **jkw)
    np.testing.assert_allclose(split.float().numpy(), np.asarray(want, np.float32), atol=1e-6 if not extra else 1e-2)


@pytest.mark.parametrize("block_b, batch, exact", [(16, 128, True), (64, 64, False)],
                         ids=["block_divides", "block_ragged"])
def test_adaptive_kernel_split(block_b, batch, exact):
    """``block_b`` dividing the per-device batch keeps the blocks: bit for
    bit, the stats the unsplit ones. Otherwise each device's one block is
    ragged: the solve tolerance, as JAX's test."""
    rhs, y0, p = _sir_rows(np, batch)
    kw = dict(duration=20.0, rtol=1e-4, atol=1e-6, steps_per_save=16, block_b=block_b)
    split, st = tsh.ensemble_solve_kernel_adaptive_sharded(rhs, _t(y0), _t(p), mesh=_mesh(), **kw)
    single, st1 = tgen.ensemble_solve_kernel_adaptive(rhs, _t(y0), _t(p), **kw)
    assert int(st["exhausted_intervals"].sum()) == 0
    assert st["exhausted_intervals"].shape == (max(8, batch // block_b),)
    if exact:
        assert torch.equal(split, single)
        for key in st:
            assert torch.equal(st[key], st1[key]), key
    else:
        np.testing.assert_allclose(split.numpy(), single.numpy(), rtol=0, atol=5e-4)
        jkw = {k: v for k, v in kw.items() if k != "block_b"}
        want, _ = jsh.ensemble_solve_kernel_adaptive_sharded(rhs, jnp.asarray(y0), jnp.asarray(p),
                                                             mesh=_jmesh(), **jkw)
        np.testing.assert_allclose(split.numpy(), np.asarray(want), rtol=0, atol=5e-4)


def test_split_batch_must_divide_mesh():
    rhs, y0, p = _sir_rows(np, 30)
    with pytest.raises(ValueError, match="divide"):
        tsh.ensemble_solve_kernel_sharded(rhs, _t(y0), _t(p), mesh=_mesh(), duration=5.0, dt=0.5)
    with pytest.raises(ValueError, match="divide"):
        tsh.ensemble_solve_kernel_adaptive_sharded(rhs, _t(y0), _t(p), mesh=_mesh(), duration=5.0)
    with pytest.raises(ValueError, match="whole number of dt"):  # checked before any shard runs
        tsh.ensemble_solve_kernel_sharded(rhs, _t(y0[:, :16]), _t(p[:, :16]), mesh=_mesh(), duration=5.2,
                                          dt=0.5)
    with pytest.raises(ValueError, match="block_b"):
        tsh.ensemble_solve_kernel_adaptive_sharded(rhs, _t(y0[:, :16]), _t(p[:, :16]), mesh=_mesh(),
                                                   duration=5.0, block_b=24)


def _seip(batch):
    from dynode_tpu.config import SolverParams as JSP
    from dynode_tpu.models import seip as jseip
    from dynode_tpu_torch.config import SolverParams as TSP
    from dynode_tpu_torch.models import seip as tseip

    jcfg = jseip.seip_config(solver_params=JSP(constant_step_size=0.5))
    tcfg = tseip.seip_config(solver_params=TSP(constant_step_size=0.5))
    scales = np.linspace(0.9, 1.1, batch)
    j = (jseip.seip_initial_state(jcfg), jseip.seip_odeparams(jcfg), jnp.asarray(scales))
    t = (tseip.seip_initial_state(tcfg, device="cpu"), tseip.seip_odeparams(tcfg, device="cpu"),
         torch.as_tensor(scales, dtype=torch.float32))
    return j, t


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_seip_split_bit_identical():
    from dynode_tpu_torch.ops.seip import seip_ensemble_solve

    (jy, jp, js), (ty, tp, ts) = _seip(16)
    kw = dict(duration=3, dt=0.5, save=(3,))
    ref = seip_ensemble_solve(ty, tp, ts, **kw)
    got = tsh.seip_ensemble_solve_sharded(ty, tp, ts, mesh=_mesh(), **kw)
    assert len(got) == len(ref) == 1 and torch.equal(got[0], ref[0])
    want = jsh.seip_ensemble_solve_sharded(jy, jp, js, mesh=_jmesh(), **kw)
    assert _rel(got[0], want[0]) <= 1e-6


@pytest.mark.parametrize("batch, exact", [(32, True), (16, False)], ids=["block_divides", "block_ragged"])
def test_seip_adaptive_split(batch, exact):
    """``block_b`` 4: 4 members a device keep the blocks (bit for bit, the
    unsplit stats); 2 a device make ragged blocks (JAX's tolerance)."""
    from dynode_tpu_torch.ops.seip import seip_ensemble_solve_adaptive

    (jy, jp, js), (ty, tp, ts) = _seip(batch)
    kw = dict(duration=3, rtol=1e-4, atol=1e-3, save=(3,), steps_per_save=16, block_b=4)
    ref, ref_st = seip_ensemble_solve_adaptive(ty, tp, ts, **kw)
    got, st = tsh.seip_ensemble_solve_adaptive_sharded(ty, tp, ts, mesh=_mesh(), **kw)
    assert int(st["exhausted_intervals"].sum()) == 0
    assert st["exhausted_intervals"].shape == (max(8, batch // 4),)
    if exact:
        assert torch.equal(got[0], ref[0])
        for key in st:
            assert torch.equal(st[key], ref_st[key]), key
    else:
        np.testing.assert_allclose(got[0].double().numpy(), ref[0].double().numpy(), rtol=5e-3, atol=1e-6)
    jkw = {k: v for k, v in kw.items() if k != "block_b"}
    want, _ = jsh.seip_ensemble_solve_adaptive_sharded(jy, jp, js, mesh=_jmesh(), **jkw)
    np.testing.assert_allclose(got[0].double().numpy(), np.asarray(want[0], np.float64), rtol=5e-3, atol=1e-6)


def test_seip_split_refuses_packed():
    for entry in (tsh.seip_ensemble_solve_sharded, tsh.seip_ensemble_solve_adaptive_sharded):
        with pytest.raises(ValueError, match="packed"):
            entry(None, None, torch.zeros(16), mesh=_mesh(), duration=1, packed=True)


# ---------------------------------------------------------------------------
# simulate_ensemble(mesh=)
# ---------------------------------------------------------------------------


def _sir_batch(batch):
    from dynode_tpu.models import sir as jsir
    from dynode_tpu_torch.models import sir as tsir

    beta = np.linspace(0.2, 0.5, batch)
    gamma = np.full(batch, 1 / 7.0)
    cm = np.ones((batch, 1, 1))
    jp = jsir.SIRParams(beta=jnp.asarray(beta), gamma=jnp.asarray(gamma), contact_matrix=jnp.asarray(cm))
    tp = tsir.SIRParams(beta=torch.as_tensor(beta), gamma=torch.as_tensor(gamma), contact_matrix=torch.as_tensor(cm))
    jy0 = (jnp.array([0.99]), jnp.array([0.01]), jnp.array([0.0]))
    ty0 = tuple(torch.as_tensor(np.array(x)) for x in jy0)
    return (jsir, jy0, jp), (tsir, ty0, tp)


@pytest.mark.parametrize("layout, adaptive, batch", [
    ("batch_leading", True, 128), ("batch_leading", True, 16), ("batch_leading", False, 16),
    ("lane_major", False, 16)], ids=["batch_leading-adaptive-16_a_device", "batch_leading-adaptive-2_a_device",
                                     "batch_leading-constant", "lane_major-constant"])
def test_simulate_ensemble_split(layout, adaptive, batch):
    from dynode_tpu import simulate_ensemble as j_ensemble
    from dynode_tpu.config import SolverParams as JSP
    from dynode_tpu_torch import simulate_ensemble as t_ensemble
    from dynode_tpu_torch.config import SolverParams as TSP

    (jsir, jy0, jp), (tsir, ty0, tp) = _sir_batch(batch)
    kw = dict(step_budget=128) if adaptive else dict(constant_step_size=0.5)
    whole = t_ensemble(tsir.sir_ode, 30, ty0, tp, TSP(**kw), layout=layout)
    got = t_ensemble(tsir.sir_ode, 30, ty0, tp, TSP(**kw), layout=layout, mesh=_mesh(), axis_name="ensemble")
    for key in ("num_accepted", "num_rejected"):
        assert torch.equal(got.stats[key], whole.stats[key]), key
    assert torch.equal(got.result, whole.result) and torch.equal(got.ts, whole.ts)
    # each shard is the unsplit solve of its own members, bit for bit
    width, dim = batch // 8, (0 if layout == "batch_leading" else -1)
    alone = [t_ensemble(tsir.sir_ode, 30, ty0, tree_map(lambda x: x[s * width:(s + 1) * width], tp), TSP(**kw),
                        layout=layout) for s in range(8)]
    for i, g in enumerate(got.ys):
        assert torch.equal(g, torch.cat([a.ys[i] for a in alone], dim=dim))
    # against the whole batch's solve: bit for bit, but for 2 members a
    # device of the adaptive solve, where the CPU's float64 pow and exp
    # run over groups of 16 members and a scalar tail, so that a solve of
    # 2 members rounds otherwise than the same members among 16
    for g, w in zip(got.ys, whole.ys):
        if adaptive and width % 16:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0)
        else:
            assert torch.equal(g, w)
    want = j_ensemble(jsir.sir_ode, 30, jy0, jp, JSP(**kw), layout=layout, mesh=_jmesh(), axis_name="ensemble")
    for key in ("num_accepted", "num_rejected"):
        np.testing.assert_array_equal(got.stats[key].numpy(), np.asarray(want.stats[key]))
    for g, w in zip(got.ys, want.ys):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-300)


def test_simulate_ensemble_split_refusals():
    from dynode_tpu_torch import simulate_ensemble as t_ensemble
    from dynode_tpu_torch.config import SolverParams as TSP

    _, (tsir, ty0, tp) = _sir_batch(16)
    _, (tsir, ty0, tp12) = _sir_batch(12)
    with pytest.raises(ValueError, match="width 12 must divide"):
        t_ensemble(tsir.sir_ode, 5, ty0, tp12, TSP(), mesh=_mesh())
    with pytest.raises(ValueError, match="not one of"):
        t_ensemble(tsir.sir_ode, 5, ty0, tp, TSP(), mesh=_mesh(), axis_name="chain")


@pytest.mark.parametrize("batch", [128, 16], ids=["16_a_device", "2_a_device"])
def test_lane_major_adaptive_split_matches_unsplit_and_jax(batch):
    """An adaptive lane-major ensemble over the mesh keeps one dt chain: one
    solve whose RHS is split over the 8 devices. The unsplit call's
    accepted and rejected steps; its saves bit for bit where each shard is
    a whole number of 16 members, else within 1e-12 (float64 ``pow`` on CPU
    tensors rounds a shard of 2 members otherwise than the same members
    among 16, ROADMAP.md Queue 3); JAX's split call's steps, and its saves
    within 1e-10."""
    from dynode_tpu import simulate_ensemble as j_ensemble
    from dynode_tpu.config import SolverParams as JSP
    from dynode_tpu_torch import simulate_ensemble as t_ensemble
    from dynode_tpu_torch.config import SolverParams as TSP

    (jsir, jy0, jp), (tsir, ty0, tp) = _sir_batch(batch)
    kw = dict(step_budget=128)
    whole = t_ensemble(tsir.sir_ode, 30, ty0, tp, TSP(**kw), layout="lane_major")
    got = t_ensemble(tsir.sir_ode, 30, ty0, tp, TSP(**kw), layout="lane_major", mesh=_mesh(),
                     axis_name="ensemble")
    assert int(got.result) == 0
    for key in ("num_accepted", "num_rejected"):
        assert torch.equal(got.stats[key], whole.stats[key]), key
    assert torch.equal(got.ts, whole.ts)
    for g, w in zip(got.ys, whole.ys):
        assert g.shape == w.shape and g.shape[-1] == batch
        if (batch // 8) % 16:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0)
        else:
            assert torch.equal(g, w)
    want = j_ensemble(jsir.sir_ode, 30, jy0, jp, JSP(**kw), layout="lane_major", mesh=_jmesh(),
                      axis_name="ensemble")
    for key in ("num_accepted", "num_rejected"):
        np.testing.assert_array_equal(got.stats[key].numpy(), np.asarray(want.stats[key]))
    for g, w in zip(got.ys, want.ys):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-300)
