"""The port's ``infer.handlers`` against ``dynode_tpu.infer.handlers``.

One model, written once over either library's handlers and ``dist``, runs
under the same handler stacks in JAX and in the port; the latents are
substituted from numpy-seeded values, so the traces hold the same values.
Each trace is compared site by site: names and their order, type, value,
observed flag, plates (``cond_indep_stack``), mask, scale and the
weighted log-prob, within 1e-12 in float64. Draws (sites left to the seed)
are held by shape only: the port draws from a ``torch.Generator``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.dist as jd
import dynode_tpu.infer.handlers as jh
import dynode_tpu_torch.dist as td
import dynode_tpu_torch.infer.handlers as th

RTOL = 1e-12
RNG = np.random.default_rng(11)
VALUES = {"a": 0.7, "b": RNG.uniform(0.5, 2.0, 3), "c": RNG.normal(size=(2, 3))}
OBS = RNG.normal(size=(2, 3))
OBS_NAN = np.where(RNG.uniform(size=(2, 3)) < 0.3, np.nan, OBS)
MASK = np.array([[True, False, True], [True, True, False]])

LIBS = {
    "jax": (jh, jd, lambda x: jnp.asarray(x, dtype=jnp.float64)),
    "torch": (th, td, lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)),
}


def model(lib, obs=None, masked=False):
    h, d, T = LIBS[lib]
    a = h.sample("a", d.Normal(T(0.0), T(1.0)))
    with h.plate("strain", 3):
        b = h.sample("b", d.LogNormal(T(0.0), T(0.5)))
        with h.plate("age", 2, dim=-2):
            c = h.sample("c", d.Normal(T(np.zeros(3)), T(1.0)))
    h.deterministic("ab", a * b)
    loc = a + b + c
    if masked:
        with h.mask(mask=MASK), h.scale(scale=0.5):
            h.sample("y", d.Normal(loc, T(1.0)), obs=None if obs is None else T(obs))
    else:
        with h.scale(scale=2.0), h.scale(scale=0.25):
            h.sample("y", d.Normal(loc, T(1.0)), obs=None if obs is None else T(obs))
    h.factor("f", -(a**2))
    h.param("p", T(1.5))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _run(lib, stack, *args, **kwargs):
    """The trace of ``model`` under ``stack(h, T)`` (a list of handlers,
    outermost first) in library ``lib``."""
    h, d, T = LIBS[lib]
    handlers = stack(lib, h, T)
    with h.trace() as tr:
        for handler in handlers:
            handler.__enter__()
        try:
            model(lib, *args, **kwargs)
        finally:
            for handler in reversed(handlers):
                handler.__exit__(None, None, None)
    return tr


def _seed(lib, h):
    return h.seed(0) if lib == "jax" else h.seed(0, device="cpu")


def _subs(lib, h, T):
    return [_seed(lib, h), h.substitute({k: T(v) for k, v in VALUES.items()})]


def _compare(tj, tt, values=True):
    assert list(tt) == list(tj)
    for name, sj in tj.items():
        st = tt[name]
        assert st["type"] == sj["type"], name
        assert st["is_observed"] == sj["is_observed"], name
        assert st.get("cond_indep_stack") == sj.get("cond_indep_stack"), name
        assert (st.get("mask") is None) == (sj.get("mask") is None), name
        if sj.get("mask") is not None:
            np.testing.assert_array_equal(_np(st["mask"]), _np(sj["mask"]))
        assert st.get("scale") == sj.get("scale"), name
        vj, vt = _np(sj["value"]), _np(st["value"])
        assert vt.shape == vj.shape, name
        if values:
            np.testing.assert_allclose(vt, vj, rtol=RTOL, equal_nan=True, err_msg=name)
        if sj["type"] == "sample":
            assert tuple(st["fn"].batch_shape) == tuple(sj["fn"].batch_shape), name
            if values:
                lj = _np(jh.weighted_log_prob(sj))
                lt = _np(th.weighted_log_prob(st))
                np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=1e-300, err_msg=name)


@pytest.mark.parametrize("masked, obs", [(False, OBS), (True, OBS), (True, OBS_NAN)],
                         ids=["scaled", "masked", "masked_nan_gaps"])
def test_trace_matches_jax(masked, obs):
    tj = _run("jax", _subs, obs=obs, masked=masked)
    tt = _run("torch", _subs, obs=obs, masked=masked)
    _compare(tj, tt)
    if masked:
        assert np.isfinite(_np(th.weighted_log_prob(tt["y"]))).all()


def test_trace_of_draws_matches_jax_in_shape():
    tj = _run("jax", lambda lib, h, T: [_seed(lib, h)], obs=OBS)
    tt = _run("torch", lambda lib, h, T: [_seed(lib, h)], obs=OBS)
    _compare(tj, tt, values=False)


def test_condition_matches_jax():
    def stack(lib, h, T):
        return _subs(lib, h, T)[:1] + [h.condition({"a": T(0.3), "b": T(VALUES["b"]), "c": T(VALUES["c"])})]

    tj, tt = _run("jax", stack, obs=OBS), _run("torch", stack, obs=OBS)
    _compare(tj, tt)
    assert tt["a"]["is_observed"] and tt["c"]["is_observed"]


def test_block_hides_inner_sites():
    def stack(lib, h, T):
        return [h.block(hide_fn=lambda msg: msg["name"] in ("b", "ab"))] + _subs(lib, h, T)

    for lib in LIBS:
        h, _, _ = LIBS[lib]
        tr = _run(lib, stack, obs=OBS)
        assert "b" not in tr and "ab" not in tr and "a" in tr
    _compare(_run("jax", stack, obs=OBS), _run("torch", stack, obs=OBS))


def test_do_matches_jax():
    def stack(lib, h, T):
        return _subs(lib, h, T) + [h.do({"a": T(2.5)})]

    tj, tt = _run("jax", stack, obs=OBS), _run("torch", stack, obs=OBS)
    _compare(tj, tt)
    assert "a__do" in tt and float(tt["ab"]["value"][0]) == pytest.approx(2.5 * VALUES["b"][0])


def test_uncondition_draws_in_the_data_layout():
    def stack(lib, h, T):
        return _subs(lib, h, T) + [h.uncondition()]

    tj, tt = _run("jax", stack, obs=OBS), _run("torch", stack, obs=OBS)
    _compare({k: v for k, v in tj.items() if k not in ("y", "f")},
             {k: v for k, v in tt.items() if k not in ("y", "f")})
    assert not tt["y"]["is_observed"] and tuple(tt["y"]["value"].shape) == OBS.shape
    np.testing.assert_array_equal(_np(tt["y"]["_observed_value"]), OBS)


def test_reparam_matches_jax():
    def stack(lib, h, T):
        d = LIBS[lib][1]

        def strategy(name, fn):
            x = h.sample(name + "_base", d.Normal(T(0.0), T(1.0)))
            return d.Delta(0.5 * x), 0.5 * x

        return [_seed(lib, h), h.substitute({"a_base": T(1.2), "b": T(VALUES["b"]), "c": T(VALUES["c"])}),
                h.reparam({"a": strategy})]

    tj, tt = _run("jax", stack, obs=OBS), _run("torch", stack, obs=OBS)
    _compare(tj, tt)
    assert float(tt["a"]["value"]) == pytest.approx(0.6)


def test_plate_errors_match_jax():
    for h in (jh, th):
        with pytest.raises(ValueError, match="positive size"):
            h.plate("p", 0)
        with pytest.raises(NotImplementedError, match="subsampling"):
            h.plate("p", 4, subsample_size=2)
        with pytest.raises(ValueError, match="must be negative"):
            h.plate("p", 4, dim=0)
        with pytest.raises(ValueError, match="already taken"):
            with h.plate("p", 4, dim=-1), h.plate("q", 2, dim=-1):
                pass


def test_site_errors():
    with pytest.raises(ValueError, match="outside an inference context"):
        th.sample("x", td.Normal(0.0, 1.0))
    with pytest.raises(ValueError, match="needs an rng_key"):
        with th.trace():
            th.sample("x", td.Normal(0.0, 1.0))
    with pytest.raises(ValueError, match="duplicate site name"):
        with th.trace(), th.seed(0, device="cpu"):
            th.sample("x", td.Normal(0.0, 1.0))
            th.sample("x", td.Normal(0.0, 1.0))
    gen = torch.Generator().manual_seed(1)
    assert th.sample("x", td.Normal(torch.zeros(2), 1.0), rng_key=gen).shape == (2,)
    assert th.deterministic("d", 3.0) == 3.0 and th.param("p", 2.0) == 2.0


def test_seed_makes_its_generator_on_the_site_device():
    s = th.seed(5)
    with th.trace() as tr, s:
        th.sample("x", td.Normal(torch.zeros(3, dtype=torch.float64), 1.0))
    assert s.generator.device.type == "cpu"
    assert tr["x"]["value"].dtype == torch.float64
    want = td.Normal(torch.zeros(3, dtype=torch.float64), 1.0).sample(torch.Generator().manual_seed(5))
    torch.testing.assert_close(tr["x"]["value"], want, rtol=0, atol=0)
