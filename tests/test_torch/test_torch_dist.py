"""The port's ``dist`` against ``dynode_tpu.dist``, on the CPU.

Inputs are seeded with numpy and shaped (12,) throughout, so the eager JAX
calls share their compiled kernels. Tolerances: ``log_prob``, ``mean``,
``variance`` and every transform in float64 within 1e-12 relative (inf and
NaN where JAX has them, at the same places); float32 against JAX's float64
at 1e-5. Draws are held by their support and moments (``chip_smoke``'s
checks, 2**14 draws from a CPU generator), not by JAX's bits.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import dynode_tpu.dist as jd
import dynode_tpu_torch.dist as td
from dynode_tpu.dist import continuous as jcont
from dynode_tpu.dist import transforms as jtr
from dynode_tpu_torch.dist import continuous as tcont
from dynode_tpu_torch.dist import transforms as ttr

RTOL = 1e-12
N = 12
RNG = np.random.default_rng(20)

REAL = np.array([-np.inf, -1e3, -2.5, -1.0, -0.1, 0.0, 0.3, 1.0, 2.5, 1e3, np.inf, np.nan])
POSITIVE = np.array([-1.0, 0.0, 1e-300, 1e-3, 0.1, 0.5, 1.0, 2.0, 10.0, 1e3, np.inf, np.nan])
UNIT = np.array([-0.1, 0.0, 1e-12, 0.1, 0.3, 0.5, 0.7, 0.9, 1 - 1e-12, 1.0, 1.1, np.nan])
INTERVAL = np.array([-2.0, -1.0, 0.0, 0.5, 0.5000001, 1.0, 1.5, 2.0, 2.0001, 3.0, 4.0, np.nan])
COUNT = np.array([-1.0, 0.0, 1.0, 2.0, 3.0, 5.0, 10.0, 2.5, 50.0, 1e3, np.inf, np.nan])


def _pos(lo=0.5, hi=2.0):
    return RNG.uniform(lo, hi, N)


#: family -> (keyword parameters as numpy arrays, values for log_prob)
FAMILIES = {
    "Normal": (dict(loc=RNG.normal(size=N), scale=_pos()), REAL),
    "LogNormal": (dict(loc=RNG.normal(size=N), scale=_pos()), POSITIVE),
    "HalfNormal": (dict(scale=_pos()), POSITIVE),
    "Cauchy": (dict(loc=RNG.normal(size=N), scale=_pos()), REAL),
    "HalfCauchy": (dict(scale=_pos()), POSITIVE),
    "StudentT": (dict(df=_pos(1.0, 8.0), loc=RNG.normal(size=N), scale=_pos()), REAL),
    "Uniform": (dict(low=np.full(N, -1.0), high=np.full(N, 3.0)), INTERVAL),
    "Exponential": (dict(rate=_pos()), POSITIVE),
    "Gamma": (dict(concentration=np.r_[1.0, _pos(0.3, 4.0)[1:]], rate=_pos()), POSITIVE),
    "Beta": (dict(concentration1=np.r_[1.0, _pos(0.3, 4.0)[1:]], concentration0=_pos(0.3, 4.0)), UNIT),
    "TruncatedNormal": (dict(loc=np.full(N, 1.0), scale=np.full(N, 0.3), low=0.5, high=2.0), INTERVAL),
    "TruncatedNormal_low": (dict(loc=RNG.normal(size=N), scale=_pos(), low=-0.5), REAL),
    "TruncatedNormal_high": (dict(loc=RNG.normal(size=N), scale=_pos(), high=1.5), REAL),
    "TruncatedNormal_right_tail": (dict(loc=np.zeros(N), scale=np.ones(N), low=8.0, high=30.0),
                                   np.array([7.0, 8.0, 8.001, 8.1, 8.5, 9.0, 10.0, 15.0, 29.0, 30.0, 31.0,
                                             np.nan])),
    "TruncatedNormal_left_tail": (dict(loc=np.zeros(N), scale=np.ones(N), low=-30.0, high=-8.0),
                                  np.array([-31.0, -30.0, -20.0, -12.0, -9.0, -8.5, -8.1, -8.001, -8.0, -7.0,
                                            0.0, np.nan])),
    "Poisson": (dict(rate=np.r_[0.0, 0.0, _pos(0.1, 20.0)[2:]]), COUNT),
    "Bernoulli": (dict(probs=np.r_[0.0, 1.0, RNG.uniform(0.05, 0.95, N - 2)]),
                  np.array([0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.5, -1.0, 2.0, 1.0, 0.0, np.nan])),
    "Bernoulli_logits": (dict(logits=RNG.normal(scale=3.0, size=N)),
                         np.array([0.0, 1.0] * 5 + [0.5, np.nan])),
    "Binomial": (dict(total_count=np.full(N, 10.0), probs=RNG.uniform(0.05, 0.95, N)),
                 np.array([-1.0, 0.0, 1.0, 2.0, 3.0, 5.0, 9.0, 10.0, 11.0, 2.5, np.inf, np.nan])),
    "NegativeBinomial": (dict(mean=_pos(0.5, 20.0), concentration=_pos(0.5, 5.0)), COUNT),
    "BetaBinomial": (dict(concentration1=_pos(0.5, 4.0), concentration0=_pos(0.5, 4.0),
                          total_count=np.full(N, 12.0)),
                     np.array([-1.0, 0.0, 1.0, 2.0, 3.0, 5.0, 11.0, 12.0, 13.0, 2.5, np.inf, np.nan])),
}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _pair(name):
    params, values = FAMILIES[name]
    cls = name.split("_")[0]
    if name == "Bernoulli_logits":
        cls = "Bernoulli"
    kw_j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in params.items()}
    kw_t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in params.items()}
    return getattr(jd, cls)(**kw_j), getattr(td, cls)(**kw_t), values


def _same_support(got, want):
    assert type(got).__name__ == type(want).__name__
    for bound in ("low", "high"):
        if hasattr(want, bound):
            g, w = getattr(got, bound), getattr(want, bound)
            assert (g is None) == (w is None)
            if w is not None:
                _close(torch.as_tensor(g, dtype=torch.float64), w)


def _moment(d, name):
    try:
        return getattr(d, name)
    except NotImplementedError:
        return NotImplementedError


@pytest.mark.parametrize("name", list(FAMILIES))
def test_log_prob_mean_variance_match_jax(name):
    """``log_prob`` at the support's edges and outside it, ``mean`` and
    ``variance`` (or ``NotImplementedError`` on both sides), in float64."""
    jdist, tdist, values = _pair(name)
    assert tdist.batch_shape == tuple(jdist.batch_shape)
    _close(tdist.log_prob(torch.from_numpy(values)), jdist.log_prob(jnp.asarray(values)))
    for moment in ("mean", "variance"):
        want, got = _moment(jdist, moment), _moment(tdist, moment)
        if want is NotImplementedError:
            assert got is NotImplementedError, moment
        else:
            _close(got, want)
    _same_support(tdist.support, jdist.support)


def test_vector_families_match_jax():
    """Categorical (an index off the end is NaN, a negative one counts from
    the end, as JAX's gather), Multinomial, Dirichlet, MultivariateNormal,
    the zero-inflated pair, Delta, Unit, Expanded and Transformed."""
    probs = RNG.dirichlet(np.ones(4), size=3)
    idx = np.array([[0, 1, 3, -1], [2, 4, -5, 1], [3, 3, 0, 2]])
    for kw in (dict(probs=probs), dict(logits=np.log(probs) + 0.3)):
        j = jd.Categorical(**{k: jnp.asarray(v) for k, v in kw.items()})
        t = td.Categorical(**{k: torch.from_numpy(v) for k, v in kw.items()})
        for row in idx.T:  # JAX's gather takes a value of the batch shape
            _close(t.log_prob(torch.from_numpy(row.copy())), j.log_prob(jnp.asarray(row)))
        _close(t.mean, j.mean)
        _close(t.probs, j.probs)
    p = RNG.dirichlet(np.ones(3), size=4)
    k = RNG.multinomial(10, [0.2, 0.3, 0.5], size=4).astype(np.float64)
    _close(td.Multinomial(10.0, torch.from_numpy(p)).log_prob(torch.from_numpy(k)),
           jd.Multinomial(10.0, jnp.asarray(p)).log_prob(jnp.asarray(k)))
    _close(td.Multinomial(10.0, torch.from_numpy(p)).mean, jd.Multinomial(10.0, jnp.asarray(p)).mean)
    conc = RNG.uniform(0.5, 3.0, (4, 3))
    _close(td.Dirichlet(torch.from_numpy(conc)).log_prob(torch.from_numpy(p)),
           jd.Dirichlet(jnp.asarray(conc)).log_prob(jnp.asarray(p)))
    _close(td.Dirichlet(torch.from_numpy(conc)).mean, jd.Dirichlet(jnp.asarray(conc)).mean)
    loc = RNG.normal(size=(4, 3))
    tril = np.tril(RNG.normal(size=(4, 3, 3))) + 3 * np.eye(3)  # JAX's solve takes a batched factor
    x = RNG.normal(size=(4, 3))
    _close(td.MultivariateNormal(torch.from_numpy(loc), torch.from_numpy(tril)).log_prob(torch.from_numpy(x)),
           jd.MultivariateNormal(jnp.asarray(loc), jnp.asarray(tril)).log_prob(jnp.asarray(x)))
    counts = COUNT
    gate = RNG.uniform(0.05, 0.5, N)
    for j, t in (
        (jd.ZeroInflatedPoisson(jnp.asarray(gate), 3.0), td.ZeroInflatedPoisson(torch.from_numpy(gate), 3.0)),
        (jd.ZeroInflatedNegativeBinomial(jnp.asarray(gate), 3.0, 2.0),
         td.ZeroInflatedNegativeBinomial(torch.from_numpy(gate), 3.0, 2.0)),
    ):
        _close(t.log_prob(torch.from_numpy(counts)), j.log_prob(jnp.asarray(counts)))
        _close(t.mean, j.mean)
    v = RNG.normal(size=(4, 3))
    _close(td.Delta(torch.from_numpy(v), -1.5, event_dim=1).log_prob(torch.from_numpy(v)),
           jd.Delta(jnp.asarray(v), -1.5, event_dim=1).log_prob(jnp.asarray(v)))
    _close(td.Unit(torch.from_numpy(v[0])).log_prob(None), jd.Unit(jnp.asarray(v[0])).log_prob(None))
    base_j, base_t = jd.Normal(0.3, 1.2), td.Normal(torch.tensor(0.3, dtype=torch.float64), 1.2)
    _close(base_t.expand((N,)).log_prob(torch.from_numpy(REAL)), base_j.expand((N,)).log_prob(jnp.asarray(REAL)))
    _close(base_t.expand((N,)).mean, base_j.expand((N,)).mean)
    tj = jd.TransformedDistribution(jd.Beta(2.0, 3.0), jd.AffineTransform(1.5, 1.0))
    tt = td.TransformedDistribution(td.Beta(torch.tensor(2.0, dtype=torch.float64), 3.0),
                                    td.AffineTransform(1.5, 1.0))
    y = INTERVAL + 0.5
    _close(tt.log_prob(torch.from_numpy(y)), tj.log_prob(jnp.asarray(y)))
    assert repr(tt.support) == repr(tj.support) == "Interval(1.5, 2.5)"
    _close(tt.mean, tj.mean)


#: (a, b) pairs of the truncation's standardised bounds: both tails, +-8,
#: +-30, and across zero
BOUNDS = np.array([[-30.0, -8.0], [-8.0, 8.0], [8.0, 30.0], [-1.0, 1.0], [0.5, 2.0], [-np.inf, -30.0],
                   [30.0, np.inf], [-40.0, -30.0], [-2.0, -1e-3], [1e-3, 2.0], [-0.5, 0.5], [5.0, 6.0]])
X_NDTR = np.array([-40.0, -30.0, -20.0, -19.99, -8.0, -1.0, 0.0, 1.0, 5.0, 8.0, 8.01, 30.0])


def test_log_diff_ndtr_and_log_ndtr_match_jax():
    """``_log_diff_ndtr`` at bounds +-8, +-30 and across zero, and the
    segments of ``log_ndtr`` (-20 and 8 in float64), against JAX."""
    a, b = BOUNDS.T
    _close(tcont._log_diff_ndtr(torch.from_numpy(a.copy()), torch.from_numpy(b.copy())),
           jcont._log_diff_ndtr(jnp.asarray(a), jnp.asarray(b)))
    from jax.scipy import special as jsp

    _close(tcont._log_ndtr(torch.from_numpy(X_NDTR)), jsp.log_ndtr(jnp.asarray(X_NDTR)))
    _close(tcont._ndtr(torch.from_numpy(X_NDTR)), jsp.ndtr(jnp.asarray(X_NDTR)))


def test_float32_matches_jax_float64_at_a_float32_bound():
    """The fit's float32 path (TruncatedNormal prior, Poisson likelihood)
    against JAX's float64 values, relative 1e-5."""
    scales = np.array([0.5, 0.6, 0.8, 0.95, 1.0, 1.05, 1.2, 1.5, 1.8, 1.99, 2.0, 1.3])
    j = jd.TruncatedNormal(jnp.ones(3), 0.3 * jnp.ones(3), low=0.5, high=2.0)
    t = td.TruncatedNormal(torch.ones(3), 0.3 * torch.ones(3), low=0.5, high=2.0)
    got = t.log_prob(torch.from_numpy(scales.reshape(4, 3)).float())
    assert got.dtype == torch.float32
    _close(got, j.log_prob(jnp.asarray(scales.reshape(4, 3))), rtol=1e-5)
    rate, k = RNG.uniform(0.5, 50.0, N), RNG.poisson(10.0, N).astype(np.float64)
    got = td.Poisson(torch.from_numpy(rate).float()).log_prob(torch.from_numpy(k).float())
    _close(got, jd.Poisson(jnp.asarray(rate)).log_prob(jnp.asarray(k)), rtol=1e-5)


Z = np.array([-40.0, -30.0, -20.0, -10.0, -1.0, -1e-3, 0.0, 1e-3, 1.0, 10.0, 30.0, 40.0])


def _transform_pairs():
    loc, scale = RNG.normal(size=N), RNG.uniform(0.5, 2.0, N) * np.sign(RNG.normal(size=N))
    return [
        ("identity", jd.IdentityTransform(), td.IdentityTransform()),
        ("affine_scalar", jd.AffineTransform(0.5, -2.0), td.AffineTransform(0.5, -2.0)),
        ("affine_array", jd.AffineTransform(jnp.asarray(loc), jnp.asarray(scale)),
         td.AffineTransform(torch.from_numpy(loc), torch.from_numpy(scale))),
        ("exp", jd.ExpTransform(), td.ExpTransform()),
        ("sigmoid", jd.SigmoidTransform(), td.SigmoidTransform()),
        ("compose", jd.ComposeTransform([jd.ExpTransform(), jd.AffineTransform(1.0, 2.0)]),
         td.ComposeTransform([td.ExpTransform(), td.AffineTransform(1.0, 2.0)])),
    ]


CONSTRAINTS = ["real", "positive", "nonnegative", "unit_interval", "Interval", "GreaterThan", "LessThan"]


def _constraint(module, name):
    C = module.constraints
    return {"Interval": lambda: C.Interval(0.5, 2.0), "GreaterThan": lambda: C.GreaterThan(1.5),
            "LessThan": lambda: C.LessThan(-0.5)}.get(name, lambda: getattr(C, name))()


def _check_transform(jt, tt, x):
    xj, xt = jnp.asarray(x), torch.from_numpy(np.array(x))
    yj, yt = jt(xj), tt(xt)
    _close(yt, yj)
    _close(tt.inv(yt), jt.inv(yj))
    _close(torch.as_tensor(tt.log_abs_det_jacobian(xt, yt)), jt.log_abs_det_jacobian(xj, yj))


@pytest.mark.parametrize("name", [n for n, _, _ in _transform_pairs()])
def test_transforms_match_jax(name):
    """Forward, inverse and ``log_abs_det_jacobian`` into both tails."""
    _, jt, tt = next(p for p in _transform_pairs() if p[0] == name)
    _check_transform(jt, tt, Z)
    assert repr(tt.codomain) == repr(jt.codomain)


@pytest.mark.parametrize("name", CONSTRAINTS)
def test_biject_to_matches_jax(name):
    """``biject_to`` of every constraint: the same chain of transforms and
    the same values, in the tails of z too (the sigmoid/affine composition
    of an interval)."""
    jt, tt = jd.biject_to(_constraint(jd, name)), td.biject_to(_constraint(td, name))
    chain = lambda t: [type(p).__name__ for p in getattr(t, "parts", [t])]  # noqa: E731
    assert chain(tt) == chain(jt)
    _check_transform(jt, tt, Z)


def test_stick_breaking_and_the_rest_of_biject_to():
    """The simplex's stick-breaking bijection (a multivariate Jacobian),
    ``push_constraint``, and the constraints with no bijection."""
    x = RNG.normal(scale=3.0, size=(4, 3))
    jt, tt = jd.biject_to(jd.constraints.simplex), td.biject_to(td.constraints.simplex)
    assert type(tt) is td.StickBreakingTransform
    _check_transform(jt, tt, x)
    for con in ("real", "positive", "unit_interval", "Interval", "GreaterThan", "LessThan"):
        for tr_j, tr_t in ((jd.ExpTransform(), td.ExpTransform()), (jd.SigmoidTransform(), td.SigmoidTransform()),
                           (jd.AffineTransform(1.5, -2.0), td.AffineTransform(1.5, -2.0)),
                           (jd.AffineTransform(jnp.ones(2), 2.0), td.AffineTransform(torch.ones(2), 2.0))):
            assert repr(ttr.push_constraint(_constraint(td, con), tr_t)) == repr(
                jtr.push_constraint(_constraint(jd, con), tr_j))
    for module in (jd, td):
        with pytest.raises(ValueError, match="no bijection"):
            module.biject_to(module.constraints.integer_nonnegative)


@pytest.mark.parametrize("name", [n for n, _, _ in chip_smoke.dist_families(torch.float32, "cpu")])
def test_draws_lie_in_the_support_with_the_right_moments(name):
    """2**14 float32 draws from a CPU generator: equal bits from equal
    seeds, in the support, the mean (median for the Cauchy pair) within 5
    standard errors (``chip_smoke.check_draws``, as on the card)."""
    _, d, centre = next(f for f in chip_smoke.dist_families(torch.float32, "cpu") if f[0] == name)
    chip_smoke.check_draws(name, d, centre, torch.Generator(), 7, 2**14)


def test_reparameterised_draws_carry_gradients():
    """The location-scale families, TruncatedNormal, Gamma, Beta and
    Dirichlet draw differentiably; TruncatedNormal's gradient equals central
    differences of its draws at a fixed seed."""
    loc = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    scale = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    conc = torch.tensor(2.5, dtype=torch.float64, requires_grad=True)
    for d in (td.Normal(loc, scale), td.LogNormal(loc, scale), td.HalfNormal(scale), td.Cauchy(loc, scale),
              td.Uniform(loc, loc + scale), td.Exponential(scale), td.Gamma(conc, scale), td.Beta(conc, scale),
              td.StudentT(conc, loc, scale), td.TruncatedNormal(loc, scale, low=0.0, high=2.0),
              td.Dirichlet(torch.stack([conc, scale]))):
        for p in (loc, scale, conc):
            p.grad = None
        d.sample(torch.Generator().manual_seed(3), (64,)).sum().backward()
        grads = [p.grad for p in (loc, scale, conc) if p.grad is not None]
        assert grads and all(bool(torch.isfinite(g)) and float(g) != 0.0 for g in grads), type(d).__name__

    def draw(m):
        return td.TruncatedNormal(m, 1.3, low=0.0, high=2.0).sample(torch.Generator().manual_seed(5), (64,))

    m = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    draw(m).sum().backward()
    h = 1e-6
    fd = float((draw(torch.tensor(0.4 + h, dtype=torch.float64)).sum()
                - draw(torch.tensor(0.4 - h, dtype=torch.float64)).sum()) / (2 * h))
    assert math.isclose(float(m.grad), fd, rel_tol=1e-6)


def test_device_and_dtype_rules():
    """Draws lie on the generator's device, and a parameter on another
    device raises; a number takes the dtype of the tensors it meets, else
    float32; a tensor keeps its own."""
    g = torch.Generator().manual_seed(0)
    assert td.Normal(0.0, 1.0).sample(g, (3,)).dtype == torch.float32
    assert td.Normal(torch.zeros(2, dtype=torch.float64), 1.0).sample(g).dtype == torch.float64
    assert td.Normal(0.0, 1.0).log_prob(torch.zeros(2, dtype=torch.float64)).dtype == torch.float64
    assert td.Poisson(3.0).sample(g, (2,)).dtype == torch.int64
    with pytest.raises(ValueError, match="generator's device"):
        td.Normal(torch.zeros(2, device="meta"), 1.0).sample(g)
    with pytest.raises(ValueError, match="several devices"):
        td.Normal(torch.zeros(2, device="meta"), 1.0).log_prob(torch.zeros(2))
    x = td.Gamma(2.0).sample(torch.Generator().manual_seed(9), (5,))
    assert torch.equal(x, td.Gamma(2.0).sample(torch.Generator().manual_seed(9), (5,)))
