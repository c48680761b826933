"""Model introspection: traces -> transforms -> potential functions.

Port of ``dynode_tpu/infer/util.py``: discovers latent sites, maps them to
unconstrained space via ``dist.transforms.biject_to``, and builds the flat
potential ``U(z) = -[log p(constrain(z)) + log|det J|]`` the samplers
differentiate. :func:`flatten_potential` lays the sites out as
``jax.flatten_util.ravel_pytree`` does (dict keys sorted, each leaf raveled
row-major), so the port's flat ``z`` and JAX's are the same vector.

The init strategies are called once per site. Given a chain count, the
site's distribution is expanded to a leading chain axis and its value
broadcast to it (:func:`initialize_latents`), so one call initialises a
whole bank.
"""

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import PlaceholderSample
from ..dist import Distribution
from ..dist.transforms import biject_to
from . import handlers


def get_model_trace(model, rng_key, *args, substitutions=None, **kwargs):
    """Run ``model`` once under seed (+ optional substitute) and record sites.

    ``rng_key`` is an int or a ``torch.Generator`` (:class:`handlers.seed`).
    Wrapped in ``handlers.block`` so this internal trace never leaks sites
    into a surrounding user trace.
    """
    sub = handlers.substitute(substitutions or {})
    with handlers.block(), handlers.trace() as tr, handlers.seed(rng_key), sub:
        model(*args, **kwargs)
    return tr


def latent_sites(tr) -> Dict[str, Dict[str, Any]]:
    """Sample sites that are unobserved, real latents (not placeholders,
    not point masses)."""
    from ..dist.distribution import Delta

    return {
        name: site
        for name, site in tr.items()
        if site["type"] == "sample"
        and not site["is_observed"]
        and isinstance(site["fn"], Distribution)
        and not isinstance(site["fn"], (PlaceholderSample, Delta))
    }


def get_transforms(tr) -> Dict[str, Any]:
    """Per-latent-site bijection from unconstrained space onto its support."""
    return {name: biject_to(site["fn"].support) for name, site in latent_sites(tr).items()}


def _params_device(params) -> Optional[torch.device]:
    for value in params.values():
        if isinstance(value, torch.Tensor):
            return value.device
    return None


def log_density(
    model,
    model_args: tuple,
    model_kwargs: dict,
    params: Dict[str, Any],
    centers: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Joint log density of the model at the given (constrained) latents.

    Returns (log_joint, trace). Sites absent from ``params`` are sampled
    fresh from a generator seeded with 0 (on the device of ``params``).

    ``centers`` maps site names to constant per-element reference log-probs
    subtracted *before* the sum, which keeps float32 energy differences
    free of cancellation; the density shifts by a constant.
    """
    with handlers.block(), handlers.trace() as tr, handlers.seed(0, device=_params_device(params)), \
            handlers.substitute(params):
        model(*model_args, **model_kwargs)
    log_joint = None
    for name, site in tr.items():
        if site["type"] == "sample" and isinstance(site["fn"], Distribution):
            lp = handlers.weighted_log_prob(
                site,
                center=centers.get(name) if centers is not None else None,
            )
            term = torch.sum(lp)
            log_joint = term if log_joint is None else log_joint + term
    if log_joint is None:
        log_joint = torch.zeros((), dtype=torch.get_default_dtype())
    return log_joint, tr


def observed_logprob_centers(tr) -> Dict[str, torch.Tensor]:
    """Per-element log-probs (detached) of every observed site in a model
    trace: the fixed centering constants of :func:`log_density`."""
    centers = {}
    for name, site in tr.items():
        if (
            site["type"] == "sample"
            and site["is_observed"]
            and isinstance(site["fn"], Distribution)
        ):
            centers[name] = site["fn"].log_prob(site["value"]).detach()
    return centers


def constrain_sample(transforms: Dict[str, Any], uparams: Dict[str, Any]):
    """Map an unconstrained latent dict onto the supports."""
    return {name: transforms[name](u) for name, u in uparams.items()}


def unconstrain_sample(transforms: Dict[str, Any], cparams: Dict[str, Any]):
    """Inverse of :func:`constrain_sample`."""
    return {name: transforms[name].inv(c) for name, c in cparams.items()}


def make_potential_fn(
    model,
    model_args: tuple,
    model_kwargs: dict,
    transforms: Dict[str, Any],
    centers: Optional[Dict[str, torch.Tensor]] = None,
) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """Potential over the *unconstrained* latent dict (negative log joint +
    ldj); ``centers`` as in :func:`log_density`."""

    def potential(uparams: Dict[str, Any]) -> torch.Tensor:
        cparams = {}
        ldj = 0.0
        for name, u in uparams.items():
            t = transforms[name]
            c = t(u)
            cparams[name] = c
            ldj = ldj + torch.sum(t.log_abs_det_jacobian(u, c))
        log_joint, _ = log_density(
            model, model_args, model_kwargs, cparams, centers=centers
        )
        return -(log_joint + ldj)

    return potential


class Unravel:
    """The inverse of the flat layout of :func:`flatten_potential`.

    Called on ``(..., D)`` it returns the dict of sites, each shaped
    ``(..., *site_shape)``: leading axes (chains, draws) carry through.
    """

    def __init__(self, example: Dict[str, Any]):
        self.names = sorted(example)
        self.shapes = [tuple(torch.as_tensor(example[n]).shape) for n in self.names]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.size = sum(self.sizes)

    def ravel(self, params: Dict[str, Any], batch_dims: int = 0) -> torch.Tensor:
        """The dict ``params`` (sites with ``batch_dims`` leading axes) as
        one ``(..., D)`` tensor, in the dtype the sites promote to."""
        leaves = [torch.as_tensor(params[n]) for n in self.names]
        dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            dtype = torch.promote_types(dtype, leaf.dtype)
        batch = tuple(leaves[0].shape[:batch_dims])
        return torch.cat([leaf.to(dtype).reshape(batch + (-1,)) for leaf in leaves], dim=-1)

    def __call__(self, zvec: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch = tuple(zvec.shape[:-1])
        parts = torch.split(zvec, self.sizes, dim=-1)
        return {n: p.reshape(batch + s) for n, p, s in zip(self.names, parts, self.shapes)}


def flatten_potential(
    potential_fn: Callable[[Dict[str, Any]], torch.Tensor],
    example_uparams: Dict[str, Any],
):
    """Vectorize the potential: dict latents -> flat R^D, in
    ``ravel_pytree``'s order. Returns ``(flat_potential, flat0, unravel)``."""
    unravel = Unravel(example_uparams)
    flat0 = unravel.ravel(example_uparams)

    def flat_potential(zvec):
        return potential_fn(unravel(zvec))

    return flat_potential, flat0, unravel


# ---------------------------------------------------------------------------
# init strategies: ``init(site, generator)`` -> constrained value
# ---------------------------------------------------------------------------


def init_to_median(site: Dict[str, Any], rng_key, num_samples: int = 15):
    """Init a latent to the elementwise median of ``num_samples`` prior draws.

    The median of an odd count is its middle draw, as ``jnp.median``; for
    an even count it is the mean of the two middle draws."""
    draws = torch.as_tensor(site["fn"].sample(rng_key, (num_samples,)))
    ordered = torch.sort(draws, dim=0).values
    lo, hi = (num_samples - 1) // 2, num_samples // 2
    return ordered[lo] if lo == hi else 0.5 * (ordered[lo] + ordered[hi])


def init_to_sample(site: Dict[str, Any], rng_key):
    """Init a latent to a single prior draw."""
    return site["fn"].sample(rng_key)


def init_to_mean(site: Dict[str, Any], rng_key):
    """Init a latent to its prior mean (falls back to a prior draw)."""
    try:
        mean = site["fn"].mean
        if mean is not None:
            mean = torch.as_tensor(mean)
            if bool(torch.all(torch.isfinite(mean))):
                return torch.broadcast_to(mean, torch.as_tensor(site["value"]).shape)
    except (NotImplementedError, TypeError):
        pass
    return init_to_sample(site, rng_key)


def init_to_uniform(site: Dict[str, Any], rng_key, radius: float = 2.0):
    """Init uniformly in [-radius, radius] in *unconstrained* space (drawn
    in the unconstrained shape, which differs for simplex supports)."""
    t = biject_to(site["fn"].support)
    u0 = t.inv(site["value"])
    u = torch.rand(u0.shape, generator=rng_key, dtype=u0.dtype, device=u0.device)
    return t(-radius + 2.0 * radius * u)


def init_to_value(values: Dict[str, Any], fallback: Callable = init_to_median):
    """Strategy factory: init named latents to given (constrained) values,
    broadcast to the site's value shape; other sites use ``fallback``."""

    def init(site: Dict[str, Any], rng_key):
        name = site.get("name")
        if name in values:
            value = torch.as_tensor(site["value"])
            return torch.as_tensor(values[name], dtype=value.dtype, device=value.device).expand(value.shape)
        return fallback(site, rng_key)

    return init


def _bank_site(site: Dict[str, Any], num_chains: int) -> Dict[str, Any]:
    """``site`` with its distribution expanded to a leading chain axis and
    its value broadcast to it."""
    fn = site["fn"]
    value = torch.as_tensor(site["value"])
    bank = dict(site)
    bank["fn"] = fn.expand((num_chains,) + tuple(fn.batch_shape))
    bank["value"] = value.expand((num_chains,) + tuple(value.shape))
    return bank


def initialize_latents(
    tr,
    rng_key,
    init_strategy: Callable = init_to_median,
    num_chains: Optional[int] = None,
) -> Dict[str, Any]:
    """Constrained init values for every latent site of a traced model.

    ``rng_key`` is a ``torch.Generator``. With ``num_chains`` every value
    gains a leading chain axis: the strategy sees the site expanded to it.
    """
    out = {}
    for name, site in latent_sites(tr).items():
        if num_chains is not None:
            site = _bank_site(site, num_chains)
        out[name] = torch.as_tensor(init_strategy(site, rng_key))
    return out


# ---------------------------------------------------------------------------
# draw seams for banks of replays (multi-start SVI, Predictive)
# ---------------------------------------------------------------------------


def draw_seam(rng_key, device: torch.device):
    """The draw seam of ``rng_key``: a seam itself (anything with
    ``normal``, as :class:`~.hmc.Draws` or a test's replay), a
    ``torch.Generator`` wrapped in :class:`~.hmc.Draws`, or an int seeding a
    generator on ``device``."""
    from .hmc import Draws

    if hasattr(rng_key, "normal"):
        return rng_key
    if isinstance(rng_key, torch.Generator):
        return Draws(rng_key)
    return Draws(torch.Generator(device=device).manual_seed(int(rng_key)))


class RecordingDraws:
    """A draw seam that passes every draw on to ``source`` and records its
    kind, shape and dtype: the draw signature of one call of a guide."""

    def __init__(self, source):
        self.source = source
        self.calls = []

    @property
    def device(self):
        return self.source.device

    def normal(self, shape, dtype, device, active=None):
        self.calls.append(("normal", tuple(shape), dtype))
        return self.source.normal(shape, dtype, device)

    def uniform(self, shape, dtype, device, active=None):
        self.calls.append(("uniform", tuple(shape), dtype))
        return self.source.uniform(shape, dtype, device)


class GivenDraws:
    """A draw seam that hands out the given tensors in order, one per draw
    (inside a ``torch.func.vmap`` over a bank, each member's slices)."""

    def __init__(self, values, device):
        self.values = list(values)
        self.device = device

    def _next(self, shape):
        value = self.values.pop(0)
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"a given draw has shape {tuple(value.shape)}, the call asks for {tuple(shape)}")
        return value

    def normal(self, shape, dtype, device, active=None):
        return self._next(shape)

    def uniform(self, shape, dtype, device, active=None):
        return self._next(shape)


def bank_draws(seam, signature, n: Optional[int], repeats: int = 1) -> list:
    """Draws of ``signature`` (``RecordingDraws.calls``) for a bank of ``n``
    members, ``repeats`` times in a row: one ``(n, *shape)`` tensor per
    call, from ``seam`` in the order of the calls (so a seam that hands
    each member its own stream gives member i its i-th slices). With ``n``
    None, the calls' own shapes: the draws of one member, as it makes
    them."""
    lead = () if n is None else (n,)
    out = []
    for _ in range(repeats):
        for kind, shape, dtype in signature:
            out.append(getattr(seam, kind)(lead + shape, dtype, seam.device))
    return out


__all__ = [
    "get_model_trace",
    "latent_sites",
    "get_transforms",
    "log_density",
    "observed_logprob_centers",
    "constrain_sample",
    "unconstrain_sample",
    "make_potential_fn",
    "flatten_potential",
    "Unravel",
    "init_to_median",
    "init_to_sample",
    "init_to_mean",
    "init_to_uniform",
    "init_to_value",
    "initialize_latents",
    "draw_seam",
    "RecordingDraws",
    "GivenDraws",
    "bank_draws",
]
