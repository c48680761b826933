"""Minimal effect-handler system: sample/deterministic/param primitives.

Port of ``dynode_tpu/infer/handlers.py`` on PyTorch. Models are ordinary
Python callables containing :func:`sample` / :func:`deterministic` calls;
handlers are context managers stacked around model execution:

- ``seed(rng_seed=...)``: provides the ``torch.Generator`` sites draw from.
- ``trace()``: records every site (name, fn, value, observed flag).
- ``substitute(data=...)``: forces named sites to given values.
- ``condition(data=...)``: like substitute but marks sites observed.
- ``plate(name, size, dim=...)``: batch of conditionally independent draws.
- ``mask(mask=...)`` / ``scale(scale=...)``: zero out (missing data) or
  temper enclosed sites' log-density contributions.

Site names, the order of sites, the handler order (innermost first, then
outermost last for postprocessing) and plate broadcasting follow the JAX
package. Where JAX splits a key per site, a site here draws with
``fn.sample(generator, sample_shape)`` from the one generator of its
:class:`seed` handler.
"""

from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from .. import _device
from ..dist import Distribution

_STACK: list = []


class Messenger:
    """Base handler: a context manager that rewrites site messages."""

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_value, tb):
        assert _STACK and _STACK[-1] is self
        _STACK.pop()

    def process_message(self, msg: Dict[str, Any]) -> None:
        """Mutate ``msg`` before the site's default behavior runs."""

    def postprocess_message(self, msg: Dict[str, Any]) -> None:
        """Observe the finished ``msg`` (e.g. to record it)."""


def _fn_device(fn) -> Optional[torch.device]:
    """The device of the first tensor among a distribution's attributes
    (searched into wrapped distributions), or None."""
    for value in vars(fn).values():
        if isinstance(value, torch.Tensor):
            return value.device
        if isinstance(value, Distribution):
            found = _fn_device(value)
            if found is not None:
                return found
    return None


class seed(Messenger):
    """Provide the generator that sites without a value draw from.

    ``rng_seed`` is a ``torch.Generator`` (used as it is, on its device) or
    an int. For an int the generator is made at the first site that draws,
    seeded with it, on ``device`` when given, else on the device of that
    site's distribution parameters, else on the default device (the card).
    """

    def __init__(self, rng_seed=0, device=None):
        if isinstance(rng_seed, torch.Generator):
            self.generator = rng_seed
            self._seed = None
        else:
            self.generator = None
            self._seed = int(rng_seed)
        self.device = device

    def _generator_for(self, fn) -> torch.Generator:
        if self.generator is None:
            device = self.device or _fn_device(fn) or _device.default_device()
            self.generator = torch.Generator(device=device).manual_seed(self._seed)
        return self.generator

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample" and msg["rng_key"] is None and msg["value"] is None:
            msg["rng_key"] = self._generator_for(msg["fn"])


class trace(Messenger):
    """Record every site into an OrderedDict (``with trace() as tr:``)."""

    def __init__(self):
        self.sites: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

    def __enter__(self):
        super().__enter__()
        self.sites = OrderedDict()
        return self.sites

    def postprocess_message(self, msg):
        """Observe/record the finalized site message."""
        name = msg["name"]
        if name in self.sites:
            raise ValueError(f"duplicate site name {name!r} in one model trace")
        self.sites[name] = dict(msg)

    def get_trace(self, model, *args, **kwargs):
        """Run ``model`` under this handler, returning the recorded sites."""
        with self as sites:
            model(*args, **kwargs)
        return sites


class substitute(Messenger):
    """Force named sample/param sites to the provided values."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data = data or {}

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] in ("sample", "param") and msg["value"] is None:
            if msg["name"] in self.data:
                msg["value"] = self.data[msg["name"]]


class condition(Messenger):
    """Force named sample sites to values AND mark them observed."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data = data or {}

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample" and msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True


class block(Messenger):
    """Hide inner sites from handlers stacked *outside* this one.

    Used around internal model traces (log-density evaluation, model
    introspection) so their sites don't leak into a user's surrounding
    trace.
    """

    def __init__(self, hide_fn=None):
        self.hide_fn = hide_fn or (lambda msg: True)


class reparam(Messenger):
    """Rewrite sample sites through reparameterization strategies.

    ``config`` maps site names to strategies: a strategy is called as
    ``strategy(name, fn)`` and returns ``(new_fn, value)``; it draws its
    auxiliary site(s) with :func:`sample`, and the original site becomes
    the returned (typically zero-density ``Delta``) distribution at the
    recomputed value.
    """

    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] != "sample" or msg["is_observed"]:
            return
        strategy = self.config.get(msg["name"])
        if strategy is None or msg.get("_reparam_done"):
            return
        new_fn, value = strategy(msg["name"], msg["fn"])
        msg["fn"] = new_fn
        msg["value"] = value
        msg["_reparam_done"] = True


class do(Messenger):
    """Pearl-style intervention on sample sites.

    ``with do(data={"r0": 2.5}):`` severs the edge from the site ``r0``
    into its children: downstream consumers of the site's return value
    receive the intervention value, while the original stochastic site is
    still executed under its own name (replayed through the full handler
    stack). The in-flight message becomes a ``deterministic`` site named
    ``{name}__do`` that records the intervention. With nested ``do``
    handlers intervening on the same site, the innermost wins.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data = dict(data or {})

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] != "sample" or msg.get("_do_original"):
            return
        if msg["name"] not in self.data:
            return
        # a FRESH message, not a copy of the partially handled one: inner
        # handlers re-run on it, so cond_indep_stack is rebuilt
        orig = {
            "type": "sample",
            "name": msg["name"],
            "fn": msg["fn"],
            "value": msg["value"] if msg["is_observed"] else None,
            "is_observed": msg["is_observed"],
            "rng_key": msg["rng_key"],
            "sample_shape": msg.get("sample_shape", ()),
            "_do_original": True,
        }
        _apply_stack(orig)
        msg["type"] = "deterministic"
        msg["name"] = msg["name"] + "__do"
        msg["fn"] = None
        msg["value"] = self.data[orig["name"]]
        msg["is_observed"] = False
        msg["rng_key"] = None


class uncondition(Messenger):
    """Make observed sample sites latent again.

    Inside this handler every ``sample(..., obs=data)`` statement draws a
    fresh value from its distribution (expanded to the data's batch shape)
    instead of returning the data; the observation is kept on the message
    as ``_observed_value``. Nest it INSIDE :class:`seed`: handlers run
    innermost-first, and seed only serves sites whose value is still unset.
    """

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample" and msg["is_observed"]:
            value = msg["value"]
            obs_shape = tuple(value.shape) if isinstance(value, torch.Tensor) else tuple(torch.as_tensor(value).shape)
            fn = msg["fn"]
            batch_obs = obs_shape[: len(obs_shape) - len(fn.event_shape)]
            target = tuple(torch.broadcast_shapes(batch_obs, fn.batch_shape))
            if target != tuple(fn.batch_shape):
                msg["fn"] = fn.expand(target)
            msg["_observed_value"] = msg["value"]
            msg["value"] = None
            msg["is_observed"] = False


class mask(Messenger):
    """Mask log-density contributions of enclosed sample sites.

    Where the (boolean, broadcastable) mask is False the site's elementwise
    log-prob contributes ZERO to the joint. Sampling draws are unaffected.
    Nested masks compose with logical AND.
    """

    def __init__(self, mask):
        self.mask = mask

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample":
            m = torch.as_tensor(self.mask, dtype=torch.bool)
            prev = msg.get("mask")
            msg["mask"] = m if prev is None else torch.logical_and(prev, m)


class scale(Messenger):
    """Scale log-density contributions of enclosed sample sites; nested
    scales multiply."""

    def __init__(self, scale):
        self.scale = scale

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample":
            msg["scale"] = msg.get("scale", 1.0) * self.scale


def _feasible_value(fn, value):
    """An always-in-support fill for masked-out entries:
    ``biject_to(support)(0)`` lands inside any continuous support;
    discrete/count supports (where biject_to has no bijector) admit 0."""
    value = torch.as_tensor(value)
    dtype = value.dtype if value.is_floating_point() else torch.float32
    try:
        from ..dist.transforms import biject_to

        t = biject_to(fn.support)
        fill = t(torch.zeros((), dtype=dtype, device=value.device))
        return torch.broadcast_to(fill, value.shape).to(value.dtype)
    except Exception:
        return torch.zeros_like(value)


def weighted_log_prob(site, center=None):
    """A sample site's elementwise log-prob with mask/scale applied.

    ``center`` (optional per-element constants, see
    :func:`~dynode_tpu_torch.infer.util.log_density`) is subtracted before
    weighting. Masked entries never reach ``log_prob`` (double-where): the
    value is first replaced with an in-support fill, then the log-prob is
    zeroed, so NaN-encoded gaps poison neither the density nor its gradient.
    """
    value = site["value"]
    m = site.get("mask")
    if m is not None:
        m = m.to(torch.as_tensor(value).device)
        value = torch.where(m, torch.as_tensor(value), _feasible_value(site["fn"], value))
    lp = site["fn"].log_prob(value)
    if center is not None:
        lp = lp - center
    if m is not None:
        lp = torch.where(m, lp, torch.zeros((), dtype=lp.dtype, device=lp.device))
    s = site.get("scale")
    if s is not None:
        lp = lp * s
    return lp


class plate(Messenger):
    """Batch dimension of conditionally independent sample draws.

    ``with plate("strain", 3):`` gives every enclosed sample site an extra
    batch dimension of size 3. Nested plates stack dims right-to-left;
    ``dim=`` (negative, counting from the right of the batch shape) pins a
    dimension explicitly. Subsampling is not supported.
    """

    def __init__(self, name: str, size: int, subsample_size=None, dim=None):
        if int(size) <= 0:
            raise ValueError(f"plate {name!r} needs a positive size, got {size}")
        if subsample_size is not None and subsample_size != size:
            raise NotImplementedError(
                "plate subsampling is not supported (the full-data "
                "likelihood is the fast path); use subsample_size=None"
            )
        if dim is not None and dim >= 0:
            raise ValueError(f"plate dim must be negative, got {dim}")
        self.name = name
        self.size = int(size)
        self.dim = dim
        self._explicit_dim = dim is not None

    def __enter__(self):
        occupied = {p.dim for p in _STACK if isinstance(p, plate)}
        if self._explicit_dim:
            if self.dim in occupied:
                raise ValueError(
                    f"plate {self.name!r}: dim {self.dim} is already taken "
                    "by an enclosing plate"
                )
        else:
            d = -1
            while d in occupied:
                d -= 1
            self.dim = d
        return super().__enter__()

    def __exit__(self, exc_type, exc_value, tb):
        super().__exit__(exc_type, exc_value, tb)
        if not self._explicit_dim:
            self.dim = None

    def process_message(self, msg):
        """Apply this handler's effect to an incoming site message."""
        if msg["type"] == "sample":
            msg.setdefault("cond_indep_stack", []).append(
                (self.name, self.size, self.dim)
            )


def _expand_for_plates(msg) -> None:
    """Broadcast a sample site's distribution over its enclosing plates."""
    stack = msg.get("cond_indep_stack")
    fn = msg["fn"]
    if not stack or not isinstance(fn, Distribution):
        return
    ndim = max(-d for (_, _, d) in stack)
    plate_shape = [1] * ndim
    for _, size, d in stack:
        plate_shape[d] = size
    target = tuple(torch.broadcast_shapes(tuple(plate_shape), tuple(fn.batch_shape)))
    if target != tuple(fn.batch_shape):
        msg["fn"] = fn.expand(target)


def _active_handlers(msg):
    """Handlers that see ``msg``, innermost-first.

    Walk outward from the innermost handler; the first ``block`` whose
    ``hide_fn`` hides this message stops the walk. A block that does not
    hide the message is transparent for it, but outer blocks still apply
    their own ``hide_fn``.
    """
    active = []
    for i in range(len(_STACK) - 1, -1, -1):
        h = _STACK[i]
        if isinstance(h, block) and h.hide_fn(msg):
            break
        active.append(h)
    return active


def _apply_stack(msg: Dict[str, Any]) -> Dict[str, Any]:
    active = _active_handlers(msg)  # innermost-first
    for handler in active:
        handler.process_message(msg)

    if msg["type"] == "sample":
        _expand_for_plates(msg)
    if msg["type"] == "sample" and msg["value"] is None:
        if msg["is_observed"]:
            raise RuntimeError("observed sample site lost its value")
        if msg["rng_key"] is None:
            raise ValueError(
                f"site {msg['name']!r} needs an rng_key: run the model under "
                "handlers.seed(...) or pass rng_key= to sample(). (If "
                "handlers.uncondition made this site latent, nest it INSIDE "
                "handlers.seed -- seed runs innermost-first and skips sites "
                "whose value is still set.)"
            )
        msg["value"] = msg["fn"].sample(
            msg["rng_key"], msg.get("sample_shape", ())
        )
    if msg["type"] == "param" and msg["value"] is None:
        msg["value"] = msg["init_value"]

    for handler in reversed(active):
        handler.postprocess_message(msg)
    return msg


def sample(
    name: str,
    fn: Distribution,
    obs=None,
    rng_key=None,
    sample_shape=(),
):
    """Declare a random variable (or observe data against a likelihood).

    ``rng_key`` is a ``torch.Generator``; outside any handler a site with
    no ``obs`` draws from it directly.
    """
    if not _STACK and obs is None:
        if rng_key is None:
            raise ValueError(
                f"sample site {name!r} called outside an inference context "
                "without an rng_key"
            )
        return fn.sample(rng_key, sample_shape)
    msg = {
        "type": "sample",
        "name": name,
        "fn": fn,
        "value": obs,
        "is_observed": obs is not None,
        "rng_key": rng_key,
        "sample_shape": tuple(sample_shape),
    }
    return _apply_stack(msg)["value"]


def factor(name: str, log_factor):
    """Add an arbitrary term to the joint log-density: an observed site of
    a :class:`~dynode_tpu_torch.dist.Unit` whose ``log_prob`` is the factor."""
    from ..dist.distribution import Unit

    unit = Unit(log_factor)
    value = torch.empty(
        tuple(unit.batch_shape) + (0,), dtype=unit.log_factor.dtype, device=unit.log_factor.device
    )
    sample(name, unit, obs=value)


def deterministic(name: str, value):
    """Record a derived value as a named trace site (no density)."""
    if not _STACK:
        return value
    msg = {
        "type": "deterministic",
        "name": name,
        "fn": None,
        "value": value,
        "is_observed": False,
        "rng_key": None,
    }
    return _apply_stack(msg)["value"]


def param(name: str, init_value=None):
    """Declare a learnable parameter site."""
    if not _STACK:
        return init_value
    msg = {
        "type": "param",
        "name": name,
        "fn": None,
        "value": None,
        "init_value": init_value,
        "is_observed": False,
        "rng_key": None,
    }
    return _apply_stack(msg)["value"]


__all__ = [
    "Messenger",
    "seed",
    "trace",
    "substitute",
    "condition",
    "block",
    "do",
    "uncondition",
    "plate",
    "mask",
    "scale",
    "reparam",
    "weighted_log_prob",
    "sample",
    "factor",
    "deterministic",
    "param",
]
