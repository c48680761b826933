"""Stochastic variational inference: Trace_ELBO, autoguides, Adam.

Port of ``dynode_tpu/infer/svi.py``: ``SVI(model, guide, optim,
Trace_ELBO())`` with ``AutoMultivariateNormal(model, init_loc_fn=
init_to_median)`` and ``Adam(step_size=0.1)``; ``svi.init(key, **kwargs)``
then ``svi.run(key, num_steps, init_state)`` returning an ``SVIRunResult``.

- **Optimizers without optax.** :class:`Adam` and :class:`ClippedAdam`
  write out optax's ``scale_by_adam`` (bias correction on an integer count)
  and ``clip_by_global_norm`` (its select) as a functional ``init`` /
  ``update`` over a dict of tensors, so a bank of starts maps them. Any
  object with ``init(params)`` and ``update(grads, state, params)`` is
  taken in their place.
- **Draws.** ``rng_key`` is an int, a ``torch.Generator`` or a draw seam
  (:class:`~.hmc.Draws`, or a test's replay of recorded draws): every draw
  of a run comes from that one stream, in order, where JAX splits a key
  per step. So the draws differ from JAX's for a seed.
- **CUDA graphs.** JAX jits ``SVI.run``'s loop as one ``lax.scan`` and
  ``run_multistart``'s bank as one program. On a card the port captures
  the step (one ``update``, or the bank's ``torch.func.vmap`` of one
  start's step) into one CUDA graph at the run's first step and replays
  it at every step (:class:`~.graphs.GraphedStep`; one graph a shard on a
  mesh). Each step's draws are taken from the seam outside the graph
  first, in the order of the guide's draws (its draw signature, recorded
  by ``init``), and handed to the graph: so a run takes the eager loop's
  draws and arithmetic, bit for bit. A capture that fails raises
  :class:`~.graphs.GraphCaptureError` naming the user's line, and no step
  runs eagerly in its place. CPU tensors run the steps eagerly (a host
  loop; the losses stay on the device). The final ELBO of a bank runs
  eagerly, once a run.
- **Kept across runs.** ``SVI.run`` releases its graph at the end, as JAX
  jits a fresh closure every run. ``run_multistart`` keeps its bank, as
  JAX keeps its compiled bank (``_multistart_cache``): per instance, keyed
  on JAX's key (the counts and the identity of every model argument) plus
  the device, the parameters' dtype and the mesh, confirmed with ``is``
  and the arguments' fingerprints (:func:`~.graphs.cached`; a changed
  argument warns and misses). An entry holds the bank's functions and
  their graphs with their state and draw buffers: a repeated fit copies
  its start into those buffers and replays at once, and returns copies of
  them. ``init_jitter`` and every draw stay outside the graph, so changing
  them recaptures nothing. At most ``_EXEC_CACHE_SIZE`` (8) entries an
  instance, the least recently used dropped first with its graphs
  released (JAX's dict is unbounded; a graph pins its memory on the card).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree

from .. import _device
from ..dist import Delta, MultivariateNormal, Normal
from ..dist.transforms import biject_to
from ..parallel.mesh import gather_shards, run_shards, shard_plan, split
from . import handlers
from .graphs import GraphedStep, cached, fingerprint, keep
from .hmc import Draws
from .mcmc import _EXEC_CACHE_SIZE, _run_device
from .util import (
    GivenDraws,
    RecordingDraws,
    Unravel,
    bank_draws,
    draw_seam,
    get_model_trace,
    init_to_median,
    initialize_latents,
    latent_sites,
    log_density,
)


class SVIState(NamedTuple):
    """Optimizer + draw-stream carry of an SVI run (``rng_key`` is the
    run's draw seam)."""
    params: Dict[str, Any]
    opt_state: Any
    rng_key: Any


class SVIRunResult(NamedTuple):
    """Final state and per-step loss trace of :meth:`SVI.run`."""
    params: Dict[str, Any]
    state: SVIState
    losses: torch.Tensor


class SVIMultiStartResult(NamedTuple):
    """Result of :meth:`SVI.run_multistart`.

    ``params`` holds the winning start's parameters (drop-in for
    ``SVIRunResult.params``); the ``all_*`` fields keep the full bank for
    multi-modality diagnostics (a bimodal final-ELBO histogram means the
    guide found distinct optima).
    """

    params: Dict[str, Any]
    losses: torch.Tensor  # (num_steps,) winning start's loss trace
    best_idx: torch.Tensor  # ()
    final_elbos: torch.Tensor  # (num_starts,) multi-particle final -loss
    all_params: Dict[str, Any]  # (num_starts, ...) per-start final params
    all_losses: torch.Tensor  # (num_starts, num_steps)


# ---------------------------------------------------------------------------
# optimizers (optax's formulas)
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: an int32 step count and the moments."""
    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    """optax's ``adam(step_size, b1, b2, eps, eps_root)`` with numpyro's
    ``Adam(step_size=...)`` constructor shape, as a functional
    ``init`` / ``update`` over a dict of tensors."""

    def __init__(self, step_size: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0):
        self.step_size = step_size
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        """Zero moments and a zero count (on the parameters' device)."""
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update(self, grads, state: AdamState, params=None):
        """``(updates, state)``: ``-step_size * mu_hat / (sqrt(nu_hat +
        eps_root) + eps)`` with optax's moments and bias correction."""
        mu = {k: (1 - self.b1) * g + self.b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - self.b2) * (g**2) + self.b2 * state.nu[k] for k, g in grads.items()}
        count = state.count + 1
        steps = count.to(torch.float64)
        bc1, bc2 = 1 - self.b1**steps, 1 - self.b2**steps
        updates = {}
        for k in grads:
            mu_hat = mu[k] / bc1.to(mu[k].dtype)
            nu_hat = nu[k] / bc2.to(nu[k].dtype)
            updates[k] = (mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)) * (-self.step_size)
        return updates, AdamState(count, mu, nu)


class ClippedAdam(Adam):
    """Adam after optax's ``clip_by_global_norm(clip_norm)``."""

    def __init__(self, step_size: float = 1e-3, clip_norm: float = 10.0, **kwargs):
        super().__init__(step_size, **kwargs)
        self.clip_norm = clip_norm

    def update(self, grads, state: AdamState, params=None):
        """Clip the gradients to a global norm of ``clip_norm`` (optax's
        select: kept where the norm is below it), then Adam."""
        sq = 0
        for k in sorted(grads):  # the order of JAX's tree leaves
            sq = sq + torch.sum(grads[k] * grads[k])
        g_norm = torch.sqrt(sq)
        trigger = g_norm < self.clip_norm
        clipped = {k: torch.where(trigger, g, (g / g_norm.to(g.dtype)) * self.clip_norm) for k, g in grads.items()}
        return super().update(clipped, state, params)


def _as_optimizer(optim):
    """``optim`` itself: any object with ``init(params)`` and
    ``update(grads, state, params)`` (JAX's ``_as_optax``)."""
    if not (callable(getattr(optim, "init", None)) and callable(getattr(optim, "update", None))):
        raise TypeError(
            f"an SVI optimizer needs init(params) and update(grads, state, params); got {type(optim).__name__}"
        )
    return optim


def _apply_updates(params, updates):
    """optax's ``apply_updates``: ``params + updates`` in the parameters' dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


# ---------------------------------------------------------------------------
# the ELBO
# ---------------------------------------------------------------------------


class Trace_ELBO:
    """Single-sample (or multi-particle) reparameterized ELBO."""

    def __init__(self, num_particles: int = 1):
        self.num_particles = num_particles

    def loss(self, rng_key, params, model, guide, *args, **kwargs):
        """Monte-Carlo ELBO loss (negative evidence lower bound) estimate.

        ``rng_key``: the draw seam (or generator) the guide draws from;
        the particles draw one after another from it."""

        def particle():
            with handlers.trace() as guide_tr, handlers.seed(rng_key), handlers.substitute(params):
                guide(*args, **kwargs)
            log_q = None
            latent_values = {}
            for name, site in guide_tr.items():
                if site["type"] == "sample" and not site["is_observed"]:
                    term = torch.sum(handlers.weighted_log_prob(site))
                    log_q = term if log_q is None else log_q + term
                    latent_values[name] = site["value"]
            log_p, _ = log_density(model, args, kwargs, latent_values)
            return log_p.new_zeros(()) - log_p if log_q is None else log_q - log_p  # negative ELBO

        if self.num_particles == 1:
            return particle()
        return torch.mean(torch.stack([particle() for _ in range(self.num_particles)]))


# ---------------------------------------------------------------------------
# autoguides
# ---------------------------------------------------------------------------


def _setup_device(args, kwargs) -> torch.device:
    """The device of the guide's set-up trace: the innermost seed handler's
    generator or seam, else that of the model's tensor arguments, else the
    card."""
    for h in reversed(handlers._STACK):
        if isinstance(h, handlers.seed) and h.generator is not None:
            return torch.device(h.generator.device)
    return _run_device(None, args, kwargs)


class AutoGuide:
    """Base: discovers the model's latent structure on first trace."""

    def __init__(self, model, *, prefix: str = "auto", init_loc_fn=init_to_median):
        self.model = model
        self.prefix = prefix
        self.init_loc_fn = init_loc_fn
        self._ready = False

    def _setup(self, *args, **kwargs):
        if self._ready:
            return
        device = _setup_device(args, kwargs)
        tr = get_model_trace(self.model, torch.Generator(device=device).manual_seed(0), *args, **kwargs)
        sites = latent_sites(tr)
        if not sites:
            raise ValueError("model has no latent sites for the guide")
        self._transforms = {n: biject_to(s["fn"].support) for n, s in sites.items()}
        init_constrained = initialize_latents(tr, torch.Generator(device=device).manual_seed(0), self.init_loc_fn)
        init_unconstrained = {n: self._transforms[n].inv(v) for n, v in init_constrained.items()}
        self._unravel = Unravel(init_unconstrained)
        self._init_flat = self._unravel.ravel(init_unconstrained).detach()
        self._dim = self._init_flat.shape[0]
        self._ready = True

    def _emit_sites(self, z_flat):
        """Emit each model latent as a Delta site carrying -ldj."""
        uparams = self._unravel(z_flat)
        out = {}
        for name, u in uparams.items():
            t = self._transforms[name]
            c = t(u)
            ldj = torch.sum(t.log_abs_det_jacobian(u, c))
            # event_dim=c.ndim: the scalar -ldj enters the ELBO once per
            # site, not broadcast over every element of c
            out[name] = handlers.sample(name, Delta(c, log_density=-ldj, event_dim=c.ndim))
        return out

    def __call__(self, *args, **kwargs):
        raise NotImplementedError


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _softplus_inv(y):
    return torch.log(torch.expm1(y))


class AutoMultivariateNormal(AutoGuide):
    """Full-rank Gaussian posterior in unconstrained space (reference default:
    src/dynode/infer/inference.py:258).

    The raw ``*_scale_tril`` parameter is unconstrained; the guide maps it to
    a valid lower-Cholesky factor (softplus on the diagonal, strict lower
    triangle elsewhere) so gradient updates cannot break positive-definiteness.
    """

    init_scale: float = 0.1

    def _scale_tril_from_params(self, params):
        """raw param -> the lower-Cholesky factor the guide samples with
        (shared by ``__call__`` and :func:`chees_warm_start_from_guide`)."""
        raw = params[f"{self.prefix}_scale_tril"]
        return torch.tril(raw, -1) + torch.diag_embed(_softplus(torch.diagonal(raw, dim1=-2, dim2=-1)))

    def __call__(self, *args, **kwargs):
        self._setup(*args, **kwargs)
        flat = self._init_flat
        loc = handlers.param(f"{self.prefix}_loc", flat)
        diag = _softplus_inv(_device.scalar(self.init_scale, flat.dtype, flat.device))
        raw_init = torch.diag_embed(diag.expand(self._dim).clone())
        raw = handlers.param(f"{self.prefix}_scale_tril", raw_init)
        scale_tril = self._scale_tril_from_params({f"{self.prefix}_scale_tril": raw})
        z = handlers.sample("_auto_latent", MultivariateNormal(loc, scale_tril))
        return self._emit_sites(z)


class AutoNormal(AutoGuide):
    """Mean-field Gaussian posterior in unconstrained space."""

    def _scale_from_params(self, params):
        """raw param -> per-dim scales (shared by ``__call__`` and the
        SVI->MCMC handoff)."""
        return torch.exp(torch.as_tensor(params[f"{self.prefix}_log_scale"]))

    def __call__(self, *args, **kwargs):
        self._setup(*args, **kwargs)
        flat = self._init_flat
        loc = handlers.param(f"{self.prefix}_loc", flat)
        log_scale = handlers.param(
            f"{self.prefix}_log_scale",
            torch.full((self._dim,), math.log(0.1), dtype=flat.dtype, device=flat.device),
        )
        z = handlers.sample("_auto_latent", Normal(loc, self._scale_from_params({f"{self.prefix}_log_scale": log_scale})))
        return self._emit_sites(z)


class AutoDelta(AutoGuide):
    """MAP point estimate (a Delta guide in unconstrained space)."""

    def __call__(self, *args, **kwargs):
        self._setup(*args, **kwargs)
        loc = handlers.param(f"{self.prefix}_loc", self._init_flat)
        z = handlers.sample("_auto_latent", Delta(loc))
        return self._emit_sites(z)


#: alias for numpyro's AutoContinuous base (reference type annotations)
AutoContinuous = AutoGuide


# ---------------------------------------------------------------------------
# SVI driver
# ---------------------------------------------------------------------------


class SVI:
    """Stochastic variational inference driver (numpyro-style API:
    init/update/run)."""

    def __init__(self, model, guide, optim, loss: Optional[Trace_ELBO] = None):
        self.model = model
        self.guide = guide
        self.optim = _as_optimizer(optim)
        self.loss = loss or Trace_ELBO()
        #: the guide's draws in one call (kind, shape, dtype), from ``init``
        self._signature = None
        #: the :class:`~.graphs.GraphedStep` of the last run on a card (one
        #: a shard on a mesh): released when an ``SVI.run`` ended, kept in
        #: ``_multistart_cache`` by ``run_multistart``
        self.graphs: list = []
        #: kept multi-start banks, identity-keyed (:meth:`run_multistart`)
        self._multistart_cache: "OrderedDict[tuple, dict]" = OrderedDict()

    def _seam(self, rng_key, args, kwargs):
        """The run's draw seam: an int seeds a generator on the device of
        the model's tensor arguments, else the card."""
        return draw_seam(rng_key, _run_device(rng_key, args, kwargs))

    def init(self, rng_key, **model_kwargs) -> SVIState:
        """Trace the guide to discover params; build the optimizer state.

        The guide's draws in this trace come from ``rng_key``'s stream (as
        JAX draws them from its key); their kinds and shapes are kept as the
        guide's draw signature for :meth:`run_multistart`."""
        args = model_kwargs.pop("_args", ())
        seam = self._seam(rng_key, args, model_kwargs)
        recorder = RecordingDraws(seam)
        with handlers.trace() as tr, handlers.seed(recorder):
            self.guide(*args, **model_kwargs)
        self._signature = recorder.calls
        params = {name: site["value"].detach().clone() for name, site in tr.items() if site["type"] == "param"}
        opt_state = self.optim.init(params)
        return SVIState(params=params, opt_state=opt_state, rng_key=seam)

    def _graphed(self, device: torch.device) -> bool:
        """Whether a run on ``device`` replays its step from a CUDA graph:
        on a card, always (the eager loop stays the CPU path)."""
        return device.type == "cuda"

    def _step(self, params, opt_state, seam, args, kwargs):
        """One ELBO gradient step from ``params`` and ``opt_state``, the
        particles drawing from ``seam``: ``((params, opt_state), loss)``."""
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss_val = self.loss.loss(seam, leaves, self.model, self.guide, *args, **kwargs)
            grads = torch.autograd.grad(loss_val, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        updates, opt_state = self.optim.update(grads, opt_state, params)
        return (_apply_updates(params, updates), opt_state), loss_val.detach()

    def update(self, state: SVIState, *args, **kwargs):
        """One ELBO gradient step; the particle draws from the state's seam."""
        (params, opt_state), loss_val = self._step(state.params, state.opt_state, state.rng_key, args, kwargs)
        return SVIState(params, opt_state, state.rng_key), loss_val

    def _draw_signature(self, params, device, args, kwargs) -> list:
        """The guide's draws in one call (kind, shape, dtype), from a trace
        of the guide at ``params`` that draws from a throwaway generator on
        ``device``, not from the run's seam."""
        recorder = RecordingDraws(Draws(torch.Generator(device=device).manual_seed(0)))
        with handlers.block(), handlers.trace(), handlers.seed(recorder), handlers.substitute(params):
            self.guide(*args, **kwargs)
        return recorder.calls

    def run(
        self,
        rng_key,
        num_steps: int,
        init_state: Optional[SVIState] = None,
        progress_bar: bool = False,
        **model_kwargs,
    ) -> SVIRunResult:
        """Optimize for ``num_steps``; the losses stay on the device until
        read.

        On a card the step is captured into one CUDA graph at the first
        step and replayed at every step (the module docstring); its draws
        are taken from the state's seam first, in the guide's order (the
        signature that ``init`` recorded, or for an ``init_state`` from
        elsewhere one traced without drawing from the seam). On CPU
        tensors :meth:`update` runs in a host loop."""
        args = model_kwargs.pop("_args", ())
        state = init_state if init_state is not None else self.init(rng_key, _args=args, **dict(model_kwargs))
        n_steps = int(num_steps)
        if progress_bar:
            print(f"[dynode_tpu_torch.SVI] running {n_steps} steps...")
        device = next(iter(state.params.values())).device
        self.graphs = []
        if n_steps and self._graphed(device):
            signature = self._signature
            if signature is None:
                signature = self._draw_signature(state.params, device, args, model_kwargs)

            def step(carry, draws):
                return self._step(*carry, GivenDraws(draws, device), args, model_kwargs)

            carry, losses = self._replay({0: GraphedStep(step)}, None, (state.params, state.opt_state), state.rng_key,
                                         signature, None, n_steps, kept=False)
            state = SVIState(*carry, state.rng_key)
        else:
            losses = []
            for _ in range(n_steps):
                state, loss_val = self.update(state, *args, **model_kwargs)
                losses.append(loss_val)
            losses = torch.stack(losses) if losses else torch.zeros(0)
        if progress_bar and len(losses):
            print(f"[dynode_tpu_torch.SVI] final loss {float(losses[-1]):.4f}")
        return SVIRunResult(params=state.params, state=state, losses=losses)

    def get_params(self, state: SVIState):
        """Parameter values from an :class:`SVIState`."""
        return state.params

    def _bank_fns(self, device, home, args, kwargs, final_particles: int):
        """The bank's step ``((params, opt_state), draws) -> ((params,
        opt_state), losses)`` and final ELBO ``(params, draws) -> elbos``,
        one start's mapped over the starts with ``torch.func.vmap``, with
        the model's tensors on ``device`` (copied there from ``home``)."""
        model, guide, loss = self.model, self.guide, self.loss
        if device == home:
            a, kw = args, kwargs
        else:
            a, kw = pytree.tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, (args, kwargs))

        def one_step(state, noise):
            params, opt_state = state

            def neg_elbo(p):
                return loss.loss(GivenDraws(noise, device), p, model, guide, *a, **kw)

            grads, loss_val = torch.func.grad_and_value(neg_elbo)(params)
            updates, opt_state = self.optim.update(grads, opt_state, params)
            return (_apply_updates(params, updates), opt_state), loss_val

        def final_elbo(params, noise):
            draws = GivenDraws(noise, device)
            losses = [loss.loss(draws, params, model, guide, *a, **kw) for _ in range(final_particles)]
            return -torch.mean(torch.stack(losses))

        return torch.func.vmap(one_step), torch.func.vmap(final_elbo)

    def _replay(self, graphs: dict, plan, state, seam, signature, n: Optional[int], n_steps: int, kept: bool):
        """``n_steps`` steps replayed on the card: one :class:`~.graphs.GraphedStep`
        ``graphs[s]`` a shard ``s`` of ``plan`` (``graphs[0]`` without a
        mesh), started from ``state`` in its buffers, captured on the
        shard's card at its first step (unless kept from an earlier run)
        and replayed at every step; released at the end unless ``kept``.
        Each step's draws of ``signature`` are made for the whole bank of
        ``n`` (one start: None) on the seam's device and split to the
        shards outside the graphs; each shard's state stays in its graph's
        buffers, and the shards' states and losses are gathered once, at
        the end. Returns ``(state, losses)`` on the seam's device, the
        steps on the losses' last axis; a kept graph's state as a copy,
        which its next run does not overwrite."""
        def cut(tree, s):
            if plan is None:
                return tree
            return pytree.tree_map(lambda x: split(x, plan, s) if isinstance(x, torch.Tensor) else x, tree)

        def each(fn):
            return {0: fn(0)} if plan is None else run_shards(plan, fn)

        self.graphs = list(graphs.values())
        per_step = getattr(self.loss, "num_particles", 1)
        losses = {}
        try:
            each(lambda s: graphs[s].start(cut(state, s)))
            for i in range(n_steps):
                draws = bank_draws(seam, signature, n, per_step)
                for s, loss_val in each(lambda s: graphs[s](cut(draws, s))).items():
                    if s not in losses:
                        losses[s] = loss_val.new_empty(tuple(loss_val.shape) + (n_steps,))
                    losses[s][..., i].copy_(loss_val)
        finally:
            if not kept:
                for graph in graphs.values():
                    graph.release()
        if plan is None:
            state = graphs[0].state
            if kept:
                state = pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)
            return state, losses[0]
        whole = gather_shards(plan, {s: (graphs[s].state, losses[s]) for s in graphs}, dim=0)
        return pytree.tree_map(lambda x: x.to(seam.device), whole)

    def run_multistart(
        self,
        rng_key,
        num_steps: int,
        num_starts: int,
        *,
        init_jitter: float = 1.0,
        final_particles: int = 16,
        mesh=None,
        batch_axis: str = "start",
        progress_bar: bool = False,
        **model_kwargs,
    ) -> SVIMultiStartResult:
        """Run ``num_starts`` independent SVI optimizations as one bank.

        Per-start diversity: every ``*_loc`` parameter is jittered by
        ``init_jitter``-scaled Gaussian noise in unconstrained space
        (start 0 keeps the un-jittered init strategy); non-loc parameters
        are shared at their init values. Winner selection re-evaluates
        each start's final ELBO with ``final_particles`` fresh particles,
        and a non-finite ELBO never wins.

        One start's steps and its final ELBO are mapped over the starts
        with ``torch.func.vmap``. The draws of the bank come from the seam
        in this order: the guide's draws of :meth:`init`; for each
        ``*_loc`` parameter its ``(num_starts, ...)`` jitter; for each step
        the guide's draws of each particle, ``(num_starts, ...)`` each; for
        each final particle the same. A seam that gives each start its own
        stream (a replay of JAX's draws) so gives start i JAX's order.

        ``mesh=`` splits the starts over its axis ``batch_axis``: the
        bank's draws are made for the whole bank first, on the seam's
        device, then each device steps its shard of the starts (the
        model's tensor arguments copied to it; tensors the model holds
        itself must follow the device of its arguments on a mesh of
        several cards) and the shards' parameters, optimizer
        states and losses come back concatenated on the seam's device. So a
        split bank takes the unsplit bank's draws. ``num_starts`` must
        divide over the axis (``ValueError`` before anything runs).

        On a card the bank's step is captured into one CUDA graph at the
        first step (one a shard, on the shard's card, with ``mesh=``) and
        replayed at every step; the draws, the split and the gather stay
        outside the graphs (:meth:`_replay`). The final ELBO runs eagerly,
        once a run.

        Repeat calls with the same counts and the same model argument
        OBJECTS reuse the kept bank, its graphs included (the module
        docstring): fresh seeds, re-inits and another ``init_jitter``
        capture nothing. A different obs object is a deliberate miss.
        """
        args = model_kwargs.pop("_args", ())
        n = int(num_starts)
        plan = None if mesh is None else shard_plan(mesh, batch_axis, n, "SVI start bank")
        base = self.init(rng_key, _args=args, **model_kwargs)
        seam = base.rng_key

        params0 = {}
        for name, v in base.params.items():
            if name.endswith("_loc"):
                noise = seam.normal((n,) + tuple(v.shape), v.dtype, seam.device)
                jittered = v + init_jitter * noise
                jittered[0] = v  # start 0 keeps the un-jittered init
                params0[name] = jittered
            else:
                params0[name] = v.expand((n,) + tuple(v.shape)).clone()

        places = {0: seam.device} if plan is None else {s: plan.place(s) for s in plan.local}

        leaves, treedef = pytree.tree_flatten((args, dict(sorted(model_kwargs.items()))))
        cache_key = (
            int(num_steps),
            n,
            int(final_particles),
            treedef,
            tuple(id(x) for x in leaves),
            str(seam.device),
            next(iter(base.params.values())).dtype,
            None if mesh is None else (mesh.key(), batch_axis),
        )
        fps = [fingerprint(x) for x in leaves]
        entry = cached(self._multistart_cache, cache_key, leaves, fps, "run_multistart")
        if entry is None:
            fns = {s: self._bank_fns(dev, seam.device, args, model_kwargs, final_particles) for s, dev in places.items()}
            entry = keep(self._multistart_cache, cache_key, {"objects": leaves, "fps": fps, "fns": fns}, _release_bank,
                         _EXEC_CACHE_SIZE)
        fns = entry["fns"]
        if plan is None:
            bank_step, bank_elbo = fns[0]
        else:
            def on_shards(which):
                def run(*trees):
                    def shard(s):
                        cut = pytree.tree_map(lambda x: split(x, plan, s) if isinstance(x, torch.Tensor) else x, trees)
                        return fns[s][which](*cut)

                    whole = gather_shards(plan, run_shards(plan, shard), dim=0)
                    return pytree.tree_map(lambda x: x.to(seam.device), whole)

                return run

            bank_step, bank_elbo = on_shards(0), on_shards(1)

        if progress_bar:
            print(f"[dynode_tpu_torch.SVI] running {n} starts x {num_steps} steps...")
        n_steps = int(num_steps)
        state = (params0, torch.func.vmap(self.optim.init)(params0))
        per_step = getattr(self.loss, "num_particles", 1)
        self.graphs = []
        if n_steps and all(self._graphed(dev) for dev in places.values()):
            if "graphs" not in entry:
                entry["graphs"] = {s: GraphedStep(f[0]) for s, f in fns.items()}
            state, losses_all = self._replay(entry["graphs"], plan, state, seam, self._signature, n, n_steps,
                                             kept=True)
        else:
            losses = []
            for _ in range(n_steps):
                noise = bank_draws(seam, self._signature, n, per_step)
                state, loss_val = bank_step(state, noise)
                state = pytree.tree_map(lambda x: x.detach(), state)
                losses.append(loss_val.detach())
            losses_all = torch.stack(losses, dim=1) if losses else torch.zeros((n, 0))
        params = state[0]
        noise = bank_draws(seam, self._signature, n, final_particles * per_step)
        with torch.no_grad():
            elbos = bank_elbo(params, noise)
        ranked = torch.where(torch.isfinite(elbos), elbos, torch.full_like(elbos, -math.inf))
        best = torch.argmax(ranked)
        if progress_bar:
            print(f"[dynode_tpu_torch.SVI] best start {int(best)}: ELBO {float(elbos[best]):.4f}")
        return SVIMultiStartResult(
            params={k: v[best] for k, v in params.items()},
            losses=losses_all[best],
            best_idx=best,
            final_elbos=elbos,
            all_params=params,
            all_losses=losses_all,
        )


def _release_bank(entry: dict) -> None:
    """Release the graphs of a dropped ``_multistart_cache`` entry and
    their state buffers."""
    for graph in entry.get("graphs", {}).values():
        graph.release()
        graph.state = None


# ---------------------------------------------------------------------------
# SVI-initialized MCMC (Pathfinder-style warm starts)
# ---------------------------------------------------------------------------


def chees_warm_start_from_guide(
    guide: AutoGuide,
    params: Dict[str, torch.Tensor],
    num_chains: int,
    rng_key,
    *,
    step_size: Optional[float] = None,
    trajectory_length: Optional[float] = None,
    init_jitter: float = 0.0,
):
    """An ``MCMC.run(warm_start=)`` value for a ChEES kernel from a fitted
    autoguide: chain positions drawn from the guide, the guide covariance
    as the (inverse) mass matrix, and the step size of the D^(-1/4)
    optimal-scaling rule (``min(1.65 D^(-1/4), 1.9)``; times
    ``init_jitter`` for :class:`AutoDelta`, which carries no covariance).
    ``MCMC.run`` re-evaluates the potentials and gradients itself. The
    draws come from ``rng_key`` (an int, a generator or a draw seam, on
    the parameters' device): the positions' normals, then the jitter's.
    """
    from .chees import ChEESBankState

    if not guide._ready:
        raise ValueError(
            "guide has no latent structure yet: fit it first (SVI.run / run_multistart traces it)"
        )
    loc = torch.as_tensor(params[f"{guide.prefix}_loc"])
    dtype, device = loc.dtype, loc.device
    d = loc.shape[0]
    seam = draw_seam(rng_key, device)
    eps_n = seam.normal((num_chains, d), dtype, device)
    if isinstance(guide, AutoMultivariateNormal):
        scale_tril = guide._scale_tril_from_params(params)
        z = loc[None, :] + eps_n @ scale_tril.T
        inv_mass = scale_tril @ scale_tril.T  # guide covariance, dense
        chol_inv = scale_tril  # chol(inv_mass): exactly hmc.sample_momentum's
    elif isinstance(guide, AutoNormal):
        scale = guide._scale_from_params(params)
        z = loc[None, :] + scale[None, :] * eps_n
        inv_mass = scale**2  # diag
        chol_inv = scale
    elif isinstance(guide, AutoDelta):
        if init_jitter <= 0.0:
            raise ValueError(
                "AutoDelta is a point guide: pass init_jitter > 0 so the "
                "bank's chains do not all start at the identical MAP point"
            )
        z = loc[None, :].expand(num_chains, d)
        inv_mass = torch.ones((d,), dtype=dtype, device=device)  # no covariance information
        chol_inv = torch.ones((d,), dtype=dtype, device=device)
    else:
        raise TypeError(
            f"unsupported guide type {type(guide).__name__}: expected "
            "AutoMultivariateNormal, AutoNormal, or AutoDelta"
        )
    if init_jitter > 0.0:
        z = z + init_jitter * seam.normal(tuple(z.shape), dtype, device)
    if step_size is not None:
        eps_val = step_size
    else:
        eps_val = min(1.65 * d**-0.25, 1.9)
        if isinstance(guide, AutoDelta):
            eps_val *= init_jitter
    eps = torch.as_tensor(eps_val, dtype=dtype, device=device)
    traj = torch.as_tensor(trajectory_length if trajectory_length is not None else math.pi / 2.0,
                           dtype=dtype, device=device)
    traj = torch.maximum(traj, eps)
    zeros = torch.zeros((num_chains,), dtype=dtype, device=device)
    state = ChEESBankState(
        z=z.to(dtype).detach(),
        # placeholders: MCMC.run's warm-start path re-evaluates both under
        # the run's own (centered) potential before the first transition
        potential=zeros,
        grad=torch.zeros((num_chains, d), dtype=dtype, device=device),
        energy=zeros,
        accept_prob=zeros,
        num_steps=torch.zeros((num_chains,), dtype=torch.int32, device=device),
        diverging=torch.zeros((num_chains,), dtype=torch.bool, device=device),
        iter_idx=0,
    )
    return state, (inv_mass.detach(), chol_inv.detach(), eps, traj)


__all__ = [
    "SVI",
    "SVIState",
    "SVIRunResult",
    "SVIMultiStartResult",
    "Trace_ELBO",
    "Adam",
    "AdamState",
    "ClippedAdam",
    "AutoGuide",
    "AutoContinuous",
    "AutoNormal",
    "AutoMultivariateNormal",
    "AutoDelta",
    "chees_warm_start_from_guide",
]
