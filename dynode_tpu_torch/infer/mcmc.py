"""NUTS kernel + MCMC runner over a bank of chains.

Port of ``dynode_tpu/infer/mcmc.py``: ``MCMC(NUTS(model, dense_mass=True,
max_tree_depth=..., init_strategy=...), num_warmup, num_samples,
num_chains)`` then ``.run(rng_key, **model_kwargs)`` /
``.get_samples(group_by_chain)``.

Where the JAX runner vmaps a per-chain program and compiles the whole run,
here the chains are the leading axis of every tensor (:mod:`.hmc` is
written for a bank) and a Python loop drives the transitions on the device
of the model's tensors. One ``torch.Generator`` per run, on that device,
feeds every draw (:class:`~.hmc.Draws`); JAX's split-key trees have no
counterpart, so the draws differ from JAX's for the same seed. The model's
trace and the example init that lays out the flat vector draw from a
generator of their own, seeded by one draw of the run's (JAX's
``key_struct``): a run served from the cache below skips them and takes
that one draw all the same, so its inits and transitions draw what a run
that traces draws. (A prior's gamma or Poisson draws go to the generator
itself, and on the CPU their count depends on the values, so the setup's
draws cannot be recorded and retaken one by one.)

The potential and its gradient for the bank:

- ``batched_potential_fn`` (``(C, D)`` -> ``(C,)``) is differentiated with
  one ``torch.autograd.grad`` of the sum (the chains are independent, so
  this is JAX's vjp with ones). On a CUDA bank it is captured once into a
  ``torch.cuda.CUDAGraph`` (:class:`GraphedPotential`) and every later call
  replays it. A capture that meets a host sync or a host copy raises
  :class:`GraphCaptureError`; the runner never falls back to the eager call.
- Otherwise the flat potential of the model is mapped over the chains with
  ``torch.func.vmap(torch.func.grad_and_value(...))`` (JAX's
  ``jax.vmap(jax.value_and_grad(...))``). On a CUDA bank of a vectorized
  run that map is captured into a :class:`GraphedPotential` at its first
  call, one graph per width and device (one per shard device of a mesh),
  and replayed at every later call, as JAX jits it. A capture that fails
  raises :class:`GraphCaptureError`, as for a batched potential. The
  sequential method and CPU tensors run the map eagerly.

Both are kept across runs in ``_EXEC_CACHE``, as JAX keeps its programs
(its ``_exec_cache_entry``; here :func:`~.graphs.cached` and
:func:`~.graphs.keep`): at most ``_EXEC_CACHE_SIZE`` (8) entries, the
least recently used dropped first, and a dropped entry releases its graphs
(:func:`clear_exec_cache` drops them all). A run's entry is keyed on JAX's
key (the model's identity, the kernel's configuration, the run's shape, the
mesh, the arguments' tree and the identity of every leaf) plus the default
dtype and the bank's device, and holds the trace, the transforms, the
centres, the unravel, the flat potential and the generic potential's graphs
with the argument copies a shard makes for its card: a repeated run with
the same model and argument objects traces and captures nothing. A tensor
leaf is fingerprinted by its shape, dtype, device and version counter (a
numpy leaf by JAX's strided probe), so an argument changed in place warns
and misses. The graph of a ``batched_potential_fn`` reads no model
argument: it is an entry of its own in the same cache, keyed on the
function, the bank's shape, dtype and device and the mesh
(:func:`graphed_potential`), so a run with another model or other
arguments shares it.
"""

import inspect
import math
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import _device
from .._graphs import EXEC_CACHE_SIZE
from ..parallel.mesh import (
    check_mesh,
    create_mesh,
    default_device_count,
    gather_shards,
    run_shards,
    shard_plan,
    split,
)
from . import handlers
from .chees import ChEES, make_chees_parts
from .graphs import GraphCaptureError, cached, capture, fingerprint, keep
from .hmc import (
    Draws,
    build_warmup_schedule,
    chol_of_inv,
    da_init,
    da_update,
    find_reasonable_step_size,
    init_state,
    nuts_transition,
    welford_covariance,
    welford_init,
    welford_update,
)
from .util import (
    flatten_potential,
    get_model_trace,
    get_transforms,
    init_to_median,
    initialize_latents,
    latent_sites,
    make_potential_fn,
    observed_logprob_centers,
    unconstrain_sample,
)

# ---------------------------------------------------------------------------
# the bank's potential and gradient
# ---------------------------------------------------------------------------


def batched_pot_and_grad(batched_pot: Callable) -> Callable:
    """``zb -> (pe, grad)`` of a natively chain-batched potential: one
    forward and one ``autograd.grad`` of the sum (chains are independent,
    so each chain gets its own gradient)."""

    def pot_and_grad(zb):
        with torch.enable_grad():
            z = zb.detach().requires_grad_()
            pe = batched_pot(z)
            (grad,) = torch.autograd.grad(pe.sum(), z)
        return pe.detach(), grad

    return pot_and_grad


def generic_pot_and_grad(flat_potential: Callable, graph_device: Optional[torch.device] = None) -> Callable:
    """``zb -> (pe, grad)`` of a per-chain flat potential, mapped over the
    chains by ``torch.func.vmap`` of ``torch.func.grad_and_value``.

    With a CUDA ``graph_device`` the map is returned as a
    :class:`GraphedPotential`: captured at its first call on that device,
    replayed at every later one. Otherwise it runs eagerly. A wrapper of
    this function that keeps the graph visible sets ``__wrapped__`` on
    what it returns (:func:`inspect.unwrap` finds it)."""
    mapped = torch.func.vmap(torch.func.grad_and_value(flat_potential))

    def pot_and_grad(zb):
        try:
            grad, pe = mapped(zb.detach())
        except RuntimeError as err:
            if "data-dependent control flow" not in str(err):
                raise
            raise NotImplementedError(
                "the model's potential reads a tensor on the host, which "
                "cannot run under the chain vmap of the generic potential "
                "(an adaptive solve does); pass the kernel a natively "
                "chain-batched batched_potential_fn=, or use "
                "SolverParams(constant_step_size=...)"
            ) from err
        return pe.detach(), grad.detach()

    if graph_device is not None and torch.device(graph_device).type == "cuda":
        return GraphedPotential(pot_and_grad)
    return pot_and_grad


def split_pot_and_grad(plan, parts: dict) -> Callable:
    """``zb -> (pe, grad)`` of a bank split over a mesh: shard ``s`` of the
    chains goes to ``parts[s]`` on its device, and the shards' potentials
    and gradients come back concatenated on ``zb``'s device, where the
    sampler's state and its bank-wide reductions stay. The chains are
    independent, so the split does the unsplit bank's arithmetic.

    On a mesh of several cards each shard's potential runs on its card:
    the model's tensor arguments are copied there for the generic
    potential, while a ``batched_potential_fn`` must itself compute on the
    device of the positions it is given."""

    def pot_and_grad(zb):
        outs = run_shards(plan, lambda s: parts[s](split(zb, plan, s)))
        pe, grad = gather_shards(plan, outs, dim=0)
        return pe.to(zb.device), grad.to(zb.device)

    return pot_and_grad


class GraphedPotential:
    """``pot_and_grad`` of a ``(C, D)`` bank captured into one CUDA graph.

    The first call copies its input into a static ``(C, D)`` buffer, runs
    ``pot_and_grad`` once on a side stream (warm-up), then captures it
    with host syncs raising (:func:`.graphs.capture`); every call then copies
    its input into the buffer, replays the graph and returns clones of the
    static outputs. The replay runs the captured kernels in the captured
    order, so it equals the eager call bit for bit. The device constants
    that the warm-up copies (:func:`~dynode_tpu_torch._device.constant`)
    live in :attr:`constants`, as long as the graph that reads them.
    """

    def __init__(self, pot_and_grad: Callable):
        self.pot_and_grad = pot_and_grad
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.constants: dict = {}
        self.replays = self.captures = 0
        #: the device of the last capture, and the walls of its warm-up and capture
        self.device: Optional[torch.device] = None
        self.warmup_s = self.capture_s = None

    def capture(self, zb: torch.Tensor):
        """Warm up on a side stream and capture the graph at ``zb``.

        Returns the warm-up's ``(pe, grad)``: the eager call's result, which
        every replay equals. :attr:`warmup_s` and :attr:`capture_s` hold the
        walls of the warm-up and of the capture (host clock, each ended by
        a synchronize of the card)."""
        self.device = zb.device
        self.static_z = zb.detach().clone()

        def call():
            return self.pot_and_grad(self.static_z)

        self.graph, warm, (self.static_pe, self.static_grad), self.warmup_s, self.capture_s = capture(
            self.device, self.constants, call, call, "the potential")
        self.captures += 1
        return warm

    def __call__(self, zb: torch.Tensor):
        if self.graph is None:
            self.capture(zb)
        self.static_z.copy_(zb)
        self.graph.replay()
        self.replays += 1
        return self.static_pe.clone(), self.static_grad.clone()

    def release(self) -> None:
        """Free the graph, its static buffers and its kept constants (the
        replay and capture counts stay); a later call captures anew."""
        self.graph = None
        self.static_z = self.static_pe = self.static_grad = None
        self.constants = {}


_EXEC_CACHE: "OrderedDict[tuple, dict]" = OrderedDict()
_EXEC_CACHE_SIZE = EXEC_CACHE_SIZE


def _release_entry(entry: dict) -> None:
    """Release every graph an entry of ``_EXEC_CACHE`` holds."""
    graphs = [entry["graph"]] if "graph" in entry else [inspect.unwrap(p) for p in entry["parts"].values()]
    for graph in graphs:
        if isinstance(graph, GraphedPotential):
            graph.release()


def clear_exec_cache() -> None:
    """Drop every entry of ``_EXEC_CACHE``, releasing its graphs (JAX's
    ``_EXEC_CACHE.clear()``). Their memory goes back to the caching
    allocator, which ``torch.cuda.empty_cache()`` returns to the card."""
    while _EXEC_CACHE:
        _release_entry(_EXEC_CACHE.popitem()[1])


def graphed_potential(batched_pot: Callable, num_chains: int, D: int, dtype, device, mesh=None) -> GraphedPotential:
    """The cached :class:`GraphedPotential` of ``batched_pot`` for a bank
    of ``num_chains`` x ``D`` in ``dtype`` on ``device``: an entry of
    ``_EXEC_CACHE`` that holds ``batched_pot`` to pin its identity.

    ``mesh``: the key of the mesh and axis a split bank runs on (None for
    a whole bank), part of the cache key as in JAX's exec cache: a shard's
    graph is captured once per device and shard width of that mesh, and
    the shards of one device share it (each call replays and clones)."""
    key = ("batched", id(batched_pot), int(num_chains), int(D), dtype, str(device), mesh)
    entry = cached(_EXEC_CACHE, key, [batched_pot], [], "graphed_potential")
    if entry is None:
        entry = keep(_EXEC_CACHE, key, {"objects": [batched_pot], "fps": [],
                                        "graph": GraphedPotential(batched_pot_and_grad(batched_pot))},
                     _release_entry, _EXEC_CACHE_SIZE)
    return entry["graph"]


def _kernel_token(kern) -> tuple:
    """Hashable fingerprint of everything a kernel bakes into its programs."""
    common = (
        type(kern).__name__,
        kern.dense_mass,
        kern.target_accept_prob,
        id(kern.init_strategy),
        kern.step_size,
        kern.adapt_step_size,
        kern.adapt_mass_matrix,
        kern.center_potential,
        id(kern.batched_potential_fn) if kern.batched_potential_fn is not None else None,
    )
    if isinstance(kern, ChEES):
        return common + (kern.trajectory_length, kern.max_num_steps, kern.adapt_lr)
    return common + (kern.max_tree_depth,)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


class NUTS:
    """No-U-Turn sampler kernel configuration for a model callable.

    ``batched_potential_fn``: optional natively chain-batched potential,
    ``fn(z_batch) -> pe``, mapping a ``(chains, D)`` block of unconstrained
    flat latents (in :func:`~.util.flatten_potential`'s layout) to
    ``(chains,)`` potential energies, with exactly the semantics of the
    model-derived potential (negative log-joint including Jacobian
    corrections; centering is its own business). The ``model`` is still
    used for tracing, site naming, transforms and inits.
    ``center_potential`` subtracts fixed per-datapoint reference log-probs
    from observed sites before summing (a constant shift of the potential).
    """

    def __init__(
        self,
        model: Callable,
        *,
        dense_mass: bool = True,
        max_tree_depth: int = 10,
        target_accept_prob: float = 0.8,
        init_strategy: Callable = init_to_median,
        step_size: Optional[float] = None,
        adapt_step_size: bool = True,
        adapt_mass_matrix: bool = True,
        center_potential: bool = True,
        batched_potential_fn: Optional[Callable] = None,
        **_ignored,
    ):
        self.model = model
        self.dense_mass = dense_mass
        self.max_tree_depth = max_tree_depth
        self.target_accept_prob = target_accept_prob
        self.init_strategy = init_strategy
        self.step_size = step_size
        self.adapt_step_size = adapt_step_size
        self.adapt_mass_matrix = adapt_mass_matrix
        self.batched_potential_fn = batched_potential_fn
        self.center_potential = center_potential


def _run_device(rng_key, args, kwargs) -> torch.device:
    """The bank's device: the generator's (or a draw seam's), else the one
    device of the tensors among the model's arguments, else the default
    device (the card)."""
    if isinstance(rng_key, torch.Generator) or hasattr(rng_key, "normal"):
        return torch.device(rng_key.device)
    tensors = [x for x in pytree.tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)]
    if tensors:
        return _device.common_device(*tensors)
    return _device.default_device()


class MCMC:
    """Run a NUTS or ChEES kernel over a bank of chains."""

    def __init__(
        self,
        kernel: NUTS,
        *,
        num_warmup: int,
        num_samples: int,
        num_chains: int = 1,
        chain_method: str = "vectorized",
        progress_bar: bool = False,
        mesh=None,
        chain_axis: str = "chain",
        steps_per_call: Optional[int] = None,
        rescue_stuck_chains: bool = True,
    ):
        if chain_method not in ("vectorized", "sequential", "parallel"):
            raise ValueError(
                f"unknown chain_method {chain_method!r}: expected "
                "'vectorized' (one vmapped bank, the TPU-native default), "
                "'parallel' (mesh-sharded vectorized bank), or "
                "'sequential' (host loop, one chain at a time)"
            )
        if mesh is not None:
            check_mesh(mesh)
        self.kernel = kernel
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.chain_method = chain_method
        self.progress_bar = progress_bar
        #: a :class:`~dynode_tpu_torch.parallel.Mesh` whose ``chain_axis``
        #: splits the potential and its gradient (:func:`split_pot_and_grad`)
        self.mesh = mesh
        self.chain_axis = chain_axis
        #: JAX's transitions per compiled call; accepted for its API and
        #: errors only, since the port runs eagerly and syncs the host at
        #: every NUTS leaf anyway. The vectorized NUTS bank re-seats stuck
        #: chains after warmup whatever it is (:meth:`_rescue_stuck_chains`)
        self.steps_per_call = steps_per_call
        self.rescue_stuck_chains = rescue_stuck_chains
        self._n_rescued = 0
        self._samples: Optional[Dict[str, torch.Tensor]] = None
        self._extra_fields: Optional[Dict[str, torch.Tensor]] = None
        self._transforms = None
        self._unravel = None
        self._model_args: tuple = ()
        self._model_kwargs: dict = {}
        self.last_state = None
        self._tuned = None
        #: per-site max sub-bank z-scores from ``run(consensus_check=k)``
        self.consensus_report: Optional[Dict[str, float]] = None
        #: the :class:`GraphedPotential` of the last run, when it had one
        #: (the first shard's on a mesh; :attr:`graphs` holds every shard's)
        self.graph: Optional[GraphedPotential] = None
        self.graphs: list = []

    # -- NUTS over the bank --------------------------------------------------

    def _nuts_parts(self, pot_and_grad, D, dtype, device, draws):
        kern = self.kernel
        max_depth = kern.max_tree_depth
        target = kern.target_accept_prob
        dense = kern.dense_mass

        def init_chain(z0s):
            C = z0s.shape[0]
            state = init_state(pot_and_grad, z0s)
            if dense:
                inv_mass = torch.eye(D, dtype=dtype, device=device).expand(C, D, D).clone()
            else:
                inv_mass = torch.ones((C, D), dtype=dtype, device=device)
            chol = chol_of_inv(inv_mass, dense)
            if kern.step_size is not None:
                eps0 = torch.full((C,), kern.step_size, dtype=dtype, device=device)
            else:
                eps0 = find_reasonable_step_size(pot_and_grad, inv_mass, chol, state, draws)
            wf = welford_init(D, dense, dtype, batch=(C,), device=device)
            return [state, da_init(eps0), wf, inv_mass, chol]

        def warmup_step(carry, slow: bool, end: bool):
            state, da, wf, inv_mass, chol = carry
            eps = torch.exp(da.log_eps) if kern.adapt_step_size else torch.exp(da.log_eps_avg)
            state = nuts_transition(pot_and_grad, inv_mass, chol, eps, max_depth, state, draws)
            if kern.adapt_step_size:
                da = da_update(da, state.accept_prob, target=target)
            if kern.adapt_mass_matrix:
                if slow:
                    wf = welford_update(wf, state.z)
                if end:
                    inv_mass = welford_covariance(wf)
                    chol = chol_of_inv(inv_mass, dense)
                    wf = welford_init(D, dense, dtype, batch=(state.z.shape[0],), device=device)
                    if kern.adapt_step_size:
                        # re-search a reasonable step size under the NEW
                        # metric (a collapsed eps otherwise death-spirals)
                        da = da_init(find_reasonable_step_size(pot_and_grad, inv_mass, chol, state, draws))
            return [state, da, wf, inv_mass, chol]

        def sample_step(state, inv_mass, chol, eps):
            state = nuts_transition(pot_and_grad, inv_mass, chol, eps, max_depth, state, draws)
            out = {
                "z": state.z,
                "potential_energy": state.potential,
                "energy": state.energy,
                "accept_prob": state.accept_prob,
                "num_steps": state.num_steps,
                "diverging": state.diverging,
            }
            return state, out

        return init_chain, warmup_step, sample_step

    def _warm(self, carry, warmup_step):
        """Every warmup transition, on ``build_warmup_schedule``'s windows."""
        for slow, end in zip(*build_warmup_schedule(self.num_warmup)):
            carry = warmup_step(carry, bool(slow), bool(end))
        return carry

    def _sample(self, state, sample_step, tuned):
        """``num_samples`` transitions; fields stacked on axis 1 (chains lead)."""
        outs = []
        for _ in range(self.num_samples):
            state, out = sample_step(state, *tuned)
            outs.append(out)
        collected = {k: torch.stack([o[k] for o in outs], dim=1) for k in outs[0]} if outs else {}
        return state, collected

    def _run_nuts(self, pot_and_grad, D, dtype, device, z0s, draws, rescue: bool):
        init_chain, warmup_step, sample_step = self._nuts_parts(pot_and_grad, D, dtype, device, draws)
        carry = init_chain(z0s)
        if self.num_warmup > 0:
            carry = self._warm(carry, warmup_step)
        state, da, _, inv_mass, chol = carry
        # exp(log_eps_avg) is right whether or not step-size adaptation ran
        eps_final = torch.exp(da.log_eps_avg)
        if rescue:
            state, inv_mass, chol, eps_final = self._rescue_stuck_chains(state, inv_mass, chol, eps_final)
        state, collected = self._sample(state, sample_step, (inv_mass, chol, eps_final))
        collected["step_size"] = eps_final
        return state, (inv_mass, chol, eps_final), collected

    def _rescue_stuck_chains(self, state, inv_mass, chol, eps_final):
        """Re-seat born-dead chains on healthy tuned parameters.

        A chain whose step size left warmup more than 50x below the
        cross-chain median, or whose potential is not finite, takes a
        healthy donor's position, potential, gradient, energy and mass
        matrix (donors cycle through the healthy chains in order) and the
        healthy chains' median step size. The vectorized bank only (JAX
        rescues in its chunked runs only); disable with
        ``MCMC(rescue_stuck_chains=False)``.
        """
        if not self.rescue_stuck_chains or self.num_chains < 4:
            return state, inv_mass, chol, eps_final
        eps = eps_final.detach().cpu().double().numpy()
        pot = state.potential.detach().cpu().double().numpy()
        log_eps = np.log(np.maximum(eps, 1e-300))
        med = np.median(log_eps)
        bad = (log_eps < med - np.log(50.0)) | ~np.isfinite(pot)
        if not bad.any():
            return state, inv_mass, chol, eps_final
        healthy = np.where(~bad)[0]
        if healthy.size == 0:
            return state, inv_mass, chol, eps_final
        n_bad = int(bad.sum())
        donors = healthy[np.arange(n_bad) % healthy.size]
        dev = eps_final.device
        bad_idx = torch.as_tensor(np.where(bad)[0], device=dev)
        donor_idx = torch.as_tensor(donors, device=dev)

        def reseat(arr):
            arr = arr.clone()
            arr[bad_idx] = arr[donor_idx]
            return arr

        state = state._replace(
            z=reseat(state.z),
            potential=reseat(state.potential),
            grad=reseat(state.grad),
            energy=reseat(state.energy),
        )
        inv_mass = reseat(inv_mass)
        chol = reseat(chol)
        eps_final = eps_final.clone()
        eps_final[bad_idx] = float(np.exp(np.median(log_eps[healthy])))
        if self.progress_bar:
            print(f"[dynode_tpu_torch.MCMC] re-seated {n_bad} stuck chain(s) on healthy tuned parameters after warmup")
        self._n_rescued = n_bad
        return state, inv_mass, chol, eps_final

    # -- ChEES bank execution -------------------------------------------------

    def _run_chees(self, pot_and_grad, D, dtype, device, z0s, draws, warm_start=None):
        """Run a ChEES kernel: adaptation pools statistics across the bank,
        so the bank is the unit of execution."""
        kern = self.kernel
        if self.num_chains < 8 and kern.trajectory_length is None:
            warnings.warn(
                f"ChEES with num_chains={self.num_chains} (< 8): trajectory "
                "adaptation pools statistics across chains and is "
                "ineffective for narrow banks (with 1 chain it never moves "
                "from its initialization). Use a wide bank, pass a fixed "
                "trajectory_length, or switch to the NUTS kernel.",
                stacklevel=3,
            )
        init_bank, warmup_step, sample_step = make_chees_parts(kern, pot_and_grad, D, dtype, device, draws)
        if warm_start is not None:
            state, (inv_mass, chol, eps, traj) = warm_start
            # re-evaluate the energy at the saved positions under THIS run's
            # potential: its centering constants may differ from the saved run's
            pe, grad = pot_and_grad(state.z)
            state = state._replace(potential=pe, grad=grad)
        else:
            carry = init_bank(z0s)
            if self.num_warmup > 0:
                carry = self._warm(carry, warmup_step)
            state, da, ts, _, inv_mass, chol = carry
            eps = torch.exp(da.log_eps_avg)
            if kern.trajectory_length is not None:
                traj = torch.tensor(kern.trajectory_length, dtype=dtype, device=device)
            else:
                traj = torch.maximum(torch.exp(ts.log_t_avg), eps)
        state, collected = self._sample(state, sample_step, (inv_mass, chol, eps, traj))
        collected["step_size"] = torch.full((self.num_chains,), float(eps), dtype=dtype, device=device)
        return state, (inv_mass, chol, eps, traj), collected

    # -- public API ----------------------------------------------------------

    def run(self, rng_key, *args, warm_start=None, consensus_check=None, **kwargs):
        """Trace the model, adapt, and sample the whole bank.

        ``rng_key``: an int seed or a ``torch.Generator``. The run draws from
        one generator on the bank's device: the generator's own, else the
        device of the model's tensor arguments, else the card.

        ``warm_start``: a value from :meth:`warm_start_state` of a previous
        run (or :func:`~dynode_tpu_torch.convert.warm_start_from_numpy` of
        a JAX one) -- skips warmup and continues sampling from the saved
        states with the saved mass matrices and step sizes. Such a run
        draws nothing but its transitions from the generator, so given the
        earlier run's generator it continues that run's chains exactly.

        ``consensus_check``: split the bank into this many sub-banks after
        sampling and compare their posterior means against the combined
        Monte-Carlo standard errors; warns when a site's sub-bank means
        diverge by more than 4 SEs (:attr:`consensus_report`).
        """
        if "rng_key" in kwargs and not isinstance(rng_key, (int, torch.Generator)):
            raise ValueError("pass rng_key positionally or as first arg")
        if warm_start is not None:
            _, tuned = warm_start
            want = 4 if isinstance(self.kernel, ChEES) else 3
            if len(tuned) != want:
                raise ValueError(
                    "warm_start kernel mismatch: the saved tuned-parameter "
                    f"tuple has {len(tuned)} entries but a "
                    f"{type(self.kernel).__name__} kernel expects {want} "
                    "(NUTS saves (inv_mass, chol, step_size); ChEES saves "
                    "(inv_mass, chol, step_size, trajectory)). Re-create "
                    "the warm start with the same kernel type."
                )
            saved_chains = warm_start[0].z.shape[0]
            if saved_chains != self.num_chains:
                raise ValueError(
                    f"warm_start width mismatch: the saved state holds "
                    f"{saved_chains} chains but this MCMC is configured "
                    f"with num_chains={self.num_chains}. Use a matching "
                    "num_chains (or rebuild the warm start, e.g. "
                    "chees_warm_start_from_guide(..., num_chains=...))."
                )
        if self.chain_method == "parallel":
            # numpyro's "parallel" = one host process per chain (pmap); here
            # the vectorized bank with its potential split over every card
            n_dev = default_device_count()
            if self.mesh is None and n_dev > 1 and self.num_chains % n_dev == 0:
                self.mesh = create_mesh((self.chain_axis,))
            if self.mesh is not None:
                warnings.warn(
                    "chain_method='parallel' runs as a mesh-sharded "
                    "vectorized chain bank on this backend (same posterior; "
                    "chains are split across devices, one shard of the "
                    "bank's potential per device, rather than host pmap)",
                    stacklevel=2,
                )
            else:
                warnings.warn(
                    "chain_method='parallel' fell back to a plain vectorized "
                    f"(unsharded) chain bank: {max(n_dev, 1)} device(s) visible and "
                    f"num_chains={self.num_chains} must be divisible by the "
                    "device count for the mesh-sharded layout",
                    stacklevel=2,
                )
        elif self.chain_method == "sequential":
            if isinstance(self.kernel, ChEES):
                raise ValueError(
                    "ChEES adapts across the whole chain bank each "
                    "transition; chain_method='sequential' cannot express "
                    "it -- use 'vectorized'"
                )
            if warm_start is not None or self.steps_per_call is not None:
                raise ValueError(
                    "chain_method='sequential' does not compose with "
                    "warm_start or steps_per_call; use 'vectorized'"
                )
        # the split is checked before anything runs
        plan = None
        if self.mesh is not None:
            plan = shard_plan(self.mesh, self.chain_axis, self.num_chains, "chain bank")
        self._model_args = args
        self._model_kwargs = kwargs
        model = self.kernel.model
        device = _run_device(rng_key, args, kwargs)
        gen = rng_key if isinstance(rng_key, torch.Generator) else torch.Generator(device=device).manual_seed(int(rng_key))
        draws = Draws(gen)

        # cross-run cache (module docstring): the trace, transforms, centres,
        # flat potential and graphs are reused whenever the kernel's
        # configuration, the run's shape and the identity of the model and of
        # every argument match. Centres are draw-derived constants: reusing an
        # earlier run's shifts the potential by a constant per site, to which
        # the chains and the diagnostics are invariant
        leaves, treedef = pytree.tree_flatten((args, kwargs))
        cache_key = (
            id(model),
            _kernel_token(self.kernel),
            self.num_warmup,
            self.num_samples,
            self.num_chains,
            self.steps_per_call,
            self.chain_method,
            None if self.mesh is None else self.mesh.key(),
            self.chain_axis,
            treedef,
            tuple(id(x) for x in leaves),
            torch.get_default_dtype(),
            str(device),
        )
        # the entry holds the model, every leaf and the kernel's callables: their
        # ids cannot be recycled while it lives, and a hit is confirmed with ``is``
        objects = [model, *leaves, self.kernel.init_strategy, self.kernel.batched_potential_fn]
        fps = [fingerprint(x) for x in leaves]
        entry = cached(_EXEC_CACHE, cache_key, objects, fps, "MCMC executable")

        # the setup's draws come from a generator seeded by one draw of ``gen``
        # (JAX's key_struct), taken on a hit too; a warm-started run takes
        # nothing from ``gen`` but its transitions, so it continues an earlier
        # run's stream
        setup_seed = 0 if warm_start is not None else int(torch.randint(2**62, (), generator=gen, device=gen.device))
        if entry is None:
            setup_gen = torch.Generator(device=device).manual_seed(setup_seed)
            tr = get_model_trace(model, setup_gen, *args, **kwargs)
            if not latent_sites(tr):
                raise ValueError("model has no latent sample sites to infer")
            transforms = get_transforms(tr)
            centers = observed_logprob_centers(tr) if self.kernel.center_potential else None
            u0 = unconstrain_sample(transforms, initialize_latents(tr, setup_gen, self.kernel.init_strategy))
            flat_pot, _, unravel = flatten_potential(make_potential_fn(model, args, kwargs, transforms,
                                                                       centers=centers), u0)
            entry = keep(_EXEC_CACHE, cache_key, {"objects": objects, "fps": fps, "parts": {}, "tr": tr,
                                                  "transforms": transforms, "centers": centers, "u0": u0,
                                                  "unravel": unravel, "flat_pot": flat_pot},
                         _release_entry, _EXEC_CACHE_SIZE)
        tr, transforms, centers, u0 = entry["tr"], entry["transforms"], entry["centers"], entry["u0"]
        flat_pot, unravel = entry["flat_pot"], entry["unravel"]
        init_strategy = self.kernel.init_strategy
        self._transforms = transforms
        self._unravel = unravel

        def flat_init_bank():
            c = initialize_latents(tr, gen, init_strategy, num_chains=self.num_chains)
            return unravel.ravel(unconstrain_sample(transforms, c), batch_dims=1)

        if warm_start is not None:
            z0s = None
            D = warm_start[0].z.shape[-1]
            dtype = warm_start[0].z.dtype
        else:
            z0s = flat_init_bank().to(device)
            D, dtype = z0s.shape[-1], z0s.dtype

        batched = self.kernel.batched_potential_fn
        self.graph, self.graphs = None, []

        def bank_part(width, dev):
            """The potential and gradient of ``width`` chains on ``dev``:
            graph-captured on a card unless the chains run one by one; the
            generic one kept in the run's cache entry."""
            graphed = dev.type == "cuda" and self.chain_method != "sequential"
            if batched is None:
                part = entry["parts"].get((width, str(dev), graphed))
                if part is None:
                    pot = flat_pot
                    if dev != device:
                        # the model's tensors go with the shard
                        moved = pytree.tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x,
                                                (args, kwargs, centers))
                        pot = flatten_potential(make_potential_fn(model, moved[0], moved[1], transforms,
                                                                  centers=moved[2]), u0)[0]
                    part = entry["parts"][(width, str(dev), graphed)] = generic_pot_and_grad(pot, dev if graphed
                                                                                             else None)
                graph = inspect.unwrap(part)
                if isinstance(graph, GraphedPotential):
                    self.graphs.append(graph)
                return part
            if graphed:
                graph = graphed_potential(batched, width, D, dtype, dev,
                                          mesh=None if plan is None else (self.mesh.key(), self.chain_axis))
                self.graphs.append(graph)
                return graph
            return batched_pot_and_grad(batched)

        if plan is None:
            pot_and_grad = bank_part(self.num_chains, device)
        else:
            parts = {s: bank_part(plan.width, plan.place(s)) for s in plan.local}
            pot_and_grad = split_pot_and_grad(plan, parts)
        self.graph = self.graphs[0] if self.graphs else None

        if z0s is not None:
            # reject non-finite starting points: redraw the bad chains up to
            # 20 times (21 validations bracket 20 redraw rounds)
            for attempt in range(21):
                pe0, g0 = pot_and_grad(z0s)
                ok = torch.isfinite(pe0) & torch.all(torch.isfinite(g0), dim=-1)
                if bool(ok.all()):
                    break
                if attempt == 20:
                    bad = torch.where(~ok)[0].tolist()
                    raise RuntimeError(
                        "could not find finite initial potentials/gradients "
                        f"for all chains after 20 redraws (bad chains: {bad})"
                    )
                z0s = torch.where(ok[:, None], z0s, flat_init_bank().to(device))

        if self.progress_bar:
            print(
                f"[dynode_tpu_torch.MCMC] running {self.num_chains} chain(s) x "
                f"({self.num_warmup} warmup + {self.num_samples} samples) on {device}..."
            )
        if isinstance(self.kernel, ChEES):
            self.last_state, self._tuned, collected = self._run_chees(
                pot_and_grad, D, dtype, device, z0s, draws, warm_start=warm_start
            )
        elif warm_start is not None:
            prev_state, (inv_mass, chol, eps) = warm_start
            # re-anchor the saved states on this run's potential function
            pe, grad = pot_and_grad(prev_state.z)
            state = prev_state._replace(potential=pe, grad=grad)
            _, _, sample_step = self._nuts_parts(pot_and_grad, D, dtype, device, draws)
            state, collected = self._sample(state, sample_step, (inv_mass, chol, eps))
            collected["step_size"] = eps
            self.last_state, self._tuned = state, (inv_mass, chol, eps)
        elif self.chain_method == "sequential":
            # one chain at a time, each a bank of one, from the one generator
            outs = [
                self._run_nuts(pot_and_grad, D, dtype, device, z0s[i : i + 1], draws, rescue=False)
                for i in range(self.num_chains)
            ]
            self.last_state = type(outs[0][0])(*(torch.cat(xs) for xs in zip(*(o[0] for o in outs))))
            self._tuned = tuple(torch.cat(xs) for xs in zip(*(o[1] for o in outs)))
            collected = {k: torch.cat([o[2][k] for o in outs]) for k in outs[0][2]}
        else:
            self.last_state, self._tuned, collected = self._run_nuts(
                pot_and_grad, D, dtype, device, z0s, draws, rescue=True
            )
        z = collected.pop("z")  # (chains, samples, D)
        self._collect(z, collected)
        if consensus_check:
            self.consensus_report = self._consensus_check(int(consensus_check))
        if self.progress_bar:
            div = int(torch.sum(self._extra_fields["diverging"]))
            print(f"[dynode_tpu_torch.MCMC] done; divergences={div}")
        return self

    def _consensus_check(self, k: int):
        """Compare posterior means across ``k`` disjoint sub-banks (max
        pairwise z-score per site; warns above 4), on the host in float64."""
        from .diagnostics import _host, effective_sample_size

        if k < 2:
            raise ValueError("consensus_check needs k >= 2 sub-banks")
        if self.num_chains < 2 * k:
            raise ValueError(
                f"consensus_check={k} needs at least {2 * k} chains "
                f"(got {self.num_chains}) so every sub-bank has >= 2"
            )
        report = {}
        flagged = []
        for name, v in self._samples.items():
            arr = _host(v)
            flat = arr.reshape(arr.shape[0], arr.shape[1], -1)
            groups = np.array_split(np.arange(arr.shape[0]), k)
            max_z = 0.0
            for e in range(flat.shape[-1]):
                stats = []
                for g in groups:
                    x = flat[g, :, e]
                    ess = max(effective_sample_size(x), 1.0)
                    stats.append((float(x.mean()), float(x.var(ddof=1)) / ess))
                for i in range(k):
                    for j in range(i + 1, k):
                        dm = abs(stats[i][0] - stats[j][0])
                        se = math.sqrt(stats[i][1] + stats[j][1])
                        if se > 0.0:
                            max_z = max(max_z, dm / se)
                        elif dm > 0.0:
                            max_z = float("inf")
            report[name] = max_z
            if max_z > 4.0:
                flagged.append((name, max_z))
        if flagged:
            detail = ", ".join(f"{n}: z={z:.1f}" for n, z in flagged)
            warnings.warn(
                f"consensus check FAILED ({detail}): sub-bank posterior "
                "means diverge beyond Monte-Carlo error. The run may be "
                "corrupted; re-run with a fresh seed before trusting this "
                "posterior.",
                stacklevel=3,
            )
        return report

    def _collect(self, z, extras):
        uparams = self._unravel(z)
        self._samples = {name: self._transforms[name](u) for name, u in uparams.items()}
        self._extra_fields = extras
        # loud diagnostics for frozen chains
        if self.num_samples >= 4:
            spread = z.double().std(dim=1).amax(dim=-1)  # per-chain max-coord std
            stuck = torch.where(spread < 1e-8)[0].cpu().numpy()
            if stuck.size:
                warnings.warn(
                    f"{stuck.size} of {self.num_chains} chains produced "
                    f"(near-)constant samples (chains {stuck[:10].tolist()}"
                    f"{'...' if stuck.size > 10 else ''}); their draws are "
                    "not exploring the posterior. Check warmup diagnostics "
                    "or re-run with different seeds.",
                    stacklevel=3,
                )

    def get_samples(self, group_by_chain: bool = False) -> Dict[str, torch.Tensor]:
        """Posterior samples per site: (C*S, ...) or (C, S, ...) tensors."""
        assert self._samples is not None, "run() first"
        if group_by_chain:
            return dict(self._samples)
        return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in self._samples.items()}

    def get_extra_fields(self, group_by_chain: bool = False):
        """Per-draw sampler statistics (``diverging``, ``num_steps``, ...)."""
        assert self._extra_fields is not None, "run() first"
        if group_by_chain:
            return dict(self._extra_fields)
        out = {}
        for k, v in self._extra_fields.items():
            if v.dim() >= 2:
                out[k] = v.reshape((-1,) + tuple(v.shape[2:]))
            else:
                out[k] = v
        return out

    def deterministic_samples(self) -> Dict[str, torch.Tensor]:
        """Replay the model per posterior draw to collect deterministic
        sites (one ``torch.func.vmap`` over all draws)."""
        samples = self.get_samples(group_by_chain=False)
        model = self.kernel.model
        args, kwargs = self._model_args, self._model_kwargs

        def replay(draw):
            with handlers.trace() as tr, handlers.seed(0), handlers.substitute(draw):
                model(*args, **kwargs)
            return {name: site["value"] for name, site in tr.items() if site["type"] == "deterministic"}

        probe = replay({k: v[0] for k, v in samples.items()})
        if not probe:
            return {}
        return torch.func.vmap(replay)(samples)

    def warm_start_state(self):
        """The resumable sampler state: ``(last_state, tuned_params)``.

        For a NUTS kernel: ``(HMCState of the bank, (inv_mass, chol,
        step_size))``, one entry per chain. For a ChEES kernel:
        ``(ChEESBankState, (inv_mass, chol, step_size, trajectory))``,
        shared by the bank. Pass to a later ``run(..., warm_start=...)``.
        """
        assert self.last_state is not None, "run() first"
        return self.last_state, self._tuned

    def print_summary(self):
        """Print a per-site posterior summary (mean/std/HDI/ESS/r_hat)."""
        from .diagnostics import summary

        stats = summary(self.get_samples(group_by_chain=True))
        for name, row in stats.items():
            print(name, row)


__all__ = ["NUTS", "MCMC", "GraphCaptureError", "GraphedPotential", "clear_exec_cache", "graphed_potential",
           "split_pot_and_grad"]
