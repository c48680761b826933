"""CUDA graphs of the inference loops, as the JAX package jits them.

Two graphs share the capture of :mod:`dynode_tpu_torch._graphs`: the chain
bank's potential and gradient of :mod:`.mcmc`
(:class:`~.mcmc.GraphedPotential`) and the SVI step of :mod:`.svi`
(:class:`GraphedStep`, here). :func:`capture` warms a function up on a
side stream, then captures it with host syncs raising, inside
:func:`~dynode_tpu_torch._device.keep_constants`; a capture that fails
raises :class:`GraphCaptureError` naming the user's line, and nothing then
runs eagerly in its place.

Both keep their graphs across runs in caches of JAX's kind (``MCMC``'s
``_EXEC_CACHE``, ``SVI``'s ``_multistart_cache``) through :func:`cached`,
:func:`fingerprint` and :func:`keep`. Those helpers live in
``_graphs.py``, below both ``ode`` and ``infer``, since the ODE engine
keeps its solves' graphs with them too; this module re-exports them.
"""

from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

from .._graphs import (  # noqa: F401  (re-exported)
    GraphCaptureError,
    _syncs_raise,
    _user_frame,
    cached,
    capture,
    fingerprint,
    keep,
)


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class GraphedStep:
    """An optimizer step ``step(state, draws) -> (state, loss)`` over a
    pytree ``state`` (SVI's parameters and optimizer state), replayed from
    one CUDA graph with the state in static buffers.

    :meth:`start` copies the first state into the buffers (made at the first
    start; a later start, of a step kept across runs, writes into the same
    buffers, whose addresses the graph reads). The first call
    writes its draws (a list of tensors) into static draw buffers and, on a
    card, captures ``step`` followed by the copy of the new state into the
    state buffers; the warm-up before the capture calls ``step`` alone, so
    it leaves the buffers as they were and the first replay takes the
    first step. Every call (the first included) then writes its draws,
    replays the graph and returns the static loss, which the next call
    rewrites. So ``k`` calls take the eager loop's ``k`` steps, in its
    kernels and order: bit for bit. On CPU tensors the same buffers are
    stepped by calling the function (no graph).
    """

    def __init__(self, step: Callable):
        self.step = step
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.constants: dict = {}
        self.replays = self.captures = 0
        #: the device of the state, and the walls of the warm-up and capture
        self.device: Optional[torch.device] = None
        self.warmup_s = self.capture_s = None
        self.state = self.draws = self.static_loss = None

    def start(self, state) -> None:
        """Copy ``state`` into the state buffers (:attr:`state`), in place
        when they exist."""
        if self.state is None:
            self.state = pytree.tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, state)
            self.device = _tensors(self.state)[0].device
            return
        for buf, x in zip(_tensors(self.state), _tensors(state), strict=True):
            buf.copy_(x)

    def _body(self):
        new, loss = self.step(self.state, self.draws)
        for buf, value in zip(_tensors(self.state), _tensors(new)):
            buf.copy_(value)
        return loss.detach()

    def __call__(self, draws) -> torch.Tensor:
        if self.draws is None:
            self.draws = [d.detach().clone() for d in draws]
            if self.device.type == "cuda":
                try:
                    self.graph, _, self.static_loss, self.warmup_s, self.capture_s = capture(
                        self.device, self.constants, lambda: self.step(self.state, self.draws), self._body,
                        "the SVI step")
                    self.captures += 1
                except GraphCaptureError:
                    self.draws = None  # a later call captures again, and never steps eagerly
                    raise
        else:
            for buf, d in zip(self.draws, draws):
                buf.copy_(d)
        self.replays += 1
        if self.graph is None:
            return self._body()
        self.graph.replay()
        return self.static_loss

    def release(self) -> None:
        """Free the graph, its draw buffers and its kept constants (the
        state buffers stay with whoever holds them; the replay count
        stays)."""
        self.graph = None
        self.draws = self.static_loss = None
        self.constants = {}
