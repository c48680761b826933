"""CUDA graphs of the inference loops, as the JAX package jits them.

Two graphs share the capture here: the chain bank's potential and gradient
of :mod:`.mcmc` (:class:`~.mcmc.GraphedPotential`) and the SVI step of
:mod:`.svi` (:class:`GraphedStep`). :func:`capture` warms a function up on
a side stream, then captures it on a stream of the graph's own card with
host syncs raising, inside :func:`~dynode_tpu_torch._device.keep_constants`
so that the constants the warm-up copied to the card are read, not copied,
by the graph. A capture that fails raises :class:`GraphCaptureError`
naming the user's line; nothing then runs eagerly in its place.
"""

import contextlib
import time
import traceback
import warnings
from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

from .. import _device


class GraphCaptureError(RuntimeError):
    """A potential or a step could not be captured into a CUDA graph."""


@contextlib.contextmanager
def _syncs_raise():
    """Within the block, an operation that would make the host wait for the
    device (``.item()``, ``nonzero``, a copy from pageable host memory)
    raises instead (``torch.cuda.set_sync_debug_mode("error")``). Torch
    warns that the mode misses some syncs; a sync it misses fails the
    capture itself, and :func:`capture` raises for both."""
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype feature")
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _user_frame(tb) -> str:
    """The innermost frame outside torch of the traceback ``tb``."""
    mine = [f for f in traceback.extract_tb(tb) if "/torch/" not in f.filename.replace("\\", "/")]
    if not mine:
        return "no frame outside torch"
    f = mine[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


def capture(device: torch.device, constants: dict, warmup: Callable, body: Callable, what: str):
    """Run ``warmup()`` on a side stream, then capture ``body()`` into a CUDA
    graph on ``device``.

    Returns ``(graph, warm, static, warmup_s, capture_s)``: the graph, the
    warm-up's result (an eager call's), the captured call's outputs (static
    tensors that every replay rewrites), and the walls of the warm-up and
    of the capture (host clock, each ended by a synchronize of the card).
    Both calls run inside ``keep_constants(constants)``, which the caller
    keeps as long as the graph. A capture that meets a host sync or a host
    copy raises :class:`GraphCaptureError` naming the user's frame;
    ``what`` names the captured function in its message.
    """
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    # ``torch.cuda.graph``'s default capture stream is one per process,
    # made on whichever card was current at the first capture: each
    # graph gets a stream of its own card
    with torch.cuda.device(device), _device.keep_constants(constants):
        start = time.perf_counter()
        with torch.cuda.stream(side):
            warm = warmup()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        warmup_s = time.perf_counter() - start
        start = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
                with _syncs_raise():
                    static = body()
        except RuntimeError as err:
            first = err
            while isinstance(first.__context__, RuntimeError):
                first = first.__context__
            raise GraphCaptureError(
                f"CUDA-graph capture of {what} failed at {_user_frame(first.__traceback__)}: {first}. "
                "What a graph captures must not sync the host, and it is not run eagerly instead"
            ) from err
        torch.cuda.synchronize(device)
        capture_s = time.perf_counter() - start
    return graph, warm, static, warmup_s, capture_s


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class GraphedStep:
    """An optimizer step ``step(state, draws) -> (state, loss)`` over a
    pytree ``state`` (SVI's parameters and optimizer state), replayed from
    one CUDA graph with the state in static buffers.

    :meth:`start` copies the first state into the buffers. The first call
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
        self.replays = 0
        #: the device of the state, and the walls of the warm-up and capture
        self.device: Optional[torch.device] = None
        self.warmup_s = self.capture_s = None
        self.state = self.draws = self.static_loss = None

    def start(self, state) -> None:
        """Copy ``state`` into the state buffers (:attr:`state`)."""
        self.state = pytree.tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, state)
        self.device = _tensors(self.state)[0].device

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
