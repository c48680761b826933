"""CUDA-graph capture and the caches that keep graphs, shared by the ODE
engine and inference.

:func:`capture` warms a function up on a side stream, then captures it on a
stream of the graph's own card with host syncs raising, inside
:func:`~dynode_tpu_torch._device.keep_constants` so that the constants the
warm-up copied to the card are read, not copied, by the graph. A capture
that fails raises :class:`GraphCaptureError` naming the user's line;
nothing then runs eagerly in its place.

The graphs are kept in caches of JAX's kind (the engine's kept solves in
``ode/integrate.py``, ``MCMC``'s ``_EXEC_CACHE``, ``SVI``'s
``_multistart_cache``): :func:`cached` finds an entry by its key, the
identity of the objects it was built from and the fingerprints of their
arrays (:func:`fingerprint`), and :func:`keep` stores one, dropping the
least recently used past the cache's size (:data:`EXEC_CACHE_SIZE`).

This module sits below ``ode`` and ``infer`` (it imports neither), so both
reach it without an import cycle; ``infer/graphs.py`` re-exports its names.
"""

import contextlib
import gc
import time
import traceback
import warnings
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from . import _device

#: entries of each graph cache, as JAX's exec cache keeps 8 programs
EXEC_CACHE_SIZE = 8


class GraphCaptureError(RuntimeError):
    """A solve, a potential or a step could not be captured into a CUDA graph."""


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

    Python's cyclic garbage collector is run before the capture and held
    off during it: a graph freed inside a capture (one that dead objects
    in a reference cycle still held) would invalidate it.
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
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
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
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
        capture_s = time.perf_counter() - start
    return graph, warm, static, warmup_s, capture_s


def fingerprint(x):
    """Content tag of an argument leaf: a tensor's shape, dtype, device and
    version counter (which every in-place write advances; an inference
    tensor, made under ``torch.inference_mode``, has none and is tagged
    without it); a numpy array's shape, dtype and JAX's strided probe (8
    strided elements and the last), which catches realistic in-place
    changes; None for any other leaf."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, str(x.device), None if x.is_inference() else x._version)
    if isinstance(x, np.ndarray):
        flat = x.reshape(-1)
        if flat.size == 0:
            return (x.shape, x.dtype.str, b"")
        stride = max(1, flat.size // 8)
        probe = np.concatenate([flat[::stride][:8], flat[-1:]])
        return (x.shape, x.dtype.str, probe.tobytes())
    return None


def cached(cache: OrderedDict, key, objects: list, fps: list, what: str) -> Optional[dict]:
    """The entry of ``cache`` under ``key``, made the most recently used,
    when it was built from ``objects`` (each the same object: ``is``, as a
    recycled id may hide another) and its arrays' fingerprints are still
    ``fps``; else None. An array changed in place (same objects, other
    fingerprints) warns: its entry is never served stale."""
    entry = cache.get(key)
    if entry is None or any(a is not b for a, b in zip(entry["objects"], objects, strict=True)):
        return None
    if entry["fps"] != fps:
        warnings.warn(
            f"{what} cache: an array argument was mutated in place since the "
            "cached run (same object identity, different contents) -- "
            "tracing and capturing again. Pass a fresh array instead of "
            "mutating, or this run pays the full trace and capture every time.",
            stacklevel=3,
        )
        return None
    cache.move_to_end(key)
    return entry


def keep(cache: OrderedDict, key, entry: dict, drop: Callable, size: int) -> dict:
    """Store ``entry`` under ``key`` as the most recently used, calling
    ``drop`` (which releases its graphs) on the entry it replaces and on
    the least recently used past ``size``."""
    old = cache.pop(key, None)
    if old is not None:
        drop(old)
    cache[key] = entry
    while len(cache) > size:
        drop(cache.popitem(last=False)[1])
    return entry
