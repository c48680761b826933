"""Where the kernels are built: the port's counterpart of JAX's persistent
compilation cache.

Port of ``dynode_tpu/utils/compilation_cache.py``. The port's compiled
programs are its kernels: the nvcc builds of ``ops/_build.py`` (a shared
library per hash of the sources and flags, so a hit is never stale) and
Triton's cache of the generic kernels. By default both live under
``build/dynode_tpu_torch/`` of the checkout; :func:`enable_compilation_cache`
points both at another directory for the rest of the process, so that
later processes, or other checkouts of the same sources, load the built
kernels from there instead of compiling them again.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["enable_compilation_cache", "compilation_cache_dir"]

_ENV_VAR = "DYNODE_COMPILATION_CACHE"
_DEFAULT_SUBDIR = os.path.join("dynode_tpu_torch", "kernel_cache")


def compilation_cache_dir() -> str:
    """The directory :func:`enable_compilation_cache` uses by default:
    ``$DYNODE_COMPILATION_CACHE`` if set, else
    ``$XDG_CACHE_HOME/dynode_tpu_torch/kernel_cache`` (``~/.cache``
    without it)."""
    env = os.environ.get(_ENV_VAR)
    if env:
        return os.path.expanduser(env)
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, _DEFAULT_SUBDIR)


def _built() -> bool:
    """Whether this process has built or loaded a kernel yet."""
    from ..ops import _build, generic_triton

    caches = (_build.load_library, generic_triton._kernel, generic_triton._adaptive_kernel)
    return any(f.cache_info().currsize for f in caches)


def enable_compilation_cache(path: Optional[str] = None, *, min_compile_time_secs: float = 1.0) -> str:
    """Build and load the kernels under ``path`` (default
    :func:`compilation_cache_dir`) for the rest of the process: the nvcc
    builds in ``path`` itself, Triton's cache in ``path/triton``
    (``TRITON_CACHE_DIR``). Returns the directory in use.

    Call it before the first kernel is built: after one, a call for
    another directory raises ``RuntimeError`` (a call for the directory in
    use returns it). ``DYNODE_COMPILATION_CACHE=0`` (or ``off``, ``false``,
    ``no``) makes the call return ``""`` and change nothing.
    ``min_compile_time_secs`` is JAX's threshold, accepted for its call
    form: every kernel build is kept.
    """
    from ..ops import _build

    env = os.environ.get(_ENV_VAR, "").strip().lower()
    if env in ("0", "off", "false", "no"):
        return ""
    cache_dir = os.path.expanduser(path) if path else compilation_cache_dir()
    if Path(cache_dir).resolve() == Path(_build.BUILD_ROOT).resolve():
        return cache_dir
    if _built():
        raise RuntimeError(
            f"a kernel was already built in this process under {_build.BUILD_ROOT}; "
            "call enable_compilation_cache before the first kernel build"
        )
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_ROOT = Path(cache_dir)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache_dir, "triton")
    return cache_dir
