"""SaveAt / SubSaveAt: which times and which compartments to keep.

Port of ``dynode_tpu/ode/saveat.py``. ``SaveAt(ts=...)`` saves the whole
state on a time grid; ``SaveAt(subs=SubSaveAt(ts=..., fn=...))`` applies
``fn(t, y, args)`` to each saved state, as ``simulate`` does to replace the
compartments it does not keep by empty ``(T, 0)`` tensors. A grid may be a
sequence, a numpy array or a tensor; the engine reads it in float64 on the
host and casts it to the state's dtype.
"""

from typing import Callable, Optional


class SubSaveAt:
    """A save grid plus a function applied to each saved state."""

    def __init__(self, ts, fn: Optional[Callable] = None):
        self.ts = ts
        self.fn = fn if fn is not None else (lambda t, y, args: y)


class SaveAt:
    """Save times, and optionally a :class:`SubSaveAt` transform."""

    def __init__(self, ts=None, subs: Optional[SubSaveAt] = None, t1: bool = False):
        if ts is None and subs is None and not t1:
            raise ValueError("SaveAt requires ts=, subs=, or t1=True")
        self.ts = ts
        self.subs = subs
        self.t1 = t1


__all__ = ["SaveAt", "SubSaveAt"]
