"""Draws recorded from the JAX samplers, replayed through the port's seam.

:func:`record` runs a JAX function under ``jax.disable_jit()`` with
``jax.random.normal``, ``uniform`` and ``bernoulli`` wrapped (by pytest's
``monkeypatch``) so that every value they return is kept in call order;
``dynode_tpu`` itself is untouched. :class:`Replay` is the port's draw seam
(:class:`dynode_tpu_torch.infer.hmc.Draws`) fed from such recordings: per
chain, every active chain takes its next recorded values; for a bank-level
JAX function (ChEES) one stream holds whole-bank arrays.
"""

import jax
import numpy as np
import torch


def record(monkeypatch, fn, *args, **kwargs):
    """``(fn(*args, **kwargs), draws)`` with every JAX draw of the call."""
    draws = []
    originals = {name: getattr(jax.random, name) for name in ("normal", "uniform", "bernoulli")}

    def wrap(name):
        def drawn(*a, **k):
            x = originals[name](*a, **k)
            draws.append(np.asarray(x))
            return x

        return drawn

    with monkeypatch.context() as m:
        for name in originals:
            m.setattr(jax.random, name, wrap(name))
        with jax.disable_jit():
            out = fn(*args, **kwargs)
    return out, draws


class Replay:
    """The port's draw seam, handing out recorded draws.

    ``streams`` is a list with one list of draws per chain, or, with
    ``bank=True``, one list of whole-bank arrays. :meth:`done` says
    whether every recorded draw was taken.
    """

    def __init__(self, streams, bank=False):
        self.streams = [list(s) for s in streams]
        self.bank = bank

    def _take(self, shape, active, dtype, device):
        shape = tuple(shape)
        if self.bank:
            x = np.asarray(self.streams[0].pop(0))
            assert x.shape == shape, (x.shape, shape)
            return torch.as_tensor(x, dtype=dtype, device=device)
        out = np.zeros(shape)
        per_chain = int(np.prod(shape[1:]))
        for c in range(shape[0]):
            if active is not None and not bool(active[c]):
                continue
            got = []
            while len(got) < per_chain:
                got.extend(np.asarray(self.streams[c].pop(0), dtype=np.float64).reshape(-1).tolist())
            assert len(got) == per_chain
            out[c] = np.asarray(got).reshape(shape[1:])
        return torch.as_tensor(out, dtype=dtype, device=device)

    def normal(self, shape, dtype, device, active=None):
        return self._take(shape, active, dtype, device)

    def uniform(self, shape, dtype, device, active=None):
        return self._take(shape, active, dtype, device)

    def bernoulli(self, shape, device, active=None):
        return self._take(shape, active, torch.float64, device) > 0.5

    def done(self) -> bool:
        return all(not s for s in self.streams)
