"""Draws recorded from the JAX samplers, replayed through the port's seam.

:func:`record` runs a JAX function under ``jax.disable_jit()`` with
``jax.random.normal``, ``uniform`` and ``bernoulli`` wrapped (by pytest's
``monkeypatch``) so that every value they return is kept in call order;
``dynode_tpu`` itself is untouched. :class:`Replay` is the port's draw seam
(:class:`dynode_tpu_torch.infer.hmc.Draws`) fed from such recordings: per
chain, every active chain takes its next recorded values; for a bank-level
JAX function (ChEES) one stream holds whole-bank arrays. A replay also
stands in for a generator where a model or guide of the port draws
(``handlers.seed`` takes it).

:func:`sequential_vmap` replaces ``jax.vmap`` while recording a JAX
function that maps over a bank (SVI's starts and particles, Predictive's
draws), so that each member's draws come out concrete, member by member.
"""

import jax
import numpy as np
import torch


def sequential_vmap(fn, in_axes=0, out_axes=0, **_):
    """``jax.vmap`` as a Python loop over the leading axis (in_axes 0 or
    None per argument, out_axes 0)."""

    def mapped(*args):
        axes = in_axes if isinstance(in_axes, (tuple, list)) else (in_axes,) * len(args)
        sizes = {jax.tree_util.tree_leaves(a)[0].shape[0] for a, ax in zip(args, axes) if ax is not None}
        (n,) = sizes
        rows = [fn(*(a if ax is None else jax.tree_util.tree_map(lambda x: x[i], a) for a, ax in zip(args, axes)))
                for i in range(n)]
        return jax.tree_util.tree_map(lambda *xs: jax.numpy.stack(xs), *rows)

    return mapped


def record(monkeypatch, fn, *args, sequential=False, **kwargs):
    """``(fn(*args, **kwargs), draws)`` with every JAX draw of the call;
    with ``sequential``, ``jax.vmap`` runs as :func:`sequential_vmap`."""
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
        if sequential:
            m.setattr(jax, "vmap", sequential_vmap)
        with jax.disable_jit():
            out = fn(*args, **kwargs)
    return out, draws


class Replay:
    """The port's draw seam, handing out recorded draws.

    ``streams`` is a list with one list of draws per chain, or, with
    ``bank=True``, one list of whole-bank arrays. :meth:`done` says
    whether every recorded draw was taken.
    """

    #: a draw seam's device (the port's distributions read it)
    device = torch.device("cpu")

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
