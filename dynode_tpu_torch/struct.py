"""Dataclasses registered as PyTorch pytrees, with static (context) fields.

Port of ``dynode_tpu/struct.py``. A ``@pytree_dataclass`` class flattens to
its data fields, in declaration order, so that ``torch.func.vmap``,
``torch.utils._pytree.tree_map`` and the engine's member mapping see its
tensors as leaves; the fields named in ``static_fieldnames`` (or its alias
``static_keynames``) travel in the tree's context and are never mapped.

The registration is ``torch.utils._pytree.register_pytree_node`` with a
flatten of our own rather than ``register_dataclass``: the latter has no
static context, and it moves a field that holds ``None`` out of the leaves,
so a tree of ``in_dims`` with a ``None`` inside no longer lines up with the
tree of tensors it describes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Type, TypeVar, Union

import torch.utils._pytree as pytree

_T = TypeVar("_T")


def _as_tuple(names: Union[str, Iterable[str], None]) -> tuple:
    if names is None:
        return ()
    if isinstance(names, str):
        return (names,)
    return tuple(names)


def pytree_dataclass(
    cls: Optional[Type[_T]] = None,
    *,
    static_fieldnames: Union[str, Sequence[str], None] = None,
    static_keynames: Union[str, Sequence[str], None] = None,
    frozen: bool = False,
):
    """Make ``cls`` a dataclass registered as a PyTorch pytree.

    Works bare (``@pytree_dataclass``) and with arguments. ``frozen`` as in
    :func:`dataclasses.dataclass`; equality is identity, as in the JAX
    package (tensor fields have no boolean ``==``). A ``replace(**updates)``
    method is added unless the class defines its own.
    """
    static = _as_tuple(static_fieldnames) + _as_tuple(static_keynames)

    def wrap(inner_cls: Type[_T]) -> Type[_T]:
        dc = dataclasses.dataclass(inner_cls, frozen=frozen, eq=False)
        names = [f.name for f in dataclasses.fields(dc) if f.init]
        unknown = set(static) - set(names)
        if unknown:
            raise ValueError(
                f"static field names {sorted(unknown)} not found among "
                f"dataclass fields {names}"
            )
        data = tuple(n for n in names if n not in static)
        meta = tuple(n for n in names if n in static)

        def flatten(obj):
            return [getattr(obj, n) for n in data], tuple(getattr(obj, n) for n in meta)

        def unflatten(values, context):
            return dc(**dict(zip(data, values)), **dict(zip(meta, context)))

        def flatten_with_keys(obj):
            children, context = flatten(obj)
            return [(pytree.GetAttrKey(n), v) for n, v in zip(data, children)], context

        pytree.register_pytree_node(
            dc, flatten, unflatten, flatten_with_keys_fn=flatten_with_keys
        )
        if "replace" not in inner_cls.__dict__:

            def replace(self, **updates):
                """A copy with the given fields replaced."""
                return dataclasses.replace(self, **updates)

            dc.replace = replace
        return dc

    if cls is None:
        return wrap
    return wrap(cls)


def field(**kwargs):
    """Passthrough to :func:`dataclasses.field`, as in the JAX package."""
    return dataclasses.field(**kwargs)


__all__ = ["pytree_dataclass", "field"]
