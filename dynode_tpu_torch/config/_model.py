"""``Model``: the plain-class stand-in for pydantic's ``BaseModel``.

The config classes of the port declare their fields as :class:`Field`
class attributes (a validator of :mod:`dynode_tpu_torch._validate`, a
default or a default factory, and field checks run after it) and their
model checks with :func:`model_validator`. A ``Model`` then behaves as the
pydantic models of the JAX package do:

- ``Model(**data)`` validates each field in declaration order (a parent's
  fields first), fills defaults (a deep copy of a mutable default per
  instance, so no two instances share one) and runs the model checks in
  declaration order, a parent's first. A refused value raises
  ``ValueError`` with the reference's message; unknown keywords are
  dropped, or kept as attributes where the class sets ``extra = "allow"``.
- Instances stay mutable; assignment does not validate.
- ``dict(model)`` yields the fields in declaration order, then the extras
  (and, as pydantic does, a ``cached_property`` once computed), so
  ``type(model)(**dict(model))`` rebuilds the model.
- ``==`` compares the type and the fields (and extras), not identity.
- ``model_copy(update=...)`` is a shallow copy with fields replaced,
  unvalidated; ``model_validate(dict)`` builds an instance from fields
  past a custom ``__init__``; ``model_fields`` maps each field name to its
  :class:`Field`.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Sequence

from .. import _validate as V

_REQUIRED = object()
_IMMUTABLE = (type(None), bool, int, float, complex, str, bytes, tuple, frozenset)


class Field:
    """A declared field: its validator, its default (or default factory),
    and the checks run on the validated value (pydantic's
    ``field_validator(mode="after")``), in order."""

    def __init__(
        self,
        validator: V.Validator,
        default: Any = _REQUIRED,
        *,
        default_factory: Optional[Callable[[], Any]] = None,
        after: Sequence[Callable[[Any], Any]] = (),
    ):
        self.validator = validator
        self.default = default
        self.default_factory = default_factory
        self.after = tuple(after)

    @property
    def required(self) -> bool:
        return self.default is _REQUIRED and self.default_factory is None

    def get_default(self):
        if self.default_factory is not None:
            return self.default_factory()
        if isinstance(self.default, _IMMUTABLE):
            return self.default
        return copy.deepcopy(self.default)

    def validate(self, name: str, value):
        try:
            value = self.validator(value)[0]
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        for check in self.after:
            value = check(value)
        return value


def model_validator(fn):
    """Mark ``fn(self)`` as a model check run after the fields (pydantic's
    ``model_validator(mode="after")``)."""
    fn._model_check = True
    return fn


class Model:
    """Base of the port's config classes (module docstring)."""

    extra = "ignore"
    model_fields: Dict[str, Field] = {}
    _model_checks: tuple = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = {}
        checks = {}
        for base in reversed(cls.__mro__[1:]):
            fields.update(base.__dict__.get("model_fields", {}))
        for base in reversed(cls.__mro__):
            for name, value in base.__dict__.items():
                if getattr(value, "_model_check", False):
                    checks[name] = value
        for name, value in list(cls.__dict__.items()):
            if isinstance(value, Field):
                fields[name] = value
                delattr(cls, name)
        cls.model_fields = fields
        cls._model_checks = tuple(checks.values())

    def __init__(self, **data):
        values = {}
        for name, f in type(self).model_fields.items():
            if name in data:
                values[name] = f.validate(name, data.pop(name))
            elif f.required:
                raise ValueError(f"{name}: Field required")
            else:
                values[name] = f.get_default()
        self.__dict__.update(values)
        if type(self).extra == "allow":
            self.__dict__.update(data)
        for check in type(self)._model_checks:
            check(self)

    @classmethod
    def model_validate(cls, data: dict):
        """An instance built from the fields in ``data``, past any custom
        ``__init__`` (pydantic's ``model_validate``)."""
        obj = cls.__new__(cls)
        Model.__init__(obj, **dict(data))
        return obj

    def _extras(self) -> dict:
        if type(self).extra != "allow":
            return {}
        fields = type(self).model_fields
        return {k: v for k, v in self.__dict__.items() if k not in fields and not k.startswith("_")}

    def __iter__(self):
        yield from ((k, v) for k, v in self.__dict__.items() if not k.startswith("_"))

    def __eq__(self, other):
        if not isinstance(other, Model):
            return NotImplemented
        if type(self) is not type(other):
            return False
        names = list(type(self).model_fields)
        mine = [self.__dict__.get(n) for n in names]
        theirs = [other.__dict__.get(n) for n in names]
        return mine == theirs and self._extras() == other._extras()

    __hash__ = None

    def __repr__(self):
        shown = [(n, self.__dict__.get(n)) for n in type(self).model_fields] + list(self._extras().items())
        return f"{type(self).__name__}({', '.join(f'{k}={v!r}' for k, v in shown)})"

    def model_copy(self, *, update: Optional[dict] = None, deep: bool = False):
        """A copy with the fields of ``update`` replaced, unvalidated (as
        pydantic's ``model_copy``)."""
        out = copy.deepcopy(self) if deep else copy.copy(self)
        out.__dict__.update(update or {})
        return out



__all__ = ["Field", "Model", "model_validator"]
