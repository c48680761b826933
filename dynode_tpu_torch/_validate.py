"""Field validators that do what pydantic's lax mode does, without pydantic.

A validator is a callable ``v(value) -> (coerced, exactness)`` that raises
``ValueError`` (pydantic's ``ValidationError`` is one) for a value it
refuses. ``exactness`` is :data:`EXACT`, :data:`STRICT` or :data:`LAX`, as
pydantic-core grades a match: a ``float`` given to a float field is exact,
an ``int`` is strict, a string or a ``bool`` is lax. :func:`union` uses it
as pydantic's smart-mode ``Union`` does: the first exact member wins at
once, else the best-graded success, the earliest on a tie. So
``Union[NonNegativeFloat, ArrayLike, ...]`` keeps ``2`` as the int ``2``
(the ``int`` member is exact) and takes ``-1`` (refused by the constrained
float, taken by ``int``).

The coercions are pydantic 2's: numeric strings and bytes become numbers,
integral floats become ints, ``"yes"``/``"off"``/``0``/``1`` become bools,
midnight datetimes and ISO strings become dates, and any iterable but a
string or mapping becomes a list.
"""

from __future__ import annotations

import datetime
import math
import numbers
from collections import deque
from collections.abc import Mapping
from typing import Any, Callable, Tuple

EXACT, STRICT, LAX = 2, 1, 0

Validator = Callable[[Any], Tuple[Any, int]]

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _refuse(kind: str, value) -> ValueError:
    return ValueError(f"Input should be {kind}, got {value!r}")


def _text(value):
    """``value`` as text when it is a string or bytes, else None."""
    if isinstance(value, str):
        return value
    if isinstance(value, (bytes, bytearray)):
        try:
            return bytes(value).decode()
        except UnicodeDecodeError:
            raise _refuse("valid UTF-8 bytes", value) from None
    return None


def _number(value) -> float:
    """``float(value)`` for an object with ``__float__`` or ``__index__``
    (Python's ``PyFloat_AsDouble``); raises ``ValueError`` otherwise."""
    if isinstance(value, (str, bytes, bytearray, complex)):
        raise _refuse("a valid number", value)
    try:
        return float(value)
    except (TypeError, ValueError, OverflowError, RuntimeError):
        raise _refuse("a valid number", value) from None


def _integral(value: float, original) -> int:
    if not math.isfinite(value) or not float(value).is_integer():
        raise _refuse("a valid integer", original)
    return int(value)


def float_(value):
    """pydantic's ``float``."""
    if type(value) is float:
        return value, EXACT
    text = _text(value)
    if text is not None:
        try:
            return float(text.strip()), LAX
        except ValueError:
            raise _refuse("a valid number", value) from None
    number = _number(value)
    return number, LAX if isinstance(value, bool) else STRICT


def int_(value):
    """pydantic's ``int``."""
    if type(value) is int:
        return value, EXACT
    if isinstance(value, int):  # bool or another int subclass
        return int(value), LAX if isinstance(value, bool) else STRICT
    text = _text(value)
    if text is not None:
        text = text.strip()
        try:
            return int(text), LAX
        except ValueError:
            pass
        head, dot, tail = text.partition(".")
        if dot and head and tail.strip("0") == "":
            try:
                return int(head), LAX
            except ValueError:
                pass
        raise _refuse("a valid integer", value)
    return _integral(_number(value), value), LAX


def bool_(value):
    """pydantic's ``bool``."""
    if isinstance(value, bool):
        return value, EXACT
    text = _text(value)
    if text is not None:
        if text.lower() in _TRUE | _FALSE:
            return text.lower() in _TRUE, LAX
        raise _refuse("a valid boolean", value)
    if isinstance(value, numbers.Integral) or hasattr(type(value), "__index__"):
        try:
            as_int = int(value)
        except (TypeError, ValueError):
            raise _refuse("a valid boolean", value) from None
    else:
        as_int = _integral(_number(value), value)
    if as_int in (0, 1):
        return bool(as_int), LAX
    raise _refuse("a valid boolean", value)


def complex_(value):
    """pydantic's ``complex``: a complex, or (lax) a string, float or int."""
    if isinstance(value, complex):
        return complex(value), STRICT
    if isinstance(value, str):
        try:
            return complex(value.strip().replace(" ", "")), LAX
        except ValueError:
            raise _refuse("a valid complex number", value) from None
    if type(value) in (float, int):
        return complex(value), LAX
    raise _refuse("a valid complex number", value)


def str_(value):
    """pydantic's ``str``: a string, or (lax) UTF-8 bytes."""
    if type(value) is str:
        return value, EXACT
    if isinstance(value, str):
        return str(value), STRICT
    if isinstance(value, (bytes, bytearray)):
        return _text(value), LAX
    raise _refuse("a valid string", value)


def date_(value):
    """pydantic's ``datetime.date``: a date; (lax) a midnight datetime, an
    ISO date string, or a Unix time of a whole day."""
    if type(value) is datetime.date:
        return value, EXACT
    if isinstance(value, datetime.datetime):
        if value.time() != datetime.time(0):
            raise _refuse("a date (a datetime with zero time)", value)
        return value.date(), LAX
    if isinstance(value, datetime.date):
        return datetime.date(value.year, value.month, value.day), STRICT
    text = _text(value)
    if text is not None:
        try:
            return datetime.date.fromisoformat(text.strip()), LAX
        except ValueError:
            raise _refuse("a valid date", value) from None
    if isinstance(value, bool) or not isinstance(value, numbers.Real):
        raise _refuse("a valid date", value)
    seconds = float(value)
    if abs(seconds) > 2e10:  # pydantic reads large Unix times as milliseconds
        seconds /= 1000.0
    if not math.isfinite(seconds) or seconds % 86400 != 0:
        raise _refuse("a date (a Unix time of a whole day)", value)
    return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(seconds // 86400)), LAX


def constrained(base: Validator, *, gt=None, ge=None, lt=None, le=None) -> Validator:
    """``base`` with pydantic's numeric bounds; NaN fails every bound."""

    def check(value):
        out, exactness = base(value)
        for bound, ok, sign in ((gt, lambda v, b: v > b, ">"), (ge, lambda v, b: v >= b, ">="),
                                (lt, lambda v, b: v < b, "<"), (le, lambda v, b: v <= b, "<=")):
            if bound is not None and not ok(out, bound):
                raise ValueError(f"Input should be {sign} {bound}, got {value!r}")
        return out, exactness

    return check


def instance_of(*types) -> Validator:
    """An arbitrary type: the value itself when it is an instance (exact)."""

    def check(value):
        if isinstance(value, types):
            return value, EXACT
        raise _refuse(f"an instance of {' or '.join(t.__name__ for t in types)}", value)

    check.instance_types = types
    return check


def model(cls) -> Validator:
    """A model field: an instance passes as it is; a mapping builds one
    through ``cls.model_validate`` (the fields, not a custom ``__init__``)."""

    def check(value):
        if isinstance(value, cls):
            return value, EXACT
        if isinstance(value, Mapping):
            return cls.model_validate(value), LAX
        raise _refuse(f"a valid {cls.__name__}", value)

    check.instance_types = (cls,)
    return check


#: the types whose instances a scalar validator may take exactly
_PLAIN = (float, int, bool, str, datetime.date)


def union(*members: Validator) -> Validator:
    """pydantic's smart-mode ``Union`` over ``members``, in order.

    A value of another type than those of :data:`_PLAIN` is taken exactly
    only by an instance member (:func:`instance_of`, :func:`model`), so the
    first one that holds it wins at once, without the numeric members
    trying it first (which would copy a tensor on the card to the host)."""

    def check(value):
        if type(value) not in _PLAIN:
            for member in members:
                types = getattr(member, "instance_types", None)
                if types is not None and isinstance(value, types):
                    return value, EXACT
        best = None
        errors = []
        for member in members:
            try:
                out, exactness = member(value)
            except ValueError as e:
                errors.append(str(e))
                continue
            if exactness == EXACT:
                return out, EXACT
            if best is None or exactness > best[1]:
                best = (out, exactness)
        if best is not None:
            return best
        raise ValueError(f"no member of the union takes {value!r}: {'; '.join(errors)}")

    return check


def optional(member: Validator) -> Validator:
    """``Optional[member]``: None, or what ``member`` takes."""

    def check(value):
        if value is None:
            return None, EXACT
        return member(value)

    return check


def _items(value):
    if isinstance(value, (str, bytes, bytearray, Mapping)) or value is None:
        raise _refuse("a valid list", value)
    try:
        return list(value)
    except TypeError:
        raise _refuse("a valid list", value) from None


def list_of(item: Validator) -> Validator:
    """``List[item]``: any iterable but a string or mapping, as a list."""

    def check(value):
        return [item(x)[0] for x in _items(value)], STRICT

    return check


def sequence_of(item: Validator) -> Validator:
    """``Sequence[item]``: a list or tuple, kept as its own kind."""

    def check(value):
        if not isinstance(value, (list, tuple, deque)):
            raise _refuse("a valid sequence", value)
        out = [item(x)[0] for x in value]
        return type(value)(out) if not isinstance(value, list) else out, STRICT

    return check


def dict_of(key: Validator, val: Validator) -> Validator:
    """``dict[key, val]``: any mapping, as a dict of coerced items."""

    def check(value):
        if not isinstance(value, Mapping):
            raise _refuse("a valid dictionary", value)
        return {key(k)[0]: val(v)[0] for k, v in value.items()}, STRICT

    return check


def before(fn: Callable[[Any], Any], member: Validator) -> Validator:
    """pydantic's ``BeforeValidator``: ``fn`` sees the raw value first."""

    def check(value):
        return member(fn(value))

    return check


#: pydantic's constrained number aliases
PositiveFloat = constrained(float_, gt=0)
NonNegativeFloat = constrained(float_, ge=0)
PositiveInt = constrained(int_, gt=0)
NonNegativeInt = constrained(int_, ge=0)

__all__ = [
    "EXACT",
    "STRICT",
    "LAX",
    "float_",
    "int_",
    "bool_",
    "complex_",
    "str_",
    "date_",
    "constrained",
    "instance_of",
    "model",
    "union",
    "optional",
    "list_of",
    "sequence_of",
    "dict_of",
    "before",
    "PositiveFloat",
    "NonNegativeFloat",
    "PositiveInt",
    "NonNegativeInt",
]
