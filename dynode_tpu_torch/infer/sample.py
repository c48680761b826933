"""Recursive sampling/resolution of Distribution and DeterministicParameter.

Port of ``dynode_tpu/infer/sample.py``: the object-to-tensor bridge at the
top of every model's ``get_odeparams``. It walks nested dicts, config
:class:`~dynode_tpu_torch.config._model.Model` objects (pydantic's
``BaseModel`` in the JAX package) and lists, sampling Distribution leaves
as named sites and resolving DeterministicParameter links, with the
reference's site names: path segments joined by underscores, e.g.
``strains_0_r0``. ``dict(model)`` walks a model's fields in declaration
order, as pydantic does, so the sites come in the JAX package's order.
"""

from copy import deepcopy
from typing import Any, Optional, Union

import numpy as np

from ..config import DeterministicParameter
from ..config._model import Model
from ..dist import Distribution
from . import handlers


def sample_distributions(obj: Any, rng_key=None, _prefix: str = ""):
    """Recursively replace every Distribution in ``obj`` with a named sample.

    Naming rules: dict/model fields append ``{key}_``; list/array elements
    append ``{i}_``; the trailing underscore is stripped at the leaf. If
    ``obj`` itself is a Distribution its sample is returned directly.
    ``rng_key``: a ``torch.Generator`` for sites outside any handler.
    """
    if isinstance(obj, (Model, dict)):
        as_dict = dict(obj)
        for key, value in as_dict.items():
            as_dict[key] = sample_distributions(value, rng_key=rng_key, _prefix=f"{_prefix}{key}_")
        return as_dict if isinstance(obj, dict) else obj.__class__(**as_dict)
    if isinstance(obj, (np.ndarray, list)):
        return [sample_distributions(item, rng_key=rng_key, _prefix=f"{_prefix}{i}_") for i, item in enumerate(obj)]
    if isinstance(obj, Distribution):
        site = _prefix[:-1] if _prefix else _prefix
        return handlers.sample(site, obj, rng_key=rng_key)
    return obj


def resolve_deterministic(obj: Any, root_params: Union[dict, Model], _prefix: str = ""):
    """Recursively resolve DeterministicParameter links against ``root_params``.

    Each resolved value is recorded as a deterministic trace site under the
    same path-joined name the sampler would have used. Dependencies must be
    top-level keys of ``root_params``.
    """
    if isinstance(root_params, Model):
        root_params = dict(root_params)
    if isinstance(obj, (Model, dict)):
        as_dict = dict(obj)
        for key, value in as_dict.items():
            as_dict[key] = resolve_deterministic(value, root_params, _prefix=f"{_prefix}{key}_")
        return as_dict if isinstance(obj, dict) else obj.__class__(**as_dict)
    if isinstance(obj, (np.ndarray, list)):
        return [resolve_deterministic(item, root_params, _prefix=f"{_prefix}{i}_") for i, item in enumerate(obj)]
    if isinstance(obj, DeterministicParameter):
        site = _prefix[:-1] if _prefix else _prefix
        return handlers.deterministic(site, obj.resolve(root_params))
    return obj


def sample_then_resolve(parameters: Any, rng_key: Optional[Any] = None, _prefix: str = ""):
    """deepcopy -> sample -> resolve; returns a fully concrete copy.

    The deepcopy keeps the chains of a bank (and repeated calls) from
    sharing mutable config state (the reference's rationale,
    ``src/dynode/infer/sample.py:190``).
    """
    parameters = deepcopy(parameters)
    parameters = sample_distributions(parameters, rng_key=rng_key, _prefix=_prefix)
    return resolve_deterministic(parameters, root_params=dict(parameters), _prefix=_prefix)


__all__ = ["sample_distributions", "resolve_deterministic", "sample_then_resolve"]
