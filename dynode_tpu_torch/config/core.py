"""Compartment and SimulationConfig: the top of the config object graph.

Port of ``dynode_tpu/config/core.py`` on :class:`~._model.Model`. The
cached ``idx`` namespaces are plain Python ints with attributes: static
metadata that models keep as a static field of their parameter dataclass.
"""

from functools import cached_property
from types import SimpleNamespace
from typing import List

from .. import _validate as V
from ..typing import DynodeName
from ._model import Field, Model, model_validator
from .axes import (
    AgeBin,
    Bin,
    Dimension,
    FullStratifiedImmuneHistoryDimension,
    ImmuneHistoryDimension,
    LastStrainImmuneHistoryDimension,
)
from .initializer import Initializer
from .params import Params


class _IndexInt(int):
    """An int subclass that can also carry attribute namespaces.

    Lets ``config.idx.s`` act both as the integer compartment index and as a
    namespace (``config.idx.s.age.young``).
    """

    def __new__(cls, value, **attributes):
        obj = super().__new__(cls, value)
        for key, val in attributes.items():
            setattr(obj, key, val)
        return obj

    def __str__(self):
        return str(self.__dict__)


class Compartment(Model):
    """A named tensor of population counts, one axis per Dimension."""

    name = Field(DynodeName)
    dimensions = Field(V.list_of(V.model(Dimension)))

    @model_validator
    def _dimension_names_unique(self):
        names = [d.name for d in self.dimensions]
        if len(set(names)) != len(names):
            raise ValueError(
                "you can not have two identically named dimensions within a compartment"
            )
        return self

    @property
    def shape(self) -> tuple:
        """Tensor shape: one extent per dimension."""
        return tuple(len(d) for d in self.dimensions)

    @cached_property
    def idx(self) -> SimpleNamespace:
        """dimension-name -> (axis index carrying bin-name -> bin index).

        Cached: later mutations of the compartment do not refresh it.
        """
        ns = SimpleNamespace()
        for axis, dim in enumerate(self.dimensions):
            setattr(ns, dim.name, _IndexInt(axis, **dim.idx.__dict__))
        return ns

    def __eq__(self, other) -> bool:
        """Structural equality: same name and same ordered dimensions."""
        if not isinstance(other, Compartment):
            return False
        if self.name != other.name:
            return False
        if len(self.dimensions) != len(other.dimensions):
            return False
        return all(a == b for a, b in zip(self.dimensions, other.dimensions))

    __hash__ = None


class SimulationConfig(Model):
    """The full model description: initializer + compartments + parameters."""

    initializer = Field(V.model(Initializer))
    compartments = Field(V.list_of(V.model(Compartment)))
    parameters = Field(V.model(Params))

    @cached_property
    def idx(self) -> SimpleNamespace:
        """compartment-name -> (tuple index carrying dimension namespaces).

        Cached once; static metadata of the models' parameters.
        """
        ns = SimpleNamespace()
        for i, compartment in enumerate(self.compartments):
            setattr(ns, compartment.name, _IndexInt(i, **compartment.idx.__dict__))
        return ns

    # ---- checks, in the reference's order ----------------------------------

    @model_validator
    def _no_duplicate_compartment_names(self):
        names = [c.name for c in self.compartments]
        dupes = {n for n in names if names.count(n) > 1}
        if len(dupes) != 0:
            raise ValueError(
                f"you can not have two identically named compartments, "
                f"found shared names: {dupes}"
            )
        return self

    @model_validator
    def _shared_dimension_names_agree(self):
        seen: dict = {}
        for dim in self.flatten_dims():
            if dim.name in seen:
                if dim != seen[dim.name]:
                    raise ValueError(
                        f"dimension {dim.name} has different definitions across "
                        "different compartments, if this intended, make the "
                        "dimensions have different names"
                    )
            else:
                seen[dim.name] = dim
        return self

    @model_validator
    def _immune_histories_match_strains(self):
        strains = self.parameters.transmission_params.strains
        for dim in self.flatten_dims():
            if isinstance(dim, ImmuneHistoryDimension):
                if not isinstance(
                    dim, (FullStratifiedImmuneHistoryDimension, LastStrainImmuneHistoryDimension)
                ):
                    raise ValueError(f"unknown immune history dimension {type(dim).__name__}")
                # regenerating the dimension from the config's strains must
                # reproduce it exactly
                if type(dim)(strains) != dim:
                    raise ValueError(
                        "Found immune states that dont correlate with strains "
                        "from transmission_params"
                    )
        return self

    @model_validator
    def _encode_introduction_age_masks(self):
        strains = self.parameters.transmission_params.strains
        if any(s.introduction_ages is not None for s in strains):
            age_bins: list = []
            for dim in self.flatten_dims():
                if isinstance(dim.bins[0], AgeBin):
                    age_bins = dim.bins
                    break
            if not len(age_bins) > 0:
                raise ValueError(
                    "attempted to encode introduction_ages but could not "
                    "find any age structure in the compartments"
                )
            for strain in strains:
                if strain.introduction_ages is not None:
                    mask = [1 if b in strain.introduction_ages else 0 for b in age_bins]
                else:
                    mask = [0] * len(age_bins)
                strain.introduction_ages_mask_vector = mask
        return self

    @model_validator
    def _introduced_strain_ages_exist(self):
        age_structure = [b for b in self.flatten_bins() if isinstance(b, AgeBin)]
        for strain in self.parameters.transmission_params.strains:
            targets = strain.introduction_ages
            if strain.is_introduced and targets is not None:
                if not all(t in age_structure for t in targets):
                    raise ValueError(
                        f"{strain.strain_name} attempts to introduce itself using "
                        f"{targets} age bins, but those are not found "
                        "within the age structure of the model."
                    )
        return self

    # ---- accessors --------------------------------------------------------

    def get_compartment(self, compartment_name: str) -> Compartment:
        """Return the compartment with this name or raise AssertionError."""
        for c in self.compartments:
            if c.name == compartment_name:
                return c
        raise AssertionError(
            "Compartment with name %s not found in model, found only these "
            "names: %s" % (compartment_name, str([c.name for c in self.compartments]))
        )

    def flatten_bins(self) -> List[Bin]:
        """All bins of all dimensions of all compartments, order-preserving."""
        return [b for c in self.compartments for d in c.dimensions for b in d.bins]

    def flatten_dims(self) -> List[Dimension]:
        """All dimensions of all compartments, order-preserving."""
        return [d for c in self.compartments for d in c.dimensions]


__all__ = ["Compartment", "SimulationConfig"]
