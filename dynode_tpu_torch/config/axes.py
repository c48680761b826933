"""Bins and Dimensions: the axis vocabulary of compartment tensors.

Port of ``dynode_tpu/config/axes.py`` on :class:`~._model.Model`: bins are
the atomic cells of an axis; dimensions are named, validated lists of
same-typed bins with an ``idx`` namespace for readable indexing. The
reference's validator ``assert``s are ``ValueError``s with its messages;
the ``assert``s of its constructors are explicit ``AssertionError``s, as
they are there.
"""

import math
from itertools import combinations
from types import SimpleNamespace
from typing import TYPE_CHECKING, List

from .. import _validate as V
from ..typing import DynodeName
from ._model import Field, Model, model_validator

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (strains uses AgeBin)
    from .strains import Strain

# ---------------------------------------------------------------------------
# Bins
# ---------------------------------------------------------------------------


class Bin(Model):
    """One cell of a dimension (e.g. an age band, a waning stage)."""

    name = Field(DynodeName)


class DiscretizedPositiveIntBin(Bin):
    """A bin covering the inclusive integer range [min_value, max_value]."""

    min_value = Field(V.NonNegativeInt)
    max_value = Field(V.NonNegativeInt)

    def __init__(self, min_value, max_value, name=None):
        """Default the bin name to ``range_{min}_{max}`` when not given."""
        if name is None:
            name = f"range_{min_value}_{max_value}"
        super().__init__(name=name, min_value=min_value, max_value=max_value)

    @model_validator
    def _check_ordering(self):
        if not self.min_value <= self.max_value:
            raise ValueError(
                f"min_value {self.min_value} must not exceed max_value {self.max_value}"
            )
        return self


class AgeBin(DiscretizedPositiveIntBin):
    """Integer age band; auto-named ``a{min}_{max}``."""

    def __init__(self, min_value, max_value, name=None):
        if name is None:
            name = f"a{min_value}_{max_value}"
        super().__init__(name=name, min_value=min_value, max_value=max_value)


class WaneBin(Bin):
    """A waning stage with mean residence time and retained protection.

    ``waiting_time``: mean days spent in the bin before waning onward
    (``math.inf``: the population never wanes out); ``base_protection``:
    the fraction of immune protection retained, in [0, 1].
    """

    waiting_time = Field(V.PositiveFloat)
    base_protection = Field(V.constrained(V.float_, ge=0, le=1.0))


# ---------------------------------------------------------------------------
# Dimensions
# ---------------------------------------------------------------------------


def _bins_nonempty_and_homogeneous(bins):
    if not len(bins) > 0:
        raise ValueError("can not have dimension with no bins")
    first_type = type(bins[0])
    if not all(type(b) is first_type for b in bins):
        raise ValueError(
            "can not instantiate dimension with mixed type bins. "
            f"Found list of types {[type(b) for b in bins]}"
        )
    return bins


def _bin_names_unique(bins):
    names = [b.name for b in bins]
    if len(set(names)) != len(names):
        raise ValueError("Dimension of categorical bins must have unique bin names.")
    return bins


def _int_bins_sorted_disjoint(bins):
    if bins and all(isinstance(b, DiscretizedPositiveIntBin) for b in bins):
        in_order = sorted(bins, key=lambda b: b.min_value)
        if bins != in_order:
            raise ValueError(
                f"Any dimension made up of DiscretizedIntBins must be sorted, got {bins}"
            )
        if not all(bins[i].max_value < bins[i + 1].min_value for i in range(len(bins) - 1)):
            raise ValueError("DiscretizedPositiveIntBin within a dimension can not overlap.")
    return bins


def _int_bins_gapless(bins):
    if bins and all(isinstance(b, DiscretizedPositiveIntBin) for b in bins):
        for left, right in zip(bins, bins[1:]):
            if left.max_value + 1 != right.min_value:
                raise ValueError(
                    "dimensions containing DiscretizedPositiveIntBin can not "
                    f"have gaps between them, found one between {left} and {right}"
                )
    return bins


class Dimension(Model):
    """A named axis of a compartment tensor, composed of bins."""

    name = Field(DynodeName)
    bins = Field(
        V.list_of(V.model(Bin)),
        after=(_bins_nonempty_and_homogeneous, _bin_names_unique,
               _int_bins_sorted_disjoint, _int_bins_gapless),
    )

    def __len__(self):
        return len(self.bins)

    @property
    def idx(self) -> SimpleNamespace:
        """Namespace mapping each bin name to its integer index."""
        ns = SimpleNamespace()
        for i, b in enumerate(self.bins):
            setattr(ns, b.name, i)
        return ns


class VaccinationDimension(Dimension):
    """Ordinal vaccine-dose axis ``v0..vK``, optionally with a seasonal dose."""

    seasonal_vaccination = Field(V.bool_, False)

    def __init__(
        self,
        max_ordinal_vaccinations: int,
        seasonal_vaccination: bool = False,
        name="vax",
    ):
        doses = max_ordinal_vaccinations + (1 if seasonal_vaccination else 0)
        bins: list = [
            DiscretizedPositiveIntBin(name=f"v{k}", min_value=k, max_value=k)
            for k in range(doses + 1)
        ]
        super().__init__(name=name, bins=bins)
        self.seasonal_vaccination = seasonal_vaccination

    @property
    def max_shots(self) -> int:
        """Highest tracked dose count (the v0 bin is not a shot)."""
        return len(self.bins) - 1


class ImmuneHistoryDimension(Dimension):
    """Marker base class for axes tracking post-infection immunity."""


class FullStratifiedImmuneHistoryDimension(ImmuneHistoryDimension):
    """All 2^N subsets of strains ever recovered from, plus ``none``."""

    def __init__(self, strains: List["Strain"], name="hist") -> None:
        if not len(strains) > 0:
            raise AssertionError("Must pass at least one strain to immune history dimension.")
        names = [s.strain_name for s in strains]
        bins = [Bin(name="none")]
        for size in range(1, len(names) + 1):
            bins.extend(Bin(name="_".join(c)) for c in combinations(names, size))
        super().__init__(name=name, bins=bins)


class LastStrainImmuneHistoryDimension(ImmuneHistoryDimension):
    """Only the most recent infecting strain is tracked (N+1 bins)."""

    def __init__(self, strains: List["Strain"], name="hist") -> None:
        if not len(strains) > 0:
            raise AssertionError("Must pass at least one strain to immune history dimension.")
        bins = [Bin(name="none")] + [Bin(name=s.strain_name) for s in strains]
        super().__init__(name=name, bins=bins)


class WaneDimension(Dimension):
    """Waning chain ``W0..Wn``; the final bin must never wane (inf wait)."""

    def __init__(self, waiting_times, base_protections, name="wane"):
        if not len(waiting_times) > 0:
            raise AssertionError("Wane dimension must have at least one bin.")
        if len(waiting_times) != len(base_protections):
            raise AssertionError("must pass equal length wait times and base protections")
        bins: list = [
            WaneBin(name=f"W{i}", waiting_time=w, base_protection=p)
            for i, (w, p) in enumerate(zip(waiting_times, base_protections))
        ]
        super().__init__(name=name, bins=bins)

    @model_validator
    def _last_bin_never_wanes(self):
        last = self.bins[-1]
        if not isinstance(last, WaneBin):
            raise ValueError(f"the last bin of a wane dimension is a {type(last).__name__}")
        if not math.isinf(last.waiting_time):
            raise ValueError("last wane bin should have math.inf waiting time")
        return self


__all__ = [
    "Bin",
    "DiscretizedPositiveIntBin",
    "AgeBin",
    "WaneBin",
    "Dimension",
    "VaccinationDimension",
    "ImmuneHistoryDimension",
    "FullStratifiedImmuneHistoryDimension",
    "LastStrainImmuneHistoryDimension",
    "WaneDimension",
]
