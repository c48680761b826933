"""Strain: the per-variant epidemiological parameter record.

Port of ``dynode_tpu/config/strains.py`` on :class:`~._model.Model`, field
for field. Fields are polymorphic, as pydantic's smart ``Union`` makes them:
plain numbers, numpy arrays or tensors for fixed values (a tensor, on the
card and with a graph, is kept as it is), a
:class:`dynode_tpu_torch.dist.Distribution` for a prior, or a
:class:`DeterministicParameter` for a value linked to another site.
"""

import numpy as np
import torch

from .. import _validate as V
from ..dist import Distribution
from ..typing import DynodeName
from ._model import Field, Model
from .axes import AgeBin
from .links import DeterministicParameter

#: ``jax.typing.ArrayLike``'s members, in its order, a tensor for a jax.Array
ARRAY_LIKE = (
    V.instance_of(torch.Tensor),
    V.instance_of(np.ndarray),
    V.instance_of(np.bool_),
    V.instance_of(np.number),
    V.bool_,
    V.int_,
    V.float_,
    V.complex_,
)
_DISTRIBUTION = V.instance_of(Distribution)
_LINK = V.instance_of(DeterministicParameter)


class Strain(Model):
    """A pathogen variant, optionally introduced from an external population.

    - ``strain_name``: no leading numbers or special characters.
    - ``r0``: reproduction number; transmission rate = r0 / infectious_period.
    - ``infectious_period``: mean days an infectious person stays infectious.
    - ``exposed_to_infectious``: mean days from exposure to onward
      transmission (the E -> I latent period); None for SIR-style models.
    - ``vaccine_efficacy``: tracked dose count -> protection in [0, 1]
      against infection by this strain, before waning.
    - ``is_introduced``: whether the strain seeds into the population from
      untracked external mixing during the simulation.
    - ``introduction_time``, ``introduction_percentage``,
      ``introduction_scale``: sim-day (or date, or prior) of the peak of
      external mixing, the external population relative to the tracked one,
      and the standard deviation in days of the normal-shaped pulse.
    - ``introduction_ages``: the external population's age bins;
      ``introduction_ages_mask_vector`` is filled by ``SimulationConfig``.
    """

    strain_name = Field(DynodeName)
    r0 = Field(V.union(V.NonNegativeFloat, *ARRAY_LIKE, _DISTRIBUTION, _LINK))
    infectious_period = Field(V.union(V.PositiveFloat, *ARRAY_LIKE, _DISTRIBUTION))
    exposed_to_infectious = Field(V.optional(V.PositiveFloat), None)
    vaccine_efficacy = Field(V.optional(V.dict_of(V.int_, V.NonNegativeFloat)), None)
    is_introduced = Field(V.bool_, False)
    introduction_time = Field(
        V.optional(V.union(V.date_, V.NonNegativeFloat, *ARRAY_LIKE, _DISTRIBUTION, _LINK)), None)
    introduction_percentage = Field(
        V.optional(V.union(V.PositiveFloat, *ARRAY_LIKE, _DISTRIBUTION, _LINK)), None)
    introduction_scale = Field(
        V.optional(V.union(V.PositiveFloat, *ARRAY_LIKE, _DISTRIBUTION, _LINK)), None)
    introduction_ages = Field(V.optional(V.list_of(V.model(AgeBin))), None)
    introduction_ages_mask_vector = Field(V.optional(V.list_of(V.int_)), None)


__all__ = ["Strain"]
