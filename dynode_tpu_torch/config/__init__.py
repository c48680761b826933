"""Configuration layer of the port: validated config classes without pydantic.

Port of ``dynode_tpu/config``, with the same public names: bins,
dimensions, strains, parameter containers, compartments, the top-level
``SimulationConfig`` with its cached ``idx`` namespaces, the abstract
``Initializer``, ``DeterministicParameter`` links, ``PlaceholderSample``
and the process-level init-date flag helpers. The classes are plain
Python (:mod:`._model`, :mod:`dynode_tpu_torch._validate`) that accept,
coerce and refuse values as the JAX package's pydantic models do.
"""

from .axes import (
    AgeBin,
    Bin,
    Dimension,
    DiscretizedPositiveIntBin,
    FullStratifiedImmuneHistoryDimension,
    ImmuneHistoryDimension,
    LastStrainImmuneHistoryDimension,
    VaccinationDimension,
    WaneBin,
    WaneDimension,
)
from .core import Compartment, SimulationConfig
from .dates import (
    get_dynode_init_date_flag,
    set_dynode_init_date_flag,
    simulation_day,
)
from .initializer import Initializer
from .links import (
    DeterministicParameter,
    PlaceholderSample,
    SamplePlaceholderError,
)
from .params import Params, SolverParams, TransmissionParams
from .strains import Strain

__all__ = [
    "Bin",
    "AgeBin",
    "DiscretizedPositiveIntBin",
    "WaneBin",
    "Dimension",
    "VaccinationDimension",
    "ImmuneHistoryDimension",
    "FullStratifiedImmuneHistoryDimension",
    "LastStrainImmuneHistoryDimension",
    "WaneDimension",
    "Strain",
    "Params",
    "SolverParams",
    "TransmissionParams",
    "Compartment",
    "SimulationConfig",
    "Initializer",
    "DeterministicParameter",
    "PlaceholderSample",
    "SamplePlaceholderError",
    "get_dynode_init_date_flag",
    "set_dynode_init_date_flag",
    "simulation_day",
]
