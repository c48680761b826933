"""Model families of the port: the multi-strain SEIRS and the production SEIP."""

from .multistrain import (
    MultiStrainParams,
    default_contact_matrix,
    multistrain_default_params,
    multistrain_ensemble_params,
    multistrain_ensemble_state,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_ode_ensemble,
)
from .seip import (
    SEIPParams,
    seip_default_params,
    seip_ensemble_params,
    seip_ensemble_state,
    seip_initial_state,
    seip_ode,
    seip_ode_ensemble,
)

__all__ = [
    "MultiStrainParams",
    "default_contact_matrix",
    "multistrain_default_params",
    "multistrain_initial_state",
    "multistrain_ode",
    "multistrain_ode_ensemble",
    "multistrain_ensemble_state",
    "multistrain_ensemble_params",
    "SEIPParams",
    "seip_default_params",
    "seip_initial_state",
    "seip_ode",
    "seip_ode_ensemble",
    "seip_ensemble_state",
    "seip_ensemble_params",
]
