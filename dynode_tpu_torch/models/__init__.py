"""Model families of the port (the multi-strain SEIRS so far)."""

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

__all__ = [
    "MultiStrainParams",
    "default_contact_matrix",
    "multistrain_default_params",
    "multistrain_initial_state",
    "multistrain_ode",
    "multistrain_ode_ensemble",
    "multistrain_ensemble_state",
    "multistrain_ensemble_params",
]
