"""Model families of the port: SIR, SEIRS (plain and seasonally forced), the
multi-strain SEIRS and the production SEIP, each with its config, its
initializer and, where the JAX package has one, its ODE parameters from a
config."""

from .multistrain import (
    MultiStrainInitializer,
    MultiStrainParams,
    multistrain_config,
    multistrain_odeparams,
    default_contact_matrix,
    multistrain_default_params,
    multistrain_ensemble_params,
    multistrain_ensemble_state,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_ode_ensemble,
)
from .seip import (
    SEIPInitializer,
    SEIPParams,
    seip_config,
    seip_odeparams,
    seip_default_params,
    seip_ensemble_params,
    seip_ensemble_state,
    seip_initial_state,
    seip_ode,
    seip_ode_ensemble,
)
from .seirs import (
    SEIRSParams,
    seirs_config,
    seirs_ode,
    seirs_seasonal_config,
    seirs_seasonal_ode,
)
from .sir import SIRParams, sir_age_config, sir_config, sir_ode

__all__ = [
    "SIRParams",
    "sir_config",
    "sir_age_config",
    "sir_ode",
    "SEIRSParams",
    "seirs_config",
    "seirs_ode",
    "seirs_seasonal_config",
    "seirs_seasonal_ode",
    "MultiStrainParams",
    "MultiStrainInitializer",
    "multistrain_config",
    "multistrain_odeparams",
    "default_contact_matrix",
    "multistrain_default_params",
    "multistrain_initial_state",
    "multistrain_ode",
    "multistrain_ode_ensemble",
    "multistrain_ensemble_state",
    "multistrain_ensemble_params",
    "SEIPParams",
    "SEIPInitializer",
    "seip_config",
    "seip_odeparams",
    "seip_default_params",
    "seip_initial_state",
    "seip_ode",
    "seip_ode_ensemble",
    "seip_ensemble_state",
    "seip_ensemble_params",
]
