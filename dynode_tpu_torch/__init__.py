"""DynODE-TPU ported to PyTorch and CUDA for an NVIDIA H100.

A second package beside ``dynode_tpu`` (JAX, the reference), ported slice by
slice. So far it holds the distributions (:mod:`.dist`, sampled with a
``torch.Generator``), the config layer without pydantic (:mod:`.config`),
the ODE engine (:mod:`.ode`: the RK solvers, controllers and
:func:`diffeqsolve`), :func:`simulate` and :func:`simulate_ensemble`
(:mod:`.simulation`), the multi-strain SEIRS and SEIP models with their
config-based constructors (:mod:`.models`), the carry-over of JAX values
(:mod:`.convert`), the six ensemble kernels with their plain versions
(:mod:`.ops`) and Bayesian inference (:mod:`.infer`: handlers, NUTS and
ChEES over a bank of chains, ``MCMC``, SVI, ``Predictive``, the fit
processes ``MCMCProcess`` and ``SVIProcess``, state files, model
comparison, forecast bands, diagnostics), the stiff solvers (:mod:`.ode`'s
``TRBDF2``, ``ImplicitEuler``), meshes of devices and process groups
(:mod:`.parallel`) and the utilities (:mod:`.utils`: logging, epiweeks,
profiling, the kernels' build directory, the plotting helpers of
``utils.vis_utils``). Constructors put
their tensors on the card unless given ``device="cpu"``. The package imports ``torch`` and never ``jax`` or
``pydantic``.
"""

from . import config, convert, dist, infer, models, ode, ops, parallel, simulation, struct, utils
from .config import (
    AgeBin,
    Bin,
    Compartment,
    DeterministicParameter,
    Dimension,
    DiscretizedPositiveIntBin,
    FullStratifiedImmuneHistoryDimension,
    ImmuneHistoryDimension,
    Initializer,
    LastStrainImmuneHistoryDimension,
    Params,
    PlaceholderSample,
    SamplePlaceholderError,
    SimulationConfig,
    SolverParams,
    Strain,
    TransmissionParams,
    VaccinationDimension,
    WaneBin,
    WaneDimension,
    get_dynode_init_date_flag,
    set_dynode_init_date_flag,
    simulation_day,
)
from .infer import (
    InferenceProcess,
    MCMCProcess,
    SVIProcess,
    checkpoint_compartment_sizes,
    resolve_deterministic,
    sample_distributions,
    sample_then_resolve,
)
from .models.multistrain import (
    MultiStrainInitializer,
    MultiStrainParams,
    multistrain_config,
    multistrain_default_params,
    multistrain_initial_state,
    multistrain_ode,
    multistrain_odeparams,
)
from .models.seip import (
    SEIPInitializer,
    SEIPParams,
    seip_config,
    seip_default_params,
    seip_initial_state,
    seip_ode,
    seip_odeparams,
)
from .struct import pytree_dataclass
from .typing import (
    CompartmentGradients,
    CompartmentState,
    CompartmentTimeseries,
    DynodeName,
    ObservedData,
    ODE_Eqns,
    UnitIntervalFloat,
)
from .utils import (
    CustomLogFormatter,
    VisualizationError,
    base_equation,
    conditional_knots,
    date_to_epi_week,
    date_to_sim_day,
    drop_keys_with_substring,
    enable_compilation_cache,
    evaluate_cubic_spline,
    flatten_list_parameters,
    identify_distribution_indexes,
    log_decorator,
    logger,
    plot_checkpoint_inference_correlation_pairs,
    plot_mcmc_chains,
    plot_model_overview_subplot_matplotlib,
    plot_posterior_density,
    plot_prior_distributions,
    plot_violin_plots,
    sim_day_to_date,
    sim_day_to_epiweek,
    use_logging,
    vectorize_objects,
    vis_utils,
)
from .ode import diffeqsolve
from .ops import (
    ensemble_solve_kernel,
    ensemble_solve_kernel_adaptive,
    ensemble_solve_tsit5,
    ensemble_solve_tsit5_2d,
    seip_ensemble_solve,
    seip_ensemble_solve_adaptive,
    unpack_saves,
    unpack_saves_2d,
)
from .simulation import AbstractODEParams, simulate, simulate_ensemble

__all__ = [
    "config",
    "convert",
    "dist",
    "infer",
    "models",
    "ode",
    "ops",
    "parallel",
    "simulation",
    "struct",
    "utils",
    "simulate",
    "simulate_ensemble",
    "AbstractODEParams",
    "sample_then_resolve",
    "resolve_deterministic",
    "sample_distributions",
    "InferenceProcess",
    "MCMCProcess",
    "SVIProcess",
    "checkpoint_compartment_sizes",
    "sim_day_to_date",
    "date_to_sim_day",
    "sim_day_to_epiweek",
    "date_to_epi_week",
    "log",
    "use_logging",
    "log_decorator",
    "CustomLogFormatter",
    "logger",
    "enable_compilation_cache",
    "SolverParams",
    "SimulationConfig",
    "Initializer",
    "Compartment",
    "Strain",
    "Dimension",
    "VaccinationDimension",
    "ImmuneHistoryDimension",
    "FullStratifiedImmuneHistoryDimension",
    "LastStrainImmuneHistoryDimension",
    "WaneDimension",
    "Bin",
    "WaneBin",
    "DiscretizedPositiveIntBin",
    "AgeBin",
    "Params",
    "TransmissionParams",
    "DeterministicParameter",
    "PlaceholderSample",
    "SamplePlaceholderError",
    "simulation_day",
    "set_dynode_init_date_flag",
    "get_dynode_init_date_flag",
    "pytree_dataclass",
    "CompartmentState",
    "CompartmentGradients",
    "CompartmentTimeseries",
    "DynodeName",
    "ObservedData",
    "ODE_Eqns",
    "UnitIntervalFloat",
    "base_equation",
    "conditional_knots",
    "evaluate_cubic_spline",
    "vectorize_objects",
    "flatten_list_parameters",
    "drop_keys_with_substring",
    "identify_distribution_indexes",
    "diffeqsolve",
    "MultiStrainParams",
    "MultiStrainInitializer",
    "SEIPParams",
    "SEIPInitializer",
    "multistrain_config",
    "multistrain_odeparams",
    "seip_config",
    "seip_odeparams",
    "multistrain_default_params",
    "multistrain_initial_state",
    "multistrain_ode",
    "seip_default_params",
    "seip_initial_state",
    "seip_ode",
    "seip_ensemble_solve",
    "seip_ensemble_solve_adaptive",
    "ensemble_solve_kernel",
    "ensemble_solve_kernel_adaptive",
    "ensemble_solve_tsit5",
    "ensemble_solve_tsit5_2d",
    "unpack_saves",
    "unpack_saves_2d",
]


def __getattr__(name):
    # the module alias the JAX package exports, resolved lazily
    if name == "log":
        from .utils import log as _log_module

        return _log_module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
