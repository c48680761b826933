"""The port's config layer against the JAX package's pydantic models, on the CPU.

Every case builds the same object through ``dynode_tpu.config`` (pydantic)
and ``dynode_tpu_torch.config`` (plain classes) and asks for the same
outcome: both refuse (pydantic's ``ValidationError`` is a ``ValueError``;
other exceptions by type), or both take the value with the same coerced
values, types and field order (``dict(model)``, the walk of inference's
site naming). The cases are those of ``tests/test_config/`` plus edge
values of each validated field. The model constructors are held to the
JAX package's in float64 bit for bit, and ``bench_nuts.py``'s lane-major
potential and its gradient to JAX's within 1e-10 (float64, 8 chains, 10
days).
"""

import datetime
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_nuts
import chip_smoke
import dynode_tpu
import dynode_tpu.config as jc
import dynode_tpu.dist as jd
import dynode_tpu_torch
import dynode_tpu_torch.config as tc
import dynode_tpu_torch.dist as tdist
from dynode_tpu.models import multistrain as jms
from dynode_tpu.models import seip as jseip
from dynode_tpu_torch.models import multistrain as tms
from dynode_tpu_torch.models import seip as tseip
from dynode_tpu_torch.utils import utils as tutils
from dynode_tpu.utils import utils as jutils

J = SimpleNamespace(c=jc, d=jd, ode=dynode_tpu.ode, ms=jms, seip=jseip)
T = SimpleNamespace(c=tc, d=tdist, ode=dynode_tpu_torch.ode, ms=tms, seip=tseip)
DAY = datetime.date(2022, 1, 1)


def _norm(x):
    """A comparable form of a config value: type names, coerced values and
    the order of ``dict(model)``."""
    if isinstance(x, (jc.Bin.__mro__[1], tc.Bin.__mro__[1])):  # pydantic BaseModel / the port's Model
        return ("model", type(x).__name__, tuple((k, _norm(v)) for k, v in dict(x).items()))
    if isinstance(x, SimpleNamespace):
        return ("namespace", tuple((k, _norm(v)) for k, v in vars(x).items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_norm(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((_norm(k), _norm(v)) for k, v in x.items()))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, repr(x.tolist()))
    if isinstance(x, (jax.Array, torch.Tensor)):  # the device arrays of each package
        return ("array", repr(np.asarray(x).tolist()))
    if isinstance(x, (jd.Distribution, tdist.Distribution)):
        return ("distribution", type(x).__name__)
    if isinstance(x, (jc.DeterministicParameter, tc.DeterministicParameter)):
        return ("link", x.depends_on, repr(x.index))
    if isinstance(x, (dynode_tpu.ode.AbstractSolver, dynode_tpu_torch.ode.AbstractSolver)):
        return ("solver", type(x).__name__)
    return (type(x).__name__, repr(x))


def _outcome(make, ns):
    try:
        return ("ok", _norm(make(ns)))
    except ValueError:
        return ("refused",)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return ("raised", type(e).__name__)


def _strain(ns, name="x", **kw):
    return ns.c.Strain(**{"strain_name": name, "r0": 2.0, "infectious_period": 7.0, **kw})


def _params(ns, strains=None, **extras):
    strains = strains or [_strain(ns)]
    names = [s.strain_name for s in strains]
    return ns.c.Params(
        solver_params=ns.c.SolverParams(),
        transmission_params=ns.c.TransmissionParams(
            strains=strains, strain_interactions={a: {b: 1.0 for b in names} for a in names}, **extras),
    )


def _age_dim(ns):
    return ns.c.Dimension(name="age", bins=[ns.c.AgeBin(0, 17), ns.c.AgeBin(18, 99)])


def _init(ns):
    return ns.c.Initializer(description="test", initialize_date=DAY, population_size=100)


def _config(ns, compartments, params=None):
    return ns.c.SimulationConfig(compartments=compartments, initializer=_init(ns), parameters=params or _params(ns))


def _intro(ns, name, ages):
    return _strain(ns, name, is_introduced=True, introduction_time=30.0, introduction_percentage=0.01,
                   introduction_scale=4.0, introduction_ages=ages)


#: the cases of tests/test_config/, as functions of a namespace of modules
MODEL_CASES = {
    "bin": lambda ns: ns.c.Bin(name="young"),
    "int_bin_autoname": lambda ns: ns.c.DiscretizedPositiveIntBin(5, 10),
    "int_bin_named": lambda ns: ns.c.DiscretizedPositiveIntBin(0, 4, name="kids"),
    "int_bin_reversed": lambda ns: ns.c.DiscretizedPositiveIntBin(11, 10),
    "int_bin_single": lambda ns: ns.c.DiscretizedPositiveIntBin(3, 3),
    "int_bin_negative": lambda ns: ns.c.DiscretizedPositiveIntBin(-1, 3, name="neg"),
    "age_bin": lambda ns: ns.c.AgeBin(0, 17),
    "wane_bin": lambda ns: ns.c.WaneBin(name="W0", waiting_time=70.0, base_protection=0.5),
    "wane_bin_inf": lambda ns: ns.c.WaneBin(name="Wl", waiting_time=math.inf, base_protection=0.1),
    "wane_bin_protection_high": lambda ns: ns.c.WaneBin(name="W0", waiting_time=10.0, base_protection=1.5),
    "wane_bin_wait_negative": lambda ns: ns.c.WaneBin(name="W0", waiting_time=-1.0, base_protection=0.5),
    "dimension": lambda ns: ns.c.Dimension(name="age", bins=[ns.c.Bin(name="young"), ns.c.Bin(name="old")]),
    "dimension_empty": lambda ns: ns.c.Dimension(name="age", bins=[]),
    "dimension_mixed": lambda ns: ns.c.Dimension(name="x", bins=[ns.c.Bin(name="a"), ns.c.AgeBin(0, 5)]),
    "dimension_duplicate": lambda ns: ns.c.Dimension(name="x", bins=[ns.c.Bin(name="a"), ns.c.Bin(name="a")]),
    "dimension_unsorted": lambda ns: ns.c.Dimension(name="age", bins=[ns.c.AgeBin(18, 64), ns.c.AgeBin(0, 17)]),
    "dimension_overlap": lambda ns: ns.c.Dimension(name="age", bins=[ns.c.AgeBin(0, 18), ns.c.AgeBin(18, 64)]),
    "dimension_gap": lambda ns: ns.c.Dimension(name="age", bins=[ns.c.AgeBin(0, 17), ns.c.AgeBin(19, 64)]),
    "dimension_ages": lambda ns: ns.c.Dimension(
        name="age", bins=[ns.c.AgeBin(0, 17), ns.c.AgeBin(18, 64), ns.c.AgeBin(65, 99)]),
    "dimension_bins_from_dicts": lambda ns: ns.c.Dimension(name="x", bins=[{"name": "a"}, {"name": "b"}]),
    "dimension_bins_tuple": lambda ns: ns.c.Dimension(name="x", bins=(ns.c.Bin(name="a"),)),
    "dimension_bins_not_bins": lambda ns: ns.c.Dimension(name="x", bins=["a"]),
    "vaccination": lambda ns: ns.c.VaccinationDimension(max_ordinal_vaccinations=2),
    "vaccination_seasonal": lambda ns: ns.c.VaccinationDimension(2, seasonal_vaccination=True),
    "history_full": lambda ns: ns.c.FullStratifiedImmuneHistoryDimension(
        [_strain(ns, "x"), _strain(ns, "y")]),
    "history_full_three": lambda ns: ns.c.FullStratifiedImmuneHistoryDimension(
        [_strain(ns, n) for n in "abc"]),
    "history_last": lambda ns: ns.c.LastStrainImmuneHistoryDimension([_strain(ns, "x"), _strain(ns, "y")]),
    "history_marker": lambda ns: ns.c.ImmuneHistoryDimension(name="hist", bins=[ns.c.Bin(name="none")]),
    "config_history_marker": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[
            ns.c.ImmuneHistoryDimension(name="hist", bins=[ns.c.Bin(name="none")])])]),
    "history_full_empty": lambda ns: ns.c.FullStratifiedImmuneHistoryDimension([]),
    "history_last_empty": lambda ns: ns.c.LastStrainImmuneHistoryDimension([]),
    "wane": lambda ns: ns.c.WaneDimension(waiting_times=[70.0, 70.0, math.inf], base_protections=[1.0, 0.5, 0.1]),
    "wane_finite_last": lambda ns: ns.c.WaneDimension(waiting_times=[70.0, 80.0], base_protections=[1.0, 0.5]),
    "wane_unequal_lists": lambda ns: ns.c.WaneDimension(waiting_times=[70.0], base_protections=[1.0, 0.5]),
    "wane_empty": lambda ns: ns.c.WaneDimension(waiting_times=[], base_protections=[]),
    "strain_distribution": lambda ns: _strain(ns, r0=ns.d.Normal(2.0, 0.2)),
    "strain_link": lambda ns: _strain(ns, r0=ns.c.DeterministicParameter("other")),
    "strain_array": lambda ns: _strain(ns, r0=np.array([2.0, 2.5])),
    "strain_full": lambda ns: _strain(ns, exposed_to_infectious=3.0, vaccine_efficacy={0: 0.0, 1: 0.5},
                                      is_introduced=True, introduction_time=DAY, introduction_percentage=0.02,
                                      introduction_scale=ns.d.HalfNormal(1.0),
                                      introduction_ages=[ns.c.AgeBin(0, 17)]),
    "strain_unknown_keyword_dropped": lambda ns: _strain(ns, colour="red"),
    "strain_missing_r0": lambda ns: ns.c.Strain(strain_name="x", infectious_period=7.0),
    "transmission": lambda ns: ns.c.TransmissionParams(
        strains=[_strain(ns, "a"), _strain(ns, "b")],
        strain_interactions={"a": {"a": 1.0, "b": 0.7}, "b": {"a": 0.7, "b": 1.0}}, contact_matrix=np.eye(2)),
    "transmission_missing_outer": lambda ns: ns.c.TransmissionParams(
        strains=[_strain(ns, "a"), _strain(ns, "b")], strain_interactions={"a": {"a": 1.0, "b": 1.0}}),
    "transmission_missing_inner": lambda ns: ns.c.TransmissionParams(
        strains=[_strain(ns, "a"), _strain(ns, "b")],
        strain_interactions={"a": {"a": 1.0}, "b": {"a": 1.0, "b": 1.0}}),
    "transmission_extra_strain": lambda ns: ns.c.TransmissionParams(
        strains=[_strain(ns, "a")], strain_interactions={"a": {"a": 1.0}, "ghost": {"a": 1.0}}),
    "transmission_empty": lambda ns: ns.c.TransmissionParams(strains=[], strain_interactions={}),
    "transmission_none": lambda ns: ns.c.TransmissionParams(strains=None, strain_interactions={}),
    "transmission_latent_some": lambda ns: ns.c.TransmissionParams(
        strains=[_strain(ns, "a", exposed_to_infectious=3.0), _strain(ns, "b")],
        strain_interactions={"a": {"a": 1.0, "b": 1.0}, "b": {"a": 1.0, "b": 1.0}}),
    "transmission_efficacy_some": lambda ns: ns.c.TransmissionParams(
        strains=[_strain(ns, "a", vaccine_efficacy={0: 0.0, 1: 0.5}), _strain(ns, "b")],
        strain_interactions={"a": {"a": 1.0, "b": 1.0}, "b": {"a": 1.0, "b": 1.0}}),
    "transmission_intro_ages_differ": lambda ns: ns.c.TransmissionParams(
        strains=[_intro(ns, "a", [ns.c.AgeBin(0, 17)]), _intro(ns, "b", [ns.c.AgeBin(18, 99)])],
        strain_interactions={"a": {"a": 1.0, "b": 1.0}, "b": {"a": 1.0, "b": 1.0}}),
    "transmission_interaction_values": lambda ns: ns.c.TransmissionParams(
        strains=[_strain(ns, "a")], strain_interactions={"a": {"a": "0.5"}}),
    "transmission_interaction_negative": lambda ns: ns.c.TransmissionParams(
        strains=[_strain(ns, "a")], strain_interactions={"a": {"a": -0.5}}),
    "params": lambda ns: _params(ns),
    "params_solver_from_dict": lambda ns: ns.c.Params(
        solver_params={"max_steps": "10"}, transmission_params=_params(ns).transmission_params),
    "compartment": lambda ns: ns.c.Compartment(name="s", dimensions=[_age_dim(ns)]),
    "compartment_duplicate_dims": lambda ns: ns.c.Compartment(name="s", dimensions=[_age_dim(ns), _age_dim(ns)]),
    "config": lambda ns: _config(ns, [ns.c.Compartment(name="s", dimensions=[_age_dim(ns)]),
                                      ns.c.Compartment(name="i", dimensions=[_age_dim(ns)])]),
    "config_duplicate_compartments": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[_age_dim(ns)]),
             ns.c.Compartment(name="s", dimensions=[_age_dim(ns)])]),
    "config_dimensions_disagree": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[_age_dim(ns)]),
             ns.c.Compartment(name="i", dimensions=[ns.c.Dimension(name="age", bins=[ns.c.AgeBin(0, 99)])])]),
    "config_history": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[
            ns.c.FullStratifiedImmuneHistoryDimension([_strain(ns, "a"), _strain(ns, "b")])])],
        params=_params(ns, [_strain(ns, "a"), _strain(ns, "b")])),
    "config_history_wrong": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[ns.c.FullStratifiedImmuneHistoryDimension([_strain(ns, "z")])])],
        params=_params(ns, [_strain(ns, "a"), _strain(ns, "b")])),
    "config_last_history_wrong": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[ns.c.LastStrainImmuneHistoryDimension([_strain(ns, "a")])])],
        params=_params(ns, [_strain(ns, "a"), _strain(ns, "b")])),
    "config_intro_mask": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[_age_dim(ns)])],
        params=_params(ns, [_strain(ns, "a"), _intro(ns, "b", [ns.c.AgeBin(0, 17)])])),
    "config_intro_ages_missing": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[_age_dim(ns)])],
        params=_params(ns, [_intro(ns, "a", [ns.c.AgeBin(40, 49)])])),
    "config_intro_no_ages_in_model": lambda ns: _config(
        ns, [ns.c.Compartment(name="s", dimensions=[ns.c.Dimension(name="x", bins=[ns.c.Bin(name="a")])])],
        params=_params(ns, [_intro(ns, "a", [ns.c.AgeBin(0, 17)])])),
    "initializer": _init,
    "solver_params": lambda ns: ns.c.SolverParams(solver_method=ns.ode.Bosh3(), discontinuity_points=(1, "2")),
    "multistrain_config": lambda ns: ns.ms.multistrain_config(),
    "seip_config": lambda ns: ns.seip.seip_config(seasonal_vaccination=True),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_config_cases_match_pydantic(case):
    """Each case of ``tests/test_config/``: refused by both, or built by
    both with the same fields, values and types."""
    assert _outcome(MODEL_CASES[case], T) == _outcome(MODEL_CASES[case], J)


#: edge values of the validated fields: numbers, numeric and other strings,
#: numpy scalars and arrays, bools, None, containers, dates
EDGE_VALUES = [2, 2.0, -1, -1.5, 0, 0.0, True, False, "2", "2.0", "-1", "-1.5", " 3 ", "true", "1e3", "inf", "nan",
               "x", "", float("nan"), float("inf"), -float("inf"), 1 + 0j, "1+2j", np.float32(2), np.float64(2.5),
               np.float64(-1), np.int64(3), np.int32(-2), np.bool_(True), np.array(2.0), np.array([1.0, 2.0]),
               None, b"2", [1.0], (1.0,), DAY, datetime.datetime(2022, 1, 1), datetime.datetime(2022, 1, 1, 5),
               "2022-01-01", 86400, {"a": 1}]

#: field -> a function making a model with that field set to ``v``
FIELDS = {
    "Strain.r0": lambda ns, v: _strain(ns, r0=v),
    "Strain.infectious_period": lambda ns, v: _strain(ns, infectious_period=v),
    "Strain.exposed_to_infectious": lambda ns, v: _strain(ns, exposed_to_infectious=v),
    "Strain.is_introduced": lambda ns, v: _strain(ns, is_introduced=v),
    "Strain.introduction_time": lambda ns, v: _strain(ns, introduction_time=v),
    "Strain.introduction_percentage": lambda ns, v: _strain(ns, introduction_percentage=v),
    "Strain.introduction_scale": lambda ns, v: _strain(ns, introduction_scale=v),
    "Strain.vaccine_efficacy": lambda ns, v: _strain(ns, vaccine_efficacy={1: v}),
    "Strain.introduction_ages_mask_vector": lambda ns, v: _strain(ns, introduction_ages_mask_vector=[v]),
    "Strain.strain_name": lambda ns, v: _strain(ns, name=v),
    "AgeBin.min_value": lambda ns, v: ns.c.DiscretizedPositiveIntBin(v, 200, name="b"),
    "WaneBin.waiting_time": lambda ns, v: ns.c.WaneBin(name="w", waiting_time=v, base_protection=0.5),
    "WaneBin.base_protection": lambda ns, v: ns.c.WaneBin(name="w", waiting_time=1.0, base_protection=v),
    "Initializer.population_size": lambda ns, v: ns.c.Initializer(
        description="d", initialize_date=DAY, population_size=v),
    "Initializer.initialize_date": lambda ns, v: ns.c.Initializer(
        description="d", initialize_date=v, population_size=1),
    "Initializer.description": lambda ns, v: ns.c.Initializer(description=v, initialize_date=DAY, population_size=1),
    "TransmissionParams.strain_interactions": lambda ns, v: ns.c.TransmissionParams(
        strains=[_strain(ns, "a")], strain_interactions={"a": {"a": v}}),
    "SolverParams.constant_step_size": lambda ns, v: ns.c.SolverParams(constant_step_size=v),
    "SolverParams.max_steps": lambda ns, v: ns.c.SolverParams(max_steps=v),
    "SolverParams.compensated_summation": lambda ns, v: ns.c.SolverParams(compensated_summation=v),
    "MultiStrainInitializer.s0_prop": lambda ns, v: ns.ms.MultiStrainInitializer(
        description="d", initialize_date=DAY, population_size=1, s0_prop=v),
}
FIELD_CASES = [(f, i) for f in FIELDS for i in range(len(EDGE_VALUES))]


@pytest.mark.parametrize("field, i", FIELD_CASES, ids=[f"{f}={EDGE_VALUES[i]!r}" for f, i in FIELD_CASES])
def test_field_coercions_match_pydantic(field, i):
    """Smart-mode unions and lax coercion, value by value: pydantic's
    choice decides (``r0=2`` stays the int 2, ``r0=-1`` is taken by the
    ``int`` member of ArrayLike, ``r0="true"`` by its ``bool``)."""
    make = FIELDS[field]
    value = EDGE_VALUES[i]
    assert _outcome(lambda ns: make(ns, value), T) == _outcome(lambda ns: make(ns, value), J)


def test_sequence_and_mapping_fields_match_pydantic():
    """``Sequence[float]`` keeps a list a list and a tuple a tuple;
    ``List`` takes any iterable; dict keys are coerced to int."""
    cases = [
        lambda ns: ns.ms.MultiStrainInitializer(description="d", initialize_date=DAY, population_size=1,
                                                age_demographics=(1, "2")),
        lambda ns: ns.ms.MultiStrainInitializer(description="d", initialize_date=DAY, population_size=1,
                                                age_demographics=[0.5, 0.5]),
        lambda ns: ns.ms.MultiStrainInitializer(description="d", initialize_date=DAY, population_size=1,
                                                age_demographics=np.array([0.5, 0.5])),
        lambda ns: ns.seip.SEIPInitializer(description="d", initialize_date=DAY, population_size=1,
                                           age_demographics="ab"),
        lambda ns: _strain(ns, vaccine_efficacy={"1": 0.5, 2.0: "0.3", True: 1}),
        lambda ns: _strain(ns, vaccine_efficacy={1.5: 0.1}),
        lambda ns: _strain(ns, vaccine_efficacy=[(1, 0.5)]),
        lambda ns: _strain(ns, introduction_ages=(ns.c.AgeBin(0, 4),)),
        lambda ns: _strain(ns, introduction_ages=[ns.c.Bin(name="a")]),
        lambda ns: ns.c.SolverParams(discontinuity_points=np.array([1.0, 2.0])),
        lambda ns: ns.c.SolverParams(discontinuity_points={1.0: 2.0}),
        lambda ns: ns.c.SolverParams(discontinuity_points="12"),
    ]
    for make in cases:
        assert _outcome(make, T) == _outcome(make, J)


def test_equality_is_by_fields_and_models_stay_mutable():
    """``==`` compares type and fields (a Dimension rebuilt equal, a subclass
    unequal); a mask written into a Strain stays; mutable defaults are not
    shared; ``type(m)(**dict(m))`` rebuilds and ``model_copy`` updates."""
    for ns in (T, J):
        a = ns.c.Dimension(name="age", bins=[ns.c.Bin(name="x")])
        assert a == ns.c.Dimension(name="age", bins=[ns.c.Bin(name="x")])
        assert a != ns.c.Dimension(name="age", bins=[ns.c.Bin(name="y")])
        assert ns.c.AgeBin(0, 5) != ns.c.DiscretizedPositiveIntBin(0, 5, name="a0_5")
        assert ns.c.Compartment(name="s", dimensions=[a]) != "s"
        s = _strain(ns)
        s.introduction_ages_mask_vector = [1, 0]
        assert s.introduction_ages_mask_vector == [1, 0] and _strain(ns).introduction_ages_mask_vector is None
        assert ns.c.SolverParams().discontinuity_points is not ns.c.SolverParams().discontinuity_points
        rebuilt = type(s)(**dict(s))
        assert rebuilt == s and rebuilt is not s
        sp = ns.c.SolverParams(step_budget=4)
        copy = sp.model_copy(update={"step_budget": 128})
        assert copy.step_budget == 128 and sp.step_budget == 4
    assert _norm(tc.SolverParams().model_copy(update={"max_steps": "x"})) == _norm(
        jc.SolverParams().model_copy(update={"max_steps": "x"}))  # neither validates an update


def test_idx_namespaces_and_accessors_match_jax():
    """``idx`` (an int carrying namespaces, cached into ``dict(config)``
    as pydantic does), ``get_compartment``, ``flatten_bins`` and
    ``flatten_dims`` of the SEIP config."""
    jcfg, tcfg = jseip.seip_config(seasonal_vaccination=True), tseip.seip_config(seasonal_vaccination=True)
    assert list(dict(tcfg)) == list(dict(jcfg))
    assert _norm(tcfg.idx) == _norm(jcfg.idx)
    assert list(dict(tcfg)) == list(dict(jcfg)) == ["initializer", "compartments", "parameters", "idx"]
    assert int(tcfg.idx.s) == 0 and tcfg.idx.s.hist == 1 and tcfg.idx.e.strain.delta == 1
    assert [c.shape for c in tcfg.compartments] == [c.shape for c in jcfg.compartments]
    assert _norm(tcfg.flatten_bins()) == _norm(jcfg.flatten_bins())
    assert _norm(tcfg.flatten_dims()) == _norm(jcfg.flatten_dims())
    for base, cfg in ((tc.Initializer, tcfg), (jc.Initializer, jcfg)):
        with pytest.raises(AssertionError):
            cfg.get_compartment("nope")
        with pytest.raises(NotImplementedError):
            base.get_initial_state(cfg.initializer)


def test_links_dates_and_utils_match_jax(monkeypatch):
    """DeterministicParameter, PlaceholderSample, the init-date flag and the
    helpers of ``utils/utils.py``."""
    for ns in (T, J):
        dp = ns.c.DeterministicParameter
        assert dp("x").resolve({"x": 5}) == 5
        assert dp("xs", index=slice(0, 2)).resolve({"xs": [10, 20, 30]}) == [10, 20]
        assert dp("x", transform=lambda v: v * 2).resolve({"x": 5}) == 10
        assert dp("xs", index=(0, 1)).resolve({"xs": np.array([[1, 2], [3, 4]])}) == 2
        with pytest.raises(Exception, match="missing"):
            dp("missing").resolve({"x": 1})
        with pytest.raises(ns.c.SamplePlaceholderError):
            ns.c.PlaceholderSample().sample(None)
    np.testing.assert_array_equal(tc.PlaceholderSample().log_prob(torch.ones(3)).numpy(),
                                  np.asarray(jc.PlaceholderSample().log_prob(jnp.ones(3))))
    monkeypatch.delenv(f"DYNODE_INITIALIZATION_DATE({__import__('os').getpid()})", raising=False)
    assert tc.get_dynode_init_date_flag() is None
    with pytest.raises(ValueError):
        tc.simulation_day(2022, 5, 1)
    tc.set_dynode_init_date_flag(datetime.date(2022, 2, 11))
    assert jc.get_dynode_init_date_flag() == tc.get_dynode_init_date_flag() == datetime.date(2022, 2, 11)
    assert tc.simulation_day(2022, 2, 1) == jc.simulation_day(2022, 2, 1) == -10
    monkeypatch.delenv(f"DYNODE_INITIALIZATION_DATE({__import__('os').getpid()})")
    strains_t = [_strain(T, "a", r0=1.5), _strain(T, "b", r0=tdist.Normal(0.0, 1.0))]
    assert tutils.vectorize_objects(strains_t, "r0", filter=lambda s: s.strain_name == "a") == [1.5]
    samples = {"x": np.arange(24.0).reshape(2, 3, 4), "y": np.ones((2, 3)), "z_drop": 1}
    got, want = tutils.flatten_list_parameters(samples), jutils.flatten_list_parameters(samples)
    assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in got)
    got = tutils.flatten_list_parameters({"x": torch.arange(24.0).reshape(2, 3, 4)})
    assert list(got) == [f"x_{i}" for i in range(4)]
    assert tutils.drop_keys_with_substring(dict(samples), "drop").keys() == jutils.drop_keys_with_substring(
        dict(samples), "drop").keys()
    params_t = {"test": [1.0, tdist.Normal(0.0, 1.0)], "r": tdist.HalfNormal(1.0), "n": 3}
    params_j = {"test": [1.0, jd.Normal(0.0, 1.0)], "r": jd.HalfNormal(1.0), "n": 3}
    assert tutils.identify_distribution_indexes(params_t) == jutils.identify_distribution_indexes(params_j)


#: the two multi-strain shapes of the kernels, (A, K) = (2, 3) and (3, 2)
MS_SHAPES = {
    "2x3": {},
    "3x2": dict(r0s=(2.0, 2.6), infectious_periods=(7.0, 5.0), latent_periods=(3.0, 2.0),
                waning_periods=(60.0, 90.0), strain_names=("A", "B"), age_names=("a", "b", "c"),
                age_demographics=(0.5, 0.3, 0.2)),
}
MS_FIELDS = ("beta", "sigma", "gamma", "omega", "contact_matrix")


@pytest.mark.parametrize("shape", list(MS_SHAPES))
def test_multistrain_odeparams_and_initializer_match_jax(shape):
    """``multistrain_odeparams`` and the initializer, float64, bit for bit;
    ``idx`` is the config's."""
    kw = MS_SHAPES[shape]
    jcfg, tcfg = jms.multistrain_config(**kw), tms.multistrain_config(**kw)
    jp, tp = jms.multistrain_odeparams(jcfg), tms.multistrain_odeparams(tcfg, dtype=torch.float64, device="cpu")
    for name in MS_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    assert _norm(tp.idx) == _norm(jp.idx) and tp.idx is tcfg.idx
    for got, want in zip(tms.multistrain_initial_state(tcfg, dtype=torch.float64, device="cpu"),
                         jms.multistrain_initial_state(jcfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seasonal", [True, False])
def test_seip_odeparams_and_initializer_match_jax(seasonal):
    """``seip_odeparams`` and the initializer, float64, bit for bit, with
    introduction ages encoded by the config (a mask, not all ages)."""
    kw = dict(seasonal_vaccination=seasonal)
    for strains in (None, "masked"):
        if strains:
            jstr = [_strain(J, "a", exposed_to_infectious=3.0, vaccine_efficacy={0: 0.1, 1: 0.4}),
                    _intro(J, "b", [jc.AgeBin(18, 49)]).model_copy(update={"exposed_to_infectious": 2.0,
                                                                          "vaccine_efficacy": {1: 0.5}})]
            tstr = [_strain(T, "a", exposed_to_infectious=3.0, vaccine_efficacy={0: 0.1, 1: 0.4}),
                    _intro(T, "b", [tc.AgeBin(18, 49)]).model_copy(update={"exposed_to_infectious": 2.0,
                                                                          "vaccine_efficacy": {1: 0.5}})]
            jcfg, tcfg = jseip.seip_config(jstr, **kw), tseip.seip_config(tstr, **kw)
        else:
            jcfg, tcfg = jseip.seip_config(**kw), tseip.seip_config(**kw)
        jp, tp = jseip.seip_odeparams(jcfg), tseip.seip_odeparams(tcfg, dtype=torch.float64, device="cpu")
        for f in tp.__dataclass_fields__:
            if f in ("idx", "seasonal_vaccination"):
                continue
            np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
        assert tp.seasonal_vaccination is jp.seasonal_vaccination is seasonal
        assert _norm(tp.idx) == _norm(jp.idx)
        for got, want in zip(tseip.seip_initial_state(tcfg, dtype=torch.float64, device="cpu"),
                             jseip.seip_initial_state(jcfg)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_config_free_twins_are_unchanged():
    """The config-free constructors keep their bits (the float64 formulas
    cast once) and their ``idx`` of None, and equal the config path."""
    p = tms.multistrain_default_params(device="cpu")
    r0, inf_p = np.asarray(tms.DEFAULT_R0S), np.asarray(tms.DEFAULT_INFECTIOUS_PERIODS)
    np.testing.assert_array_equal(p.beta.numpy(), (r0 / inf_p).astype(np.float32))
    np.testing.assert_array_equal(p.omega.numpy(), (1.0 / np.asarray(tms.DEFAULT_WANING_PERIODS)).astype(np.float32))
    np.testing.assert_array_equal(p.contact_matrix.numpy(), tms.default_contact_matrix(2).astype(np.float32))
    assert p.idx is None and tseip.seip_default_params(True, device="cpu").idx is None
    demo = np.asarray(tms.DEFAULT_AGE_DEMOGRAPHICS)
    y = tms.multistrain_initial_state(device="cpu")
    np.testing.assert_array_equal(y[0].numpy(), (1000.0 * 0.99 * demo).astype(np.float32))
    np.testing.assert_array_equal(y[2].numpy(), (1000.0 * 0.01 * demo[:, None] * (r0 / np.sum(r0))).astype(np.float32))
    cfg = tms.multistrain_config()
    q = tms.multistrain_odeparams(cfg, device="cpu")
    assert all(torch.equal(getattr(p, f), getattr(q, f)) for f in MS_FIELDS)
    assert all(torch.equal(a, b) for a, b in zip(y, tms.multistrain_initial_state(cfg, device="cpu")))
    sp, sq = tseip.seip_default_params(True, device="cpu"), tseip.seip_odeparams(
        tseip.seip_config(seasonal_vaccination=True), device="cpu")
    assert all(torch.equal(getattr(sp, f), getattr(sq, f)) for f in sp.__dataclass_fields__
               if f not in ("idx", "seasonal_vaccination"))


def test_sampled_config_keeps_tensors_and_their_graph():
    """A Strain.r0 drawn as a tensor with a graph stays that tensor in the
    config, and ``multistrain_odeparams`` and the initializer differentiate
    through it (d sum(beta) / d r0 = 1 / T_inf)."""
    loc = torch.tensor([2.0, 2.5, 1.8], dtype=torch.float64, requires_grad=True)
    r0 = tdist.TruncatedNormal(loc, 0.1, low=1.0).sample(torch.Generator().manual_seed(0))
    cfg = tms.multistrain_config(r0s=list(r0.unbind()))
    kept = [s.r0 for s in cfg.parameters.transmission_params.strains]
    assert all(isinstance(x, torch.Tensor) and x.grad_fn is not None for x in kept)
    p = tms.multistrain_odeparams(cfg, dtype=torch.float64, device="cpu")
    y = tms.multistrain_initial_state(cfg, dtype=torch.float64, device="cpu")
    (g_beta,) = torch.autograd.grad(p.beta.sum(), r0, retain_graph=True)
    np.testing.assert_allclose(g_beta.numpy(), 1.0 / np.asarray(tms.DEFAULT_INFECTIOUS_PERIODS), rtol=1e-15)
    (g_y,) = torch.autograd.grad(y[2][0, 0], r0)
    assert bool(torch.isfinite(g_y).all()) and float(g_y.abs().sum()) > 0


def test_lane_major_potential_matches_bench_nuts(monkeypatch):
    """``chip_smoke.fit_potential`` (the port's config and dist) against
    ``bench_nuts.build_lane_major_potential`` with ``DURATION`` at 10 days:
    the potential and its gradient on 8 chains within 1e-10, float64."""
    monkeypatch.setattr(bench_nuts, "DURATION", 10)
    obs = np.random.default_rng(3).poisson(5.0, (10, 2, 3)).astype(np.float64)
    z = np.random.default_rng(4).normal(0.0, 0.6, (8, 3))
    per_chain, vjp = jax.vjp(bench_nuts.build_lane_major_potential(obs), jnp.asarray(z))
    (want_grad,) = vjp(jnp.ones(8))  # chains are independent: the per-chain gradients
    fit = chip_smoke.fit_potential(obs, days=10, dtype=torch.float64, device="cpu")
    zt = torch.from_numpy(z).requires_grad_(True)
    got = fit.potential(zt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(per_chain), rtol=1e-10)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want_grad), rtol=1e-10)
