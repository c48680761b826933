"""State files, ``InferenceData`` files and checkpoint sites of the port.

- ``save_pytree`` / ``load_pytree`` round trips (exact), the refusal of a
  file the JAX package wrote (its treedef is a pickle), and a saved warm
  start that resumes a chain as an unbroken run (equal draws).
- ``InferenceData.to_npz`` / ``from_npz``, read across packages both ways.
- ``checkpoint_compartment_sizes`` against the JAX package on the same
  float64 solve: the same sites in the same order, values within 1e-12.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynode_tpu.infer as jinfer
from dynode_tpu import simulate as j_simulate
from dynode_tpu.models import sir as jsir
from dynode_tpu_torch import dist, simulate
from dynode_tpu_torch.infer import (
    MCMC,
    NUTS,
    ChEES,
    checkpoint_compartment_sizes,
    from_dynode,
    handlers,
    load_mcmc_warm_start,
    load_pytree,
    save_mcmc,
    save_pytree,
)
from dynode_tpu_torch.infer.chees import ChEESBankState
from dynode_tpu_torch.infer.hmc import HMCState
from dynode_tpu_torch.infer.idata import InferenceData
from dynode_tpu_torch.models import sir as tsir

F64 = torch.float64


def _same(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def test_save_and_load_pytree_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    state = HMCState(*(torch.as_tensor(rng.normal(size=(3, 2))) for _ in range(4)),
                     torch.zeros(3, dtype=torch.int32), torch.tensor([True, False, True]), torch.rand(3))
    tree = {
        "state": state,
        "bank": ChEESBankState(*state[:6], torch.zeros(3, dtype=torch.bool), iter_idx=7),
        "params": {"auto_loc": torch.tensor([0.5, -1.0], dtype=torch.float32), "half": torch.ones(2, dtype=torch.bfloat16)},
        "mixed": [1, 2.5, True, None, (np.arange(3), np.zeros((2, 1), np.float32))],
    }
    path = str(tmp_path / "tree.npz")
    save_pytree(path, tree)
    back = load_pytree(path, device="cpu")
    _same(back, tree)
    assert set(np.load(path).files) == {"__treedef__"} | {f"leaf_{i}" for i in range(len(np.load(path).files) - 1)}
    with pytest.raises(TypeError, match="leaf"):
        save_pytree(path, {"x": object()})


def test_a_file_of_the_jax_package_names_the_converter(tmp_path):
    path = str(tmp_path / "jax.npz")
    jinfer.save_pytree(path, {"z": jnp.ones(3)})
    with pytest.raises(ValueError, match="convert.warm_start_from_numpy"):
        load_pytree(path, device="cpu")


MU = np.array([1.0, -2.0])


def model():
    handlers.sample("x", dist.Normal(torch.as_tensor(MU), torch.tensor([1.0, 0.5], dtype=F64)))


@pytest.mark.parametrize("kernel", ["nuts", "chees"])
def test_a_saved_warm_start_resumes_as_an_unbroken_run(kernel, tmp_path):
    """Warmup and 10 draws in one run equal warmup and 4 draws, then the
    saved state reloaded and 6 more draws from the same generator."""
    def make(samples):
        k = NUTS(model, max_tree_depth=3) if kernel == "nuts" else ChEES(model, trajectory_length=1.0)
        return MCMC(k, num_warmup=12, num_samples=samples, num_chains=4)

    unbroken = make(10)
    unbroken.run(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    head = make(4)
    head.run(gen)
    path = str(tmp_path / "run.npz")
    save_mcmc(path, head)
    warm = load_mcmc_warm_start(path, device="cpu")
    assert type(warm[0]) is type(head.warm_start_state()[0])
    tail = make(6)
    tail.run(gen, warm_start=warm)
    joined = torch.cat([head.get_samples(group_by_chain=True)["x"], tail.get_samples(group_by_chain=True)["x"]], dim=1)
    assert torch.equal(joined, unbroken.get_samples(group_by_chain=True)["x"])
    saved = load_pytree(path, device="cpu")
    assert torch.equal(saved["samples"]["x"], head.get_samples(group_by_chain=True)["x"])
    assert sorted(saved["extra_fields"]) == sorted(head.get_extra_fields(group_by_chain=True))


def test_inference_data_files_cross_packages(tmp_path):
    rng = np.random.default_rng(1)
    groups = dict(posterior={"mu": rng.normal(size=(2, 5))}, log_likelihood={"y": rng.normal(size=(10, 3))},
                  prior={}, observed_data={"y": np.arange(3.0)})
    mine = from_dynode(**{k: {s: torch.as_tensor(v) for s, v in g.items()} for k, g in groups.items()}, note="a")
    theirs = jinfer.from_dynode(**groups, note="a")
    for writer, reader in ((mine, jinfer.InferenceData), (theirs, InferenceData)):
        path = str(tmp_path / f"{type(writer).__module__}.npz")
        writer.to_npz(path)
        back = reader.from_npz(path)
        assert back.groups() == writer.groups() == ["posterior", "prior", "log_likelihood", "observed_data"]
        assert back.attrs == {"note": "a"}
        for g in back.groups():
            for site, arr in getattr(writer, g).items():
                np.testing.assert_array_equal(getattr(back, g)[site], arr)
    assert repr(mine) == repr(theirs)
    try:
        import arviz  # noqa: F401
    except ImportError:  # as here and on the card's machine: the refusal points to to_npz
        with pytest.raises(ImportError, match="to_npz"):
            mine.to_arviz()


def test_checkpoint_sites_match_jax():
    dates = [datetime.date(2022, 2, 20), datetime.date(2021, 1, 1), datetime.date(2022, 3, 1), datetime.date(2030, 1, 1)]
    j_cfg, t_cfg = jsir.sir_age_config(), tsir.sir_age_config()
    strain = t_cfg.parameters.transmission_params.strains[0]
    contact = t_cfg.parameters.transmission_params.contact_matrix
    j_sol = j_simulate(jsir.sir_ode, 40, j_cfg.initializer.get_initial_state(),
                       jsir.SIRParams(beta=jnp.asarray(strain.r0 / strain.infectious_period),
                                      gamma=jnp.asarray(1.0 / strain.infectious_period),
                                      contact_matrix=jnp.asarray(contact.numpy())), j_cfg.parameters.solver_params)
    t_sol = simulate(tsir.sir_ode, 40, t_cfg.initializer.get_initial_state(dtype=F64, device="cpu"),
                     tsir.SIRParams(beta=torch.tensor(strain.r0 / strain.infectious_period, dtype=F64),
                                    gamma=torch.tensor(1.0 / strain.infectious_period, dtype=F64), contact_matrix=contact),
                     t_cfg.parameters.solver_params)
    with jinfer.handlers.trace() as jtr:
        jinfer.checkpoint_compartment_sizes(j_cfg, j_sol, compartment_save_dates=dates)
    with handlers.trace() as ttr:
        checkpoint_compartment_sizes(t_cfg, t_sol, compartment_save_dates=dates)
    assert list(ttr) == list(jtr) and len(ttr) == 9  # final + two dates in range, three compartments
    for name in jtr:
        assert ttr[name]["type"] == "deterministic"
        np.testing.assert_allclose(ttr[name]["value"].numpy(), np.asarray(jtr[name]["value"]), rtol=1e-12)
    with handlers.trace() as none:
        checkpoint_compartment_sizes(t_cfg, t_sol, save_final_timesteps=False, compartment_save_dates=dates[1:2])
    assert not none
