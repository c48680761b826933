"""SIR stratified by age x risk group (rank-2 compartments).

The port of examples/sir_age_risk_stratified.py: the age x risk contact
structure is a Kronecker product contracted against the rank-2 infectious
tensor in a single einsum::

    python examples_torch/sir_age_risk_stratified.py [--device cpu]

``steps_per_save=3`` bounds the solve's steps per day (it takes at most two
after the first day); it changes no step of the example's solve. On the card
the grid engine runs every step slot of a save interval, masked, so the
bound sets the card's work.
"""

import _bootstrap

from datetime import date

import torch

from dynode_tpu_torch import _device, pytree_dataclass, simulate
from dynode_tpu_torch import _validate as V
from dynode_tpu_torch.config import (
    Bin,
    Compartment,
    Dimension,
    Initializer,
    Params,
    SimulationConfig,
    SolverParams,
    Strain,
    TransmissionParams,
)
from dynode_tpu_torch.config._model import Field
from dynode_tpu_torch.simulation import AbstractODEParams
from dynode_tpu_torch.typing import CompartmentState

AGE_NAMES = ("young", "adult", "old")
RISK_NAMES = ("low", "high")
DAYS = 200


class AgeRiskInitializer(Initializer):
    """Splits the population over age x risk."""

    age_demographics = Field(V.sequence_of(V.float_), (0.4, 0.4, 0.2))
    risk_split = Field(V.sequence_of(V.float_), (0.8, 0.2))
    i0_prop = Field(V.float_, 0.01)

    def get_initial_state(self, *, dtype=torch.float32, device=None, **kwargs) -> CompartmentState:
        device = _device.resolve(device)
        demo = torch.outer(torch.tensor(self.age_demographics, dtype=dtype, device=device),
                           torch.tensor(self.risk_split, dtype=dtype, device=device))
        total = self.population_size * demo
        i0 = self.i0_prop * total
        s0 = total - i0
        return (s0, i0, torch.zeros_like(s0))


def get_config(r_0=2.0, infectious_period=7.0, n_age=3, n_risk=2) -> SimulationConfig:
    age_dim = Dimension(name="age", bins=[Bin(name=a) for a in AGE_NAMES[:n_age]])
    risk_dim = Dimension(name="risk", bins=[Bin(name=r) for r in RISK_NAMES[:n_risk]])
    dims = [age_dim, risk_dim]
    f64 = torch.float64  # get_odeparams casts to the solve's dtype
    age_contact = torch.full((n_age, n_age), 0.2, dtype=f64) + 0.5 * torch.eye(n_age, dtype=f64)
    # high-risk mixes more within itself
    risk_contact = torch.full((n_risk, n_risk), 0.4, dtype=f64) + 0.6 * torch.eye(n_risk, dtype=f64)
    # kron contact: C[a,r,a',r'] = age_contact[a,a'] * risk_contact[r,r']
    contact = torch.einsum("ij,kl->ikjl", age_contact, risk_contact)
    return SimulationConfig(
        compartments=[
            Compartment(name="s", dimensions=dims),
            Compartment(name="i", dimensions=dims),
            Compartment(name="r", dimensions=dims),
        ],
        initializer=AgeRiskInitializer(
            description="age x risk proportional initializer",
            initialize_date=date(2022, 2, 11),
            population_size=10000,
            age_demographics=[0.4, 0.4, 0.2][:n_age],
            risk_split=[0.8, 0.2][:n_risk],
        ),
        parameters=Params(
            solver_params=SolverParams(steps_per_save=3),
            transmission_params=TransmissionParams(
                strains=[Strain(strain_name="flu", r0=r_0, infectious_period=infectious_period)],
                strain_interactions={"flu": {"flu": 1.0}},
                contact_matrix=contact,
            ),
        ),
    )


@pytree_dataclass
class AgeRiskParams(AbstractODEParams):
    beta: torch.Tensor
    gamma: torch.Tensor
    contact_matrix: torch.Tensor  # (A, R, A, R)


def sir_age_risk_ode(t, state: CompartmentState, p: AgeRiskParams):
    s, i, r = state  # each (A, R)
    n = s + i + r
    # foi[a,r] = beta * sum_{a',r'} C[a,r,a',r'] * i[a',r'] / N[a',r']
    foi = p.beta * torch.einsum("arkl,kl->ar", p.contact_matrix, i / n)
    s_to_i = s * foi
    i_to_r = p.gamma * i
    return (-s_to_i, s_to_i - i_to_r, i_to_r)


def get_odeparams(config: SimulationConfig, *, dtype=torch.float32, device=None) -> AgeRiskParams:
    strain = config.parameters.transmission_params.strains[0]
    device = _device.resolve(device)
    return AgeRiskParams(
        beta=torch.tensor(strain.r0 / strain.infectious_period, dtype=dtype, device=device),
        gamma=torch.tensor(1.0 / strain.infectious_period, dtype=dtype, device=device),
        contact_matrix=config.parameters.transmission_params.contact_matrix.to(dtype=dtype, device=device),
    )


def run(device, dtype=torch.float32) -> dict:
    """The example's solve: S, I and R by age and risk over 200 days."""
    config = get_config()
    sol = simulate(
        ode=sir_age_risk_ode,
        duration_days=DAYS,
        initial_state=config.initializer.get_initial_state(dtype=dtype, device=device),
        ode_parameters=get_odeparams(config, dtype=dtype, device=device),
        solver_parameters=config.parameters.solver_params,
    )
    s, i, r = sol.ys  # (T, A, R)
    return {"ts": sol.ts, "s": s, "i": i, "r": r}


def draw(plt, out):
    fig, ax = plt.subplots()
    for a, aname in enumerate(AGE_NAMES):
        for k, rname in enumerate(RISK_NAMES):
            ax.plot(out["ts"], out["i"][:, a, k], label=f"I {aname}/{rname}")
    ax.legend()
    ax.set_xlabel("Days")
    ax.set_title("Age x Risk Stratified SIR (dynode_tpu_torch)")
    return fig


if __name__ == "__main__":
    args = _bootstrap.parse_args(__doc__)
    out = run(args.device, args.dtype)
    print("peak infectious by group:", out["i"].amax(dim=0))
    _bootstrap.save("sir_age_risk", out, draw)
