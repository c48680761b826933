"""Abstract Initializer: produces the t=0 compartment state.

Port of ``dynode_tpu/config/initializer.py``. Users subclass it and
implement ``get_initial_state`` for their data streams; see
``dynode_tpu_torch.models`` for concrete ones.
"""

from .. import _validate as V
from ..typing import CompartmentState
from ._model import Field, Model


class Initializer(Model):
    """Builds the initial CompartmentState of an ODE model.

    ``description``: what data streams and dates it covers;
    ``initialize_date``: sim day 0; ``population_size``: the total at t=0.
    """

    description = Field(V.str_)
    initialize_date = Field(V.date_)
    population_size = Field(V.PositiveInt)

    def get_initial_state(self, **kwargs) -> CompartmentState:
        """Return one tensor per compartment, summing to population_size.

        Raises
        ------
        NotImplementedError
            Subclasses must implement this for their data streams.
        """
        raise NotImplementedError("implement functionality to get initial state")


__all__ = ["Initializer"]
