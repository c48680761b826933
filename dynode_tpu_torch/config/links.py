"""Lazy parameter links: DeterministicParameter and PlaceholderSample.

Port of ``dynode_tpu/config/links.py``. ``PlaceholderSample`` is a
distribution of the port's :mod:`dynode_tpu_torch.dist`.
"""

from typing import Any, Callable, Optional, Union

from ..dist import Distribution
from ..dist.distribution import as_float


class DeterministicParameter:
    """A parameter whose value is derived from another parameter's value.

    ``resolve(parameter_state)`` looks up ``depends_on`` (optionally indexing
    with ``index``) and applies ``transform``.
    """

    def __init__(
        self,
        depends_on: str,
        index: Optional[Union[int, tuple, slice]] = None,
        transform: Callable[[Any], Any] = lambda x: x,
    ):
        self.depends_on = depends_on
        self.index = index
        self.transform = transform

    def resolve(self, parameter_state: dict) -> Any:
        """Fetch ``parameter_state[depends_on][index]`` with a helpful error."""
        try:
            target = parameter_state[self.depends_on]
            if self.index is None:
                return self.transform(target)
            return self.transform(target[self.index])
        except Exception as e:
            if self.index is None:
                msg = (
                    f"Was unable to find {self.depends_on} within the following "
                    f"scope, make sure DeterministicParameter dependencies are "
                    f"at the top level of the configuration object. "
                    f"Scope: {parameter_state}"
                )
            else:
                msg = (
                    f"Was unable to find {self.depends_on}[{self.index}] within "
                    f"the following scope, make sure DeterministicParameter "
                    f"dependency indexes are correct or you are querying a "
                    f"list/dict-like object. Scope: {parameter_state}"
                )
            raise Exception(msg) from e


class SamplePlaceholderError(Exception):
    """Raised when a PlaceholderSample is sampled without substitution."""


class PlaceholderSample(Distribution):
    """A 'distribution' that must be substituted from external samples.

    Sampling raises :class:`SamplePlaceholderError`; inference substitutes
    the site's value before this ``sample`` is reached.
    """

    def sample(self, generator=None, sample_shape=()):
        """Raise :class:`SamplePlaceholderError`: placeholders must be substituted."""
        raise SamplePlaceholderError(
            "Attempted to sample a PosteriorSample parameter outside of a "
            "Predictive() context. This likely means you did not provide "
            "posterior samples to the context via infer.Predictive() or "
            "infer.handlers.substitute()."
        )

    def log_prob(self, value):
        """Zero density: substituted values contribute no likelihood of their own."""
        (value,) = as_float(value)
        return value.new_zeros(value.shape)


__all__ = ["DeterministicParameter", "PlaceholderSample", "SamplePlaceholderError"]
