"""Probability distributions of the port, on PyTorch.

Port of ``dynode_tpu/dist``: the same constraints, transforms and families
under the same names. ``sample`` takes a ``torch.Generator`` where the JAX
package takes a key, and draws on its device; see
:mod:`.distribution` for the device and dtype rules. Nothing here builds
on ``torch.distributions``.
"""

from . import constraints, transforms
from .constraints import Constraint
from .continuous import (
    Beta,
    Dirichlet,
    Cauchy,
    Exponential,
    Gamma,
    HalfCauchy,
    HalfNormal,
    LogNormal,
    MultivariateNormal,
    Normal,
    StudentT,
    TruncatedNormal,
    Uniform,
)
from .discrete import (
    BetaBinomial,
    ZeroInflatedDistribution,
    ZeroInflatedNegativeBinomial,
    ZeroInflatedPoisson,
    Bernoulli,
    Binomial,
    Categorical,
    Multinomial,
    NegativeBinomial,
    Poisson,
)
from .distribution import (
    Delta,
    Unit,
    Distribution,
    ExpandedDistribution,
    TransformedDistribution,
)
from .transforms import (
    AffineTransform,
    StickBreakingTransform,
    ComposeTransform,
    ExpTransform,
    IdentityTransform,
    SigmoidTransform,
    Transform,
    biject_to,
)

__all__ = [
    "constraints",
    "transforms",
    "Constraint",
    "Distribution",
    "TransformedDistribution",
    "Delta",
    "Unit",
    "Normal",
    "LogNormal",
    "HalfNormal",
    "Cauchy",
    "HalfCauchy",
    "StudentT",
    "Uniform",
    "Exponential",
    "Gamma",
    "Beta",
    "TruncatedNormal",
    "MultivariateNormal",
    "Poisson",
    "Bernoulli",
    "Categorical",
    "Multinomial",
    "Dirichlet",
    "ExpandedDistribution",
    "StickBreakingTransform",
    "Binomial",
    "NegativeBinomial",
    "BetaBinomial",
    "ZeroInflatedDistribution",
    "ZeroInflatedPoisson",
    "ZeroInflatedNegativeBinomial",
    "Transform",
    "IdentityTransform",
    "AffineTransform",
    "ExpTransform",
    "SigmoidTransform",
    "ComposeTransform",
    "biject_to",
]
