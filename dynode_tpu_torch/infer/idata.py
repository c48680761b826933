"""InferenceData: a lightweight arviz-style container for fit results.

Port of ``dynode_tpu/infer/idata.py`` (numpy, as there). Groups are plain
dicts of numpy arrays with arviz's shape conventions: posterior and
sample_stats are ``(chains, draws, *shape)``; prior and
posterior_predictive are ``(draws, *shape)``. A tensor goes to the CPU
first (a bfloat16 one as float32, which numpy lacks).
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch


def _np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def _np_group(group: Optional[Dict[str, Any]]) -> Optional[Dict[str, np.ndarray]]:
    if group is None:
        return None
    return {k: _np(v) for k, v in group.items()}


@dataclass
class InferenceData:
    """Grouped fit results with summary/diagnostic helpers."""

    posterior: Optional[Dict[str, np.ndarray]] = None
    posterior_predictive: Optional[Dict[str, np.ndarray]] = None
    prior: Optional[Dict[str, np.ndarray]] = None
    sample_stats: Optional[Dict[str, np.ndarray]] = None
    log_likelihood: Optional[Dict[str, np.ndarray]] = None
    observed_data: Optional[Dict[str, np.ndarray]] = None
    attrs: Dict[str, Any] = field(default_factory=dict)

    def groups(self):
        """Names of the stored groups (``posterior``, ``sample_stats``, ...).
        """
        return [
            name
            for name in (
                "posterior",
                "posterior_predictive",
                "prior",
                "sample_stats",
                "log_likelihood",
                "observed_data",
            )
            if getattr(self, name) is not None
        ]

    def summary(self, prob: float = 0.9):
        """Per-parameter mean/std/HDI/ESS/Rhat over the posterior group."""
        from .diagnostics import summary as _summary

        if self.posterior is None:
            raise AssertionError("no posterior group")
        return _summary(self.posterior, prob=prob)

    def __repr__(self):
        lines = ["InferenceData with groups:"]
        for g in self.groups():
            sites = getattr(self, g)
            lines.append(f"  > {g}: {list(sites.keys())}")
        return "\n".join(lines)

    def to_npz(self, path: str) -> None:
        """Persist all groups + attrs to one ``.npz`` (``to_netcdf`` analog).

        Keys are ``{group}/{site}``; ``attrs`` is stored as JSON
        (non-JSON-serializable values fall back to ``str``); present-but-
        empty groups get a marker so the round-trip preserves
        :meth:`groups` exactly. Dependency-free and loadable with plain
        numpy or :meth:`from_npz`.
        """
        import json

        arrays = {}
        for g in self.groups():
            sites = getattr(self, g)
            if not sites:
                arrays[f"{g}/__empty__"] = np.zeros(0)
                continue
            for site, arr in sites.items():
                arrays[f"{g}/{site}"] = np.asarray(arr)
        if self.attrs:
            arrays["__attrs__"] = np.frombuffer(
                json.dumps(self.attrs, default=str).encode(), dtype=np.uint8
            )
        np.savez_compressed(path, **arrays)

    def to_arviz(self):
        """Build a REAL ``arviz.InferenceData`` when arviz is installed.

        Reference behavior parity: the reference's ``to_arviz()`` hands back
        a genuine ``az.InferenceData`` usable by the whole arviz toolchain
        (plot_trace, summary, to_netcdf; the reference's
        ``src/dynode/infer/inference.py:237-241``). This container stores groups with arviz's own shape conventions, so the
        bridge is a direct ``az.from_dict``: posterior/sample_stats are
        already (chains, draws, ...); draw-indexed groups (prior,
        posterior_predictive, log_likelihood) gain the singleton chain
        axis arviz expects. Raises ImportError with a pointer to
        :meth:`to_npz` when arviz is not available.
        """
        try:
            import arviz as az
        except ImportError as e:  # pragma: no cover - exercised when absent
            raise ImportError(
                "arviz is not installed; install it for ecosystem interop "
                "or use InferenceData.to_npz()/from_npz() for the "
                "dependency-free round-trip"
            ) from e

        def chainify(group):
            # (draws, *shape) -> (1, draws, *shape)
            return {k: np.asarray(v)[None] for k, v in group.items()}

        kwargs = {}
        if self.posterior is not None:
            kwargs["posterior"] = self.posterior
        if self.sample_stats is not None:
            kwargs["sample_stats"] = self.sample_stats
        if self.posterior_predictive is not None:
            kwargs["posterior_predictive"] = chainify(
                self.posterior_predictive
            )
        if self.prior is not None:
            kwargs["prior"] = chainify(self.prior)
        if self.log_likelihood is not None:
            kwargs["log_likelihood"] = chainify(self.log_likelihood)
        if self.observed_data is not None:
            kwargs["observed_data"] = self.observed_data
        idata = az.from_dict(**kwargs)
        if self.attrs:
            for g in idata.groups():
                getattr(idata, g).attrs.update(
                    {k: str(v) for k, v in self.attrs.items()}
                )
        return idata

    @classmethod
    def from_npz(cls, path: str) -> "InferenceData":
        """Inverse of :meth:`to_npz`."""
        import json

        groups: Dict[str, Dict[str, np.ndarray]] = {}
        attrs: Dict[str, Any] = {}
        with np.load(path) as data:
            for key in data.files:
                if key == "__attrs__":
                    attrs = json.loads(data[key].tobytes().decode())
                    continue
                g, site = key.split("/", 1)
                if site == "__empty__":
                    groups.setdefault(g, {})
                    continue
                groups.setdefault(g, {})[site] = data[key]
        return cls(attrs=attrs, **groups)


def from_dynode(
    *,
    posterior: Optional[Dict[str, Any]] = None,
    posterior_predictive: Optional[Dict[str, Any]] = None,
    prior: Optional[Dict[str, Any]] = None,
    sample_stats: Optional[Dict[str, Any]] = None,
    log_likelihood: Optional[Dict[str, Any]] = None,
    observed_data: Optional[Dict[str, Any]] = None,
    **attrs,
) -> InferenceData:
    """Assemble an InferenceData from raw sample dicts (tensors on any device ok)."""
    return InferenceData(
        posterior=_np_group(posterior),
        posterior_predictive=_np_group(posterior_predictive),
        prior=_np_group(prior),
        sample_stats=_np_group(sample_stats),
        log_likelihood=_np_group(log_likelihood),
        observed_data=_np_group(observed_data),
        attrs=dict(attrs),
    )


__all__ = ["InferenceData", "from_dynode"]
