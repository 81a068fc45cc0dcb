"""Feature scalings as frozen dataclasses of tensors.

Port of ``climateparameterizations_jl_tpu/core/scalings.py``
(``ZeroMeanUnitVarianceScaling``, ``MinMaxScaling``, ``fit_scaling``;
reference ``src/DataWrangling/feature_scaling.jl:7-54``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ZeroMeanUnitVarianceScaling:
    """``y = (x - mu) / sigma``."""

    mu: torch.Tensor
    sigma: torch.Tensor

    def scale(self, x):
        return (x - self.mu) / self.sigma

    def unscale(self, y):
        return self.sigma * y + self.mu

    def __call__(self, x):
        return self.scale(x)

    @classmethod
    def fit(cls, data) -> "ZeroMeanUnitVarianceScaling":
        data = torch.as_tensor(data)
        # unbiased=True matches Julia's Statistics.std; a constant field
        # scales to 0 instead of NaN (same guard as the JAX package).
        sigma = torch.std(data, unbiased=True)
        return cls(mu=torch.mean(data), sigma=torch.where(sigma > 0, sigma, torch.ones_like(sigma)))


@dataclasses.dataclass(frozen=True)
class MinMaxScaling:
    """``y = a + (x - data_min) * (b - a) / (data_max - data_min)``."""

    a: torch.Tensor
    b: torch.Tensor
    data_min: torch.Tensor
    data_max: torch.Tensor

    def scale(self, x):
        return self.a + (x - self.data_min) * (self.b - self.a) / (self.data_max - self.data_min)

    def unscale(self, y):
        return self.data_min + (y - self.a) * (self.data_max - self.data_min) / (self.b - self.a)

    def __call__(self, x):
        return self.scale(x)

    @classmethod
    def fit(cls, data, a=0.0, b=1.0) -> "MinMaxScaling":
        data = torch.as_tensor(data)
        lo, hi = torch.min(data), torch.max(data)
        # A degenerate range widens to 1 instead of dividing by zero.
        hi = torch.where(hi > lo, hi, lo + torch.ones_like(hi))
        f = lambda v: torch.tensor(v, dtype=data.dtype, device=data.device)  # noqa: E731
        return cls(a=f(a), b=f(b), data_min=lo, data_max=hi)


def fit_scaling(data, kind: str = "zero_mean_unit_variance"):
    """Fit a scaling of the given kind to ``data``."""
    if kind in ("zero_mean_unit_variance", "ZeroMeanUnitVarianceScaling"):
        return ZeroMeanUnitVarianceScaling.fit(data)
    if kind in ("min_max", "MinMaxScaling"):
        return MinMaxScaling.fit(data)
    raise ValueError(f"unknown scaling kind: {kind!r}")
