"""Feature scalings as frozen dataclasses of tensors.

Port of ``climateparameterizations_jl_tpu/core/scalings.py:21``
(``ZeroMeanUnitVarianceScaling``; reference
``src/DataWrangling/feature_scaling.jl:7-54``).
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
