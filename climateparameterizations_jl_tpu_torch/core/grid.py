"""Staggered 1-D vertical grid of an ocean column.

Port of ``climateparameterizations_jl_tpu/core/grid.py``. The column spans
``z in [-H, 0]`` with ``Nz`` cell centers and ``Nz + 1`` faces; state
variables (``u``, ``v``, ``T``) live on centers, vertical fluxes and
gradients on faces. The reference keeps the grid implicit in its ``zC`` /
``zF`` vectors (``wind_mixing/src/lesbrary_data.jl:156-157``).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import torch


@dataclasses.dataclass(frozen=True)
class ColumnGrid:
    """Uniform staggered z-grid of one column: ``Nz`` centers over depth ``H`` (m, positive)."""

    Nz: int
    H: float

    @property
    def dz(self) -> float:
        """Dimensional grid spacing (m)."""
        return self.H / self.Nz

    @property
    def dz_hat(self) -> float:
        """Non-dimensional grid spacing ``dz / H = 1 / Nz``."""
        return 1.0 / self.Nz

    @cached_property
    def zc(self) -> torch.Tensor:
        """Cell-center coordinates, bottom (-H) to top, float64 on the CPU."""
        return (torch.arange(self.Nz, dtype=torch.float64) + 0.5) * self.dz - self.H

    @cached_property
    def zf(self) -> torch.Tensor:
        """Cell-face coordinates, bottom (-H) to top (0), float64 on the CPU."""
        return torch.arange(self.Nz + 1, dtype=torch.float64) * self.dz - self.H
