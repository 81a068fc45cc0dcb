"""Modified Pacanowski-Philander (mPP) Richardson-number-dependent diffusivity.

Port of ``climateparameterizations_jl_tpu/physics/mpp.py:27,34,56``
(reference ``wind_mixing/src/NDE_training.jl:54,125``):

    nu(Ri) = nu_0 + nu_minus * tanh_step((Ri - Ri_c) / delta_Ri),  kappa_T = nu / Pr
"""

from __future__ import annotations

import dataclasses

import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device


def tanh_step(x):
    """Smooth step from 1 (x -> -inf) to 0 (x -> +inf); ``NDE_training.jl:54``."""
    return (1.0 - torch.tanh(x)) / 2.0


@dataclasses.dataclass(frozen=True)
class MPPParameters:
    """mPP diffusivity parameters (defaults: ``NDE_training.jl:168``)."""

    nu_0: torch.Tensor
    nu_minus: torch.Tensor
    Ri_c: torch.Tensor
    delta_Ri: torch.Tensor
    Pr: torch.Tensor

    @classmethod
    def default(cls, dtype=torch.float32, device=None) -> "MPPParameters":
        """The reference's values, on ``cuda`` unless the caller asks for the CPU."""
        device = resolve_device(device)
        f = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
        return cls(nu_0=f(1e-4), nu_minus=f(1e-1), Ri_c=f(0.25), delta_Ri=f(1.0), Pr=f(1.0))

    def as_vector(self):
        return torch.stack([self.nu_0, self.nu_minus, self.Ri_c, self.delta_Ri, self.Pr])

    @classmethod
    def from_vector(cls, v) -> "MPPParameters":
        return cls(nu_0=v[0], nu_minus=v[1], Ri_c=v[2], delta_Ri=v[3], Pr=v[4])


def mpp_diffusivity(Ri, params: MPPParameters):
    """Face viscosity ``nu(Ri)``; divide by ``params.Pr`` for tracers."""
    return params.nu_0 + params.nu_minus * tanh_step((Ri - params.Ri_c) / params.delta_Ri)
