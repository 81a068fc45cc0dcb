"""Six-channel NDE loss with auto-balanced scalings.

Port of ``climateparameterizations_jl_tpu/train/loss.py`` (reference
``wind_mixing/src/loss.jl``): per-variable MSE channels ``(u, v, T)`` plus
vertical-gradient channels ``(du/dz, dv/dz, dT/dz)``, closed-form channel
weights hitting target fractions, and the per-frame loss. Trajectories are
time-major ``(..., Nt, 3 Nz)``.
"""

from __future__ import annotations

import dataclasses

import torch

from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face
from climateparameterizations_jl_tpu_torch.models.wind_mixing import split_uvT


@dataclasses.dataclass(frozen=True)
class LossChannels:
    """The six loss channels (or their scaling weights)."""

    u: torch.Tensor
    v: torch.Tensor
    T: torch.Tensor
    dudz: torch.Tensor
    dvdz: torch.Tensor
    dTdz: torch.Tensor

    def total(self):
        return self.u + self.v + self.T + self.dudz + self.dvdz + self.dTdz

    def profile(self):
        return self.u + self.v + self.T

    def gradient(self):
        return self.dudz + self.dvdz + self.dTdz

    @classmethod
    def ones(cls, gradient_scaling=0.0, device=None) -> "LossChannels":
        one = torch.tensor(1.0, dtype=torch.float32, device=device)
        gs = torch.tensor(gradient_scaling, dtype=torch.float32, device=device)
        return cls(u=one, v=one, T=one, dudz=gs, dvdz=gs, dTdz=gs)

    def as_floats(self) -> dict:
        """The channels as Python floats (one host transfer)."""
        values = torch.stack([getattr(self, f.name) for f in dataclasses.fields(self)]).tolist()
        return dict(zip((f.name for f in dataclasses.fields(self)), values))


def mse(a, b):
    return torch.mean((a - b) ** 2)


def nde_loss_channels(pred, target, Nz: int, train_gradient: bool = True) -> LossChannels:
    """Raw (unscaled) channels from predicted/target trajectories ``(..., Nt, 3 Nz)``."""
    pu, pv, pT = split_uvT(pred, Nz)
    tu, tv, tT = split_uvT(target, Nz)
    if train_gradient:
        dz_hat = 1.0 / Nz
        dd = lambda x: d_center_to_face(x, dz_hat)  # noqa: E731
        grads = (mse(dd(pu), dd(tu)), mse(dd(pv), dd(tv)), mse(dd(pT), dd(tT)))
    else:
        zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
        grads = (zero, zero, zero)
    return LossChannels(u=mse(pu, tu), v=mse(pv, tv), T=mse(pT, tT), dudz=grads[0], dvdz=grads[1], dTdz=grads[2])


def calculate_loss_scalings(losses: LossChannels, fractions, train_gradient: bool = True) -> LossChannels:
    """Closed-form channel weights hitting the target fractions (``loss.jl:11-31``).

    ``fractions`` is a mapping or namespace with ``T``, ``dTdz`` and
    ``profile``. A zero denominator (a channel group with no signal) gives
    weight 0 instead of a NaN.
    """
    get = (lambda k: fractions[k]) if isinstance(fractions, dict) else (lambda k: getattr(fractions, k))
    fT, fdT, fprof = get("T"), get("dTdz"), get("profile")

    def safe_div(a, b):
        return torch.where(b > 0, a / torch.where(b > 0, b, torch.ones_like(b)), torch.zeros_like(a))

    velocity_scaling = (1 - fT) / fT * safe_div(losses.T, losses.u + losses.v)
    profile_loss = velocity_scaling * (losses.u + losses.v) + losses.T
    if train_gradient:
        velocity_gradient_scaling = (1 - fdT) / fdT * safe_div(losses.dTdz, losses.dudz + losses.dvdz)
        gradient_loss = velocity_gradient_scaling * (losses.dudz + losses.dvdz) + losses.dTdz
        total_gradient_scaling = (1 - fprof) / fprof * safe_div(profile_loss, gradient_loss)
    else:
        velocity_gradient_scaling = torch.zeros_like(velocity_scaling)
        total_gradient_scaling = torch.zeros_like(velocity_scaling)
    one = torch.ones_like(velocity_scaling)
    return LossChannels(
        u=velocity_scaling,
        v=velocity_scaling,
        T=one,
        dudz=total_gradient_scaling * velocity_gradient_scaling,
        dvdz=total_gradient_scaling * velocity_gradient_scaling,
        dTdz=total_gradient_scaling,
    )


def apply_loss_scalings(losses: LossChannels, scalings: LossChannels) -> LossChannels:
    return LossChannels(**{
        f.name: getattr(scalings, f.name) * getattr(losses, f.name) for f in dataclasses.fields(LossChannels)
    })


def loss_per_timestep(pred, target):
    """MSE per saved frame of ``(Nt, ..., F)`` trajectories (time leading, as solvers return)."""
    sq = (pred - target) ** 2
    return torch.mean(sq.reshape(sq.shape[0], -1), dim=-1)
