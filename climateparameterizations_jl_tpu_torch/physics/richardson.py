"""Local (gradient) Richardson number diagnostics.

Port of ``climateparameterizations_jl_tpu/physics/richardson.py``
(reference ``wind_mixing/src/NDE_training.jl:46-52`` and
``wind_mixing/src/richardson_number.jl:1-42``). Scaled profiles are
differentiated in the non-dimensional coordinate, and the scale factors
convert the result back to a dimensional ratio:

    Ri = H g alpha sigma_T dT/dz_hat / ((sigma_u du/dz_hat)^2 + (sigma_v dv/dz_hat)^2)

Every function acts on the last axis and batches over leading axes.
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face


def local_richardson_scaled(dudz, dvdz, dTdz, H, g, alpha, sigma_u, sigma_v, sigma_T):
    """Richardson number from scaled-profile gradients (elementwise).

    Callers add the reference's ``eps = 1e-7`` regularizer to the gradients
    before calling (``NDE_training.jl:115-119``).
    """
    Bz = H * g * alpha * sigma_T * dTdz
    S2 = (sigma_u * dudz) ** 2 + (sigma_v * dvdz) ** 2
    return Bz / S2


def local_richardson(dudz, dvdz, dTdz, g, alpha):
    """Richardson number from dimensional gradients (elementwise)."""
    S2 = dudz**2 + dvdz**2
    return g * alpha * dTdz / S2


def sanitize_richardson(Ri):
    """NaN -> 0 and +/-Inf -> +/-1e10 (reference ``richardson_number.jl:32-40``)."""
    return torch.nan_to_num(Ri, nan=0.0, posinf=1e10, neginf=-1e10)


def richardson_profile(u_scaled, v_scaled, T_scaled, H, g, alpha, sigma_u, sigma_v, sigma_T, eps=0.0):
    """Sanitized face Ri profile ``(..., Nz+1)`` from scaled center profiles ``(..., Nz)``.

    Gradients are in the non-dimensional coordinate (``dz_hat = 1 / Nz``),
    as the reference's ``Dᶠ(Nz, 1/Nz)`` (``richardson_number.jl:14``).
    """
    dz_hat = 1.0 / u_scaled.shape[-1]
    dudz = d_center_to_face(u_scaled, dz_hat) + eps
    dvdz = d_center_to_face(v_scaled, dz_hat) + eps
    dTdz = d_center_to_face(T_scaled, dz_hat) + eps
    return sanitize_richardson(local_richardson_scaled(dudz, dvdz, dTdz, H, g, alpha, sigma_u, sigma_v, sigma_T))
