"""Local (gradient) Richardson number in scaled space.

Port of ``climateparameterizations_jl_tpu/physics/richardson.py:24``
(reference ``wind_mixing/src/NDE_training.jl:46-52``):

    Ri = H g alpha sigma_T dT/dz_hat / ((sigma_u du/dz_hat)^2 + (sigma_v dv/dz_hat)^2)
"""

from __future__ import annotations


def local_richardson_scaled(dudz, dvdz, dTdz, H, g, alpha, sigma_u, sigma_v, sigma_T):
    """Richardson number from scaled-profile gradients (elementwise).

    Callers add the reference's ``eps = 1e-7`` regularizer to the gradients
    before calling (``NDE_training.jl:115-119``).
    """
    Bz = H * g * alpha * sigma_T * dTdz
    S2 = (sigma_u * dudz) ** 2 + (sigma_v * dvdz) ** 2
    return Bz / S2
