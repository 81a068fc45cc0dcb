"""Budget-based reconstruction of turbulent fluxes from mean profiles.

Port of ``climateparameterizations_jl_tpu/data/flux_reconstruction.py``
(reference ``wind_mixing/src/data_containers.jl:172-217``): from mean
profiles ``u, v, T`` on ``(Nt, Nz)``, the horizontally averaged budgets

    d(uw)/dz = -du/dt + f v
    d(vw)/dz = -dv/dt - f u
    d(wT)/dz = -dT/dt

integrated upward from a zero bottom flux. Arrays are time-major ``(..., Nt,
Nz)``; the result drops the last time step (one-sided time difference), as
the reference does.
"""

from __future__ import annotations

import torch


def reconstruct_flux_profiles(u, v, T, t, f, dz):
    """Return ``(u, v, T, uw, vw, wT, t)`` with ``Nt - 1`` steps.

    ``u, v, T``: ``(..., Nt, Nz)`` unscaled mean profiles; ``t``: ``(...,
    Nt)`` times; ``f``: the Coriolis parameter; ``dz``: the uniform spacing.
    """
    dt = torch.diff(t, dim=-1)[..., :, None]  # (..., Nt-1, 1)

    ddt = lambda A: (A[..., 1:, :] - A[..., :-1, :]) / dt  # noqa: E731
    dudt, dvdt, dTdt = ddt(u), ddt(v), ddt(T)

    u_, v_, T_ = u[..., :-1, :], v[..., :-1, :], T[..., :-1, :]

    duw_dz = -dudt + f * v_
    dvw_dz = -dvdt - f * u_
    dwT_dz = -dTdt

    def integrate(div):
        # Faces: flux[0] = 0; flux[k] = sum_{j<k} dz div[j].
        interior = torch.cumsum(div, dim=-1) * dz
        return torch.cat([torch.zeros_like(interior[..., :1]), interior], dim=-1)

    return u_, v_, T_, integrate(duw_dz), integrate(dvw_dz), integrate(dwT_dz), t[..., :-1]
