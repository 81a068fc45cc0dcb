"""Synthetic LES-like wind-mixing datasets (the offline training data).

Port of the wind-mixing half of ``climateparameterizations_jl_tpu/data/synthetic.py``.
A dimensional mPP column (identity scalings, ``tau = 1``: the scaled
non-dimensional model is then the dimensional one) is run at LES
resolution by the split stepper, and its profiles and diagnosed fluxes are
packaged as a :class:`ColumnTimeSeries`, as a horizontally averaged LES
would record them.

The generator runs on the CPU by design, not as a fallback: the stand-ins
are data fixtures, and the same catalog name has to give the same truth on
every platform. The JAX package pins generation to its CPU backend for the
same reason (``data/synthetic.py:42-57``): generated on an accelerator, the
stiff 128-level mPP column drifts measurably from the CPU trajectories. The
solve uses the plain ``"scan"`` tridiagonal backend there. Callers move the
finished data to their device (``cli/main.py::_load_suite``).
"""

from __future__ import annotations

import dataclasses

import torch

from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    BoundaryConditions,
    FluxNNs,
    WindMixingModel,
    WindMixingScalings,
    predict_flux,
    solve_wind_mixing_split,
    split_uvT,
)
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

NO_NNS = FluxNNs(uw=None, vw=None, wT=None)
GENERATOR_DEVICE = torch.device("cpu")  # see the module docstring


def _identity_scalings(dtype) -> WindMixingScalings:
    s = ZeroMeanUnitVarianceScaling(torch.zeros((), dtype=dtype), torch.ones((), dtype=dtype))
    return WindMixingScalings(u=s, v=s, T=s, uw=s, vw=s, wT=s)


def three_layer_profile(z, T_surface=19.0, mixed_layer_depth=50.0, thermocline_thickness=50.0,
                        dTdz_thermocline=0.02, dTdz_deep=0.002):
    """Three-layer initial temperature: mixed layer / thermocline / deep.

    The LESbrary "three_layer_constant_fluxes" family; ``z`` is negative
    downward (0 at the surface).
    """
    d = -torch.as_tensor(z)
    t1 = mixed_layer_depth
    t2 = mixed_layer_depth + thermocline_thickness
    in_thermocline = torch.clamp(d - t1, 0.0, thermocline_thickness)
    below = torch.clamp(d - t2, min=0.0)
    return T_surface - dTdz_thermocline * in_thermocline - dTdz_deep * below


def _generator_model(f, alpha, g, H, Nz, diurnal, mpp, dtype) -> WindMixingModel:
    c = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    return WindMixingModel(
        H=c(H), tau=c(1.0), f=c(f), g=c(g), alpha=c(alpha), kappa=c(10.0),
        scalings=_identity_scalings(dtype),
        mpp=mpp if mpp is not None else MPPParameters.default(dtype, GENERATOR_DEVICE),
        Nz=Nz, use_mpp=True, zero_weights=True, diurnal=diurnal,
    )


def _forcing(Qu, Qb, alpha, g, diurnal, dtype):
    """``(bcs, theta_top)`` for surface fluxes ``Qu``/``Qb`` (floats or ``(M,)`` tensors)."""
    Qu = torch.as_tensor(Qu, dtype=dtype)
    theta_top = torch.as_tensor(Qb, dtype=torch.float64) / (alpha * g)
    theta_top = theta_top.to(dtype)
    zero = torch.zeros_like(Qu)
    bcs = BoundaryConditions(
        uw_bot=zero, uw_top=Qu, vw_bot=zero, vw_top=zero, wT_bot=zero,
        wT_top=zero if diurnal else theta_top,
        diurnal_amplitude=theta_top if diurnal else zero,
    )
    return bcs, theta_top


def _initial_state(Nz, H, dtype):
    zc = (torch.arange(Nz, dtype=dtype) + 0.5) * (H / Nz) - H
    T0 = three_layer_profile(zc).to(dtype)
    return torch.cat([torch.zeros(Nz, dtype=dtype), torch.zeros(Nz, dtype=dtype), T0])


def _package(model, bcs, traj, t, Qu, theta_top, f, alpha, g, H, dtype) -> ColumnTimeSeries:
    u, v, T = split_uvT(traj, model.Nz)
    uw, vw, wT = predict_flux(model, NO_NNS, bcs, traj, t)
    c = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    return ColumnTimeSeries(
        u=u, v=v, T=T, uw=uw, vw=vw, wT=wT, t=t,
        H=c(H), f=c(f), g=c(g), alpha=c(alpha), beta=c(8e-4),
        u_top=torch.as_tensor(Qu, dtype=dtype), theta_top=theta_top,
        # The generating model applies zero bottom heat flux, so the
        # advertised bottom-gradient BC is 0 too.
        theta_bottom=c(0.0),
        diurnal_amplitude=bcs.diurnal_amplitude,
    )


def synthetic_wind_mixing_les(Qu: float = -5e-4, Qb: float = 3e-8, f: float = 1e-4, alpha: float = 2e-4,
                              g: float = 9.80665, H: float = 256.0, Nz: int = 128, n_save: int = 288,
                              dt_save: float = 600.0, n_substeps: int = 2, diurnal: bool = False,
                              mpp: MPPParameters | None = None, dtype=torch.float32) -> ColumnTimeSeries:
    """Run a dimensional mPP column on the CPU and package it as an LES-like dataset.

    ``Qu`` is the surface kinematic momentum flux [m^2/s^2] (negative =
    eastward wind stress), ``Qb`` the surface buoyancy flux [m^2/s^3]
    (positive = cooling); the surface heat flux is ``Qb / (alpha g)``.
    """
    model = _generator_model(f, alpha, g, H, Nz, diurnal, mpp, dtype)
    bcs, theta_top = _forcing(Qu, Qb, alpha, g, diurnal, dtype)
    with torch.no_grad():
        traj = solve_wind_mixing_split(model, NO_NNS, bcs, _initial_state(Nz, H, dtype), 0.0, dt_save, n_save,
                                       n_substeps=n_substeps)
        t = dt_save * torch.arange(n_save + 1, dtype=dtype)
        return _package(model, bcs, traj, t, Qu, theta_top, f, alpha, g, H, dtype)


def _synthetic_wind_mixing_les_batch(Qus, Qbs, f: float = 1e-4, alpha: float = 2e-4, g: float = 9.80665,
                                     H: float = 256.0, Nz: int = 128, n_save: int = 288, dt_save: float = 600.0,
                                     n_substeps: int = 2, diurnal: bool = False, mpp: MPPParameters | None = None,
                                     dtype=torch.float32) -> list:
    """:func:`synthetic_wind_mixing_les` for ``M`` members in ONE batched split solve.

    The members share ``f``, ``alpha``, ``g``, ``H``, the grid and the
    diurnal flag and differ in their surface fluxes, which ride the batch
    axis as ``(M,)`` BCs (broadcast left-aligned). Every operation of the
    split stepper is per column, so each member's columns are the per-sim
    generator's. Returns one dataset per member, in order.
    """
    model = _generator_model(f, alpha, g, H, Nz, diurnal, mpp, dtype)
    bcs, theta_top = _forcing(list(Qus), list(Qbs), alpha, g, diurnal, dtype)
    x0 = _initial_state(Nz, H, dtype).expand(len(Qus), 3 * Nz)
    with torch.no_grad():
        traj = solve_wind_mixing_split(model, NO_NNS, bcs, x0, 0.0, dt_save, n_save, n_substeps=n_substeps)
        t = dt_save * torch.arange(n_save + 1, dtype=dtype)
        out = []
        for m, Qu in enumerate(Qus):
            member = BoundaryConditions(**{k.name: getattr(bcs, k.name)[m] for k in dataclasses.fields(bcs)})
            out.append(_package(model, member, traj[:, m], t, Qu, theta_top[m], f, alpha, g, H, dtype))
        return out
