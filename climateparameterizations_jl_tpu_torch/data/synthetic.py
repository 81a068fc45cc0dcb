"""Synthetic LES-like column datasets (the offline training data).

Port of ``climateparameterizations_jl_tpu/data/synthetic.py``. Wind mixing:
a dimensional mPP column (identity scalings, ``tau = 1``: the scaled
non-dimensional model is then the dimensional one) is run at LES
resolution by the split stepper, and its profiles and diagnosed fluxes are
packaged as a :class:`ColumnTimeSeries`, as a horizontally averaged LES
would record them. Free convection (:func:`synthetic_free_convection_les`): a
surface-cooled column with the implicit convective adjustment.

The generators run on the CPU by design, not as a fallback: the stand-ins
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

from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face
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
from climateparameterizations_jl_tpu_torch.physics.convective_adjustment import convective_adjustment_implicit_step
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


def synthetic_free_convection_les(Qb: float = 1e-7, alpha: float = 2e-4, g: float = 9.80665, H: float = 256.0,
                                  Nz: int = 128, n_save: int = 288, dt_save: float = 600.0, n_substeps: int = 4,
                                  kappa: float = 10.0, stratification: float = 0.002,
                                  dtype=torch.float32) -> ColumnTimeSeries:
    """Surface-cooled convecting column: surface flux plus implicit convective adjustment.

    Stand-in for the 9 LESbrary free-convection simulations
    (``free_convection/src/data.jl:3-12``). Each substep applies the surface
    heat-flux divergence (``Qb / (alpha g)``, top cell only) explicitly,
    then a backward-Euler convective adjustment (``kappa`` m^2/s where
    unstable) by one tridiagonal solve (plain ``"scan"`` backend), the
    operator-split scheme of ``free_convection/src/oceananigans_nn.jl:13-40``.
    ``stratification`` sets the deep and thermocline gradients (10x) and
    the bottom-gradient BC: ids sharing a surface flux differ only in it.
    Velocities and momentum fluxes are zero. Generated on the CPU.
    """
    return _synthetic_free_convection_les_batch([Qb], [stratification], alpha, g, H, Nz, n_save, dt_save,
                                                n_substeps, kappa, dtype)[0]


def _synthetic_free_convection_les_batch(Qbs, stratifications, alpha: float = 2e-4, g: float = 9.80665,
                                         H: float = 256.0, Nz: int = 128, n_save: int = 288,
                                         dt_save: float = 600.0, n_substeps: int = 4, kappa: float = 10.0,
                                         dtype=torch.float32) -> list:
    """:func:`synthetic_free_convection_les` for ``M`` members in one batched solve.

    Members differ in ``Qb`` and ``stratification``, which ride the batch
    axis as per-member columns of constants. Every operation is per column
    and elementwise, so each member's dataset is the single-member call's.
    Returns one dataset per member, in order.
    """
    thetas = [Qb / (alpha * g) for Qb in Qbs]
    dz = H / Nz
    dt = dt_save / n_substeps
    member = lambda values: torch.tensor(values, dtype=dtype)[:, None]  # noqa: E731 - (M, 1) in dtype
    zc = (torch.arange(Nz, dtype=dtype) + 0.5) * dz - H
    T = three_layer_profile(zc, dTdz_thermocline=member([10.0 * s for s in stratifications]),
                            dTdz_deep=member(stratifications)).to(dtype)
    # Explicit surface-flux divergence: only the top cell feels theta_top.
    top_increment = member([-dt * theta / dz for theta in thetas])
    with torch.no_grad():
        frames = [T]
        for _ in range(n_save):
            for _ in range(n_substeps):
                T = torch.cat([T[..., :-1], T[..., -1:] + top_increment], dim=-1)
                T = convective_adjustment_implicit_step(T, dt, dz, kappa)
            frames.append(T)
        traj = torch.stack(frames, dim=0)  # (n_save + 1, M, Nz)
        t = dt_save * torch.arange(n_save + 1, dtype=dtype)
        c = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
        out = []
        for m, (theta, strat) in enumerate(zip(thetas, stratifications)):
            T_m = traj[:, m]
            # Diagnosed wT faces: the conv-adj downgradient flux between the imposed boundary fluxes.
            dTdz = d_center_to_face(T_m, dz)
            K_face = torch.where(dTdz < 0.0, c(kappa), c(0.0))
            wT = -K_face * dTdz
            wT = torch.cat([torch.zeros_like(wT[..., :1]), wT[..., 1:-1], torch.full_like(wT[..., -1:], theta)],
                           dim=-1)
            zeros_c, zeros_f = torch.zeros_like(T_m), torch.zeros_like(wT)
            out.append(ColumnTimeSeries(
                u=zeros_c, v=zeros_c, T=T_m, uw=zeros_f, vw=zeros_f, wT=wT, t=t,
                H=c(H), f=c(1e-4), g=c(g), alpha=c(alpha), beta=c(8e-4), u_top=c(0.0), theta_top=c(theta),
                theta_bottom=c(strat), diurnal_amplitude=c(0.0),
            ))
        return out
