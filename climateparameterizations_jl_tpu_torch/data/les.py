"""3-D large-eddy simulation: the generator of the ``les3d`` training data.

Port of ``climateparameterizations_jl_tpu/data/les.py`` (the reference
generates its training profiles with an Oceananigans LES,
``wind_mixing/wind_mixing.jl:1-143``: wind stress and a surface buoyancy
flux, an SGS closure, horizontally averaged output). The model:

- **Staggered MAC grid**, periodic in x and y, rigid lid and flat bottom in
  z. Fields are ``(Ny, Nx, Nz)`` with z last, the column axis of the rest of
  the package.
- **Pressure projection**: ``torch.fft.rfft2`` over the periodic
  horizontals, one batched tridiagonal solve in z over every ``(ky, kx)``
  mode, ``irfft2``. The coefficients are real, so the real and imaginary
  parts of the transformed right-hand side go as one real batch of
  ``2 x Ny x (Nx // 2 + 1)`` systems through
  ``ops/tridiagonal.py::tridiagonal_solve``: on the card one launch of the
  Thomas kernel ``csrc/thomas.cu`` per projection (the JAX package solves the
  complex systems on its scan, since its Pallas kernel is real-only). The
  diagonals depend only on the grid and are built once per configuration.
- **Smagorinsky SGS closure** plus a constant molecular floor.
- **Forcing** as the LESbrary setups: kinematic surface momentum flux ``Qu``
  (negative = eastward stress), surface buoyancy flux ``Qb`` (positive =
  cooling), a fixed bottom temperature gradient; optionally the diurnal
  cycle of the surface heat flux.
- **Output**: horizontally averaged ``(U, V, T)`` and the resolved
  covariance fluxes on z-faces, as a
  :class:`~climateparameterizations_jl_tpu_torch.data.containers.ColumnTimeSeries`.

The steps run eagerly, one ``les_step`` after another. The initial noise is
drawn from a ``torch.Generator``, so a run's fields are not the JAX
package's (``jax.random``); the parity tests hand the JAX initial state over
through numpy. Every field keeps the configuration's dtype, as JAX's
``.at[...].add`` does.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import tridiagonal_solve

_STATIC = ("diurnal", "advection", "momentum_advection")


@dataclasses.dataclass(frozen=True)
class LESConfig:
    """Box geometry, physics constants (0-d tensors), forcing and SGS settings."""

    Lx: torch.Tensor
    Ly: torch.Tensor
    H: torch.Tensor
    Qu: torch.Tensor  # kinematic surface momentum flux [m^2/s^2]
    Qb: torch.Tensor  # surface buoyancy flux [m^2/s^3]
    f: torch.Tensor
    g: torch.Tensor
    alpha: torch.Tensor
    dTdz: torch.Tensor  # initial and bottom-BC temperature gradient [K/m]
    T_surface: torch.Tensor
    nu: torch.Tensor  # constant viscosity floor [m^2/s]
    Cs: torch.Tensor  # Smagorinsky constant
    Pr_t: torch.Tensor  # turbulent Prandtl number
    Nx: int = 32
    Ny: int = 32
    Nz: int = 32
    # Diurnal surface heat flux theta_top sin(2 pi t / day)
    # (wind_mixing/src/data_containers.jl:131-156).
    diurnal: bool = False
    # Tracer advection: "weno5" (the reference LES's) or "centered".
    advection: str = "weno5"
    # Momentum advection: "centered" (2nd-order flux form, the JAX package's
    # default) or "weno5".
    momentum_advection: str = "centered"

    @classmethod
    def default(cls, Nx: int = 32, Ny: int = 32, Nz: int = 32, Qu=-5e-4, Qb=3e-8, dtype=torch.float32, device=None,
                **overrides) -> "LESConfig":
        """The JAX package's defaults (a 512 m x 512 m x 256 m box), on ``cuda`` unless the caller asks for the CPU.

        ``overrides`` replace any field: numbers (or 0-d arrays) for the
        physics, which become 0-d tensors of ``dtype``, and the static
        ``diurnal``, ``advection`` and ``momentum_advection``.
        """
        device = resolve_device(device)
        vals = dict(Lx=512.0, Ly=512.0, H=256.0, Qu=Qu, Qb=Qb, f=1e-4, g=9.80665, alpha=2e-4, dTdz=0.01,
                    T_surface=19.0, nu=1e-5, Cs=0.17, Pr_t=1.0)
        static = {k: overrides.pop(k) for k in _STATIC if k in overrides}
        vals.update(overrides)
        leaves = {k: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype).to(device)
                  for k, v in vals.items()}
        return cls(Nx=Nx, Ny=Ny, Nz=Nz, **static, **leaves)

    @property
    def dx(self):
        return self.Lx / self.Nx

    @property
    def dy(self):
        return self.Ly / self.Ny

    @property
    def dz(self):
        return self.H / self.Nz

    @property
    def theta_top(self):
        return self.Qb / (self.alpha * self.g)

    @functools.cached_property
    def poisson_diagonals(self):
        """``(dl, d, du)`` of the pressure solve, each contiguous ``(2, Ny, Nx // 2 + 1, Nz)`` in the config's dtype.

        The discrete MAC Laplacian in the Fourier modes of the periodic
        horizontals: ``lam(ky, kx) = (2 cos(2 pi ky / Ny) - 2) / dy^2 + (2
        cos(2 pi kx / Nx) - 2) / dx^2`` on the diagonal, ``1 / dz^2`` off it,
        Neumann ends by ghost reflection. The (0, 0) mode is singular (a
        constant); it is pinned: ``d = 1``, ``du = 0`` at its level 0 and
        ``dl = 0`` at its level 1. The leading 2 is the real and the imaginary
        part of the right-hand side, which share the coefficients. The
        eigenvalues are computed in float64 and rounded once.
        """
        Ny, Nx, Nz, Nxr = self.Ny, self.Nx, self.Nz, self.Nx // 2 + 1
        dx, dy, dz = (float(v) for v in (self.dx, self.dy, self.dz))
        lam_y = (2.0 * np.cos(2.0 * np.pi * np.arange(Ny) / Ny) - 2.0) / dy**2
        lam_x = (2.0 * np.cos(2.0 * np.pi * np.arange(Nxr) / Nx) - 2.0) / dx**2
        lam = lam_y[:, None] + lam_x[None, :]
        inv_dz2 = 1.0 / dz**2
        dl = np.full((Ny, Nxr, Nz), inv_dz2)
        du = np.full((Ny, Nxr, Nz), inv_dz2)
        dl[..., 0] = 0.0
        du[..., -1] = 0.0
        d = np.broadcast_to(-2.0 * inv_dz2 + lam[..., None], (Ny, Nxr, Nz)).copy()
        # Neumann ends: the ghost reflection removes one off-diagonal coupling.
        d[..., 0] += inv_dz2
        d[..., -1] += inv_dz2
        d[0, 0, 0] = 1.0
        du[0, 0, 0] = 0.0
        if Nz > 1:
            dl[0, 0, 1] = 0.0
        dtype, device = self.H.dtype, self.H.device
        return tuple(torch.as_tensor(np.broadcast_to(a, (2, Ny, Nxr, Nz)).copy(), dtype=dtype).to(device)
                     for a in (dl, d, du))


@dataclasses.dataclass(frozen=True)
class LESState:
    """MAC-staggered prognostic fields.

    ``u`` ``(Ny, Nx, Nz)`` at x-faces; ``v`` at y-faces; ``w`` ``(Ny, Nx,
    Nz + 1)`` at z-faces (``w[..., 0] = w[..., -1] = 0``); ``T`` at centers.
    """

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    T: torch.Tensor


def initial_state(config: LESConfig, generator: torch.Generator | None = None, noise: float = 1e-3) -> LESState:
    """A linearly stratified rest state with small T noise in the top quarter of the box.

    The noise is standard normal from ``generator`` (default: a
    ``torch.Generator`` seeded with 0), drawn on the CPU and moved to the
    config's device, so the same generator gives the same fields on any
    device. They are not the JAX package's fields (its ``jax.random`` key).
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    dtype, device = config.H.dtype, config.H.device
    Ny, Nx, Nz = config.Ny, config.Nx, config.Nz
    zc = (torch.arange(Nz, dtype=dtype, device=device) + 0.5) * config.dz - config.H
    T = config.T_surface + config.dTdz * zc  # T(z = 0-) = T_surface
    T = torch.broadcast_to(T, (Ny, Nx, Nz))
    mask = (zc > -0.25 * config.H).to(dtype)
    draw = torch.randn((Ny, Nx, Nz), generator=generator, dtype=dtype).to(device)
    T = T + noise * mask * draw
    zeros = torch.zeros((Ny, Nx, Nz), dtype=dtype, device=device)
    return LESState(u=zeros, v=zeros, w=torch.zeros((Ny, Nx, Nz + 1), dtype=dtype, device=device), T=T)


# ---------------------------------------------------------------------------
# stencils (periodic x: axis 1, periodic y: axis 0, bounded z: axis 2)
# ---------------------------------------------------------------------------


def _xm(a):
    return torch.roll(a, 1, dims=1)


def _xp(a):
    return torch.roll(a, -1, dims=1)


def _ym(a):
    return torch.roll(a, 1, dims=0)


def _yp(a):
    return torch.roll(a, -1, dims=0)


class PeriodicY:
    """The y axis of one device: the hooks through which the step sees y.

    ``ym`` / ``yp`` shift by one row (periodic), ``pad3`` wraps three rows
    onto both ends (the WENO5 stencil), ``poisson`` is the pressure solve.
    ``parallel/les_sharding.py`` gives the same hooks over a y-decomposed
    mesh (halo rows from the neighbouring ranks, a distributed FFT), so the
    step body below is the one both run.
    """

    @staticmethod
    def ym(a):
        return _ym(a)

    @staticmethod
    def yp(a):
        return _yp(a)

    @staticmethod
    def pad3(q):
        from climateparameterizations_jl_tpu_torch.core.advection import _pad3

        return _pad3(q, 0, "wrap")

    @staticmethod
    def poisson(config: "LESConfig", rhs, tridiag_backend: str):
        return _poisson_solve(config, rhs, tridiag_backend)


PERIODIC_Y = PeriodicY()


def _divergence(config: LESConfig, u, v, w, y=PERIODIC_Y):
    """MAC divergence at centers."""
    return (_xp(u) - u) / config.dx + (y.yp(v) - v) / config.dy + (w[..., 1:] - w[..., :-1]) / config.dz


def _lap_xy(q, dx, dy, y=PERIODIC_Y):
    return (_xp(q) - 2 * q + _xm(q)) / dx**2 + (y.yp(q) - 2 * q + y.ym(q)) / dy**2


def _edge_pad_z(q):
    return torch.cat([q[..., :1], q, q[..., -1:]], dim=-1)


def _lap_z_neumann(q, dz):
    """d2/dz2 with zero-gradient (zero-flux) top and bottom."""
    qp = _edge_pad_z(q)
    return (qp[..., 2:] - 2 * q + qp[..., :-2]) / dz**2


def _smagorinsky_nu(config: LESConfig, u, v, w, y=PERIODIC_Y):
    """Eddy viscosity at cell centers from the resolved strain rate."""
    dx, dy, dz = config.dx, config.dy, config.dz
    uc = 0.5 * (u + _xp(u))
    vc = 0.5 * (v + y.yp(v))
    wc = 0.5 * (w[..., :-1] + w[..., 1:])

    def ddz_c(q):  # centered d/dz of a center field, one-sided at the ends
        qp = _edge_pad_z(q)
        return (qp[..., 2:] - qp[..., :-2]) / (2 * dz)

    S11 = (_xp(uc) - _xm(uc)) / (2 * dx)
    S22 = (y.yp(vc) - y.ym(vc)) / (2 * dy)
    S33 = ddz_c(wc)
    S12 = 0.5 * ((y.yp(uc) - y.ym(uc)) / (2 * dy) + (_xp(vc) - _xm(vc)) / (2 * dx))
    S13 = 0.5 * (ddz_c(uc) + (_xp(wc) - _xm(wc)) / (2 * dx))
    S23 = 0.5 * (ddz_c(vc) + (y.yp(wc) - y.ym(wc)) / (2 * dy))
    S2 = S11**2 + S22**2 + S33**2 + 2 * (S12**2 + S13**2 + S23**2)
    delta = (dx * dy * dz) ** (1.0 / 3.0)
    return (config.Cs * delta) ** 2 * torch.sqrt(2 * S2)


def _resolve_backend(tridiag_backend: str, device) -> str:
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    return resolve_tridiag_backend(tridiag_backend, 1, device)


def _poisson_solve(config: LESConfig, rhs, tridiag_backend: str = "auto"):
    """Invert the discrete MAC Laplacian (periodic x and y, Neumann z).

    ``rfft2`` over (y, x), one real tridiagonal solve of the stacked real and
    imaginary parts over every mode (``2 x Ny x (Nx // 2 + 1)`` systems of
    ``Nz`` levels: on the card one launch of ``csrc/thomas.cu``), ``irfft2``.
    The exact inverse of ``div(grad(.))`` on this grid, up to the pinned
    constant. ``tridiag_backend="auto"`` is the kernel for CUDA state and the
    scan on the CPU; f64 state on the card needs ``"scan"`` (the kernel is
    f32, and raises).
    """
    Ny, Nx = config.Ny, config.Nx
    backend = _resolve_backend(tridiag_backend, rhs.device)
    rhat = torch.fft.rfft2(rhs, dim=(0, 1))  # (Ny, Nx // 2 + 1, Nz) complex
    b = torch.stack([rhat.real, rhat.imag])
    b[:, 0, 0, 0] = 0.0  # the pinned (0, 0) mode
    dl, d, du = config.poisson_diagonals
    x = tridiagonal_solve(dl, d, du, b, backend=backend)
    return torch.fft.irfft2(torch.complex(x[0], x[1]), s=(Ny, Nx), dim=(0, 1)).to(rhs.dtype)


def surface_theta_flux(config: LESConfig, t):
    """The surface heat flux at time ``t`` (the diurnal cycle where configured)."""
    if config.diurnal:
        from climateparameterizations_jl_tpu_torch.core.constants import diurnal_cycle

        return config.theta_top * diurnal_cycle(t)
    return config.theta_top


def _tendencies(config: LESConfig, state: LESState, t, coriolis: bool = True, y=PERIODIC_Y):
    """``(du/dt, dv/dt, dw_int/dt, dT/dt)`` before the pressure projection.

    ``coriolis=False`` leaves out the rotation: the forward-Euler path applies
    it forward-backward in :func:`_advance` (the repo-wide Coriolis rule);
    RK3 keeps it in the tendency.
    """
    c = config
    dx, dy, dz = c.dx, c.dy, c.dz
    u, v, w, T = state.u, state.v, state.w, state.T

    nu_e = _smagorinsky_nu(c, u, v, w, y)
    nu_c = c.nu + nu_e  # at centers
    kap_c = c.nu + nu_e / c.Pr_t

    # --- interpolations ---------------------------------------------------
    w_zc = 0.5 * (w[..., :-1] + w[..., 1:])  # w at centers
    uc = 0.5 * (u + _xp(u))  # u at centers
    vc = 0.5 * (v + y.yp(v))  # v at centers

    def zface_of_center(q):  # interior z-faces 1..Nz-1
        return 0.5 * (q[..., :-1] + q[..., 1:])

    # --- temperature ------------------------------------------------------
    if c.advection == "weno5":
        from climateparameterizations_jl_tpu_torch.core.advection import weno5_advective_flux

        FTx = weno5_advective_flux(u, T, axis=1, boundary="periodic")
        FTy = weno5_advective_flux(v, T, axis=0, boundary="periodic", pad=y.pad3)
        FTz_int = weno5_advective_flux(w[..., 1:-1], T, axis=2, boundary="edge")
    elif c.advection == "centered":
        FTx = u * 0.5 * (T + _xm(T))
        FTy = v * 0.5 * (T + y.ym(T))
        FTz_int = w[..., 1:-1] * zface_of_center(T)
    else:
        # A misspelt scheme that ran centered advection would corrupt the generated data.
        raise ValueError(f"unknown advection scheme {c.advection!r} (expected 'weno5' or 'centered')")
    zeros_f = torch.zeros_like(w[..., :1])
    FTz = torch.cat([zeros_f, FTz_int, zeros_f], dim=-1)
    adv_T = (_xp(FTx) - FTx) / dx + (y.yp(FTy) - FTy) / dy + (FTz[..., 1:] - FTz[..., :-1]) / dz
    dTdt = -adv_T + kap_c * (_lap_xy(T, dx, dy, y) + _lap_z_neumann(T, dz))
    # Surface heat flux into the top cell; fixed-gradient bottom: the upward
    # flux -kappa dTdz leaves through the bottom face, which keeps the deep
    # stratification against the zero-flux Laplacian.
    dTdt[..., -1] += -surface_theta_flux(c, t) / dz
    dTdt[..., 0] += -kap_c[..., 0] * c.dTdz / dz

    # --- u momentum (x-faces) ----------------------------------------------
    u_corner = 0.5 * (u + y.ym(u))  # (x-face, y-face)
    v_corner = 0.5 * (v + _xm(v))
    u_zf = zface_of_center(u)  # interior z-faces
    w_xf = 0.5 * (w + _xm(w))  # (x-face, z-faces)
    if c.momentum_advection == "weno5":
        from climateparameterizations_jl_tpu_torch.core.advection import weno5_advective_flux

        # Periodic face k lies between u-points k-1 and k, i.e. at T-center
        # k-1, where the advecting velocity is uc[k-1]: hence _xm, then _xp.
        Fuu = _xp(weno5_advective_flux(_xm(uc), u, axis=1, boundary="periodic"))  # centers
        Fuv = weno5_advective_flux(v_corner, u, axis=0, boundary="periodic", pad=y.pad3)  # corners
        Fuw_int = weno5_advective_flux(w_xf[..., 1:-1], u, axis=2, boundary="edge")
    elif c.momentum_advection == "centered":
        Fuu = uc * uc  # centers
        Fuv = u_corner * v_corner
        Fuw_int = u_zf * w_xf[..., 1:-1]
    else:
        raise ValueError(
            f"unknown momentum advection scheme {c.momentum_advection!r} (expected 'weno5' or 'centered')"
        )
    Fuw = torch.cat([zeros_f, Fuw_int, zeros_f], dim=-1)
    adv_u = (Fuu - _xm(Fuu)) / dx + (y.yp(Fuv) - Fuv) / dy + (Fuw[..., 1:] - Fuw[..., :-1]) / dz
    v_at_u = 0.5 * (v_corner + y.yp(v_corner))
    nu_u = 0.5 * (nu_c + _xm(nu_c))
    f_u = c.f if coriolis else torch.zeros_like(c.f)
    dudt = -adv_u + f_u * v_at_u + nu_u * (_lap_xy(u, dx, dy, y) + _lap_z_neumann(u, dz))
    dudt[..., -1] += -c.Qu / dz

    # --- v momentum (y-faces) ----------------------------------------------
    v_zf = zface_of_center(v)
    w_yf = 0.5 * (w + y.ym(w))
    if c.momentum_advection == "weno5":
        Fvv = y.yp(weno5_advective_flux(y.ym(vc), v, axis=0, boundary="periodic", pad=y.pad3))
        # The WENO corner flux upwinds v along x, so Fuv is not reused.
        Fvu = weno5_advective_flux(u_corner, v, axis=1, boundary="periodic")
        Fvw_int = weno5_advective_flux(w_yf[..., 1:-1], v, axis=2, boundary="edge")
    else:
        Fvv = vc * vc
        Fvu = Fuv  # the same corner product
        Fvw_int = v_zf * w_yf[..., 1:-1]
    Fvw = torch.cat([zeros_f, Fvw_int, zeros_f], dim=-1)
    adv_v = (_xp(Fvu) - Fvu) / dx + (Fvv - y.ym(Fvv)) / dy + (Fvw[..., 1:] - Fvw[..., :-1]) / dz
    u_at_v = 0.5 * (u_corner + _xp(u_corner))
    nu_v = 0.5 * (nu_c + y.ym(nu_c))
    dvdt = -adv_v - f_u * u_at_v + nu_v * (_lap_xy(v, dx, dy, y) + _lap_z_neumann(v, dz))

    # --- w momentum (interior z-faces) --------------------------------------
    if c.momentum_advection == "weno5":
        Fww = weno5_advective_flux(w_zc, w, axis=2, boundary="edge")  # centers
        Fwu = weno5_advective_flux(u_zf, w[..., 1:-1], axis=1, boundary="periodic")
        Fwv = weno5_advective_flux(v_zf, w[..., 1:-1], axis=0, boundary="periodic", pad=y.pad3)
    else:
        Fww = w_zc * w_zc  # centers
        Fwu = u_zf * w_xf[..., 1:-1]  # (x-face, interior z-face)
        Fwv = v_zf * w_yf[..., 1:-1]
    adv_w = (_xp(Fwu) - Fwu) / dx + (y.yp(Fwv) - Fwv) / dy + (Fww[..., 1:] - Fww[..., :-1]) / dz
    T_zf = zface_of_center(T)
    b = c.g * c.alpha * (T_zf - c.T_surface)
    nu_w = zface_of_center(nu_c)
    w_int = w[..., 1:-1]
    lap_w = _lap_xy(w_int, dx, dy, y) + (w[..., 2:] - 2 * w_int + w[..., :-2]) / dz**2
    dwdt = -adv_w + b + nu_w * lap_w
    return dudt, dvdt, dwdt, dTdt


def _add_interior_z(w, dw):
    """``w`` with ``dw`` added on its interior z-faces (JAX's ``w.at[..., 1:-1].add(dw)``, out of place)."""
    out = w.clone()
    out[..., 1:-1] += dw
    return out


def _project(config: LESConfig, u_star, v_star, w_star, dt, tridiag_backend: str = "auto", y=PERIODIC_Y):
    """Pressure projection: make ``(u, v, w)`` discretely divergence-free (one Poisson solve)."""
    c = config
    div = _divergence(c, u_star, v_star, w_star, y)
    phi = y.poisson(c, div / dt, tridiag_backend)
    u = u_star - dt * (phi - _xm(phi)) / c.dx
    v = v_star - dt * (phi - y.ym(phi)) / c.dy
    w = _add_interior_z(w_star, -dt * (phi[..., 1:] - phi[..., :-1]) / c.dz)
    return u, v, w


def _advance(config: LESConfig, state: LESState, dt, t, fb_coriolis: bool = False,
             tridiag_backend: str = "auto", y=PERIODIC_Y) -> LESState:
    """Tendencies, predictor and projection over a (sub)step of size ``dt``."""
    dudt, dvdt, dwdt, dTdt = _tendencies(config, state, t, coriolis=not fb_coriolis, y=y)
    u_star = state.u + dt * dudt
    v_star = state.v + dt * dvdt
    if fb_coriolis:
        # Forward-backward rotation: v sees the rotated u (neutral for inertial oscillations).
        c = config
        v_corner = 0.5 * (v_star + _xm(v_star))
        u_star = u_star + dt * c.f * 0.5 * (v_corner + y.yp(v_corner))
        u_corner = 0.5 * (u_star + y.ym(u_star))
        v_star = v_star - dt * c.f * 0.5 * (u_corner + _xp(u_corner))
    w_star = _add_interior_z(state.w, dt * dwdt)
    u, v, w = _project(config, u_star, v_star, w_star, dt, tridiag_backend, y)
    return LESState(u=u, v=v, w=w, T=state.T + dt * dTdt)


def _mix(a: LESState, b: LESState, wa: float, wb: float) -> LESState:
    return LESState(*(wa * getattr(a, f) + wb * getattr(b, f) for f in ("u", "v", "w", "T")))


def les_step(config: LESConfig, state: LESState, dt, method: str = "euler", t=0.0,
             tridiag_backend: str = "auto", y=PERIODIC_Y) -> LESState:
    """One LES step at simulation time ``t`` (the diurnal forcing reads it).

    ``method``:

    - ``"euler"``: forward Euler and one projection (forward-backward
      Coriolis); relies on the SGS dissipation for stability (CFL up to
      about 0.2). One Poisson solve.
    - ``"rk3"``: 3-stage SSP Runge-Kutta (Shu-Osher), a projection after
      every stage; CFL up to about 0.8. Three Poisson solves.

    Each Poisson solve is one Thomas launch on the card
    (``tridiag_backend="auto"``). ``y`` holds the y-axis hooks
    (:class:`PeriodicY`): the default is this device's whole y axis;
    ``parallel/les_sharding.py`` passes a y-decomposed one.
    """
    t = torch.as_tensor(t, dtype=state.T.dtype, device=state.T.device)
    if method == "euler":
        return _advance(config, state, dt, t, fb_coriolis=True, tridiag_backend=tridiag_backend, y=y)
    if method == "rk3":
        s1 = _advance(config, state, dt, t, tridiag_backend=tridiag_backend, y=y)
        s2 = _mix(state, _advance(config, s1, dt, t + dt, tridiag_backend=tridiag_backend, y=y), 0.75, 0.25)
        s3 = _advance(config, s2, dt, t + 0.5 * dt, tridiag_backend=tridiag_backend, y=y)
        # Convex combinations of divergence-free fields stay divergence-free.
        return _mix(state, s3, 1.0 / 3.0, 2.0 / 3.0)
    raise ValueError(f"unknown LES method {method!r}")


def _horizontal_profiles(config: LESConfig, state: LESState, t=0.0):
    """Horizontally averaged ``(U, V, T)`` and the resolved covariance fluxes on the z-faces."""
    mean_h = lambda q: torch.mean(q, dim=(0, 1))  # noqa: E731
    U, V, Tm = mean_h(state.u), mean_h(state.v), mean_h(state.T)

    def covariance(a, b):  # a, b (Ny, Nx, Nz - 1) at interior faces
        return mean_h(a * b) - mean_h(a) * mean_h(b)

    u_zf = 0.5 * (state.u[..., :-1] + state.u[..., 1:])
    v_zf = 0.5 * (state.v[..., :-1] + state.v[..., 1:])
    T_zf = 0.5 * (state.T[..., :-1] + state.T[..., 1:])
    w_xf = 0.5 * (state.w + _xm(state.w))[..., 1:-1]
    w_yf = 0.5 * (state.w + _ym(state.w))[..., 1:-1]
    w_in = state.w[..., 1:-1]

    def pad(interior, top):
        top = torch.as_tensor(top, dtype=interior.dtype, device=interior.device).reshape(1)
        return torch.cat([torch.zeros_like(interior[:1]), interior, top])

    t = torch.as_tensor(t, dtype=state.T.dtype, device=state.T.device)
    uw = pad(covariance(u_zf, w_xf), config.Qu)
    vw = pad(covariance(v_zf, w_yf), 0.0)
    wT = pad(covariance(T_zf, w_in), surface_theta_flux(config, t))
    return U, V, Tm, uw, vw, wT


def run_les(config: LESConfig, state0: LESState | None = None, dt: float = 10.0, n_save: int = 48,
            save_every: int = 60, generator: torch.Generator | None = None, method: str = "euler",
            max_frames_per_dispatch: int = 256, max_steps_per_dispatch: int | None = None,
            tridiag_backend: str = "auto") -> ColumnTimeSeries:
    """Integrate the LES and return its horizontally averaged profiles, ``n_save + 1`` frames.

    The first frame is profiled before any step, then one every
    ``save_every`` steps. A drop-in for the synthetic stand-ins and the
    LESbrary reader. The tensors stay on the config's device. ``state0``
    defaults to :func:`initial_state` drawn from ``generator``.
    ``max_frames_per_dispatch`` and ``max_steps_per_dispatch`` are the JAX
    package's chunking of its jitted scans; they are accepted and have no
    effect here, where the steps run eagerly and give the same frames in any
    chunking.
    """
    del max_frames_per_dispatch, max_steps_per_dispatch
    c = config
    state = state0 if state0 is not None else initial_state(c, generator)
    dtype, device = state.T.dtype, state.T.device
    backend = _resolve_backend(tridiag_backend, device)
    dt = torch.as_tensor(dt, dtype=dtype, device=device)
    t = torch.zeros((), dtype=dtype, device=device)
    frames = [_horizontal_profiles(c, state)]
    for _ in range(n_save):
        for _ in range(save_every):
            state = les_step(c, state, dt, method, t, tridiag_backend=backend)
            t = t + dt
        frames.append(_horizontal_profiles(c, state, t))
    U, V, Tm, uw, vw, wT = (torch.stack([f[i] for f in frames]) for i in range(6))
    times = torch.arange(n_save + 1, dtype=dtype, device=device) * (save_every * dt)
    return ColumnTimeSeries(
        u=U, v=V, T=Tm, uw=uw, vw=vw, wT=wT, t=times,
        H=c.H, f=c.f, g=c.g, alpha=c.alpha, beta=torch.zeros_like(c.alpha),
        u_top=c.Qu, theta_top=c.theta_top, theta_bottom=c.dTdz,
        diurnal_amplitude=c.theta_top if c.diurnal else torch.zeros_like(c.theta_top),
    )


def stable_dt(config: LESConfig, u_max: float = 0.1, cfl: float = 0.2) -> float:
    """Advective and diffusive time-step bound (the constant-nu part only).

    ``cfl`` up to about 0.2 with ``method="euler"``, 0.8 with ``"rk3"``.
    """
    h = float(min(config.dx, config.dy, config.dz))
    adv = cfl * h / max(u_max, 1e-6)
    # Smagorinsky nu ~ (Cs h)^2 |S| with |S| ~ u_max / h.
    nu_est = float(config.nu) + float(config.Cs * h) ** 2 * u_max / h
    # 3-D forward-Euler diffusion limit: dt <= h^2 / (6 nu) for equal spacing.
    diff = h**2 / (6.0 * max(nu_est, 1e-12))
    return min(adv, diff)
