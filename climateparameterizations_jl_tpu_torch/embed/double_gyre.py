"""3-D wind-driven double gyre with an embedded learned column closure.

Port of ``climateparameterizations_jl_tpu/embed/double_gyre.py`` (the
reference's ``free_convection/double_gyre.jl:60-196``: a 96x96x32
beta-plane basin, double-gyre wind stress, surface temperature restoring,
bottom drag, convective adjustment; ``free_convection/double_gyre_nn.jl:122-168``:
the trained free-convection MLP as a per-column heat-flux forcing). A
hydrostatic Boussinesq basin:

- **Arakawa C-grid**, flat bottom, closed basin; fields are ``(Ny, Nx, Nz)``
  with the column axis last, so every column op (implicit mixing,
  convective adjustment, the NN closure) is one batched op over the
  ``Ny x Nx`` columns.
- **Semi-implicit free surface**: ``(1 - g H dt^2 lap) d_eta = -dt div(H
  u*)`` solved directly in the cosine basis of the Neumann walls: two DCT
  products in, a pointwise divide, two out (f32 products with TF32 off).
- **Hydrostatic pressure** from the linear EOS ``b = g alpha (T - T0)`` by
  a reversed cumulative sum along z.
- **Vertical mixing**: backward Euler, three batched Thomas solves per step
  over every column (T at ``(Ny, Nx)``, u at ``(Ny, Nx + 1)``, v at ``(Ny +
  1, Nx)`` columns): on the card the kernel ``csrc/thomas.cu`` through
  ``tridiag_backend="cuda"``; convective adjustment raises the diffusivity
  where ``dT/dz < 0``.
- **NN closure**: the free-convection MLP ``T -> w'T'`` on every column as
  one batched call per step.

Advection is WENO5 upwind by default for tracer and momentum (the
reference's ``advection = WENO5()``, ``double_gyre.jl:130``); ``advection``
/ ``momentum_advection`` keep the 2nd-order schemes, and
``linear_momentum`` gives the linear gyre. The JAX package scans the steps
inside jitted chunks; here they run eagerly in the same chunks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import apply_closure
from climateparameterizations_jl_tpu_torch.core.advection import weno5_advective_flux, weno5_padded_face_values
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import implicit_diffusion_step

_STATIC = ("linear_momentum", "advection", "momentum_advection")


@dataclasses.dataclass(frozen=True)
class DoubleGyreModel:
    """Basin configuration, 0-d tensors (defaults follow ``double_gyre.jl:60-120``'s regime)."""

    Lx: torch.Tensor  # basin width [m]
    Ly: torch.Tensor  # basin length [m]
    H: torch.Tensor  # depth [m]
    f0: torch.Tensor  # Coriolis at the southern wall [1/s]
    beta: torch.Tensor  # beta-plane gradient [1/(m s)]
    g: torch.Tensor  # gravity [m/s^2]
    alpha: torch.Tensor  # thermal expansion [1/K]
    T0: torch.Tensor  # EOS reference temperature [C]
    tau0: torch.Tensor  # wind-stress amplitude / rho0 [m^2/s^2]
    r_drag: torch.Tensor  # linear bottom drag [1/s]
    Ah: torch.Tensor  # horizontal viscosity [m^2/s]
    Av: torch.Tensor  # vertical viscosity [m^2/s]
    kappa_h: torch.Tensor  # horizontal tracer diffusivity [m^2/s]
    kappa_v: torch.Tensor  # background vertical tracer diffusivity [m^2/s]
    kappa_conv: torch.Tensor  # convective-adjustment diffusivity [m^2/s]
    T_north: torch.Tensor  # restoring SST at the northern wall [C]
    T_south: torch.Tensor  # restoring SST at the southern wall [C]
    t_restore: torch.Tensor  # surface restoring timescale [s]
    Nx: int = 96
    Ny: int = 96
    Nz: int = 32
    linear_momentum: bool = False
    advection: str = "weno5"  # tracer advection: "weno5" or "centered"
    momentum_advection: str = "weno5"  # "weno5" (flux form) or "centered" (advective form)

    @classmethod
    def default(cls, Nx: int = 96, Ny: int = 96, Nz: int = 32, dtype=torch.float32, device=None,
                **overrides) -> "DoubleGyreModel":
        """The JAX package's defaults, on ``cuda`` unless the caller asks for the CPU."""
        device = resolve_device(device)
        vals = dict(
            Lx=3.84e6, Ly=3.84e6, H=1.8e3,
            f0=1e-4, beta=1.5e-11, g=9.80665, alpha=2e-4, T0=10.0,
            tau0=1e-4, r_drag=1e-6, Ah=5e3, Av=1e-3,
            kappa_h=1e3, kappa_v=1e-5, kappa_conv=1.0,
            T_north=2.0, T_south=22.0, t_restore=30.0 * 86400.0,
        )
        static = {k: overrides.pop(k) for k in _STATIC if k in overrides}
        vals.update(overrides)
        leaves = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in vals.items()}
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

    def y_centers(self, dtype=torch.float32):
        return (torch.arange(self.Ny, dtype=dtype, device=self.H.device) + 0.5) * self.dy

    def wind_stress(self, dtype=torch.float32):
        """Zonal double-gyre wind stress at cell-center latitudes ``(Ny,)``: ``-tau0 cos(2 pi y / Ly)``."""
        y = self.y_centers(dtype)
        return -self.tau0 * torch.cos(2.0 * math.pi * y / self.Ly)

    def restoring_sst(self, dtype=torch.float32):
        """Linear north-south restoring target ``(Ny,)``."""
        y = self.y_centers(dtype)
        return self.T_south + (self.T_north - self.T_south) * y / self.Ly


@dataclasses.dataclass(frozen=True)
class DoubleGyreState:
    """C-grid prognostic fields, z last (bottom -> top).

    ``u``: ``(Ny, Nx + 1, Nz)`` at x-faces (walls pinned to 0); ``v``:
    ``(Ny + 1, Nx, Nz)`` at y-faces; ``T``: ``(Ny, Nx, Nz)``; ``eta``:
    ``(Ny, Nx)`` free surface.
    """

    u: torch.Tensor
    v: torch.Tensor
    T: torch.Tensor
    eta: torch.Tensor

    @classmethod
    def rest(cls, model: DoubleGyreModel, dtype=torch.float32, stratification: float = 5e-3) -> "DoubleGyreState":
        """Rest, a linear stratification and the restoring SST ramp blended into the top quarter (model's device)."""
        Ny, Nx, Nz = model.Ny, model.Nx, model.Nz
        device = model.H.device
        zc = (torch.arange(Nz, dtype=dtype, device=device) + 0.5) * model.dz - model.H
        T_strat = model.T0 + stratification * (zc + model.H)
        sst = model.restoring_sst(dtype)
        w = torch.clamp((zc + 0.25 * model.H) / (0.25 * model.H), 0.0, 1.0)
        T = T_strat[None, None, :] + w[None, None, :] * (sst[:, None, None] - model.T0)
        return cls(
            u=torch.zeros((Ny, Nx + 1, Nz), dtype=dtype, device=device),
            v=torch.zeros((Ny + 1, Nx, Nz), dtype=dtype, device=device),
            T=torch.broadcast_to(T, (Ny, Nx, Nz)).contiguous(),
            eta=torch.zeros((Ny, Nx), dtype=dtype, device=device),
        )


# ----------------------------------------------------------------------------
# spatial operators
# ----------------------------------------------------------------------------


def _zero_pad(x, axis: int):
    """``x`` with one zero plane on both ends of ``axis`` (interior u or v faces -> the full face array, 0 walls)."""
    z = torch.zeros_like(x.narrow(axis, 0, 1))
    return torch.cat([z, x, z], dim=axis)


def _edge_pad(x, axis: int):
    """``x`` with its edge planes repeated once on both ends of ``axis``."""
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)], dim=axis)


def _set_at(x, axis: int, index: int, value):
    """``x`` with the plane ``index`` of ``axis`` replaced by ``value`` (out of place)."""
    n = x.shape[axis]
    index = index % n
    parts = [x.narrow(axis, 0, index), value.unsqueeze(axis), x.narrow(axis, index + 1, n - index - 1)]
    return torch.cat(parts, dim=axis)


def hydrostatic_pressure(model: DoubleGyreModel, T):
    """Kinematic hydrostatic pressure at centers from ``b = g alpha (T - T0)``.

    ``p(z) = -int_z^0 b dz'`` as a reversed cumulative sum along z; the top
    half-cell takes b/2 (midpoint rule).
    """
    b = model.g * model.alpha * (T - model.T0)
    below_top = torch.cumsum(b.flip(-1), dim=-1).flip(-1)
    return -model.dz * (below_top - 0.5 * b)


def vertical_velocity(model: DoubleGyreModel, u, v):
    """Diagnostic w at z-faces ``(Ny, Nx, Nz+1)`` from continuity (w = 0 at the bottom)."""
    div_h = (u[:, 1:, :] - u[:, :-1, :]) / model.dx + (v[1:, :, :] - v[:-1, :, :]) / model.dy
    w_int = -model.dz * torch.cumsum(div_h, dim=-1)
    zeros = torch.zeros(div_h.shape[:-1] + (1,), dtype=u.dtype, device=u.device)
    return torch.cat([zeros, w_int], dim=-1)


class WalledY:
    """The y axis of the basin as one device holds it: the hooks through which the step sees y.

    Fields are held as ``n`` rows of cells from global row ``offset`` (and
    ``n + 1`` rows of v-faces, the local cells' both sides); ``south_wall``
    / ``north_wall`` say whether the block ends at a basin wall. Every
    y-stencil of :func:`double_gyre_step` reads its neighbours through
    :meth:`halo`: edge copies at a wall (the zero-flux padding), the
    neighbouring rank's rows elsewhere. The default is the whole axis on one
    device; ``parallel/gyre_sharding.py`` gives the y-decomposed one, so
    both run this step body.
    """

    def __init__(self, Ny: int, n: int | None = None, offset: int = 0, south_wall: bool = True,
                 north_wall: bool = True):
        self.Ny, self.n, self.offset = Ny, Ny if n is None else n, offset
        self.south_wall, self.north_wall = south_wall, north_wall

    def rows(self, x):
        """This block's rows of a global ``(Ny, ...)`` cell array."""
        return x.narrow(0, self.offset, self.n)

    def faces(self, x):
        """This block's ``n + 1`` rows of a global ``(Ny + 1, ...)`` face array."""
        return x.narrow(0, self.offset, self.n + 1)

    def neighbours(self, x, k: int, faces: bool):
        """``(south, north)``: the ``k`` rows beyond each end of ``x`` held elsewhere, ``None`` at a wall."""
        return None, None

    def halo(self, x, k: int, faces: bool = False):
        """``x`` extended by ``k`` rows on both ends: the neighbours' rows, or copies of the edge row at a wall."""
        south, north = self.neighbours(x, k, faces)
        edge = lambda row: row.expand(k, *x.shape[1:])  # noqa: E731
        south = edge(x[:1]) if south is None else south
        north = edge(x[-1:]) if north is None else north
        return torch.cat([south, x, north], dim=0)

    def zero_walls(self, f):
        """A face array ``(n + 1, ...)`` with the rows on basin walls set to 0."""
        zero = torch.zeros_like(f[:1])
        return torch.cat([zero if self.south_wall else f[:1], f[1:-1], zero if self.north_wall else f[-1:]], dim=0)

    def weno_flux(self, v_face, q):
        """WENO5 upwind flux of the cells ``q`` on this block's ``n + 1`` y-faces (``v_face`` there), walls zeroed."""
        qL, qR = weno5_padded_face_values(self.halo(q, 3), 0, 0, q.shape[0] + 1)
        return self.zero_walls(v_face * torch.where(v_face >= 0, qL, qR))

    def free_surface(self, model, rhs, dt):
        return solve_free_surface(model, rhs, dt)


def _laplacian_h(phi, dx, dy, axis_x=1, axis_y=0, y=None, faces: bool = False):
    """Horizontal Laplacian with zero-flux (free-slip) walls via edge padding.

    ``y`` (a :class:`WalledY`, for ``axis_y = 0``) supplies the y
    neighbours; ``faces`` marks a v-face array.
    """
    px = _edge_pad(phi, axis_x)
    n = phi.shape[axis_x]
    d2x = (px.narrow(axis_x, 2, n) - 2 * phi + px.narrow(axis_x, 0, n)) / dx**2
    py = _edge_pad(phi, axis_y) if y is None else y.halo(phi, 1, faces)
    m = phi.shape[axis_y]
    d2y = (py.narrow(axis_y, 2, m) - 2 * phi + py.narrow(axis_y, 0, m)) / dy**2
    return d2x + d2y


# ----------------------------------------------------------------------------
# barotropic mode: direct DCT Helmholtz solve
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _dct_matrix_np(N: int, dtype_name: str = "float32"):
    """Orthonormal DCT-II basis matrix ``(N, N)`` as numpy: rows are modes, columns cells."""
    n = np.arange(N)
    k = n[:, None]
    M = np.cos(np.pi * (n[None, :] + 0.5) * k / N)
    M *= np.sqrt(2.0 / N)
    M[0] *= np.sqrt(0.5)
    return M.astype(dtype_name)


@functools.lru_cache(maxsize=16)
def _dct_matrix(N: int, dtype_name: str = "float32", device=None):
    """:func:`_dct_matrix_np` as a tensor on ``device``, made once per (size, dtype, device)."""
    return torch.as_tensor(_dct_matrix_np(N, dtype_name), device=device)


def _neumann_laplacian_eigenvalues(model: DoubleGyreModel, dtype):
    device = model.H.device
    mx = torch.arange(model.Nx, dtype=dtype, device=device)
    my = torch.arange(model.Ny, dtype=dtype, device=device)
    lam_x = -4.0 / model.dx**2 * torch.sin(math.pi * mx / (2 * model.Nx)) ** 2
    lam_y = -4.0 / model.dy**2 * torch.sin(math.pi * my / (2 * model.Ny)) ** 2
    return lam_y[:, None] + lam_x[None, :]


@contextlib.contextmanager
def _full_precision_matmuls():
    """f32 products in IEEE f32 on the card: TF32 off inside the block, the caller's setting restored after."""
    if not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def solve_free_surface(model: DoubleGyreModel, rhs, dt):
    """Solve ``(1 - g H dt^2 lap) d_eta = rhs`` on the ``(Ny, Nx)`` grid by 2-D DCT.

    Neumann (no-normal-flow) walls make the 5-point Laplacian diagonal in
    the cosine basis, so the solve is exact and direct. The four products
    are plain ``torch.matmul`` in the input's precision (TF32 off).
    """
    dtype_name = str(rhs.dtype).replace("torch.", "")
    Cy = _dct_matrix(model.Ny, dtype_name, rhs.device)
    Cx = _dct_matrix(model.Nx, dtype_name, rhs.device)
    lam = _neumann_laplacian_eigenvalues(model, rhs.dtype)
    with _full_precision_matmuls():
        rhat = Cy @ rhs @ Cx.T
        denom = 1.0 - model.g * model.H * dt * dt * lam
        return Cy.T @ (rhat / denom) @ Cx


# ----------------------------------------------------------------------------
# closure hooks (per-column physics over the whole basin)
# ----------------------------------------------------------------------------


def nn_closure_forcing(model: DoubleGyreModel, nn, T, T_scaling: ZeroMeanUnitVarianceScaling,
                       wT_scaling: ZeroMeanUnitVarianceScaling, T_remap=None, stability_gate=None):
    """``-d/dz(w'T'_NN)`` for every column as one batched MLP call.

    Parity: ``compute_neural_network_forcing!`` (``double_gyre_nn.jl:149-168``).
    ``T_remap=(a, b)`` applies ``T -> a + T/b`` before the training scaling
    (the reference's ``T_profile = 19.65 + T_profile/20``,
    ``double_gyre_nn.jl:155``: the basin spans ~20 K, the closure's training
    columns ~1 K). ``stability_gate=s`` (K/m) tapers each interior flux face
    by ``sigmoid(-dT/dz / s)`` of the physical (pre-remap) profile, so a
    convective closure is quiet where the column is stable; the boundary
    faces stay zero, so column heat is conserved either way. The NN output
    unscales affinely (the FC NN trains against affine-scaled wT).
    """
    if stability_gate is not None:
        dTdz_phys = (T[..., 1:] - T[..., :-1]) / model.dz  # interior faces
        gate = torch.sigmoid(-dTdz_phys / stability_gate)
    if T_remap is not None:
        a, b = T_remap
        T = a + T / b
    x = T_scaling.scale(T)
    interior = wT_scaling.unscale(apply_closure(nn, x))  # dimensional (Ny, Nx, Nz-1)
    if stability_gate is not None:
        interior = interior * gate
    wT = _zero_pad(interior, -1)
    return -(wT[..., 1:] - wT[..., :-1]) / model.dz


def _implicit_vertical_mixing(model: DoubleGyreModel, u, v, T, dt, tridiag_backend="scan"):
    """Backward-Euler vertical viscosity and conv-adj diffusivity for the basin: three batched solves.

    Zero-flux boundaries through ``zero_boundary_faces=True``.
    """
    dTdz = (T[..., 1:] - T[..., :-1]) / model.dz
    kappa_int = torch.where(dTdz < 0.0, model.kappa_conv, model.kappa_v)
    kappa = torch.cat([kappa_int[..., :1], kappa_int, kappa_int[..., -1:]], dim=-1)

    def step(phi, nu_face):
        return implicit_diffusion_step(phi, nu_face, dt, model.dz, backend=tridiag_backend, zero_boundary_faces=True)

    T = step(T, kappa)
    u = step(u, model.Av.to(u.dtype).expand(u.shape[:-1] + (model.Nz + 1,)))
    v = step(v, model.Av.to(v.dtype).expand(v.shape[:-1] + (model.Nz + 1,)))
    return u, v, T


def _u_advection_weno(model: DoubleGyreModel, u, v, w, y: WalledY):
    """Flux-form WENO5 advection divergence for ``u`` at interior x-faces, ``(Ny, Nx-1, Nz)``.

    x-fluxes at T-cell centers, y-fluxes at corners (zero at the walls,
    where v = 0), z-fluxes at z-faces (edge-value products at top and
    bottom, as the tracer's).
    """
    dx, dy, dz = model.dx, model.dy, model.dz
    ui = u[:, 1:-1, :]
    uc = 0.5 * (u[:, 1:, :] + u[:, :-1, :])
    Fx = weno5_advective_flux(uc, u, axis=1, boundary="edge")  # (Ny, Nx, Nz)
    div = (Fx[:, 1:, :] - Fx[:, :-1, :]) / dx
    v_corner = 0.5 * (v[:, 1:, :] + v[:, :-1, :])  # (Ny+1, Nx-1, Nz)
    Fy = y.weno_flux(v_corner, ui)
    div = div + (Fy[1:, :, :] - Fy[:-1, :, :]) / dy
    w_u = 0.5 * (w[:, 1:, :] + w[:, :-1, :])  # (Ny, Nx-1, Nz+1)
    Fz_int = weno5_advective_flux(w_u[..., 1:-1], ui, axis=2, boundary="edge")
    Fz = torch.cat([w_u[..., :1] * ui[..., :1], Fz_int, w_u[..., -1:] * ui[..., -1:]], dim=-1)
    return div + (Fz[..., 1:] - Fz[..., :-1]) / dz


def _v_advection_weno(model: DoubleGyreModel, u, v, w, y: WalledY):
    """Flux-form WENO5 advection divergence for ``v`` on the block's y-faces, ``(n + 1, Nx, Nz)`` (rows on walls
    are not used)."""
    dx, dy, dz = model.dx, model.dy, model.dz
    vi = v
    n = v.shape[0] - 1
    vh = y.halo(v, 3, faces=True)  # faces offset-3 .. offset+n+3
    vc = 0.5 * (vh[3:n + 5] + vh[2:n + 4])  # centers offset-1 .. offset+n
    qL, qR = weno5_padded_face_values(vh, 0, 0, n + 2)
    Fy = vc * torch.where(vc >= 0, qL, qR)
    div = (Fy[1:, :, :] - Fy[:-1, :, :]) / dy
    uh = y.halo(u, 1)
    u_corner = 0.5 * (uh[1:, :, :] + uh[:-1, :, :])  # (n+1, Nx+1, Nz)
    Fx = _zero_pad(weno5_advective_flux(u_corner[:, 1:-1, :], vi, axis=1, boundary="edge"), 1)
    div = div + (Fx[:, 1:, :] - Fx[:, :-1, :]) / dx
    wh = y.halo(w, 1)
    w_v = 0.5 * (wh[1:, :, :] + wh[:-1, :, :])  # (n+1, Nx, Nz+1)
    Fz_int = weno5_advective_flux(w_v[..., 1:-1], vi, axis=2, boundary="edge")
    Fz = torch.cat([w_v[..., :1] * vi[..., :1], Fz_int, w_v[..., -1:] * vi[..., -1:]], dim=-1)
    return div + (Fz[..., 1:] - Fz[..., :-1]) / dz


# ----------------------------------------------------------------------------
# one time step
# ----------------------------------------------------------------------------


def double_gyre_step(model: DoubleGyreModel, state: DoubleGyreState, dt, nn=None,
                     T_scaling: ZeroMeanUnitVarianceScaling | None = None,
                     wT_scaling: ZeroMeanUnitVarianceScaling | None = None, tridiag_backend: str = "auto",
                     T_remap=None, nn_stability_gate=None, y: WalledY | None = None) -> DoubleGyreState:
    """Advance one step: tracer step -> explicit momentum (pressure from the updated tracer) ->
    barotropic DCT correction -> implicit vertical mixing (+ the optional NN closure).

    Both forward-backward couplings of the JAX step stay where they are:
    the pressure the momentum sees comes from the UPDATED temperature (with
    the old one both halves of the baroclinic oscillation are forward Euler
    and internal waves grow by about sqrt(1 + (omega dt)^2) per step), and
    v's Coriolis term sees the updated u (``u_star``). ``tridiag_backend="auto"``
    is the Thomas kernel for CUDA state and the plain scan on the CPU
    (``train/nde.py::resolve_tridiag_backend``). ``y`` holds the y-axis
    hooks (:class:`WalledY`; default: the whole axis on this device); with a
    y-decomposed one the state is this rank's block of rows.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    tridiag_backend = resolve_tridiag_backend(tridiag_backend, 1, state.T.device)
    y = WalledY(model.Ny) if y is None else y
    u, v, T, eta = state.u, state.v, state.T, state.eta
    dx, dy, dz = model.dx, model.dy, model.dz
    dtype = T.dtype

    w = vertical_velocity(model, u, v)

    # ---- temperature: flux-form advection + diffusion + forcings ---------
    if model.advection == "weno5":
        Fx = _zero_pad(weno5_advective_flux(u[:, 1:-1, :], T, axis=1, boundary="edge"), 1)
        Fy = y.weno_flux(v, T)
        Fz_int = weno5_advective_flux(w[..., 1:-1], T, axis=2, boundary="edge")
        Fz = torch.cat([w[..., :1] * T[..., :1], Fz_int, w[..., -1:] * T[..., -1:]], dim=-1)
    elif model.advection == "centered":
        T_at_u = 0.5 * (T[:, 1:, :] + T[:, :-1, :])
        Fx = _zero_pad(u[:, 1:-1, :] * T_at_u, 1)
        Th = y.halo(T, 1)
        Fy = y.zero_walls(v * (0.5 * (Th[1:, :, :] + Th[:-1, :, :])))
        Tz = torch.cat([T[..., :1], 0.5 * (T[..., 1:] + T[..., :-1]), T[..., -1:]], dim=-1)
        Fz = w * Tz
    else:
        raise ValueError(f"unknown advection scheme {model.advection!r} (expected 'weno5' or 'centered')")
    GT = (
        -(Fx[:, 1:, :] - Fx[:, :-1, :]) / dx
        - (Fy[1:, :, :] - Fy[:-1, :, :]) / dy
        - (Fz[..., 1:] - Fz[..., :-1]) / dz
        + model.kappa_h * _laplacian_h(T, dx, dy, y=y)
    )
    # Surface restoring toward T*(y) in the top cell (double_gyre.jl's restoring flux BC).
    sst_target = y.rows(model.restoring_sst(dtype))
    GT = _set_at(GT, -1, -1, GT[..., -1] + (sst_target[:, None] - T[..., -1]) / model.t_restore)
    if nn is not None:
        GT = GT + nn_closure_forcing(model, nn, T, T_scaling, wT_scaling, T_remap, nn_stability_gate)
    T_new = T + dt * GT

    p = hydrostatic_pressure(model, T_new)

    yc = y.rows(model.y_centers(dtype))
    yf = y.faces(torch.arange(model.Ny + 1, dtype=dtype, device=T.device) * dy)
    f_c = model.f0 + model.beta * yc  # at u rows
    f_f = model.f0 + model.beta * yf  # at v rows

    # ---- u tendency at interior x-faces (i = 1..Nx-1) --------------------
    v_at_u = 0.25 * (v[:-1, :-1, :] + v[:-1, 1:, :] + v[1:, :-1, :] + v[1:, 1:, :])  # (Ny, Nx-1, Nz)
    dpdx = (p[:, 1:, :] - p[:, :-1, :]) / dx
    detadx = (eta[:, 1:] - eta[:, :-1])[..., None] / dx
    Gu = f_c[:, None, None] * v_at_u - dpdx - model.g * detadx
    Gu = Gu + model.Ah * _laplacian_h(u, dx, dy, y=y)[:, 1:-1, :]
    if not model.linear_momentum:
        if model.momentum_advection == "weno5":
            Gu = Gu - _u_advection_weno(model, u, v, w, y)
        elif model.momentum_advection == "centered":
            ui = u[:, 1:-1, :]
            dudx = (u[:, 2:, :] - u[:, :-2, :]) / (2 * dx)
            up = y.halo(u, 1)
            dudy = (up[2:, 1:-1, :] - up[:-2, 1:-1, :]) / (2 * dy)
            uz = _edge_pad(u, 2)
            dudz = (uz[:, 1:-1, 2:] - uz[:, 1:-1, :-2]) / (2 * dz)
            w_at_u = 0.5 * (w[:, 1:, :] + w[:, :-1, :])
            w_at_u = 0.5 * (w_at_u[..., 1:] + w_at_u[..., :-1])
            Gu = Gu - (ui * dudx + v_at_u * dudy + w_at_u * dudz)
        else:
            raise ValueError(f"unknown momentum advection scheme {model.momentum_advection!r} "
                             "(expected 'weno5' or 'centered')")
    # Wind stress (top cell) + bottom drag (bottom cell).
    tau_x = y.rows(model.wind_stress(dtype))
    Gu = _set_at(Gu, -1, -1, Gu[..., -1] + tau_x[:, None] / dz)
    Gu = _set_at(Gu, -1, 0, Gu[..., 0] + (-model.r_drag * u[:, 1:-1, 0]))
    u_star = u + dt * _zero_pad(Gu, 1)

    # ---- v tendency on the block's y-faces (those on walls are zeroed) ---
    # Forward-backward Coriolis: v sees the updated u (u_star).
    u_fb = y.halo(u_star, 1)
    u_at_v = 0.25 * (u_fb[:-1, :-1, :] + u_fb[:-1, 1:, :] + u_fb[1:, :-1, :] + u_fb[1:, 1:, :])  # (n+1, Nx, Nz)
    ph, eh = y.halo(p, 1), y.halo(eta, 1)
    dpdy = (ph[1:, :, :] - ph[:-1, :, :]) / dy
    detady = (eh[1:, :] - eh[:-1, :])[..., None] / dy
    Gv = -f_f[:, None, None] * u_at_v - dpdy - model.g * detady
    Gv = Gv + model.Ah * _laplacian_h(v, dx, dy, y=y, faces=True)
    if not model.linear_momentum:
        if model.momentum_advection == "weno5":
            # Advects the pre-rotation v with the pre-step u (the forward-backward trick is the Coriolis term's).
            Gv = Gv - _v_advection_weno(model, u, v, w, y)
        else:  # "centered" (the scheme was checked in the u block)
            vi = v
            vh = y.halo(v, 1, faces=True)
            dvdy = (vh[2:, :, :] - vh[:-2, :, :]) / (2 * dy)
            vp = _edge_pad(v, 1)
            dvdx = (vp[:, 2:, :] - vp[:, :-2, :]) / (2 * dx)
            vz = _edge_pad(v, 2)
            dvdz = (vz[:, :, 2:] - vz[:, :, :-2]) / (2 * dz)
            wh = y.halo(w, 1)
            w_at_v = 0.5 * (wh[1:, :, :] + wh[:-1, :, :])
            w_at_v = 0.5 * (w_at_v[..., 1:] + w_at_v[..., :-1])
            Gv = Gv - (u_at_v * dvdx + vi * dvdy + w_at_v * dvdz)
    Gv = _set_at(Gv, -1, 0, Gv[..., 0] + (-model.r_drag * v[:, :, 0]))
    v_star = v + dt * y.zero_walls(Gv)

    # ---- barotropic correction (semi-implicit free surface) --------------
    ubar = torch.mean(u_star, dim=-1)
    vbar = torch.mean(v_star, dim=-1)
    div_bar = (ubar[:, 1:] - ubar[:, :-1]) / dx + (vbar[1:, :] - vbar[:-1, :]) / dy
    rhs = -dt * model.H * div_bar
    d_eta = y.free_surface(model, rhs, dt)
    eta_new = eta + d_eta
    corr_x = -model.g * dt * (d_eta[:, 1:] - d_eta[:, :-1])[..., None] / dx
    dh = y.halo(d_eta, 1)
    corr_y = -model.g * dt * (dh[1:, :] - dh[:-1, :])[..., None] / dy
    u_new = torch.cat([u_star[:, :1], u_star[:, 1:-1] + corr_x, u_star[:, -1:]], dim=1)
    v_new = v_star + y.zero_walls(corr_y)

    # ---- implicit vertical mixing + convective adjustment -----------------
    u_new, v_new, T_new = _implicit_vertical_mixing(model, u_new, v_new, T_new, dt, tridiag_backend)
    # Re-pin the walls (the implicit solve keeps them, but explicitly).
    u_new = _zero_pad(u_new[:, 1:-1, :], 1)
    v_new = y.zero_walls(v_new)
    return DoubleGyreState(u=u_new, v=v_new, T=T_new, eta=eta_new)


def run_double_gyre(model: DoubleGyreModel, state0: DoubleGyreState, dt, n_save: int, save_every: int, nn=None,
                    T_scaling: ZeroMeanUnitVarianceScaling | None = None,
                    wT_scaling: ZeroMeanUnitVarianceScaling | None = None, tridiag_backend: str = "auto",
                    unroll: int = 2, T_remap=None, nn_stability_gate=None) -> DoubleGyreState:
    """Integrate the basin, saving every ``save_every`` steps; trajectories ``(n_save + 1, ...)``.

    Parity: the ``run!(simulation)`` drivers of ``double_gyre.jl:150-196``
    and ``double_gyre_nn.jl``. ``unroll`` is the JAX package's scan knob and
    is ignored here: the steps run eagerly, one after another. Runs without
    autograd.
    """
    del unroll
    state, frames = state0, [state0]
    with torch.no_grad():
        for _ in range(n_save):
            for _ in range(save_every):
                state = double_gyre_step(model, state, dt, nn, T_scaling, wT_scaling, tridiag_backend, T_remap,
                                         nn_stability_gate)
            frames.append(state)
    stack = lambda name: torch.stack([getattr(f, name) for f in frames], dim=0)  # noqa: E731
    return DoubleGyreState(u=stack("u"), v=stack("v"), T=stack("T"), eta=stack("eta"))


def barotropic_streamfunction(model: DoubleGyreModel, u):
    """Depth-integrated streamfunction ``psi(y, x)`` [m^3/s] from u.

    ``U = H mean_z(u)`` integrated in y from the southern wall; shows the
    double-gyre pattern (western intensification, two counter-rotating cells).
    ``u`` is ``(..., Ny, Nx + 1, Nz)``: leading axes (a trajectory's time) are
    batched, and each slice gives the single-field result.
    """
    U = model.H * torch.mean(u, dim=-1)  # (..., Ny, Nx+1)
    Uc = 0.5 * (U[..., 1:] + U[..., :-1])  # (..., Ny, Nx)
    return -torch.cumsum(Uc, dim=-2) * model.dy
