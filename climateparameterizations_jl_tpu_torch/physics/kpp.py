"""K-Profile Parameterization (KPP) column model, batched over leading axes.

Port of ``climateparameterizations_jl_tpu/physics/kpp.py`` (Large,
McWilliams & Doney 1994 as organized by OceanTurb; the reference's
parameter table ``k_profile_parameterization.jl:1-30``):

- **Boundary-layer depth** ``h``: the shallowest depth where the bulk
  Richardson number ``Ri_b(z) = |z| (B_sl - B(z)) / (|U_sl - U(z)|^2 + u_KE(z))``
  reaches ``CRi``, with surface-layer averages over the top ``CSL`` fraction.
- **Turbulent velocity scales** ``W_Phi(z)``: piecewise stable / wind /
  convection regimes.
- **Diffusivity** ``K_Phi = W_Phi h sigma (1 - sigma)^2 + K0`` and the
  nonlocal tracer flux ``CNL F_theta sigma (1 - sigma)^2``.

Each step diagnoses ``h`` and ``K`` from the current state, applies the
surface fluxes and the nonlocal-flux divergence explicitly, and takes one
backward-Euler diffusion step for ``(U, V, T)`` as ONE stacked batched
tridiagonal solve (``ops/tridiagonal.py::implicit_diffusion_step``): on the
card, one launch of the Thomas kernel ``csrc/thomas.cu`` per step on
``(3, ..., Nz)``.

Batch convention. States are ``(..., Nz)``; the forcing, ``h`` and every
field of :class:`KPPParameters` are either 0-d or carry the columns' batch
shape ``(...)`` (a calibration puts P parameter sets on a leading axis:
fields ``(P, 1)`` against ``(P, S, Nz)`` states). Per-column values meet
level arrays as ``x[..., None]``, exactly as ``forcing.Fb`` does.

State convention: centers ordered bottom -> top, ``z_c[k] = (k + 1/2) dz - H``.
``Fb > 0`` is surface cooling (destabilizing); ``Fu`` is the kinematic
momentum flux at the surface. Every update is out of place: calibration
differentiates through the whole solve.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from climateparameterizations_jl_tpu_torch.core.constants import diurnal_cycle
from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import implicit_diffusion_step

_DEFAULTS = dict(
    CSL=0.1, Ctau=0.4, CNL=6.33, Cstab=2.0, Cunst=6.4,
    Cn=1.0, Cmtau_U=0.25, Cmtau_T=0.5, Cmb_U=1 / 3, Cmb_T=1 / 3,
    Cd_U=0.5, Cd_T=2.5, Cb_U=0.599, Cb_T=1.36,
    CRi=0.3, CKE=4.32, CKE0=1e-11, KU0=1e-6, KT0=1e-7,
)


@dataclasses.dataclass(frozen=True)
class KPPParameters:
    """KPP constants; defaults from the reference's table (``k_profile_parameterization.jl:1-30``)."""

    CSL: torch.Tensor  # surface layer fraction
    Ctau: torch.Tensor  # von Karman constant
    CNL: torch.Tensor  # nonlocal flux amplitude
    Cstab: torch.Tensor
    Cunst: torch.Tensor
    Cn: torch.Tensor
    Cmtau_U: torch.Tensor
    Cmtau_T: torch.Tensor
    Cmb_U: torch.Tensor
    Cmb_T: torch.Tensor
    Cd_U: torch.Tensor
    Cd_T: torch.Tensor
    Cb_U: torch.Tensor
    Cb_T: torch.Tensor
    CRi: torch.Tensor
    CKE: torch.Tensor
    CKE0: torch.Tensor
    KU0: torch.Tensor
    KT0: torch.Tensor

    @classmethod
    def default(cls, dtype=torch.float32, device=None, **overrides) -> "KPPParameters":
        """The reference's values as 0-d tensors, on ``cuda`` unless the caller asks for the CPU."""
        device = resolve_device(device)
        vals = dict(_DEFAULTS)
        vals.update(overrides)
        return cls(**{k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in vals.items()})

    def Ctau_b(self, Cb, Cd, Cm_b, Cm_tau):
        """Derived wind-stress parameter of the convective regime (table lines 20-21).

        Makes the convective branch ``Cb wb (sig + Ctau_b / d3)^Cm_b`` meet the
        wind branch exactly at the regime switch ``d3 sig = Cd``, with the
        variable's own wind exponent ``Cm_tau``.
        """
        return (self.Ctau / Cb) ** (1.0 / Cm_b) * (1.0 + self.Cunst * Cd) ** (Cm_tau / Cm_b) - Cd

    def per_column(self) -> "KPPParameters":
        """Every field that carries the columns' batch shape, given a trailing level axis (0-d stay 0-d)."""
        return dataclasses.replace(self, **{f.name: _col(getattr(self, f.name)) for f in dataclasses.fields(self)})


class KPPForcing(NamedTuple):
    """Surface forcing and bottom gradient: tensors, 0-d or of the columns' batch shape."""

    Fu: torch.Tensor  # surface kinematic momentum flux (u'w' at top) [m^2/s^2]
    Fb: torch.Tensor  # surface buoyancy flux, > 0 = cooling [m^2/s^3]
    dTdz_bottom: torch.Tensor  # bottom temperature gradient [K/m]


@dataclasses.dataclass(frozen=True)
class KPPState:
    U: torch.Tensor
    V: torch.Tensor
    T: torch.Tensor


def _col(x):
    """A per-column value against a level axis: ``x[..., None]``; 0-d values and floats pass through."""
    return x[..., None] if isinstance(x, torch.Tensor) and x.dim() > 0 else x


def _pow_nonneg(x, p, tiny=1e-30):
    """``max(0, x)**p`` (fractional ``p``) with finite gradients at and below zero.

    Clamp INSIDE the power, select OUTSIDE: the unselected branch of a
    ``where`` otherwise passes ``0 * inf = NaN`` to the gradient. ``p = 0.5``
    keeps the dedicated ``sqrt``: the generic power differs by ULPs, enough
    to flip the discrete boundary-layer crossing cell in f32.
    """
    xs = torch.clamp(x, min=tiny)
    safe = torch.sqrt(xs) if isinstance(p, float) and p == 0.5 else xs**p
    return torch.where(x > tiny, safe, torch.zeros_like(safe))


def _shape_fn(sigma):
    """K-profile shape ``sigma (1 - sigma)^2`` with ``sigma`` clipped to [0, 1]."""
    s = torch.clamp(sigma, 0.0, 1.0)
    return s * (1.0 - s) ** 2


def _surface_layer_weights(zc, CSL):
    """Surface-layer averaging weights ``(..., Nz_cand, Nz_cell)``.

    Candidate bottom ``k`` (center depth ``-zc_k``) averages over the top
    ``CSL * d_k`` of the column; cell ``j`` weighs its overlap with
    ``[-CSL d_k, 0]``. A per-column ``CSL`` gives one matrix per column.
    """
    dz = zc[1] - zc[0]
    z_top = zc + 0.5 * dz
    z_bot = zc - 0.5 * dz
    thick = _col(CSL) * (-zc)  # (..., Nz_cand)
    overlap = torch.clamp(
        torch.clamp(z_top[None, :], max=0.0) - torch.maximum(z_bot[None, :], -thick[..., :, None]), min=0.0)
    return overlap / torch.clamp(overlap.sum(dim=-1, keepdim=True), min=1e-30)


def _surface_layer_anomaly(phi, W):
    """``mean_sl(phi) - phi`` in difference form: ``sum_j W_kj (phi_j - phi_k)``.

    Differencing first keeps the anomaly exactly 0 where the profile is
    uniform (the direct ``phi @ W.T - phi`` cancels two O(phi) numbers, and
    the tiny uKE floor amplifies the noise ~1e10x in the bulk Ri). An
    elementwise product and a sum over the last axis, not a matmul, so a
    batch of columns rounds as each column alone.
    """
    diff = phi[..., None, :] - phi[..., :, None]  # (..., cand k, cell j)
    return (W * diff).sum(dim=-1)


def _gradient(B, dz):
    """``jnp.gradient(B, dz, axis=-1)``: central differences inside, one-sided first order at both ends."""
    lower = (B[..., 1:2] - B[..., 0:1]) / dz
    inner = (B[..., 2:] - B[..., :-2]) * 0.5 / dz
    upper = (B[..., -1:] - B[..., -2:-1]) / dz
    return torch.cat([lower, inner, upper], dim=-1)


def bulk_richardson_number(U, V, B, zc, params: KPPParameters, Fb):
    """``Ri_b`` at each cell center (the candidate boundary-layer bottoms)."""
    dz = zc[1] - zc[0]
    W_sl = _surface_layer_weights(zc, params.CSL)

    depth = -zc
    dB = _surface_layer_anomaly(B, W_sl)
    dU2 = _surface_layer_anomaly(U, W_sl) ** 2 + _surface_layer_anomaly(V, W_sl) ** 2

    # Unresolved kinetic energy (OceanTurb form); Bz = 0 (mixed layers) and
    # Fb = 0 (pure wind) are common, so both fractional powers take the safe form.
    Bz = _gradient(B, dz)
    uKE = (
        _col(params.CKE)
        * depth ** (4.0 / 3.0)
        * _pow_nonneg(Bz, 0.5)
        * _col(_pow_nonneg(Fb, 1.0 / 3.0))
        + _col(params.CKE0)
    )
    return depth * dB / (dU2 + uKE + 1e-30)


def boundary_layer_depth(U, V, B, zc, params: KPPParameters, Fb, H):
    """Shallowest depth where ``Ri_b`` crosses ``CRi`` (linear interpolation); ``H`` without a crossing.

    Static shapes: the first crossing from the top by an argmax over a mask,
    no data-dependent control flow.
    """
    Rib = bulk_richardson_number(U, V, B, zc, params, Fb)
    depth = -zc
    Rib_td = torch.flip(Rib, dims=(-1,))  # index 0 is the surface
    depth_td = torch.flip(depth, dims=(-1,))
    crossed = Rib_td > _col(params.CRi)
    any_crossing = torch.any(crossed, dim=-1)
    # The first True: torch documents argmax's first maximum; bool needs an integer cast.
    idx = torch.argmax(crossed.to(torch.int32), dim=-1)
    idx_prev = torch.clamp(idx - 1, min=0)

    Ri1 = torch.gather(Rib_td, -1, idx_prev[..., None])[..., 0]
    Ri2 = torch.gather(Rib_td, -1, idx[..., None])[..., 0]
    d1 = depth_td[idx_prev]
    d2 = depth_td[idx]
    frac = torch.clamp((params.CRi - Ri1) / (Ri2 - Ri1 + 1e-30), 0.0, 1.0)
    h_cross = d1 + frac * (d2 - d1)
    H = torch.as_tensor(H, dtype=h_cross.dtype, device=h_cross.device)
    h = torch.where(any_crossing, h_cross, H)
    return torch.minimum(torch.maximum(h, depth_td[0]), H)


def turbulent_velocity_scales(h, params: KPPParameters, Fu, Fb, sigma):
    """``(W_U, W_T)`` at each face given the boundary-layer depth ``h``.

    ``h``, ``Fu``, ``Fb`` and the fields of ``params`` must already broadcast
    against ``sigma`` (:func:`kpp_diffusivities` passes them with a trailing
    axis, and ``params.per_column()``).
    """
    ustar = _pow_nonneg(torch.abs(Fu), 0.5)  # sqrt has an infinite gradient at Fu = 0
    wb = _pow_nonneg(Fb * h, 1.0 / 3.0)  # convective velocity
    eps = 1e-30
    # The floor keeps d3 finite in f32 at ustar = 0 (a 1e-30 floor overflowed,
    # and the wind branch's 0 * inf = NaN poisoned the gradient through the where).
    d3 = (wb / torch.clamp(ustar, min=1e-10)) ** 3

    # Destabilizing forcing caps the evaluation depth at the surface-layer
    # fraction (LMD94); stable forcing uses the full sigma.
    sig = torch.minimum(sigma, torch.as_tensor(params.CSL, device=sigma.device))
    sig_stable = torch.clamp(sigma, 0.0, 1.0)

    def scale(Cm_tau, Cm_b, Cd, Cb):
        Ctau_b = params.Ctau_b(Cb, Cd, Cm_b, Cm_tau)
        wind = params.Ctau * ustar * (1.0 + params.Cunst * d3 * sig) ** Cm_tau
        # The base is positive wherever this branch is selected and negative
        # in the unselected region (Ctau_b < 0 for tracers): the safe power.
        conv = Cb * wb * _pow_nonneg(sig + Ctau_b / (d3 + eps), Cm_b)
        unstable = torch.where(d3 * sig < Cd, wind, conv)
        # Stable branch: buoyancy flux < 0 (heating) damps turbulence.
        rb = torch.abs(Fb) * h / (ustar**3 + eps)
        stable = params.Ctau * ustar / (1.0 + params.Cstab * rb * sig_stable) ** params.Cn
        return torch.where(Fb > 0.0, unstable, stable)

    W_U = scale(params.Cmtau_U, params.Cmb_U, params.Cd_U, params.Cb_U)
    W_T = scale(params.Cmtau_T, params.Cmb_T, params.Cd_T, params.Cb_T)
    return W_U, W_T


def _boundary_mask(n: int, like):
    """``(n,)`` ones with zero end faces: no flux through the boundaries in the implicit solve."""
    mask = torch.ones(n, dtype=like.dtype, device=like.device)
    mask[0] = 0.0
    mask[-1] = 0.0
    return mask


def kpp_diffusivities(U, V, T, zf, zc, params: KPPParameters, forcing: KPPForcing, g, alpha, H):
    """Face diffusivities ``(K_U, K_T)``, the nonlocal tracer flux and ``h``."""
    B = g * alpha * T
    Fb = forcing.Fb
    h = boundary_layer_depth(U, V, B, zc, params, Fb, H)  # (...,)

    depth_f = -zf  # (Nz+1,), 0 at the top face
    sigma = depth_f / (h[..., None] + 1e-30)  # (..., Nz+1)
    pc = params.per_column()
    W_U, W_T = turbulent_velocity_scales(h[..., None], pc, _col(forcing.Fu), _col(Fb), sigma)

    shape = _shape_fn(sigma)
    in_layer = (sigma > 0.0) & (sigma < 1.0)
    zero = torch.zeros_like(shape)
    K_U = torch.where(in_layer, W_U * h[..., None] * shape, zero) + pc.KU0
    K_T = torch.where(in_layer, W_T * h[..., None] * shape, zero) + pc.KT0

    # Nonlocal heat flux (unstable forcing only): NL = CNL * F_theta * shape.
    F_theta = Fb / (g * alpha)
    NL = torch.where(_col(Fb) > 0.0, pc.CNL * _col(F_theta) * shape, zero)

    mask = _boundary_mask(sigma.shape[-1], sigma)
    return K_U * mask, K_T * mask, NL * mask, h


def _set_at(x, i: int, value):
    """``x`` with level ``i`` (0 or -1) replaced by ``value`` (per column), out of place."""
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    batch = torch.broadcast_shapes(x.shape[:-1], value.shape)
    x = x.expand(*batch, x.shape[-1])
    col = value.expand(batch)[..., None]
    return torch.cat([col, x[..., 1:]], dim=-1) if i == 0 else torch.cat([x[..., :-1], col], dim=-1)


def _add_at(x, i: int, value):
    """``x`` with ``value`` (per column) added at level ``i`` (0 or -1), out of place."""
    return _set_at(x, i, x[..., i] + value)


def kpp_diagnostic_fluxes(U, V, T, zf, zc, params: KPPParameters, forcing: KPPForcing, g, alpha, H, Nz: int):
    """Diagnostic face fluxes ``(uw, vw, wT)`` of saved KPP profiles.

    ``-K dphi/dz`` plus the nonlocal heat flux, the prescribed surface fluxes
    on the top faces and the fixed-gradient flux ``-KT0 dTdz_bottom`` on the
    bottom ``wT`` face (the ``UW, VW, WT`` outputs of the reference's KPP
    column, ``wind_mixing/src/k_profile_parameterization.jl:1-78``).
    Batches over leading axes (a whole saved trajectory at once).
    """
    dz = H / Nz
    K_U, K_T, NL, _h = kpp_diffusivities(U, V, T, zf, zc, params, forcing, g, alpha, H)
    uw = -K_U * d_center_to_face(U, dz)
    vw = -K_U * d_center_to_face(V, dz)
    wT = -K_T * d_center_to_face(T, dz) + NL
    F_theta = forcing.Fb / (g * alpha)
    uw = _set_at(uw, -1, forcing.Fu)
    wT = _set_at(wT, -1, F_theta)
    wT = _set_at(wT, 0, -params.KT0 * forcing.dTdz_bottom)
    return uw, vw, wT


def kpp_step(state: KPPState, dt, dz, zf, zc, params: KPPParameters, forcing: KPPForcing, f_cor, g, alpha, H,
             tridiag_backend: str = "auto") -> KPPState:
    """One backward-Euler KPP step (diagnose, explicit forcings, one stacked implicit solve).

    ``tridiag_backend="auto"`` is the Thomas kernel for CUDA state and the
    plain scan on the CPU (``train/nde.py::resolve_tridiag_backend``).
    """
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    U, V, T = state.U, state.V, state.T
    K_U, K_T, NL, _h = kpp_diffusivities(U, V, T, zf, zc, params, forcing, g, alpha, H)

    # Forward-backward Coriolis (V uses the updated U): neutrally stable.
    U_half = U + dt * f_cor * V
    V_half = V - dt * f_cor * U_half
    # Surface fluxes enter the top cell: dphi/dt = -F_top / dz.
    U_half = _add_at(U_half, -1, -dt * forcing.Fu / dz)
    F_theta = forcing.Fb / (g * alpha)
    T_half = _add_at(T, -1, -dt * F_theta / dz)
    # Fixed-gradient bottom BC on T: the upward flux -KT0 dTdz exits the bottom face.
    T_half = _add_at(T_half, 0, -dt * params.KT0 * forcing.dTdz_bottom / dz)
    # Nonlocal flux divergence (faces -> centers).
    dNL = (NL[..., 1:] - NL[..., :-1]) / dz
    T_half = T_half - dt * dNL

    # One batched solve for the three variables.
    phi = torch.stack(torch.broadcast_tensors(U_half, V_half, T_half), dim=0)
    K3 = torch.stack(torch.broadcast_tensors(K_U, K_U, K_T), dim=0)
    backend = resolve_tridiag_backend(tridiag_backend, 1, phi.device)
    phi = implicit_diffusion_step(phi, K3, dt, dz, backend=backend)
    return KPPState(U=phi[0].to(U.dtype), V=phi[1].to(V.dtype), T=phi[2].to(T.dtype))


def solve_kpp(state0: KPPState, t_save, params: KPPParameters, forcing: KPPForcing, H, Nz: int, f_cor, g, alpha,
              n_substeps: int = 1, tridiag_backend: str = "auto", diurnal: bool = False) -> KPPState:
    """Evolve a batch of KPP columns, saving at ``t_save`` (uniform); trajectories ``(Nt, ..., Nz)``.

    Parity: ``closure_kpp_full_evolution`` (``k_profile_parameterization.jl:61-119``)
    and ``free_convection_kpp`` (``free_convection/src/k_profile_parameterization.jl:3-47``).
    ``diurnal=True``: ``forcing.Fb`` is the amplitude of the daily cycle
    ``Fb(t) = Fb sin(2 pi t / day)`` (``wind_mixing/src/k_profile_parameterization.jl:55-57``).
    One stacked solve per substep: ``(Nt - 1) n_substeps`` Thomas launches
    on the card (``"auto"``). The JAX function defaults to its scan.
    """
    dtype, device = state0.T.dtype, state0.T.device
    t_save = torch.as_tensor(t_save, dtype=dtype, device=device)
    n_save = t_save.shape[0] - 1
    dt = (t_save[-1] - t_save[0]) / (n_save * n_substeps)
    dz = torch.as_tensor(H / Nz, dtype=dtype, device=device)
    H_ = H.to(device) if isinstance(H, torch.Tensor) else torch.tensor(H, dtype=dtype, device=device)
    zc = (torch.arange(Nz, dtype=dtype, device=device) + 0.5) * dz - H_
    zf = torch.arange(Nz + 1, dtype=dtype, device=device) * dz - H_
    t0 = t_save[0]

    state, frames = state0, [state0]
    for k in range(n_save):
        for j in range(n_substeps):
            forcing_t = forcing
            if diurnal:
                t = t0 + float(k * n_substeps + j) * dt
                forcing_t = KPPForcing(Fu=forcing.Fu, Fb=forcing.Fb * diurnal_cycle(t),
                                       dTdz_bottom=forcing.dTdz_bottom)
            state = kpp_step(state, dt, dz, zf, zc, params, forcing_t, f_cor, g, alpha, H, tridiag_backend)
        frames.append(state)
    stack = lambda name: torch.stack(  # noqa: E731
        torch.broadcast_tensors(*[getattr(s, name) for s in frames]), dim=0)
    return KPPState(U=stack("U"), V=stack("V"), T=stack("T"))
