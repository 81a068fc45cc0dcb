"""TKE-based column closure (OceanTurb's ``TKEMassFlux`` as the reference runs it), batched over leading axes.

Port of ``climateparameterizations_jl_tpu/physics/tke.py``
(``src/PhysicalParameterizations/turbulent_kinetic_energy_closure.jl:1-60``;
``free_convection/src/tke_mass_flux.jl:21-27``: backward Euler,
``RiDependentDiffusivities``). One prognostic TKE equation closes the eddy
diffusivities:

    de/dt = d/dz(K_e de/dz) + K_U S^2 - K_C N^2 - Cd e^(3/2) / ell
    ell   = min(kappa_vk d, Cb sqrt(e) / N)
    K_phi = CK_phi(Ri) ell sqrt(e) + K0_phi,
    CK_phi(Ri) = CK_phi_minus + (CK_phi_plus - CK_phi_minus) (1 + tanh((Ri - CK_Ric) / CK_Riw)) / 2

with a surface TKE flux ``Cw_ustar ustar^3 + Cw_b max(Fb, 0) dz``. Each step
applies the sources explicitly and takes one backward-Euler diffusion step
for ``(U, V, T, e)`` as ONE stacked batched solve: on the card one launch of
the Thomas kernel ``csrc/thomas.cu`` per step on ``(4, ..., Nz)``.
"""

from __future__ import annotations

import dataclasses

import torch

from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import implicit_diffusion_step
from climateparameterizations_jl_tpu_torch.physics.kpp import _add_at, _boundary_mask, _set_at

_DEFAULTS = dict(
    kappa_vk=0.4, Cb=0.7, Cd=2.91,
    CKu_minus=0.4, CKu_plus=0.1,
    CKc_minus=1.3, CKc_plus=0.16,
    CKe_minus=0.4, CKe_plus=0.1,
    CK_Ric=0.3, CK_Riw=0.1,
    Cw_ustar=3.75, Cw_b=1.0,
    e_min=1e-9, ell_min=0.01, KU0=1e-6, KT0=1e-7,
)


@dataclasses.dataclass(frozen=True)
class TKEParameters:
    """Dissipation, mixing length, ``RiDependentDiffusivities`` coefficients and the surface TKE flux."""

    kappa_vk: torch.Tensor  # von Karman constant (wall mixing length)
    Cb: torch.Tensor  # stratified mixing-length coefficient
    Cd: torch.Tensor  # dissipation coefficient (OceanTurb TKEParameters.Cᴰ)
    CKu_minus: torch.Tensor  # momentum diffusivity, convective/neutral
    CKu_plus: torch.Tensor  # momentum diffusivity, stratified
    CKc_minus: torch.Tensor  # tracer diffusivity, convective/neutral
    CKc_plus: torch.Tensor  # tracer diffusivity, stratified
    CKe_minus: torch.Tensor  # TKE diffusivity, convective/neutral
    CKe_plus: torch.Tensor  # TKE diffusivity, stratified
    CK_Ric: torch.Tensor  # step center (critical Ri)
    CK_Riw: torch.Tensor  # step width
    Cw_ustar: torch.Tensor  # wind-work TKE flux coefficient (* ustar^3)
    Cw_b: torch.Tensor  # convective TKE seed coefficient (* max(Fb, 0) * dz)
    e_min: torch.Tensor
    ell_min: torch.Tensor
    KU0: torch.Tensor  # background momentum/TKE diffusivity
    KT0: torch.Tensor  # background tracer diffusivity

    @classmethod
    def default(cls, dtype=torch.float32, device=None, **overrides) -> "TKEParameters":
        """The reference's values as 0-d tensors, on ``cuda`` unless the caller asks for the CPU."""
        device = resolve_device(device)
        vals = dict(_DEFAULTS)
        vals.update(overrides)
        return cls(**{k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in vals.items()})

    def sigma(self, Ri, minus, plus):
        """``RiDependentDiffusivities`` blend: a smooth step across ``CK_Ric`` of width ``CK_Riw``."""
        step = 0.5 * (1.0 + torch.tanh((Ri - self.CK_Ric) / self.CK_Riw))
        return minus + (plus - minus) * step


@dataclasses.dataclass(frozen=True)
class TKEState:
    U: torch.Tensor
    V: torch.Tensor
    T: torch.Tensor
    e: torch.Tensor  # turbulent kinetic energy (centers)


def tke_diffusivities(state: TKEState, dz, params: TKEParameters, g, alpha):
    """Face diffusivities ``(K_U, K_T, K_e)`` and ``(S2, N2, ell, sqrt_e)`` from the current TKE field."""
    e = state.e
    # Edge padding: the end values repeated (F.pad's replicate mode wants 3-D input).
    e_pad = torch.cat([e[..., :1], e, e[..., -1:]], dim=-1)
    e_face = torch.maximum(params.e_min, 0.5 * (e_pad[..., :-1] + e_pad[..., 1:]))
    sqrt_e = torch.sqrt(e_face)

    dUdz = d_center_to_face(state.U, dz)
    dVdz = d_center_to_face(state.V, dz)
    dTdz = d_center_to_face(state.T, dz)
    N2 = g * alpha * dTdz
    S2 = dUdz**2 + dVdz**2
    Ri = N2 / (S2 + 1e-30)

    # Mixing length: wall distance below the surface, capped by the stratification.
    Nz = state.U.shape[-1]
    depth_f = (Nz - torch.arange(Nz + 1, dtype=state.U.dtype, device=state.U.device)) * dz
    d_wall = torch.maximum(params.ell_min, params.kappa_vk * depth_f)
    ell_strat = params.Cb * sqrt_e / torch.sqrt(torch.clamp(N2, min=1e-12))
    ell = torch.minimum(d_wall, ell_strat)
    ell = torch.maximum(ell, params.ell_min)

    CK_U = params.sigma(Ri, params.CKu_minus, params.CKu_plus)
    CK_T = params.sigma(Ri, params.CKc_minus, params.CKc_plus)
    CK_e = params.sigma(Ri, params.CKe_minus, params.CKe_plus)

    K_U = CK_U * ell * sqrt_e + params.KU0
    K_T = CK_T * ell * sqrt_e + params.KT0
    K_e = CK_e * ell * sqrt_e + params.KU0

    mask = _boundary_mask(K_U.shape[-1], K_U)
    return K_U * mask, K_T * mask, K_e * mask, (S2, N2, ell, sqrt_e)


def tke_diagnostic_heat_flux(state: TKEState, dz, params: TKEParameters, Fb, g, alpha):
    """Face heat flux ``-K_T dT/dz`` with the surface flux on the top face (batches over leading axes).

    The ``wT`` output of the reference's TKE baseline (``free_convection/src/tke_mass_flux.jl:3-52``).
    """
    _K_U, K_T, _K_e, _ = tke_diffusivities(state, dz, params, g, alpha)
    wT = -K_T * d_center_to_face(state.T, dz)
    return _set_at(wT, -1, Fb / (g * alpha))


def tke_step(state: TKEState, dt, dz, params: TKEParameters, Fu, Fb, f_cor, g, alpha, tridiag_backend: str = "auto",
             dTdz_bottom=0.0) -> TKEState:
    """One operator-split TKE step: explicit sources, then one stacked implicit solve; ``e`` floored at ``e_min``.

    ``dTdz_bottom``: fixed-gradient bottom BC on T, as ``kpp_step`` applies
    it. ``tridiag_backend="auto"``: the Thomas kernel for CUDA state, the
    plain scan on the CPU.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    K_U, K_T, K_e, (S2, N2, ell, _sqrt_e) = tke_diffusivities(state, dz, params, g, alpha)

    # TKE sources at centers (face quantities averaged back to centers).
    to_c = lambda x: 0.5 * (x[..., 1:] + x[..., :-1])  # noqa: E731
    production = to_c(K_U * S2) - to_c(K_T * N2)
    e_center = torch.maximum(state.e, params.e_min)
    dissipation = params.Cd * e_center**1.5 / to_c(ell)
    e_half = torch.maximum(state.e + dt * (production - dissipation), params.e_min)
    # Surface TKE flux through the top face: wind work plus the convective seed.
    ustar3 = torch.abs(Fu) ** 1.5
    e_flux_surf = params.Cw_ustar * ustar3 + params.Cw_b * torch.clamp(Fb, min=0.0) * dz
    e_half = _add_at(e_half, -1, dt * e_flux_surf / dz)

    # Forward-backward Coriolis (neutrally stable).
    U_half = state.U + dt * f_cor * state.V
    V_half = state.V - dt * f_cor * U_half
    U_half = _add_at(U_half, -1, -dt * Fu / dz)
    F_theta = Fb / (g * alpha)
    T_half = _add_at(state.T, -1, -dt * F_theta / dz)
    T_half = _add_at(T_half, 0, -dt * params.KT0 * dTdz_bottom / dz)

    # One batched solve for the four variables.
    phi = torch.stack(torch.broadcast_tensors(U_half, V_half, T_half, e_half), dim=0)
    K4 = torch.stack(torch.broadcast_tensors(K_U, K_U, K_T, K_e), dim=0)
    backend = resolve_tridiag_backend(tridiag_backend, 1, phi.device)
    phi = implicit_diffusion_step(phi, K4, dt, dz, backend=backend)
    return TKEState(U=phi[0].to(state.U.dtype), V=phi[1].to(state.V.dtype), T=phi[2].to(state.T.dtype),
                    e=torch.maximum(phi[3], params.e_min).to(state.e.dtype))


def solve_tke(state0: TKEState, t_save, params: TKEParameters, Fu, Fb, H, Nz: int, f_cor, g, alpha,
              n_substeps: int = 1, tridiag_backend: str = "auto", dTdz_bottom=0.0) -> TKEState:
    """Evolve a batch of TKE columns; trajectories ``(Nt, ..., Nz)``.

    Parity: ``closure_tke_full_evolution`` (``turbulent_kinetic_energy_closure.jl:1-60``).
    One stacked solve per substep: ``(Nt - 1) n_substeps`` Thomas launches on
    the card (``"auto"``). The JAX function defaults to its scan.
    """
    dtype, device = state0.T.dtype, state0.T.device
    t_save = torch.as_tensor(t_save, dtype=dtype, device=device)
    n_save = t_save.shape[0] - 1
    dt = (t_save[-1] - t_save[0]) / (n_save * n_substeps)
    dz = torch.as_tensor(H / Nz, dtype=dtype, device=device)
    Fu, Fb, dTdz_bottom = (x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=dtype, device=device)
                           for x in (Fu, Fb, dTdz_bottom))

    state, frames = state0, [state0]
    for _ in range(n_save):
        for _ in range(n_substeps):
            state = tke_step(state, dt, dz, params, Fu, Fb, f_cor, g, alpha, tridiag_backend, dTdz_bottom)
        frames.append(state)
    stack = lambda name: torch.stack(  # noqa: E731
        torch.broadcast_tensors(*[getattr(s, name) for s in frames]), dim=0)
    return TKEState(U=stack("U"), V=stack("V"), T=stack("T"), e=stack("e"))
