"""Dimensional host column model with an embedded NN closure.

Port of ``climateparameterizations_jl_tpu/embed/column_model.py``, the
counterpart of the reference's Oceananigans column embeddings:

- ``free_convection/src/oceananigans_nn.jl:42-211``: a 1x1xNz column
  stepped with the NN heat-flux divergence as a forcing plus an implicit
  convective adjustment, run twice (conv-adj alone and conv-adj + NN);
- ``wind_mixing/src/NDE_oceananigans.jl:331-475``: a ``(u, v, T)`` column
  with Coriolis, three NN flux forcings recomputed every step, and implicit
  mPP diffusion.

One step is the batched MLP call for every column, the flux-divergence
forcing, the forward-backward Coriolis pair, the surface-flux injection and
ONE stacked backward-Euler solve of ``(u, v, T)``: one batched Thomas
launch per step on the card (``ops/tridiagonal.py``, the kernel
``csrc/thomas.cu`` for CUDA state through ``tridiag_backend="cuda"``). The
model batches over any leading axes, so the same step advances one column
or thousands. The JAX package scans the steps; here they run eagerly, and
``remat=True`` wraps each save interval in ``torch.utils.checkpoint``.

The model works in dimensional units; the closure's feature scalings are
applied around the NN as the reference's ``scale -> NN -> unscale ->
enforce-BC -> d/dz`` chain (``oceananigans_nn.jl:120-126``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from climateparameterizations_jl_tpu_torch.closures.mlp import apply_closure
from climateparameterizations_jl_tpu_torch.core.constants import diurnal_cycle
from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face, d_face_to_center
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs, WindMixingScalings
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import implicit_diffusion_step
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters, mpp_diffusivity
from climateparameterizations_jl_tpu_torch.physics.richardson import sanitize_richardson


@dataclasses.dataclass(frozen=True)
class HostColumnModel:
    """Configuration of the dimensional host column (0-d tensors, or ``(S,)`` per-column fields).

    ``closure``: ``"mpp"`` (wind-mixing embedding) or ``"conv_adj"``
    (free-convection embedding). Surface fluxes are kinematic (``Fu``
    [m^2/s^2] into u, ``Ftheta`` [K m/s] into T); ``dTdz_bottom`` is the
    fixed bottom temperature gradient. ``Fu``, ``Ftheta``, ``dTdz_bottom``
    and ``diurnal_amplitude`` may carry a leading ``(S,)`` axis (one value
    per column of an ``(S, Nz)`` state) or be 0-d. ``diurnal_amplitude``
    (mixed suites): members with 0 keep their constant ``Ftheta``; ``None``
    uses ``Ftheta`` as every column's amplitude. ``nn_input``: ``"uvT"``
    (the wind-mixing triple NN) or ``"T"`` (the free-convection NN, fed the
    scaled T profile alone). ``nn_dimensionalize``: ``"affine"`` (sigma y +
    mu), ``"linear"`` (sigma y, the zero-weights convention) or ``"auto"``
    (affine iff ``nn_input == "T"``). ``mpp_conv_adjust``: under mPP, the
    tracer diffusivity jumps to ``kappa_conv`` where Ri <= 0
    (``NDE_oceananigans.jl:49-54``).
    """

    H: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    alpha: torch.Tensor
    Fu: torch.Tensor
    Ftheta: torch.Tensor
    dTdz_bottom: torch.Tensor
    scalings: WindMixingScalings
    mpp: MPPParameters
    kappa_conv: torch.Tensor = dataclasses.field(default_factory=lambda: torch.tensor(1.0))
    diurnal_amplitude: torch.Tensor | None = None
    Nz: int = 32
    closure: str = "mpp"
    nn_input: str = "uvT"
    diurnal: bool = False
    nn_dimensionalize: str = "auto"
    mpp_conv_adjust: bool = False

    @property
    def dz(self):
        return self.H / self.Nz


@dataclasses.dataclass(frozen=True)
class HostColumnState:
    u: torch.Tensor
    v: torch.Tensor
    T: torch.Tensor


def _with_last(x, value):
    """``x`` with its last entry along the last axis replaced by ``value``, cast to ``x``'s dtype (out of place),
    as JAX's ``x.at[..., -1].set``."""
    return torch.cat([x[..., :-1], value.to(x.dtype).unsqueeze(-1)], dim=-1)


def _with_first(x, value):
    """``x`` with its first entry along the last axis replaced by ``value``, cast to ``x``'s dtype (out of place)."""
    return torch.cat([value.to(x.dtype).unsqueeze(-1), x[..., 1:]], dim=-1)


def _nn_flux_faces(model: HostColumnModel, nns: FluxNNs | None, state: HostColumnState):
    """Dimensional NN flux faces ``(uw, vw, wT)``, each ``(..., Nz+1)``.

    The scale -> NN -> unscale chain of ``oceananigans_nn.jl:120-126`` /
    ``NDE_oceananigans.jl:380-405`` with zero boundary faces (the host
    model owns the boundary fluxes). One batched MLP call per flux.
    """
    T = state.T
    zeros_faces = torch.zeros(T.shape[:-1] + (T.shape[-1] + 1,), dtype=T.dtype, device=T.device)
    if nns is None:
        return zeros_faces, zeros_faces, zeros_faces
    s = model.scalings
    if model.nn_input == "T":
        x = s.T.scale(T)
    else:
        x = torch.cat([s.u.scale(state.u), s.v.scale(state.v), s.T.scale(T)], dim=-1)
    affine = model.nn_dimensionalize == "affine" or (model.nn_dimensionalize == "auto" and model.nn_input == "T")

    def faces(nn, scaling):
        if nn is None:
            return zeros_faces
        y = apply_closure(nn, x)
        interior = scaling.unscale(y) if affine else scaling.sigma * y
        zeros = torch.zeros(interior.shape[:-1] + (1,), dtype=interior.dtype, device=interior.device)
        return torch.cat([zeros, interior, zeros], dim=-1)

    return faces(nns.uw, s.uw), faces(nns.vw, s.vw), faces(nns.wT, s.wT)


def _nn_forcing(model: HostColumnModel, nns: FluxNNs | None, state: HostColumnState):
    """Per-cell forcing ``-d/dz(w'phi'_NN)`` for ``(u, v, T)``, dimensional."""
    uw, vw, wT = _nn_flux_faces(model, nns, state)
    return tuple(-d_face_to_center(f, model.dz) for f in (uw, vw, wT))


def diagnose_host_fluxes(model: HostColumnModel, nns: FluxNNs | None, state: HostColumnState, t=0.0):
    """Total dimensional face fluxes ``(uw, vw, wT)`` of the host column.

    NN faces + the downgradient flux ``-K dphi/dz`` (zero boundary faces,
    as in the implicit solve) + the prescribed boundary fluxes: the flux
    diagnostics of the reference's embedded evaluation
    (``NDE_oceananigans.jl:157-286``). Batches over leading axes; for a
    saved trajectory ``(Nt, ..., Nz)`` pass ``t`` of shape ``(Nt, 1, ...)``
    (it must broadcast against ``state.T[..., 0]``): each frame then gets
    its own surface heat flux, as the JAX package's vmap over frames gives.
    """
    uw, vw, wT = _nn_flux_faces(model, nns, state)
    nu, kappa = _diffusivities(model, state)
    mask = torch.ones(nu.shape[-1], dtype=nu.dtype, device=nu.device)
    mask[0] = 0.0
    mask[-1] = 0.0
    uw = uw - mask * nu * d_center_to_face(state.u, model.dz)
    vw = vw - mask * nu * d_center_to_face(state.v, model.dz)
    wT = wT - mask * kappa * d_center_to_face(state.T, model.dz)
    uw = _with_last(uw, torch.broadcast_to(model.Fu, uw[..., -1].shape))
    Ft = surface_heat_flux(model, torch.as_tensor(t, dtype=state.T.dtype, device=state.T.device))
    wT = _with_last(wT, torch.broadcast_to(Ft, wT[..., -1].shape))
    # Fixed-gradient bottom BC: heat leaves through the bottom face (the stepper's rule, _bottom_bc_kappa).
    kappa_bc = _bottom_bc_kappa(model, nu, kappa)
    wT = _with_first(wT, torch.broadcast_to(-kappa_bc * model.dTdz_bottom, wT[..., 0].shape))
    return uw, vw, wT


def diagnose_nn_heat_flux(model: HostColumnModel, nns: FluxNNs | None, T):
    """Dimensional NN heat flux on faces ``(..., Nz+1)`` for a T profile.

    The embedded NN's ``w'T'`` as :func:`_nn_forcing` applies it (closure
    interior faces, zero boundary faces): the ``wT`` diagnostic the
    reference stores beside the embedded solution
    (``oceananigans_nn.jl:184-192``). Batches over leading axes.
    """
    if nns is None or nns.wT is None:
        return torch.zeros(T.shape[:-1] + (T.shape[-1] + 1,), dtype=T.dtype, device=T.device)
    if model.nn_input != "T":
        raise ValueError("diagnose_nn_heat_flux needs nn_input='T' (heat-flux-only embedding)")
    zeros_uv = torch.zeros_like(T)
    _, _, wT = _nn_flux_faces(model, nns, HostColumnState(u=zeros_uv, v=zeros_uv, T=T))
    return wT


def _diffusivities(model: HostColumnModel, state: HostColumnState):
    """Face ``(nu, kappa_T)`` profiles for the implicit solve (its boundary faces are zeroed by the solve)."""
    if model.closure == "conv_adj":
        dTdz = d_center_to_face(state.T, model.dz)
        kappa = torch.where(dTdz < 0.0, model.kappa_conv, 0.0)
        nu = torch.zeros_like(kappa)
    else:
        # The reference's eps on every gradient before Ri (NDE_training.jl:115-119). The floor on the
        # shear keeps the division's backward pass finite: at zero shear the raw quotient's gradient is
        # inf * 0 = NaN even where the forward value is masked.
        eps = 1e-7
        dudz = d_center_to_face(state.u, model.dz) + eps
        dvdz = d_center_to_face(state.v, model.dz) + eps
        dTdz = d_center_to_face(state.T, model.dz) + eps
        S2 = torch.clamp(dudz**2 + dvdz**2, min=1e-20)
        Ri = sanitize_richardson(model.g * model.alpha * dTdz / S2)
        nu = mpp_diffusivity(Ri, model.mpp)
        kappa = nu / model.mpp.Pr
        if model.mpp_conv_adjust:
            kappa = torch.where(Ri > 0.0, kappa, model.kappa_conv)
    return nu, kappa


def _bottom_bc_kappa(model: HostColumnModel, nu, kappa):
    """Diffusivity of the fixed-gradient bottom BC flux.

    A discontinuous convective-adjustment switch keys on the PRESCRIBED
    bottom gradient, never on the face-1 state: a transient instability at
    face 1 would otherwise pair ``kappa_conv`` with the stable prescribed
    gradient and cool the bottom cell spuriously. Applies to
    ``closure="conv_adj"`` and to mPP with ``mpp_conv_adjust``; the smooth
    mPP part keeps the face-1 value.
    """
    if model.closure == "conv_adj":
        return torch.where(model.dTdz_bottom < 0.0, model.kappa_conv, 0.0)
    if model.mpp_conv_adjust:
        smooth = nu[..., 1] / model.mpp.Pr  # face-1 mPP kappa without the jump
        return torch.where(model.dTdz_bottom < 0.0, model.kappa_conv, smooth)
    return kappa[..., 1]


def surface_heat_flux(model: HostColumnModel, t):
    """Surface heat flux at dimensional time ``t`` (the daily cycle where ``model.diurnal``).

    With ``diurnal_amplitude`` set the cycle is per column: members of
    amplitude 0 keep their constant ``Ftheta`` (the NDE path's
    ``_effective_bcs``).
    """
    if model.diurnal:
        if model.diurnal_amplitude is None:
            return model.Ftheta * diurnal_cycle(t)
        amp = model.diurnal_amplitude
        return torch.where(amp != 0.0, amp * diurnal_cycle(t), model.Ftheta)
    return model.Ftheta


def host_for_wind_mixing(model, Fu, Ftheta, dTdz_bottom, diurnal_amplitude=None) -> HostColumnModel:
    """The host column of a trained :class:`WindMixingModel`.

    The one construction behind the embedded evaluation
    (``eval/profile.nde_profile``) and the a-posteriori trainer
    (``train/embedded.py``). The host's base physics is the model's
    training-time base (mPP, else convective adjustment; a base-free model
    gets a zero-physics host, conv-adj with kappa 0), and NN faces
    dimensionalize by the training convention: ``flux/sigma`` under
    ``zero_weights``, affine otherwise. ``Fu``, ``Ftheta``, ``dTdz_bottom``
    may carry leading batch axes (per-simulation BCs).
    """
    host_closure = "mpp" if model.use_mpp else "conv_adj"
    kappa_host = model.kappa if (model.use_mpp or model.use_conv_adj) else torch.zeros_like(model.kappa)
    return HostColumnModel(
        H=model.H, f=model.f, g=model.g, alpha=model.alpha, Fu=Fu, Ftheta=Ftheta, dTdz_bottom=dTdz_bottom,
        scalings=model.scalings, mpp=model.mpp, Nz=model.Nz, closure=host_closure, kappa_conv=kappa_host,
        diurnal=model.diurnal, diurnal_amplitude=diurnal_amplitude,
        nn_dimensionalize="linear" if model.zero_weights else "affine",
    )


def host_for_free_convection(model, f, g, alpha, Ftheta, dTdz_bottom) -> HostColumnModel:
    """The host column of a trained free-convection model.

    The one construction behind the FC embedded evaluation
    (``eval/profile.free_convection_profile``) and the FC a-posteriori
    trainer. Parity: ``oceananigans_convective_adjustment_nn``
    (``free_convection/src/oceananigans_nn.jl:42-211``): implicit convective
    adjustment, a heat-flux NN fed the scaled T profile (``nn_input="T"``,
    affine), no momentum forcing. A base-free model (``base_closure="none"``)
    embeds over a zero-physics host. ``Ftheta`` / ``dTdz_bottom`` may carry
    leading batch axes; ``f``, ``g``, ``alpha`` must be scalars.
    """
    H = model.H
    unit = ZeroMeanUnitVarianceScaling(torch.zeros((), dtype=H.dtype, device=H.device),
                                       torch.ones((), dtype=H.dtype, device=H.device))
    kappa_host = model.kappa if model.base_closure == "convective_adjustment" else torch.zeros_like(model.kappa)
    def as_t(x):  # tensors keep their dtype; Python and numpy numbers take H's
        return x.to(H.device) if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=H.dtype, device=H.device)

    Ftheta = as_t(Ftheta)
    return HostColumnModel(
        H=H, f=as_t(f), g=as_t(g), alpha=as_t(alpha), Fu=torch.zeros_like(Ftheta), Ftheta=Ftheta,
        dTdz_bottom=as_t(dTdz_bottom),
        scalings=WindMixingScalings(u=unit, v=unit, T=model.T_scaling, uw=unit, vw=unit, wT=model.wT_scaling),
        mpp=MPPParameters.default(H.dtype, H.device), kappa_conv=kappa_host, Nz=model.Nz, closure="conv_adj",
        nn_input="T",
    )


def host_column_step(model: HostColumnModel, nns: FluxNNs | None, state: HostColumnState, dt,
                     tridiag_backend: str = "auto", t=0.0) -> HostColumnState:
    """One host step at dimensional time ``t``: NN forcing, Coriolis and surface fluxes (explicit),
    then the implicit physics diffusion of ``(u, v, T)`` in ONE stacked tridiagonal solve.

    ``tridiag_backend="auto"`` is the Thomas kernel for CUDA state and the
    plain scan on the CPU (``train/nde.py::resolve_tridiag_backend``).
    """
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    tridiag_backend = resolve_tridiag_backend(tridiag_backend, 1, state.T.device)
    fu, fv, fT = _nn_forcing(model, nns, state)

    # Forward-backward Coriolis: v uses the already rotated u (forward Euler amplifies inertial
    # oscillations by sqrt(1 + (f dt)^2) per step).
    u = state.u + dt * (model.f * state.v + fu)
    v = state.v + dt * (-model.f * u + fv)
    T = state.T + dt * fT

    # Surface fluxes into the top cell (NDE_oceananigans.jl:331-362 / oceananigans_nn.jl:167-210).
    dz = model.dz
    # JAX's .at[].add casts each update to the operand's dtype before adding.
    u = _with_last(u, u[..., -1] + (-dt * model.Fu / dz).to(u.dtype))
    Ft = surface_heat_flux(model, torch.as_tensor(t, dtype=state.T.dtype, device=state.T.device))
    T = _with_last(T, T[..., -1] + (-dt * Ft / dz).to(T.dtype))
    nu, kappa = _diffusivities(model, state)
    # Fixed-gradient bottom BC: the flux -kappa_bc dTdz through the bottom face keeps the deep linear
    # profile steady (Oceananigans' GradientBoundaryCondition).
    kappa_bc = _bottom_bc_kappa(model, nu, kappa)
    T = _with_first(T, T[..., 0] + (-dt * kappa_bc * model.dTdz_bottom / dz).to(T.dtype))

    # One batched solve for (u, v, T); stacking promotes mixed dtypes, so each result is cast back.
    u_b, v_b, T_b = torch.broadcast_tensors(u, v, T)
    dtype = torch.promote_types(torch.promote_types(u.dtype, v.dtype), T.dtype)
    phi = torch.stack([u_b.to(dtype), v_b.to(dtype), T_b.to(dtype)], dim=0)
    K3 = torch.stack([k.to(dtype) for k in torch.broadcast_tensors(nu, nu, kappa)], dim=0)
    phi = implicit_diffusion_step(phi, K3, dt, dz, backend=tridiag_backend, zero_boundary_faces=True)
    return HostColumnState(u=phi[0].to(u.dtype), v=phi[1].to(v.dtype), T=phi[2].to(T.dtype))


def run_embedded_column(model: HostColumnModel, nns: FluxNNs | None, state0: HostColumnState, dt, n_save: int,
                        save_every: int = 1, tridiag_backend: str = "auto", t0=0.0,
                        remat: bool = False) -> HostColumnState:
    """Run the host column from time ``t0``, saving every ``save_every`` steps.

    Returns trajectories with time leading, ``(n_save + 1, ..., Nz)``.
    ``remat=True`` wraps each save interval in ``torch.utils.checkpoint``
    where autograd records the run (the steps run again in the backward
    pass instead of being stored), as ``models/timestepper.solve_fixed_step``
    does; it does not change the result. The time carry is ``t0`` in the
    state's dtype plus ``dt`` once per step, as the JAX scan's carry.
    """
    dtype, device = state0.T.dtype, state0.T.device

    def interval(u, v, T, t):
        state = HostColumnState(u=u, v=v, T=T)
        for _ in range(save_every):
            state = host_column_step(model, nns, state, dt, tridiag_backend, t)
            t = t + dt
        return state.u, state.v, state.T, t

    checkpoint = remat and torch.is_grad_enabled()
    carry = (state0.u, state0.v, state0.T, torch.as_tensor(t0, dtype=dtype, device=device))
    frames = [carry[:3]]
    for _ in range(n_save):
        if checkpoint:
            carry = torch.utils.checkpoint.checkpoint(interval, *carry, use_reentrant=False)
        else:
            carry = interval(*carry)
        frames.append(carry[:3])
    u, v, T = (torch.stack([f[i] for f in frames], dim=0) for i in range(3))
    return HostColumnState(u=u, v=v, T=T)


def run_paired_columns(model: HostColumnModel, nns: FluxNNs, state0: HostColumnState, dt, n_save: int,
                       save_every: int = 1, tridiag_backend: str = "auto", t0=0.0):
    """The physics-only baseline and the baseline+NN run, ``(baseline, with_nn)``.

    Parity: the paired runs of ``oceananigans_nn.jl:167-210`` and
    ``NDE_oceananigans.jl:457-464``.
    """
    baseline = run_embedded_column(model, None, state0, dt, n_save, save_every, tridiag_backend, t0)
    with_nn = run_embedded_column(model, nns, state0, dt, n_save, save_every, tridiag_backend, t0)
    return baseline, with_nn
