"""Wind-mixing coupled NDE, forward half: triple-NN fluxes + mPP base closure.

Port of ``climateparameterizations_jl_tpu/models/wind_mixing.py`` (reference
``wind_mixing/src/NDE_training.jl:56-165``). The state is the scaled
``x = [u; v; T]`` vector (``3 Nz`` centers); three MLPs predict the interior
scaled fluxes ``u'w', v'w', w'T'`` from ``x``; the mPP Ri-dependent
diffusivity is the physical base closure; and the non-dimensional PDE

    du/dt_hat = -tau/H * sigma_uw/sigma_u * d/dz_hat(uw) + f tau/sigma_u (sigma_v v + mu_v)
    dv/dt_hat = -tau/H * sigma_vw/sigma_v * d/dz_hat(vw) - f tau/sigma_v (sigma_u u + mu_u)
    dT/dt_hat = -tau/H * sigma_wT/sigma_T * d/dz_hat(wT)

is integrated by :func:`solve_wind_mixing_nde` (fully explicit) or
:func:`solve_wind_mixing_split` (operator split, backward-Euler mPP
diffusion through the batched tridiagonal solve). Everything batches over
leading axes. Both solvers take ``fast_assembly=True/"fold"``: the packed NN
chain with a matmul-assembled divergence (:func:`_fast_full_rhs` for rk4).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import _ACTIVATIONS, MLP, mlp_apply
from climateparameterizations_jl_tpu_torch.core.constants import diurnal_cycle
from climateparameterizations_jl_tpu_torch.core.filters import smoothing_filter
from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face, d_face_to_center, pad_faces
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.models.timestepper import _STEPPERS, solve_fixed_step
from climateparameterizations_jl_tpu_torch.ops.fused_rhs import (
    _assembly_constants,
    _make_mxu_rhs,
    _scalar_constants,
    bc_tendency_row,
    divergence_matrix,
    fold_divergence_constants,
    tendency_coefficients,
)
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import implicit_diffusion_step
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters, mpp_diffusivity
from climateparameterizations_jl_tpu_torch.physics.richardson import local_richardson_scaled


class FluxNNs(NamedTuple):
    """The three flux closures. Any of them may be ``None`` (physics-only runs)."""

    uw: MLP | None
    vw: MLP | None
    wT: MLP | None


# Rows per block of the packed chain's products on the card (:func:`_rows_product`).
ROW_BLOCK = 128


def _rows_product(x, A):
    """``x @ A`` over the last axis, each row's result independent of how many rows share the product.

    cuBLAS chooses its GEMM kernel by the row count, and two kernels round a
    row's sums differently: on an H100 the flagship chain's folded last
    layer (60 -> 96) gives other bits at 512 rows than at 256, so a member's
    trajectory depended on how many members were solved beside it
    (``chip_smoke.py`` phase 43). On CUDA tensors the rows therefore go in
    blocks of :data:`ROW_BLOCK`, at least two (cuBLAS takes a batch of one
    as a plain GEMM), the last zero-padded, through ONE strided batched GEMM
    of a fixed shape. CPU tensors take the plain product.
    """
    if not x.is_cuda:
        return x @ A
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    n_blocks = max(2, -(-n // ROW_BLOCK))
    if n_blocks * ROW_BLOCK != n:
        rows = torch.cat([rows, rows.new_zeros(n_blocks * ROW_BLOCK - n, rows.shape[1])])
    out = torch.bmm(rows.reshape(n_blocks, ROW_BLOCK, -1), A.expand(n_blocks, *A.shape))
    return out.reshape(-1, A.shape[-1])[:n].reshape(*x.shape[:-1], A.shape[-1])


@dataclasses.dataclass(frozen=True)
class PackedFluxNNs:
    """The three flux MLPs fused into ONE block matmul chain.

    Layer 0 places the three first layers side by side (all read the same
    ``x``); deeper layers are block-diagonal. Build with :func:`pack_flux_nns`.
    """

    matrices: tuple  # right-multiply: (in, out) per layer
    biases: tuple  # (out,) per layer
    activation: str = "mish"

    def __call__(self, x):
        """Concatenated interior fluxes ``(..., 3 (Nz-1))`` in uw|vw|wT order (each row on its own:
        :func:`_rows_product`)."""
        act = _ACTIVATIONS[self.activation]
        n = len(self.matrices)
        for i, (A, b) in enumerate(zip(self.matrices, self.biases)):
            x = _rows_product(x, A) + b
            if i < n - 1:
                x = act(x)
        return x


def pack_flux_nns(nns) -> PackedFluxNNs | None:
    """Fuse three same-depth, same-activation ``MLP`` closures; else ``None``."""
    if isinstance(nns, PackedFluxNNs):
        return nns
    mlps = [nns.uw, nns.vw, nns.wT]
    if any(not isinstance(m, MLP) for m in mlps):
        return None
    depth = len(mlps[0].weights)
    if any(len(m.weights) != depth for m in mlps[1:]):
        return None
    if len({m.activation for m in mlps}) != 1:
        return None
    if len({m.weights[0].shape[1] for m in mlps}) != 1:  # all read the same x
        return None
    if len({m.weights[-1].shape[0] for m in mlps}) != 1:  # equal thirds on split
        return None
    matrices, biases = [], []
    for layer in range(depth):
        Ws = [m.weights[layer].T for m in mlps]  # (in_i, out_i)
        matrices.append(torch.cat(Ws, dim=1) if layer == 0 else torch.block_diag(*Ws))
        biases.append(torch.cat([m.biases[layer] for m in mlps]))
    return PackedFluxNNs(matrices=tuple(matrices), biases=tuple(biases), activation=mlps[0].activation)


@dataclasses.dataclass(frozen=True)
class MemberPackedFluxNNs(PackedFluxNNs):
    """``M`` ensemble members' flux chains fused into ONE block-diagonal chain.

    The state carries the members as its last batch axis ``(..., M, 3 Nz)``;
    every physics op and the tridiagonal solve are batch-shape-agnostic, and
    per-simulation BCs broadcast left-aligned, so a member axis after the
    simulation axis needs nothing else. Layer ``l``'s matrix is the
    block-diagonal of the members' packed matrices (layer 0 too: member
    trajectories differ after the first step). Off-diagonal blocks are
    structural zeros, so each member's output equals its own chain's up to
    the order of the matmul sums; the split solver then makes one Thomas
    launch per solve for all members. Build with :func:`pack_member_flux_nns`.
    Integrates wherever a :class:`PackedFluxNNs` does, except in the rk4
    fused assembly, whose body has the 3-flux layout built in.
    """

    n_members: int = 1

    def __call__(self, x):
        """``(..., M, F) -> (..., M, out)`` through the member-concatenated chain."""
        M = self.n_members
        batch = tuple(x.shape[:-2])
        y = PackedFluxNNs.__call__(self, x.reshape(batch + (M * x.shape[-1],)))
        return y.reshape(batch + (M, y.shape[-1] // M))


def pack_member_flux_nns(stacked_nns) -> MemberPackedFluxNNs | None:
    """Fuse a STACKED ensemble (a leading member axis on every MLP tensor) into one chain.

    ``None`` when the members are not packable. Differentiable (indexing and
    block placement), so gradients reach the stacked tensors.
    """
    mlps = [m for m in stacked_nns if m is not None]
    if not mlps:
        return None
    M = int(mlps[0].weights[0].shape[0])
    packs = []
    for m in range(M):
        member = FluxNNs(*(None if nn is None else dataclasses.replace(
            nn, weights=tuple(w[m] for w in nn.weights), biases=tuple(b[m] for b in nn.biases))
            for nn in stacked_nns))
        p = pack_flux_nns(member)
        if p is None:
            return None
        packs.append(p)
    depth = len(packs[0].matrices)
    matrices = tuple(torch.block_diag(*[p.matrices[layer] for p in packs]) for layer in range(depth))
    biases = tuple(torch.cat([p.biases[layer] for p in packs]) for layer in range(depth))
    return MemberPackedFluxNNs(matrices=matrices, biases=biases, activation=packs[0].activation, n_members=M)


@dataclasses.dataclass(frozen=True)
class WindMixingScalings:
    u: ZeroMeanUnitVarianceScaling
    v: ZeroMeanUnitVarianceScaling
    T: ZeroMeanUnitVarianceScaling
    uw: ZeroMeanUnitVarianceScaling
    vw: ZeroMeanUnitVarianceScaling
    wT: ZeroMeanUnitVarianceScaling


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Scaled flux boundary conditions ``(uw, vw, wT) x (bottom, top)``.

    ``diurnal_amplitude`` is the dimensional heat-flux amplitude; when the
    model's ``diurnal`` flag is set, the top ``wT`` BC becomes
    ``wT_scaling(amplitude * sin(2 pi t / day))``. Fields may carry leading
    batch axes (per-simulation BCs), broadcast left-aligned.
    """

    uw_bot: torch.Tensor
    uw_top: torch.Tensor
    vw_bot: torch.Tensor
    vw_top: torch.Tensor
    wT_bot: torch.Tensor
    wT_top: torch.Tensor
    diurnal_amplitude: torch.Tensor = dataclasses.field(default_factory=lambda: torch.tensor(0.0))

    @classmethod
    def from_vector(cls, v) -> "BoundaryConditions":
        """From the reference's 6-vector layout ``NDE_training.jl:59``."""
        return cls(uw_bot=v[..., 0], uw_top=v[..., 1], vw_bot=v[..., 2], vw_top=v[..., 3], wT_bot=v[..., 4], wT_top=v[..., 5])


@dataclasses.dataclass(frozen=True)
class WindMixingModel:
    """Configuration + physical constants (0-d tensors) for a wind-mixing column."""

    H: torch.Tensor  # column depth [m]
    tau: torch.Tensor  # simulation span [s] (time scale of t_hat)
    f: torch.Tensor  # Coriolis parameter [1/s]
    g: torch.Tensor  # gravity [m/s^2]
    alpha: torch.Tensor  # thermal expansion [1/K]
    kappa: torch.Tensor  # convective-adjustment diffusivity [m^2/s]
    scalings: WindMixingScalings
    mpp: MPPParameters
    Nz: int = 32
    use_mpp: bool = True
    use_conv_adj: bool = False
    zero_weights: bool = True
    smooth_NN: bool = False
    smooth_Ri: bool = False
    diurnal: bool = False

    @property
    def dz_hat(self) -> float:
        return 1.0 / self.Nz


def split_uvT(x, Nz: int):
    """Split ``(..., 3 Nz)`` into ``u, v, T`` (reference ``loss.jl:5-7``)."""
    return x[..., :Nz], x[..., Nz : 2 * Nz], x[..., 2 * Nz :]


def join_uvT(u, v, T):
    return torch.cat([u, v, T], dim=-1)


def _effective_bcs(model: WindMixingModel, bcs: BoundaryConditions, t):
    """Resolve the (possibly time-dependent) top heat-flux BC at time ``t_hat``.

    Per-sim amplitude: constant-flux members (amplitude 0) keep their
    frozen ``wT_top``.
    """
    if not model.diurnal:
        return bcs
    wT_top_dim = bcs.diurnal_amplitude * diurnal_cycle(t * model.tau)
    wT_top = torch.where(bcs.diurnal_amplitude != 0.0, model.scalings.wT.scale(wT_top_dim), bcs.wT_top)
    return dataclasses.replace(bcs, wT_top=wT_top)



def _nn_fluxes(model: WindMixingModel, nns, bcs: BoundaryConditions, x):
    """Scaled NN flux faces for (uw, vw, wT); reference ``NDE_training.jl:94-112``."""
    if isinstance(nns, PackedFluxNNs):
        packed = nns(x)
        ni = packed.shape[-1] // 3
        interiors = [packed[..., :ni], packed[..., ni : 2 * ni], packed[..., 2 * ni :]]
        if model.smooth_NN:
            interiors = [smoothing_filter(o, 3) for o in interiors]
    else:
        zeros_interior = torch.zeros(x.shape[:-1] + (model.Nz - 1,), dtype=x.dtype, device=x.device)
        interiors = []
        for nn in (nns.uw, nns.vw, nns.wT):
            out = mlp_apply(nn, x) if nn is not None else zeros_interior
            if model.smooth_NN:
                out = smoothing_filter(out, 3)
            interiors.append(out)

    if model.zero_weights:
        z = torch.zeros_like(torch.as_tensor(bcs.uw_bot))
        pads = [(z, z)] * 3
    else:
        pads = [(bcs.uw_bot, bcs.uw_top), (bcs.vw_bot, bcs.vw_top), (bcs.wT_bot, bcs.wT_top)]
    return tuple(pad_faces(i, b, t) for i, (b, t) in zip(interiors, pads))


def _face_nu(model: WindMixingModel, x):
    """Shared mPP face diffusivity: gradients (+eps) -> Ri (opt. smoothed) -> nu.

    Returns ``(nu, (dudz, dvdz, dTdz))``.
    """
    s = model.scalings
    u, v, T = split_uvT(x, model.Nz)
    dz_hat = model.dz_hat
    eps = 1e-7
    dudz = d_center_to_face(u, dz_hat)
    dvdz = d_center_to_face(v, dz_hat)
    dTdz = d_center_to_face(T, dz_hat)
    Ri = local_richardson_scaled(dudz + eps, dvdz + eps, dTdz + eps, model.H, model.g, model.alpha,
                                 s.u.sigma, s.v.sigma, s.T.sigma)
    if model.smooth_Ri:
        Ri = smoothing_filter(Ri, 3)
    return mpp_diffusivity(Ri, model.mpp), (dudz, dvdz, dTdz)


def _mpp_fluxes(model: WindMixingModel, bcs: BoundaryConditions, x):
    """mPP downgradient flux faces ``nu * dphi/dz`` terms; ``NDE_training.jl:114-139``."""
    s = model.scalings
    nu, (dudz, dvdz, dTdz) = _face_nu(model, x)

    cu = s.u.sigma / s.uw.sigma / model.H
    cv = s.v.sigma / s.vw.sigma / model.H
    cT = s.T.sigma / s.wT.sigma / model.H / model.mpp.Pr

    if model.zero_weights:
        # Boundary faces: the (scaled) BC flux rides on the mPP term so the
        # total face flux equals the prescribed one (NDE_training.jl:130-132).
        zero_u = s.uw.scale(torch.zeros_like(torch.as_tensor(bcs.uw_bot)))
        zero_v = s.vw.scale(torch.zeros_like(torch.as_tensor(bcs.vw_bot)))
        zero_T = s.wT.scale(torch.zeros_like(torch.as_tensor(bcs.wT_bot)))
        nu_dudz = pad_faces(cu * nu[..., 1:-1] * dudz[..., 1:-1], -(bcs.uw_bot - zero_u), -(bcs.uw_top - zero_u))
        nu_dvdz = pad_faces(cv * nu[..., 1:-1] * dvdz[..., 1:-1], -(bcs.vw_bot - zero_v), -(bcs.vw_top - zero_v))
        nu_dTdz = pad_faces(cT * nu[..., 1:-1] * dTdz[..., 1:-1], -(bcs.wT_bot - zero_T), -(bcs.wT_top - zero_T))
    else:
        nu_dudz = cu * nu * dudz
        nu_dvdz = cv * nu * dvdz
        nu_dTdz = cT * nu * dTdz
    return nu_dudz, nu_dvdz, nu_dTdz


def predict_flux(model: WindMixingModel, nns, bcs: BoundaryConditions, x, t=0.0):
    """Total scaled flux faces ``(uw, vw, wT)`` each ``(..., Nz+1)``; ``NDE_training.jl:83-147``."""
    bcs = _effective_bcs(model, bcs, t)
    uw, vw, wT = _nn_fluxes(model, nns, bcs, x)

    if model.use_mpp:
        nu_dudz, nu_dvdz, nu_dTdz = _mpp_fluxes(model, bcs, x)
        return uw - nu_dudz, vw - nu_dvdz, wT - nu_dTdz
    s = model.scalings
    if model.use_conv_adj:
        _, _, T = split_uvT(x, model.Nz)
        dTdz = d_center_to_face(T, model.dz_hat)
        kap = s.T.sigma / s.wT.sigma / model.H * model.kappa * torch.clamp(dTdz, max=0.0)
        wT = wT - kap
    if model.zero_weights:
        # Without the mPP term to carry them, the prescribed BC fluxes are
        # set on the total boundary faces directly (bc - scale(0)).
        zu = s.uw.scale(torch.zeros_like(torch.as_tensor(bcs.uw_bot)))
        zv = s.vw.scale(torch.zeros_like(torch.as_tensor(bcs.vw_bot)))
        zT = s.wT.scale(torch.zeros_like(torch.as_tensor(bcs.wT_bot)))
        uw = pad_faces(uw[..., 1:-1], bcs.uw_bot - zu, bcs.uw_top - zu)
        vw = pad_faces(vw[..., 1:-1], bcs.vw_bot - zv, bcs.vw_top - zv)
        wT = pad_faces(wT[..., 1:-1], bcs.wT_bot - zT, bcs.wT_top - zT)
    return uw, vw, wT


def _tendencies(model: WindMixingModel, x, uw, vw, wT, coriolis: bool = True):
    """Flux divergence + Coriolis; ``predict_NDE`` (``NDE_training.jl:149-165``).

    ``coriolis=False`` returns the flux-divergence part alone.
    """
    s = model.scalings
    u, v, _ = split_uvT(x, model.Nz)
    r = model.tau / model.H
    dudt = -r * s.uw.sigma / s.u.sigma * d_face_to_center(uw, model.dz_hat)
    dvdt = -r * s.vw.sigma / s.v.sigma * d_face_to_center(vw, model.dz_hat)
    if coriolis:
        dudt = dudt + model.f * model.tau / s.u.sigma * (s.v.sigma * v + s.v.mu)
        dvdt = dvdt - model.f * model.tau / s.v.sigma * (s.u.sigma * u + s.u.mu)
    dTdt = -r * s.wT.sigma / s.T.sigma * d_face_to_center(wT, model.dz_hat)
    return join_uvT(dudt, dvdt, dTdt)


def wind_mixing_rhs(model: WindMixingModel, nns, bcs: BoundaryConditions, x, t):
    """Full NDE right-hand side ``dx/dt_hat`` at scaled state ``x`` ``(..., 3 Nz)``."""
    uw, vw, wT = predict_flux(model, nns, bcs, x, t)
    return _tendencies(model, x, uw, vw, wT)


def solve_wind_mixing_nde(model: WindMixingModel, nns, bcs: BoundaryConditions, x0, t0, dt_save, n_save: int,
                          n_substeps: int = 4, method: str = "rk4", checkpoint: bool = True, unroll: int = 1,
                          fast_assembly=False):
    """Integrate the fully-explicit NDE; returns ``(n_save + 1, ..., 3 Nz)``.

    ``rk4`` integrates the full RHS. ``fast_assembly=True`` (``rk4`` and mPP
    only) integrates the matmul-assembled full RHS (:func:`_fast_full_rhs`);
    ``"fold"`` also precomposes the divergence matrix into the last NN layer,
    once per solve. For ``euler``/``heun`` the Coriolis rotation is split out
    and applied forward-backward after each flux substep: rotation inside a
    plain forward-Euler (or Heun) step amplifies inertial oscillations by
    ``~sqrt(1 + (f tau dt)^2)`` per step. ``checkpoint`` recomputes each save
    interval in the backward pass; ``unroll`` has no effect.
    """
    if fast_assembly and method != "rk4":
        raise ValueError(f"fast_assembly supports method='rk4' here (got {method!r})")
    if method in ("euler", "heun"):
        base_step = _STEPPERS[method]

        def rhs_flux(x, t):
            return _tendencies(model, x, *predict_flux(model, nns, bcs, x, t), coriolis=False)

        def fb_step(_rhs, x, t, dt):
            x = base_step(rhs_flux, x, t, dt)
            s = model.scalings
            u, v, T = split_uvT(x, model.Nz)
            u = u + dt * model.f * model.tau / s.u.sigma * (s.v.sigma * v + s.v.mu)
            v = v - dt * model.f * model.tau / s.v.sigma * (s.u.sigma * u + s.u.mu)
            return join_uvT(u, v, T)

        return solve_fixed_step(None, x0, t0, dt_save, n_save, n_substeps, fb_step, checkpoint, unroll)

    if fast_assembly:
        if fast_assembly not in (True, "fold"):
            raise ValueError(f"fast_assembly must be False, True or 'fold' (got {fast_assembly!r})")
        packed = nns if isinstance(nns, PackedFluxNNs) else pack_flux_nns(nns)
        if packed is None:
            raise ValueError("fast_assembly needs three packable (same-depth, same-activation) MLP closures")
        if isinstance(packed, MemberPackedFluxNNs):
            raise ValueError("the rk4 fused assembly hard-codes the 3-flux layout; "
                             "member-folded ensembles use the default path (or method='split')")
        rhs = _fast_full_rhs(model, packed, bcs, fold_divergence=fast_assembly == "fold")
    else:
        def rhs(x, t):
            return wind_mixing_rhs(model, nns, bcs, x, t)

    return solve_fixed_step(rhs, x0, t0, dt_save, n_save, n_substeps, method, checkpoint, unroll)


def _explicit_rhs_split(model: WindMixingModel, nns, bcs: BoundaryConditions, x, t):
    """Explicit flux part of the split stepper: NN fluxes + BC faces, no Coriolis.

    The split stepper rotates forward-backward after the flux update, and
    the interior mPP diffusion is implicit; in ``zero_weights`` mode the
    boundary faces carry the BC fluxes (``bc - scale(0)``).
    """
    bcs_t = _effective_bcs(model, bcs, t)
    uw, vw, wT = _nn_fluxes(model, nns, bcs_t, x)
    if model.zero_weights:
        s = model.scalings
        zu = s.uw.scale(torch.zeros_like(torch.as_tensor(bcs_t.uw_bot)))
        zv = s.vw.scale(torch.zeros_like(torch.as_tensor(bcs_t.vw_bot)))
        zT = s.wT.scale(torch.zeros_like(torch.as_tensor(bcs_t.wT_bot)))
        uw = pad_faces(uw[..., 1:-1], bcs_t.uw_bot - zu, bcs_t.uw_top - zu)
        vw = pad_faces(vw[..., 1:-1], bcs_t.vw_bot - zv, bcs_t.vw_top - zv)
        wT = pad_faces(wT[..., 1:-1], bcs_t.wT_bot - zT, bcs_t.wT_top - zT)
    return _tendencies(model, x, uw, vw, wT, coriolis=False)


def resolve_fast_assembly(model: WindMixingModel, nns, method: str, value):
    """Resolve ``fast_assembly="auto"``: ``"fold"`` wherever the configuration supports it.

    Every assembly needs packable MLPs and no NN smoothing. The split
    assembly is depth- and activation-generic; ``rk4`` also needs the fused
    RHS body's constraints: a 3-layer mish or relu chain, the mPP base
    closure and no Ri smoothing. Anything else resolves to ``False`` (the
    per-variable stencil path, which handles every configuration), as does
    ``euler``/``heun`` and, for ``rk4``, a member-folded ensemble chain (the
    fused body has the 3-flux layout built in). Non-``"auto"`` values pass
    through (explicit requests keep their errors).
    """
    if value != "auto":
        return value
    packed = nns if isinstance(nns, PackedFluxNNs) else pack_flux_nns(nns)
    if packed is None or model.smooth_NN:
        return False
    if method == "rk4":
        if isinstance(packed, MemberPackedFluxNNs):
            return False
        if len(packed.matrices) != 3 or packed.activation not in ("mish", "relu"):
            return False
        if model.smooth_Ri or not model.use_mpp:
            return False
        return "fold"
    if method != "split":
        return False
    return "fold"


def _tendency_coefficients(model: WindMixingModel):
    """``(R_u, R_v, R_T)`` nondimensional flux-divergence coefficients."""
    s = model.scalings
    return tendency_coefficients(model.tau, model.H, s.uw.sigma, s.vw.sigma, s.wT.sigma,
                                 s.u.sigma, s.v.sigma, s.T.sigma)


def _split_bc_row(model: WindMixingModel, bcs_t: BoundaryConditions, batch):
    """Constant tendency row carrying the boundary-face BC fluxes.

    ``+R_b bot_b / dz`` at cell 0 and ``-R_b top_b / dz`` at cell ``Nz - 1``
    of each variable block (``bc - scale(0)`` in ``zero_weights`` mode, the
    raw BC otherwise). BCs broadcast left-aligned over ``batch``; the result
    broadcasts against ``batch + (3 Nz,)``.
    """
    s = model.scalings

    def expand(c):
        c = torch.as_tensor(c)
        return c.reshape(tuple(c.shape) + (1,) * (len(batch) - c.dim()))[..., None]

    bots, tops = [], []
    for bot, top, fscale in (
        (bcs_t.uw_bot, bcs_t.uw_top, s.uw),
        (bcs_t.vw_bot, bcs_t.vw_top, s.vw),
        (bcs_t.wT_bot, bcs_t.wT_top, s.wT),
    ):
        if model.zero_weights:
            z = fscale.scale(torch.zeros_like(torch.as_tensor(bot)))
            bot, top = bot - z, top - z
        bots.append(expand(bot))
        tops.append(expand(top))
    Ru, Rv, RT = _tendency_coefficients(model)
    return bc_tendency_row(Ru, Rv, RT, bots, tops, model.Nz)


def _pad_to_block(y, Nz: int):
    """``(..., 3 (Nz-1))`` interior fluxes -> the block-aligned ``(..., 3 Nz)``
    layout (seam lane per block zero) that :func:`divergence_matrix` expects."""
    batch = tuple(y.shape[:-1])
    return torch.nn.functional.pad(y.reshape(batch + (3, Nz - 1)), (0, 1)).reshape(batch + (3 * Nz,))


def _fast_explicit_tendencies(model: WindMixingModel, packed, Dr, bcs: BoundaryConditions, x, t):
    """Matmul-assembled :func:`_explicit_rhs_split`: packed chain + divergence matmul + BC row."""
    bcs_t = _effective_bcs(model, bcs, t)
    y = _pad_to_block(packed(x), model.Nz)
    return _rows_product(y, Dr) + _split_bc_row(model, bcs_t, tuple(x.shape[:-1]))


def _pad_packed_chain(packed: PackedFluxNNs, Nz: int):
    """Padded-last-layer view of a :class:`PackedFluxNNs`: the final matmul
    writes straight into the block-aligned ``(..., 3 Nz)`` layout (seam lanes
    structurally zero). Differentiable (pad/reshape). For a
    :class:`MemberPackedFluxNNs` the padding applies per member block
    (``3 M`` flux blocks instead of 3)."""
    n_out = Nz - 1
    M = getattr(packed, "n_members", 1)
    A3, b3 = packed.matrices[-1], packed.biases[-1]
    A3p = torch.nn.functional.pad(A3.reshape(A3.shape[0], 3 * M, n_out), (0, 1)).reshape(A3.shape[0], 3 * M * Nz)
    b3p = torch.nn.functional.pad(b3.reshape(3 * M, n_out), (0, 1)).reshape(3 * M * Nz)
    return (*packed.matrices[:-1], A3p), (*packed.biases[:-1], b3p)


def _fast_full_rhs(model: WindMixingModel, packed: PackedFluxNNs, bcs: BoundaryConditions,
                   fold_divergence: bool = False):
    """The full NDE right-hand side (mPP + Coriolis) by the MXU assembly.

    :func:`ops.fused_rhs.make_fast_rhs` with per-call BCs (left-aligned
    broadcast, diurnal top flux) and trainable packed weights: the same math
    as :func:`wind_mixing_rhs` for the ``use_mpp`` configuration. With
    ``fold_divergence`` the divergence matrix ``Dr`` is precomposed into the
    last layer once, here (differentiably), and the mPP divergence becomes
    the :func:`fold_divergence_constants` roll-subtract. The constants are
    built in f64 and cast to the state's dtype, so an f64 solve stays f64;
    the casts are made once per dtype and device.
    """
    if model.smooth_NN or model.smooth_Ri:
        raise ValueError("fast_assembly does not apply the NN/Ri smoothing filters; use the default path")
    if not model.use_mpp:
        raise ValueError("fast_assembly's full RHS covers the mPP base closure; use the default path")
    if len(packed.matrices) != 3:
        raise ValueError(f"fast_assembly requires the 3-layer flux MLP architecture "
                         f"(got {len(packed.matrices)} packed layers); use the default path")
    Nz = model.Nz
    consts = _scalar_constants(model)
    body = _make_mxu_rhs(consts, Nz, packed.activation, fold_divergence=fold_divergence)
    (A1, A2, A3p), (b1, b2, b3p) = _pad_packed_chain(packed, Nz)
    # The zeroed BC tail of _scalar_constants(model) makes Krow the pure
    # Coriolis-mean row; the BC row is added per call.
    Dr, K_mu, w1, w2 = _assembly_constants(consts, Nz, dtype=np.float64)
    if fold_divergence:
        Dr_w = torch.as_tensor(Dr, dtype=A3p.dtype, device=A3p.device)
        A3p, b3p = A3p @ Dr_w, b3p @ Dr_w
        C2a, C2b = fold_divergence_constants(consts, Nz, dtype=np.float64)
        rows = (C2a, C2b)
    else:
        rows = (Dr,)
    rows += (K_mu[0], w1[0], w2[0])  # 1-D: a (1, n) row would add an axis to unbatched states
    cast = {}
    bc_rows = {}

    def rhs(x, t):
        key = (x.dtype, x.device)
        if key not in cast:
            cast[key] = tuple(torch.as_tensor(a, dtype=x.dtype, device=x.device) for a in rows)
        *lead, K_mu_x, w1_x, w2_x = cast[key]
        batch = tuple(x.shape[:-1])
        if model.diurnal:
            K_bc = _split_bc_row(model, _effective_bcs(model, bcs, t), batch)
        else:  # the BC row is constant unless the top heat flux follows the diurnal cycle
            if (batch, key) not in bc_rows:
                bc_rows[batch, key] = _split_bc_row(model, bcs, batch)
            K_bc = bc_rows[batch, key]
        return body(x, A1, b1, A2, b2, A3p, b3p, *lead, K_bc + K_mu_x, w1_x, w2_x)

    return rhs


def _interior_nu(model: WindMixingModel, x):
    """Face mPP diffusivity with zero boundary faces, for the implicit solve."""
    nu, _ = _face_nu(model, x)
    return torch.nn.functional.pad(nu[..., 1:-1], (1, 1))


def solve_wind_mixing_split(model: WindMixingModel, nns, bcs: BoundaryConditions, x0, t0, dt_save, n_save: int,
                            n_substeps: int = 1, tridiag_backend: str = "scan", checkpoint: bool = True,
                            unroll: int = 1, fast_assembly=False, implicit_solve_grad: bool = True):
    """Operator-split semi-implicit integration; returns ``(n_save + 1, ..., 3 Nz)``.

    Per substep: explicit Euler on the NN fluxes + BC faces, a
    forward-backward Coriolis rotation, then a backward-Euler solve of the
    interior mPP diffusion (diffusivity lagged at the start-of-substep
    state) as ONE batched tridiagonal solve over ``(3, ..., Nz)``
    (``NDE_oceananigans.jl:61-101``). With ``use_conv_adj`` instead of mPP,
    the implicit step is the convective adjustment on ``T``.

    ``fast_assembly=True`` computes the explicit part as the packed NN chain,
    one divergence matmul and a BC row; ``"fold"`` precomposes the divergence
    matrix into the packed last layer once per call. ``tridiag_backend`` is
    ``"scan"``, ``"pcr"`` or ``"cuda"`` (the kernel); ``implicit_solve_grad``
    differentiates the solves by the implicit function theorem.
    ``checkpoint`` recomputes each save interval in the backward pass.
    """
    dt = dt_save / n_substeps
    Nz = model.Nz
    s = model.scalings
    # Non-dimensional diffusion coefficient: nu * tau / H^2.
    nu_scale = model.tau / (model.H * model.H)
    # Loop-invariant scalars, hoisted as XLA hoists them in the JAX package.
    rot_u = dt * model.f * model.tau / s.u.sigma
    rot_v = dt * model.f * model.tau / s.v.sigma

    if fast_assembly:
        if fast_assembly not in (True, "fold"):
            raise ValueError(f"fast_assembly must be False, True or 'fold' (got {fast_assembly!r})")
        if model.smooth_NN:
            raise ValueError("fast_assembly does not apply the NN smoothing filter; use the default path")
        packed = nns if isinstance(nns, PackedFluxNNs) else pack_flux_nns(nns)
        if packed is None:
            raise ValueError("fast_assembly needs three packable (same-depth, same-activation) MLP closures")
        Ru, Rv, RT = _tendency_coefficients(model)
        unit = lambda *r: torch.as_tensor(divergence_matrix(*r, Nz), dtype=x0.dtype, device=x0.device)  # noqa: E731
        Dr = (Ru * unit(1.0, 0.0, 0.0) + Rv * unit(0.0, 1.0, 0.0) + RT * unit(0.0, 0.0, 1.0)).to(x0.dtype)
        if fast_assembly == "fold":
            mats, biases = _pad_packed_chain(packed, Nz)
            M = getattr(packed, "n_members", 1)
            A3, b3 = mats[-1], biases[-1]
            if M == 1:
                A3f, b3f = A3 @ Dr, b3 @ Dr
            else:
                # Per-member divergence: Dr acts on each (3 Nz) member block of the
                # padded last layer (block-diag(I_M x Dr) without building it).
                A3f = (A3.reshape(A3.shape[0], M, 3 * Nz) @ Dr).reshape(A3.shape[0], M * 3 * Nz)
                b3f = (b3.reshape(M, 3 * Nz) @ Dr).reshape(-1)
            # dataclasses.replace keeps the (possibly member-folded) class.
            folded = dataclasses.replace(packed, matrices=(*mats[:-1], A3f), biases=(*biases[:-1], b3f))
            # The BC row is constant unless the top heat flux follows the diurnal cycle.
            K_const = None if model.diurnal else _split_bc_row(model, bcs, tuple(x0.shape[:-1]))

    def substep(_rhs, x, t, dt):
        if fast_assembly == "fold":
            K = K_const if K_const is not None else _split_bc_row(model, _effective_bcs(model, bcs, t),
                                                                  tuple(x.shape[:-1]))
            x_adv = x + dt * (folded(x) + K)
        elif fast_assembly:
            x_adv = x + dt * _fast_explicit_tendencies(model, packed, Dr, bcs, x, t)
        else:
            x_adv = x + dt * _explicit_rhs_split(model, nns, bcs, x, t)
        # Forward-backward Coriolis (v uses the already-rotated u): neutrally
        # stable where forward Euler amplifies inertial oscillations.
        u, v, T = split_uvT(x_adv, Nz)
        u = u + rot_u * (s.v.sigma * v + s.v.mu)
        v = v - rot_v * (s.u.sigma * u + s.u.mu)
        if model.use_mpp:
            nu = _interior_nu(model, x) * nu_scale
            # One batched solve: (u, v, T) stacked on a new leading axis.
            phi = torch.stack([u, v, T], dim=0)
            nu3 = torch.stack([nu, nu, nu / model.mpp.Pr], dim=0)
            phi = implicit_diffusion_step(phi, nu3, dt, model.dz_hat, backend=tridiag_backend, unroll=8,
                                          implicit_grad=implicit_solve_grad)
            return join_uvT(phi[0], phi[1], phi[2])
        if model.use_conv_adj:
            # Implicit convective adjustment on T, switch lagged at the
            # start-of-substep state: kappa tau / H^2 where unstable.
            _, _, T_lag = split_uvT(x, Nz)
            dTdz = d_center_to_face(T_lag, model.dz_hat)
            Kc = model.kappa * (dTdz < 0.0) * nu_scale
            T = implicit_diffusion_step(T, Kc, dt, model.dz_hat, backend=tridiag_backend, zero_boundary_faces=True,
                                        unroll=8, implicit_grad=implicit_solve_grad)
        return join_uvT(u, v, T)

    return solve_fixed_step(None, x0, t0, dt_save, n_save, n_substeps, substep, checkpoint, unroll)
