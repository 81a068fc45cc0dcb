"""Free-convection NDE: one heat-flux MLP closure for a convecting column.

Port of ``climateparameterizations_jl_tpu/models/free_convection.py``
(reference ``free_convection/src/free_convection_nde.jl:1-62`` and
``convective_adjustment_nde.jl:1-57``). The state is the scaled temperature
profile ``T`` (``Nz`` centers); one MLP predicts the ``Nz - 1`` interior
scaled heat fluxes, and the non-dimensional PDE

    dT/dt_hat = -sigma_wT/sigma_T * tau/H * d/dz_hat(wT)                [plain]
    dT/dt_hat = sigma_wT/sigma_T * tau/H *
                (-d/dz_hat(wT) + d/dz_hat(min(0, kappa dT/dz_hat)))     [conv-adj]

is integrated by the fixed-step steppers (:func:`solve_free_convection_nde`)
or by the operator-split solver (:func:`solve_free_convection_split`), whose
implicit convective adjustment is one batched tridiagonal solve per
substep: on the card the Thomas kernel ``csrc/thomas.cu``. Leading axes of
``T0`` batch (simulations, ensemble members).
"""

from __future__ import annotations

import dataclasses

import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import apply_closure
from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face, d_face_to_center, pad_faces
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.models.timestepper import solve_fixed_step
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import implicit_diffusion_step
from climateparameterizations_jl_tpu_torch.physics.convective_adjustment import convective_adjustment_flux


@dataclasses.dataclass(frozen=True)
class FreeConvectionModel:
    """Constants, scalings and boundary heat fluxes of a free-convection column.

    ``bottom_flux`` / ``top_flux`` are the scaled boundary fluxes appended to
    the MLP's interior fluxes (reference ``free_convection_nde.jl:49-62``);
    ``(S,)`` fluxes apply per simulation, broadcast left-aligned over the
    leading axes of the state. ``Nz`` and ``base_closure`` are plain Python
    fields.
    """

    H: torch.Tensor  # column depth [m]
    tau: torch.Tensor  # simulation span [s]
    T_scaling: ZeroMeanUnitVarianceScaling
    wT_scaling: ZeroMeanUnitVarianceScaling
    bottom_flux: torch.Tensor  # scaled wT at the bottom face
    top_flux: torch.Tensor  # scaled wT at the top face (surface forcing)
    kappa: torch.Tensor = dataclasses.field(default_factory=lambda: torch.tensor(10.0))
    Nz: int = 32
    base_closure: str = "convective_adjustment"

    @property
    def dz_hat(self) -> float:
        return 1.0 / self.Nz


def _prefactor(model: FreeConvectionModel):
    return model.wT_scaling.sigma / model.T_scaling.sigma * model.tau / model.H


def _assemble_wT(model: FreeConvectionModel, nn, T):
    """Scaled ``wT`` faces: the closure's interior fluxes (zeros for ``nn=None``) between the BC faces."""
    if nn is None:  # physics-only baseline (convective_adjustment_nde.jl with zero weights)
        interior = torch.zeros(T.shape[:-1] + (model.Nz - 1,), dtype=T.dtype, device=T.device)
    else:
        interior = apply_closure(nn, T)
    return pad_faces(interior, model.bottom_flux, model.top_flux)


def free_convection_rhs(model: FreeConvectionModel, nn, T, t):
    """``dT/dt_hat`` for the scaled temperature ``T`` ``(..., Nz)``."""
    wT = _assemble_wT(model, nn, T)
    prefactor = _prefactor(model)
    div_wT = d_face_to_center(wT, model.dz_hat)
    if model.base_closure == "convective_adjustment":
        ca_flux = convective_adjustment_flux(T, model.dz_hat, model.kappa)
        div_ca = d_face_to_center(ca_flux, model.dz_hat)
        return prefactor * (-div_wT + div_ca)
    return -prefactor * div_wT


def solve_free_convection_nde(model: FreeConvectionModel, nn, T0, t0, dt_save, n_save: int, n_substeps: int = 2,
                              method: str = "rk4", checkpoint: bool = True, tridiag_backend: str = "scan"):
    """Integrate; returns ``(n_save + 1, ..., Nz)`` scaled trajectories.

    ``method`` is ``rk4 | heun | euler`` (:func:`solve_fixed_step` on
    :func:`free_convection_rhs`) or ``split``
    (:func:`solve_free_convection_split`, which takes ``tridiag_backend``).
    The JAX function runs the split solver on its default ``"scan"``
    backend; the port's trainer passes the backend it resolves for the
    state's device (``train/nde.py::resolve_tridiag_backend``: the kernel on
    the card). The kernel runs the scan's sweep in its roundings, so either
    backend computes the JAX package's numbers.
    """
    if method == "split":
        return solve_free_convection_split(model, nn, T0, t0, dt_save, n_save, n_substeps,
                                           tridiag_backend=tridiag_backend, checkpoint=checkpoint)
    rhs = lambda T, t: free_convection_rhs(model, nn, T, t)  # noqa: E731
    return solve_fixed_step(rhs, T0, t0, dt_save, n_save, n_substeps, method, checkpoint)


def solve_free_convection_split(model: FreeConvectionModel, nn, T0, t0, dt_save, n_save: int, n_substeps: int = 1,
                                tridiag_backend: str = "scan", checkpoint: bool = True):
    """Operator-split integration: explicit closure fluxes, implicit convective adjustment.

    The explicit ``min(0, kappa dT/dz)`` closure is stiff; here each
    substep is an explicit Euler step of the flux divergence, then one
    backward-Euler solve of the unstable-only diffusion with the switch
    lagged at the substep's start and both boundary faces zeroed (the
    scheme of the reference's Oceananigans embedding,
    ``oceananigans_nn.jl:13-40``). ``tridiag_backend`` is ``"scan"``,
    ``"pcr"`` or ``"cuda"`` (one kernel launch per substep); ``checkpoint``
    recomputes each save interval in the backward pass.
    """
    dz_hat = model.dz_hat
    prefactor = _prefactor(model)

    def substep(_rhs, T, t, dt):
        wT = _assemble_wT(model, nn, T)
        T_adv = T - dt * prefactor * d_face_to_center(wT, dz_hat)
        if model.base_closure == "convective_adjustment":
            dTdz = d_center_to_face(T, dz_hat)
            # Scaled face diffusivity: the explicit term is prefactor d/dz(kappa 1[dTdz < 0] dTdz).
            K = prefactor * model.kappa * (dTdz < 0)
            T_adv = implicit_diffusion_step(T_adv, K, dt, dz_hat, backend=tridiag_backend, zero_boundary_faces=True)
        return T_adv

    return solve_fixed_step(None, T0, t0, dt_save, n_save, n_substeps, substep, checkpoint)


def diagnose_wT(model: FreeConvectionModel, nn, T_traj):
    """Scaled ``wT`` faces of a trajectory, the conv-adj contribution included.

    Parity: the wT reconstruction in ``free_convection/src/solve.jl:8-51``.
    """
    wT = _assemble_wT(model, nn, T_traj)
    if model.base_closure == "convective_adjustment":
        wT = wT - convective_adjustment_flux(T_traj, model.dz_hat, model.kappa)
    return wT
