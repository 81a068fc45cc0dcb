"""Convective adjustment closures: the differentiable flux form and the implicit solve.

Port of ``climateparameterizations_jl_tpu/physics/convective_adjustment.py``:

- **Flux form** (inside NDEs): a diffusive heat flux active only where the
  column is statically unstable (``dT/dz < 0``), written ``min(0, K dT/dz)``
  (reference ``free_convection/src/convective_adjustment_nde.jl:43-47``).
- **Implicit backward-Euler form**: ``K(z) = kappa`` where unstable, else 0,
  then one tridiagonal solve ``(I - dt d/dz K d/dz) T' = T`` (reference
  ``free_convection/src/oceananigans_nn.jl:13-40``), through
  ``ops/tridiagonal.py`` with any of its backends (``"cuda"``: the kernel
  ``csrc/thomas.cu``).
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.core.operators import d_center_to_face
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import implicit_diffusion_step


def convective_adjustment_flux(T, dz, kappa):
    """Differentiable conv-adj face flux ``min(0, kappa dT/dz)``, shape ``(..., Nz+1)``.

    The negative of a downgradient diffusive flux restricted to unstable
    regions; callers subtract its divergence from ``dT/dt``. At a tie the
    gradient splits in halves, as ``jnp.minimum``'s does.
    """
    flux = kappa * d_center_to_face(T, dz)
    return torch.minimum(torch.zeros_like(flux), flux)


def convective_adjustment_implicit_step(T, dt, dz, kappa, backend: str = "scan"):
    """One backward-Euler convective-adjustment step on ``T`` ``(..., Nz)``.

    The face diffusivity is ``kappa`` where ``dT/dz < 0``, else 0; the
    boundary faces carry no flux.
    """
    dTdz = d_center_to_face(T, dz)
    on = torch.as_tensor(kappa, dtype=T.dtype, device=T.device)
    K_face = torch.where(dTdz < 0.0, on, torch.zeros_like(on))
    # Zero-flux boundaries (d_center_to_face zeroes them already; kappa may be an array).
    K_face = torch.nn.functional.pad(K_face[..., 1:-1], (1, 1))
    return implicit_diffusion_step(T, K_face, dt, dz, backend=backend)
