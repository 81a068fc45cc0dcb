"""Staggered-grid differentiation operators as stencils on the last axis.

Port of ``climateparameterizations_jl_tpu/core/operators.py:21,30,72``
(reference ``src/differentiation_operators.jl:6-35``).
"""

from __future__ import annotations

import torch


def d_face_to_center(w: torch.Tensor, dz) -> torch.Tensor:
    """``out[..., k] = (w[..., k+1] - w[..., k]) / dz``: ``(..., N+1) -> (..., N)``."""
    return (w[..., 1:] - w[..., :-1]) / dz


def d_center_to_face(c: torch.Tensor, dz) -> torch.Tensor:
    """Center -> face derivative with zero bottom and top faces: ``(..., N) -> (..., N+1)``."""
    interior = (c[..., 1:] - c[..., :-1]) / dz
    return torch.nn.functional.pad(interior, (1, 1))


def pad_faces(interior, bottom, top):
    """Assemble ``(..., Nz+1)`` faces from interior values and BCs.

    BC tensors broadcast LEFT-aligned against the batch axes: a ``(S,)`` BC
    with ``(S, E, Nz-1)`` interiors means "per simulation", so trailing
    axes are appended (right-aligned broadcasting would attach it to the
    wrong axis whenever ``S == E``).
    """
    batch = interior.shape[:-1]

    def expand(b):
        b = torch.as_tensor(b, dtype=interior.dtype, device=interior.device)
        b = b.reshape(tuple(b.shape) + (1,) * (len(batch) - b.dim()))
        return torch.broadcast_to(b, batch)[..., None]

    return torch.cat([expand(bottom), interior, expand(top)], dim=-1)
