"""WENO5 upwind advection (Jiang-Shu weighted essentially non-oscillatory, WENO-Z weights).

Port of ``climateparameterizations_jl_tpu/core/advection.py`` (the
reference advects with Oceananigans' ``WENO5()``,
``free_convection/double_gyre.jl:60-196``). Face values are reconstructed
from smoothness-weighted three-point candidate stencils: fifth order where
the field is smooth, monotone at fronts. Elementwise arithmetic on six
shifted copies of one padded tensor (wrap for periodic axes, edge-clamp for
bounded ones), in the JAX function's order of operations.

Face convention: ``boundary="edge"`` returns the ``n - 1`` interior faces
(face ``j + 1/2`` between cells ``j`` and ``j + 1``); ``"periodic"``
returns ``n`` faces, face ``k`` between cells ``k - 1`` and ``k``.
"""

from __future__ import annotations

import torch

# Optimal linear weights of the three candidate stencils (Jiang & Shu 1996).
_G0, _G1, _G2 = 0.1, 0.6, 0.3


def _weno5(a, b, c, d, e):
    """Left-biased face value at ``j + 1/2`` from cells ``(j-2..j+2) = (a..e)``.

    WENO-Z weights (Borges et al. 2008): the global indicator ``tau5 =
    |beta0 - beta2|`` keeps the weights at their optimal values near smooth
    critical points.
    """
    eps = 1e-15 if a.dtype == torch.float64 else 1e-8
    p0 = (2.0 * a - 7.0 * b + 11.0 * c) / 6.0
    p1 = (-b + 5.0 * c + 2.0 * d) / 6.0
    p2 = (2.0 * c + 5.0 * d - e) / 6.0
    beta0 = (13.0 / 12.0) * (a - 2.0 * b + c) ** 2 + 0.25 * (a - 4.0 * b + 3.0 * c) ** 2
    beta1 = (13.0 / 12.0) * (b - 2.0 * c + d) ** 2 + 0.25 * (b - d) ** 2
    beta2 = (13.0 / 12.0) * (c - 2.0 * d + e) ** 2 + 0.25 * (3.0 * c - 4.0 * d + e) ** 2
    tau5 = torch.abs(beta0 - beta2)
    w0 = _G0 * (1.0 + tau5 / (beta0 + eps))
    w1 = _G1 * (1.0 + tau5 / (beta1 + eps))
    w2 = _G2 * (1.0 + tau5 / (beta2 + eps))
    s = w0 + w1 + w2
    return (w0 * p0 + w1 * p1 + w2 * p2) / s


def _pad3(q, axis: int, mode: str):
    """``q`` padded by three cells on both ends of ``axis``: edge copies or a periodic wrap."""
    n = q.shape[axis]
    if mode == "wrap":
        idx = torch.arange(-3, n + 3, device=q.device) % n
    else:
        idx = torch.clamp(torch.arange(-3, n + 3, device=q.device), 0, n - 1)
    return q.index_select(axis, idx)


def weno5_padded_face_values(qp, axis: int, base: int, count: int):
    """``(qL, qR)`` on ``count`` faces of an already padded ``qp``: face ``i`` reads cells ``base + i .. base + i + 5``.

    The building block of :func:`weno5_face_values`, for callers that pad
    themselves (halo rows from neighbouring ranks, ``parallel/``).
    """
    W = [qp.narrow(axis, base + m, count) for m in range(6)]
    qL = _weno5(W[0], W[1], W[2], W[3], W[4])
    qR = _weno5(W[5], W[4], W[3], W[2], W[1])
    return qL, qR


def weno5_face_values(q, axis: int = -1, boundary: str = "edge", pad=None):
    """``(qL, qR)`` WENO5 reconstructions on the faces along ``axis``.

    ``qL`` is the left-biased value (for a positive face velocity), ``qR``
    the right-biased one. ``pad(q)``, where given, pads ``q`` by three
    cells on both ends of ``axis`` in place of the wrap or edge copies.
    """
    axis = axis % q.dim()
    n = q.shape[axis]
    if boundary == "periodic":
        pad_mode, count, base = "wrap", n, 0
    elif boundary == "edge":
        pad_mode, count, base = "edge", n - 1, 1
    else:
        raise ValueError(f"unknown boundary {boundary!r}")
    qp = _pad3(q, axis, pad_mode) if pad is None else pad(q)
    return weno5_padded_face_values(qp, axis, base, count)


def weno5_advective_flux(u_face, q, axis: int = -1, boundary: str = "edge", pad=None):
    """Upwind advective flux ``u * q_face`` with WENO5 face reconstruction.

    ``u_face`` lives on the faces the ``boundary`` convention gives
    (``n - 1`` interior faces for ``"edge"``, ``n`` for ``"periodic"``).
    ``pad`` is :func:`weno5_face_values`'s.
    """
    qL, qR = weno5_face_values(q, axis, boundary, pad)
    return u_face * torch.where(u_face >= 0, qL, qR)
