"""Coarse-graining of high-resolution LES profiles onto the model grid.

Port of ``climateparameterizations_jl_tpu/core/coarse_grain.py`` (reference
``src/DataWrangling/coarse_graining.jl:8-62``). Every variant is a linear
operator: its ``(n, N)`` weight matrix is built once in numpy (float64) and
applied as one matmul over the last axis. This is data preparation, so the
matmul runs in float64 and is rounded once to the data's dtype: never in
TF32, whatever ``torch.backends.cuda.matmul.allow_tf32`` says (reduced
precision here shifts the truth profiles; ``docs/PERFORMANCE.md``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def center_weights(N: int, n: int) -> np.ndarray:
    """Weight matrix for block-mean coarse-graining of a Center field."""
    if N % n != 0:
        raise ValueError(f"n={n} must evenly divide N={N} for Center coarse-graining")
    delta = N // n
    W = np.zeros((n, N))
    for i in range(n):
        W[i, delta * i : delta * (i + 1)] = 1.0 / delta
    return W


@lru_cache(maxsize=None)
def face_weights(N: int, n: int) -> np.ndarray:
    """Weight matrix for endpoint-preserving mean coarse-graining of a Face field."""
    W = np.zeros((n, N))
    W[0, 0] = 1.0
    W[-1, -1] = 1.0
    delta = (N - 2) / (n - 2)
    if delta == int(delta):
        W[1:-1, 1:-1] = center_weights(N - 2, n - 2)
    else:
        # Rounded-window means (reference coarse_graining.jl:32-36, 1-based).
        for i in range(2, n):
            i1 = int(np.round(2 + (i - 2) * delta))
            i2 = int(np.round(2 + (i - 1) * delta))
            W[i - 1, i1 - 1 : i2] = 1.0 / (i2 - i1 + 1)
    return W


@lru_cache(maxsize=None)
def face_interp_weights(N: int, n: int) -> np.ndarray:
    """Weight matrix for linear-interpolation coarse-graining of a Face field."""
    W = np.zeros((n, N))
    W[0, 0] = 1.0
    W[-1, -1] = 1.0
    gap = (N - 1) / (n - 1)
    for i in range(2, n):  # 1-based interior index
        pos = 1 + (i - 1) * gap
        lo = int(np.floor(pos))
        W[i - 1, lo - 1] = (lo + 1) - pos
        W[i - 1, lo] = (pos - lo) if lo < N else 0.0
    return W


def _apply(W: np.ndarray, phi) -> torch.Tensor:
    phi = torch.as_tensor(phi)
    Wt = torch.as_tensor(W, dtype=torch.float64, device=phi.device)
    return (phi.to(torch.float64) @ Wt.T).to(phi.dtype)


def coarse_grain_center(phi, n: int) -> torch.Tensor:
    """Block-mean a Center field ``(..., N)`` down to ``(..., n)``."""
    return _apply(center_weights(phi.shape[-1], n), phi)


def coarse_grain_face(phi, n: int) -> torch.Tensor:
    """Coarse-grain a Face field ``(..., N)`` to ``(..., n)``, preserving endpoints."""
    return _apply(face_weights(phi.shape[-1], n), phi)


def coarse_grain_linear_interpolation(phi, n: int) -> torch.Tensor:
    """Linear-interpolation coarse-graining of a Face field, preserving endpoints."""
    return _apply(face_interp_weights(phi.shape[-1], n), phi)
