"""Running-mean smoothing filter for NN outputs and Ri profiles.

Port of ``climateparameterizations_jl_tpu/core/filters.py`` (reference
``wind_mixing/src/filtering_operators.jl:1-15``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def smoothing_filter_matrix(N: int, filter_width: int) -> np.ndarray:
    """Running-mean matrix of odd width with renormalized edge rows."""
    if N < filter_width or filter_width % 2 != 1:
        raise ValueError("require N >= filter_width and odd filter_width")
    half = (filter_width - 1) // 2
    W = np.zeros((N, N), dtype=np.float32)
    for i in range(1, half + 1):  # 1-based edge rows
        W[i - 1, : half + i] = 1.0 / (half + i)
        W[N - i, N - (half + i) : N] = 1.0 / (half + i)
    for i in range(half + 1, N - half + 1):  # 1-based interior rows
        W[i - 1, i - 1 - half : i + half] = 1.0 / filter_width
    return W


def smoothing_filter(phi: torch.Tensor, filter_width: int = 3) -> torch.Tensor:
    """Apply the running-mean filter along the last axis."""
    W = torch.as_tensor(smoothing_filter_matrix(phi.shape[-1], filter_width), dtype=phi.dtype, device=phi.device)
    return phi @ W.T
