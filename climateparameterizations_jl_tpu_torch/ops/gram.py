"""Fused GP Gram matrix: pairwise distances and the kernel family in one kernel.

Port of ``climateparameterizations_jl_tpu/ops/gram.py``. Every Gram matrix
``K[i, j] = k(||A_i - B_j||)`` of the GP path's ``"cuda"`` backend
(``closures/gp.py``) comes from :func:`gram_cuda_diff`:

- :func:`gram_plain` is the plain version: row norms, ``A @ B^T``, clamp at
  0, then the family epilogue (:func:`_epilogue`, the TPU kernel's).
- :func:`gram_cuda` casts to f32 and runs the hand-written kernel
  ``csrc/gram.cu`` on CUDA tensors (or raises), and :func:`gram_plain` on
  CPU tensors. It is the counterpart of the TPU kernel ``gram_pallas``.
- :func:`gram_cuda_diff` wraps it in a ``torch.autograd.Function`` whose
  backward is the JAX package's analytic ``_gram_diff_bwd``: closed-form
  hyperparameter partials and the Gram-trick matmul form of the feature
  cotangents, computed with torch ops (as JAX leaves them to XLA).
"""

from __future__ import annotations

import math

import torch

from climateparameterizations_jl_tpu_torch.ops import _cuda

_FAMILIES = _cuda.GRAM_FAMILIES
MAX_FEATURES = 4096  # the TPU kernel's limit, kept as the wrapper's contract


def _epilogue(family: str, d2, gamma, sigma, alpha):
    """Kernel-family evaluation on a squared-distance matrix (the TPU kernel's epilogue)."""
    if family == "squared_exponential":
        return sigma * torch.exp(-d2 / (2.0 * gamma * gamma))
    d = torch.sqrt(d2)
    if family == "matern12":
        return sigma * torch.exp(-d / gamma)
    if family == "matern32":
        c = math.sqrt(3.0) * d / gamma
        return sigma * (1.0 + c) * torch.exp(-c)
    if family == "matern52":
        c = math.sqrt(5.0) * d / gamma
        h = 5.0 * d2 / (3.0 * gamma * gamma)
        return sigma * (1.0 + c + h) * torch.exp(-c)
    if family == "rational_quadratic":
        base = 1.0 + d2 / (2.0 * alpha * gamma * gamma)
        return sigma * torch.exp(-alpha * torch.log(base))
    raise ValueError(f"unknown kernel family {family!r}")


def _sq_distances(A, B):
    """``(d2, |a|^2, |b|^2)``: Gram-trick squared distances clamped at 0 (NaN stays NaN)."""
    aa = torch.sum(A * A, dim=1)[:, None]
    bb = torch.sum(B * B, dim=1)[None, :]
    return torch.clamp_min(aa + bb - 2.0 * (A @ B.T), 0.0), aa, bb


def gram_plain(A, B, gamma, sigma, alpha=1.0, *, family: str = "squared_exponential"):
    """The plain version of the kernel: ``K (M, N)`` in the inputs' dtype."""
    return _epilogue(family, _sq_distances(A, B)[0], gamma, sigma, alpha)


def _on_device(v, device, name: str):
    """``v`` as a tensor on ``device``; a tensor that lives on another device raises.

    Python numbers and numpy arrays become tensors on ``device``. A tensor is
    never copied between devices: a CPU tensor beside CUDA ones would
    otherwise pull the card's data to the host (or the reverse) unseen.
    """
    if isinstance(v, torch.Tensor):
        if v.device != device:
            raise ValueError(f"{name} is on {v.device} but A is on {device}; put the Gram's inputs on one device")
        return v
    return torch.as_tensor(v, device=device)


def gram_cuda(A, B, gamma, sigma, alpha=1.0, *, family: str = "squared_exponential", bm: int = 256,
              bn: int = 256):
    """Fused kernel matrix ``K[i, j] = k(||A_i - B_j||)``, shape ``(M, N)``, f32.

    ``A (M, D)``, ``B (N, D)`` are cast to f32 (use the plain backend for
    f64). ``D`` must be at most 4096, the TPU kernel's limit. ``bm``/``bn``
    are the TPU kernel's tile sizes and are ignored: the CUDA kernel has its
    own 128 x 64 tiles. CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`gram_plain` on the same f32 inputs. ``B`` and tensor
    hyperparameters on another device than ``A`` raise ``ValueError``.
    """
    del bm, bn
    if family not in _FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}")
    A = torch.as_tensor(A).to(torch.float32)
    B = _on_device(B, A.device, "B").to(torch.float32)
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[1]:
        raise ValueError(f"feature mismatch: {tuple(A.shape)} vs {tuple(B.shape)}")
    if A.shape[1] > MAX_FEATURES:
        raise ValueError(f"gram_cuda supports D <= {MAX_FEATURES} features, got {A.shape[1]}; use the plain backend")
    # Views and no-op casts for f32 tensors on A's device: the kernel reads
    # each hyperparameter where it lies, so no device op runs besides it.
    params = [_on_device(v, A.device, name).to(torch.float32).reshape(())
              for v, name in ((gamma, "gamma"), (sigma, "sigma"), (alpha, "alpha"))]
    if A.device.type == "cpu":
        return gram_plain(A, B, *params, family=family)
    return _cuda.GRAM(A.contiguous(), B.contiguous(), *params, family)


def _family_partials(family, d2, gamma, sigma, alpha):
    """``(K, dK/dgamma, dK/d(d2), dK/dalpha)`` as elementwise f32 maps.

    Matern forms are arranged so every partial is finite at ``d = 0``;
    matern12's ``dK/d(d2)`` keeps its integrable singularity behind a
    1e-12 floor on ``d``.
    """
    g2 = gamma * gamma
    if family == "squared_exponential":
        K = sigma * torch.exp(-d2 / (2.0 * g2))
        return K, K * d2 / (g2 * gamma), -K / (2.0 * g2), torch.zeros_like(d2)
    d = torch.sqrt(d2)
    if family == "matern12":
        K = sigma * torch.exp(-d / gamma)
        dK_dd2 = -K / (2.0 * gamma * torch.clamp_min(d, 1e-12))
        return K, K * d / g2, dK_dd2, torch.zeros_like(d2)
    if family == "matern32":
        c = math.sqrt(3.0) * d / gamma
        e = torch.exp(-c)
        K = sigma * (1.0 + c) * e
        return K, sigma * c * c * e / gamma, -sigma * e * 1.5 / g2, torch.zeros_like(d2)
    if family == "matern52":
        c = math.sqrt(5.0) * d / gamma
        e = torch.exp(-c)
        K = sigma * (1.0 + c + c * c / 3.0) * e
        dK_dgamma = sigma * e * c * c * (1.0 + c) / (3.0 * gamma)
        dK_dd2 = -sigma * e * (1.0 + c) * (5.0 / (6.0 * g2))
        return K, dK_dgamma, dK_dd2, torch.zeros_like(d2)
    if family == "rational_quadratic":
        base = 1.0 + d2 / (2.0 * alpha * g2)
        K = sigma * torch.exp(-alpha * torch.log(base))
        Kb = K / base
        dK_dgamma = Kb * d2 / (g2 * gamma)
        dK_dd2 = -Kb / (2.0 * g2)
        dK_dalpha = K * (-torch.log(base) + d2 / (2.0 * alpha * g2 * base))
        return K, dK_dgamma, dK_dd2, dK_dalpha
    raise ValueError(f"unknown kernel family {family!r}")


class _GramDiff(torch.autograd.Function):
    """The kernel forward with the analytic backward of JAX ``_gram_diff_bwd``."""

    @staticmethod
    def forward(ctx, family, A, B, gamma, sigma, alpha):
        ctx.family = family
        ctx.save_for_backward(A, B, gamma, sigma, alpha)
        return gram_cuda(A, B, gamma, sigma, alpha, family=family)

    @staticmethod
    def backward(ctx, Kbar):
        res = ctx.saved_tensors
        A, B, gamma, sigma, alpha = res
        Af, Bf, Kbar = A.float(), B.float(), Kbar.float()
        gf, sf, af = gamma.float(), sigma.float(), alpha.float()
        d2, a2, b2 = _sq_distances(Af, Bf)
        K, dK_dgamma, dK_dd2, dK_dalpha = _family_partials(ctx.family, d2, gf, sf, af)
        # Numerically coincident pairs (the diagonal of a training Gram)
        # contribute exactly 0 to the feature cotangents, but must be masked
        # before the Gram-trick decomposition: matern12's floored 1/d puts
        # ~1e12-scale entries into rowsum(W) A - W B, and the f32
        # cancellation would wipe out the O(1) off-diagonal signal.
        coincident = d2 <= 1e-7 * (a2 + b2)
        W = torch.where(coincident, torch.zeros_like(d2), Kbar * dK_dd2)
        dA = 2.0 * (torch.sum(W, dim=1)[:, None] * Af - W @ Bf)
        dB = 2.0 * (torch.sum(W, dim=0)[:, None] * Bf - W.T @ Af)
        dgamma = torch.sum(Kbar * dK_dgamma)
        dsigma = torch.sum(Kbar * K) / sf
        dalpha = torch.sum(Kbar * dK_dalpha)
        grads = (dA, dB, dgamma, dsigma, dalpha)
        return (None, *(g.to(r.dtype).reshape(r.shape) for g, r in zip(grads, res)))


def gram_cuda_diff(family: str, A, B, gamma, sigma, alpha):
    """Differentiable fused Gram: :func:`gram_cuda` forward, closed-form torch backward.

    The twin of JAX ``gram_pallas_diff``. The value is f32; the gradients
    come back in the dtypes (and shapes) of ``A``, ``B`` and the three
    hyperparameters. The backward never forms an ``(M, N, D)`` tensor: with
    ``W = Kbar * dK/d(d2)`` the feature cotangents are two matmuls. Inputs
    on another device than ``A`` raise, as in :func:`gram_cuda`.
    """
    A = torch.as_tensor(A)
    B = _on_device(B, A.device, "B")
    gamma, sigma, alpha = (_on_device(v, A.device, name)
                           for v, name in ((gamma, "gamma"), (sigma, "sigma"), (alpha, "alpha")))
    return _GramDiff.apply(family, A, B, gamma, sigma, alpha)
