"""Blocked Cholesky factorization: the hand-written kernel ``csrc/cholesky.cu``.

Port of ``climateparameterizations_jl_tpu/ops/cholesky.py``. The TPU kernel
``cholesky_pallas`` keeps the whole matrix in VMEM and runs the blocked
right-looking algorithm in one launch; the CUDA kernel runs the same
algorithm over 64 x 64 tiles in ``2 ceil(n / 64)`` launches (one SM's
shared memory cannot hold the matrix): a copy of the lower triangle, then
per block column one launch that factors the diagonal tile and solves the
panel below it (one reciprocal per pivot, no division on the chain) and one
trailing update. Forward-only and f32, like the TPU
kernel; the GP fits factorize with ``torch.linalg.cholesky_ex``
(``closures/gp.py``), as the JAX package uses ``jax.scipy.linalg.cholesky``.

- :func:`cholesky_plain` is the plain version, the TPU kernel's algorithm
  with its ``block``: per block column an unblocked factorization of the
  diagonal block by rank-1 updates, its triangular inverse by forward
  substitution, the panel as one matmul against that inverse, and the
  trailing update as a second matmul.
- :func:`cholesky_cuda` keeps the TPU wrapper's contract (square, f32,
  ``n`` a multiple of ``block``) and runs the kernel on CUDA tensors (or
  raises), :func:`cholesky_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.ops import _cuda


def _chol_unblocked(M):
    """Outer-product Cholesky of a ``(B, B)`` SPD block by masked rank-1 updates."""
    n = M.shape[0]
    rows = torch.arange(n, device=M.device)[:, None]
    L = torch.zeros_like(M)
    for j in range(n):
        pivot = torch.sqrt(M[j, j])
        l = torch.where(rows >= j, M[:, j:j + 1] / pivot, torch.zeros_like(pivot))  # noqa: E741 - column j of L
        # Full outer-product update: entries in rows/columns <= j become junk,
        # but every later read is masked to the trailing submatrix.
        M = M - l @ l.T
        L[:, j:j + 1] = l
    return L


def _tri_inv_lower(L):
    """Inverse of a lower-triangular ``(B, B)`` block by forward substitution, row by row."""
    n = L.shape[0]
    cols = torch.arange(n, device=L.device)[None, :]
    X = torch.zeros_like(L)
    for j in range(n):
        row = L[j:j + 1, :]
        prev = torch.where(cols < j, row, torch.zeros_like(row)) @ X
        X[j:j + 1, :] = ((cols == j).to(L.dtype) - prev) / L[j, j]
    return X


def cholesky_plain(K, block: int = 128):
    """Lower Cholesky factor of ``K (n, n)`` by the TPU kernel's blocked algorithm.

    ``n`` must be a multiple of ``block``. The upper triangle is zero.
    """
    n = K.shape[-1]
    L = K.clone()
    nb = n // block
    for k in range(nb):
        lo, hi = k * block, (k + 1) * block
        Lkk = _chol_unblocked(L[lo:hi, lo:hi])
        L[lo:hi, lo:hi] = Lkk
        if k < nb - 1:
            # Solve X Lkk^T = P as X = P (Lkk^{-1})^T: one matmul.
            Lp = L[hi:n, lo:hi] @ _tri_inv_lower(Lkk).T
            L[hi:n, lo:hi] = Lp
            L[hi:n, hi:n] = L[hi:n, hi:n] - Lp @ Lp.T
    return torch.tril(L)


def cholesky_cuda(K, block: int = 128):
    """Lower Cholesky factor of an SPD matrix (f32, forward-only).

    The contract of JAX ``cholesky_pallas``: ``K`` is ``(n, n)`` f32 with
    ``n`` a multiple of ``block``, else ``ValueError``. The result has an
    exactly zero upper triangle; a matrix that is not positive definite
    gives NaNs. CUDA tensors launch the kernel (``block`` only sets the
    contract there: the kernel's tiles are 64 x 64); CPU tensors run
    :func:`cholesky_plain` with ``block``.
    """
    n = K.shape[-1]
    if tuple(K.shape) != (n, n):
        raise ValueError(f"square matrix expected, got {tuple(K.shape)}")
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    if K.dtype != torch.float32:
        raise ValueError("cholesky_cuda is f32-only; use torch.linalg.cholesky for f64")
    if K.device.type == "cpu":
        return cholesky_plain(K, block)
    return _cuda.CHOLESKY(K.contiguous())
