"""Batched Thomas tridiagonal solve + backward-Euler vertical diffusion.

Port of ``climateparameterizations_jl_tpu/ops/tridiagonal.py``. Every
implicit diffusion step of the split stepper is one batched solve of
``N x N`` tridiagonal systems over arbitrary leading batch axes:

- ``scan``: the Thomas algorithm as two Python loops over the levels
  (:func:`_thomas_scan`); differentiable, any device.
- ``pcr``: parallel cyclic reduction (:func:`_thomas_pcr`), ``ceil(log2 N)``
  rounds of elementwise ops on shifted copies; differentiable, any device.
- ``cuda``: the hand-written kernel ``csrc/thomas.cu`` (the counterpart of
  the TPU kernel ``_thomas_pallas``), forward only: one thread per system
  runs the sweep of :func:`_thomas_scan` with its roundings, so on normal
  data it returns the same numbers. It takes CUDA tensors and raises for
  any other; its plain version is :func:`_thomas_scan`.

All functions take diagonals of shape ``(..., N)`` (``dl[..., 0]`` and
``du[..., N-1]`` ignored) and a right-hand side ``(..., N)``.
:func:`tridiagonal_solve` with ``implicit_grad=True`` differentiates by the
implicit function theorem: the backward pass is one transposed solve through
the same backend, which also makes the forward-only kernel trainable.
"""

from __future__ import annotations

import math

import torch

from climateparameterizations_jl_tpu_torch.ops import _cuda


def _thomas_scan(dl, d, du, b, unroll: int = 1):
    """Thomas algorithm over the last axis (batch = leading axes).

    Forward elimination into ``cp``/``dp``, then back-substitution, one level
    at a time. ``unroll`` is the JAX package's scan knob; it does not change
    the result.
    """
    del unroll
    n = b.shape[-1]
    cp_prev = torch.zeros_like(b[..., 0])
    dp_prev = torch.zeros_like(b[..., 0])
    cps, dps = [], []
    for i in range(n):
        denom = d[..., i] - dl[..., i] * cp_prev
        cp_prev = du[..., i] / denom
        dp_prev = (b[..., i] - dl[..., i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(b[..., 0])
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def _shift(x, s: int, fill: float):
    """``x[..., i - s]`` (``s > 0``) or ``x[..., i + |s|]`` (``s < 0``), ``fill`` outside."""
    n = x.shape[-1]
    if s > 0:
        return torch.nn.functional.pad(x, (s, 0), value=fill)[..., :n]
    return torch.nn.functional.pad(x, (0, -s), value=fill)[..., -n:]


def _thomas_pcr(dl, d, du, b):
    """Parallel cyclic reduction over the last axis.

    ``ceil(log2 N)`` elimination rounds, each a handful of elementwise ops on
    shifted copies of the diagonals. Safe for the diagonally dominant
    ``I + dt D`` systems of this repo.
    """
    n = b.shape[-1]
    a = torch.cat([torch.zeros_like(dl[..., :1]), dl[..., 1:]], dim=-1)
    c = torch.cat([du[..., :-1], torch.zeros_like(du[..., :1])], dim=-1)
    m, r = d, b
    for k in range(max(1, math.ceil(math.log2(n)))):
        s = 1 << k
        m_m, m_p = _shift(m, s, 1.0), _shift(m, -s, 1.0)
        a_m, a_p = _shift(a, s, 0.0), _shift(a, -s, 0.0)
        c_m, c_p = _shift(c, s, 0.0), _shift(c, -s, 0.0)
        r_m, r_p = _shift(r, s, 0.0), _shift(r, -s, 0.0)
        alpha = -a / m_m  # rows with i - s out of range have a == 0 already
        gamma = -c / m_p
        m = m + alpha * c_m + gamma * a_p
        r = r + alpha * r_m + gamma * r_p
        a = alpha * a_m
        c = gamma * c_p
    return r / m


def _thomas_cuda(dl, d, du, b):
    """The CUDA kernel on inputs ``(..., N)``: flattened to contiguous f32 ``(B, N)``.

    Half inputs are upcast and the result cast back; f64 raises, as the TPU
    kernel does (the kernel's scratch is f32). CUDA tensors launch the
    kernel (or raise); CPU tensors run its plain version, :func:`_thomas_scan`,
    on the same f32 inputs.
    """
    orig_dtype = b.dtype
    if orig_dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise ValueError(f"the cuda tridiagonal backend is f32-only (got {orig_dtype}); use backend='scan'")
    batch_shape, n = b.shape[:-1], b.shape[-1]
    flat = [a.reshape(-1, n).to(torch.float32).contiguous() for a in (dl, d, du, b)]
    if b.device.type == "cpu":
        x = _thomas_scan(*flat)
    else:
        x = _cuda.THOMAS(*flat)
    return x.reshape(*batch_shape, n).to(orig_dtype)


def _raw_solve(dl, d, du, b, backend: str, unroll: int):
    if backend == "scan":
        return _thomas_scan(dl, d, du, b, unroll)
    if backend == "pcr":
        return _thomas_pcr(dl, d, du, b)
    if backend == "cuda":
        return _thomas_cuda(dl, d, du, b)
    raise ValueError(f"unknown tridiagonal backend: {backend!r}")


def _shift_down(x):
    """``x[k-1]``, zero at ``k = 0``."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0))


def _shift_up(x):
    """``x[k+1]``, zero at ``k = N-1``."""
    return torch.nn.functional.pad(x[..., 1:], (0, 1))


class _ImplicitSolve(torch.autograd.Function):
    """``x = A^{-1} b`` with the IFT backward: one solve with ``A^T``.

    Gradients: ``b_bar = lam`` with ``A^T lam = g``; the matvec
    ``A x = d x + dl x[k-1] + du x[k+1]`` gives ``d_bar = -lam x``,
    ``dl_bar[k] = -lam[k] x[k-1]`` and ``du_bar[k] = -lam[k] x[k+1]``, which
    are exactly zero on the ignored corners. ``A^T`` has sub-diagonal
    ``du[k-1]`` and super-diagonal ``dl[k+1]``.
    """

    @staticmethod
    def forward(ctx, dl, d, du, b, backend, unroll):
        x = _raw_solve(dl, d, du, b, backend, unroll)
        ctx.save_for_backward(dl, d, du, x)
        ctx.backend, ctx.unroll = backend, unroll
        return x

    @staticmethod
    def backward(ctx, g):
        dl, d, du, x = ctx.saved_tensors
        lam = _raw_solve(_shift_down(du), d, _shift_up(dl), g.contiguous(), ctx.backend, ctx.unroll)
        return -lam * _shift_down(x), -lam * x, -lam * _shift_up(x), lam, None, None


def tridiagonal_solve(dl, d, du, b, backend: str = "scan", unroll: int = 1, implicit_grad: bool = True):
    """Solve tridiagonal systems ``A x = b`` batched over leading axes.

    Args:
      dl: sub-diagonal ``(..., N)``; ``dl[..., 0]`` is ignored.
      d: main diagonal ``(..., N)``.
      du: super-diagonal ``(..., N)``; ``du[..., N-1]`` is ignored.
      b: right-hand side ``(..., N)``.
      backend: ``"scan"``, ``"pcr"`` (both differentiable, any device) or
        ``"cuda"`` (the hand-written kernel; CUDA tensors only, forward only).
      unroll: the JAX package's scan knob; no effect here.
      implicit_grad: differentiate by the implicit function theorem (one
        transposed solve through the same backend in the backward pass).
        ``False`` differentiates through the solver's own ops, which the
        ``"cuda"`` backend does not have, so it raises there.
    """
    dl, d, du, b = torch.broadcast_tensors(dl, d, du, b)
    if not implicit_grad:
        if backend == "cuda":
            raise ValueError("the cuda backend has no backward of its own; use implicit_grad=True")
        return _raw_solve(dl, d, du, b, backend, unroll)
    # The ignored corners must neither be read nor receive a cotangent:
    # zero them so A is exactly the matrix the solvers factor.
    dl = torch.cat([torch.zeros_like(dl[..., :1]), dl[..., 1:]], dim=-1)
    du = torch.cat([du[..., :-1], torch.zeros_like(du[..., :1])], dim=-1)
    return _ImplicitSolve.apply(dl, d, du, b, backend, unroll)


def implicit_diffusion_matrix(nu_face, dt, dz):
    """Backward-Euler diffusion matrix diagonals from face diffusivities ``(..., N+1)``.

    The reference's boundary handling, kept exactly (top face dropped from
    the last diagonal entry; ``NDE_oceananigans.jl:73-85``):

      ``lower[k] = -dt/dz^2 nu[k]`` (k = 1..N-1), ``upper[k] = -dt/dz^2 nu[k+1]``
      (k = 0..N-2), ``diag[k] = 1 + dt/dz^2 (nu[k] + nu[k+1])`` (k = 0..N-2),
      ``diag[N-1] = 1 + dt/dz^2 nu[N-1]``.

    Returns ``(dl, d, du)``, each ``(..., N)``.
    """
    r = dt / dz**2
    nu_below = nu_face[..., :-1]
    nu_above = nu_face[..., 1:]
    dl = -r * nu_below
    dl = torch.cat([torch.zeros_like(dl[..., :1]), dl[..., 1:]], dim=-1)
    du = -r * nu_above
    du = torch.cat([du[..., :-1], torch.zeros_like(du[..., :1])], dim=-1)
    d = 1.0 + r * (nu_below + nu_above)
    d = torch.cat([d[..., :-1], 1.0 + r * nu_below[..., -1:]], dim=-1)
    return dl, d, du


def implicit_diffusion_step(phi, nu_face, dt, dz, backend: str = "scan", zero_boundary_faces: bool = False,
                            unroll: int = 1, implicit_grad: bool = True):
    """One backward-Euler diffusion step ``(I - dt D(nu)) phi' = phi``.

    ``phi`` is ``(..., N)`` (centers), ``nu_face`` ``(..., N+1)`` (faces).
    The raw matrix keeps the reference's asymmetric boundary: a nonzero
    ``nu_face[0]`` leaks toward a zero ghost value while the top face is
    dropped. ``zero_boundary_faces=True`` zeroes both boundary faces first.
    """
    if zero_boundary_faces:
        mask = torch.ones(nu_face.shape[-1], dtype=nu_face.dtype, device=nu_face.device)
        mask[0] = 0.0
        mask[-1] = 0.0
        nu_face = nu_face * mask
    dl, d, du = implicit_diffusion_matrix(nu_face, dt, dz)
    return tridiagonal_solve(dl, d, du, phi, backend=backend, unroll=unroll, implicit_grad=implicit_grad)
