"""Orthogonal-basis decomposition of profiles (Fourier / Legendre / Chebyshev).

Port of the JAX package's ``utils/polynomial.py`` (reference
``src/polynomial_decomposition.jl:6-65``): project a function sampled on a
grid onto the first ``n`` elements of an orthogonal basis by weighted
trapezoidal quadrature, and reconstruct. The projection is one
``(n_basis, n_points) @ (n_points,)`` product for all coefficients.
Inputs may be numpy arrays or tensors; results are tensors of the inputs'
floating dtype (float64 for numpy input).
"""

from __future__ import annotations

import math

import torch


def _as_tensor(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _trapezoid_weights(x):
    x = _as_tensor(x)
    dx = torch.diff(x)
    w = torch.zeros_like(x)
    w[:-1] += 0.5 * dx
    w[1:] += 0.5 * dx
    return w


def _mapped(x, domain) -> torch.Tensor:
    a, b = domain
    return torch.clamp(2.0 * (_as_tensor(x) - a) / (b - a) - 1.0, -1.0, 1.0)


def basis_functions(kind: str, n: int, x, domain=(-1.0, 1.0)):
    """Values of the first ``n`` basis functions at points ``x``: ``(n, len(x))``.

    ``kind``: ``"fourier"`` (1, cos kt, sin kt on the mapped angle t in
    [0, 2 pi], the full period, so the family is orthogonal), ``"legendre"``
    (three-term recurrence), or ``"chebyshev"`` (cos(k arccos)). ``x`` is
    mapped affinely from ``domain`` to [-1, 1].
    """
    xh = _mapped(x, domain)
    if kind == "chebyshev":
        k = torch.arange(n, dtype=xh.dtype, device=xh.device)[:, None]
        return torch.cos(k * torch.arccos(xh)[None, :])
    if kind == "fourier":
        rows = [torch.ones_like(xh)]
        t = math.pi * (xh + 1.0)
        k = 1
        while len(rows) < n:
            rows.append(torch.cos(k * t))
            if len(rows) < n:
                rows.append(torch.sin(k * t))
            k += 1
        return torch.stack(rows[:n])
    if kind == "legendre":
        rows = [torch.ones_like(xh), xh]
        for k in range(1, n - 1):
            rows.append(((2 * k + 1) * xh * rows[k] - k * rows[k - 1]) / (k + 1))
        return torch.stack(rows[:n])
    raise ValueError(f"unknown basis kind {kind!r}")


def _quadrature_weights(kind: str, x, domain):
    """Quadrature weights with the basis' orthogonality weight.

    The Chebyshev weight ``1/sqrt(1-x^2)`` is singular at the ends, so that
    integral is taken in ``theta = arccos(x)``, where the weight is flat.
    """
    xh = _mapped(x, domain)
    if kind == "chebyshev":
        return torch.abs(_trapezoid_weights(torch.arccos(xh)))
    return _trapezoid_weights(xh)


def _domain(x: torch.Tensor, domain):
    return domain if domain is not None else (float(x[0]), float(x[-1]))


def polynomial_decomposition(f_values, x, kind: str = "legendre", n: int = 8, domain=None):
    """Project samples ``f(x)`` onto the first ``n`` basis functions.

    Returns coefficients ``(n,)`` such that ``coeffs @ basis`` approximates
    ``f``: the weighted trapezoidal quadrature of ``f * phi_k * w``
    normalized by that of ``phi_k^2 w``.
    """
    x = _as_tensor(x)
    domain = _domain(x, domain)
    phi = basis_functions(kind, n, x, domain)  # (n, P)
    wq = _quadrature_weights(kind, x, domain)  # (P,)
    num = phi @ (wq * torch.as_tensor(f_values, dtype=x.dtype, device=x.device))
    den = (phi * phi) @ wq
    return num / den


def reconstruct(coeffs, x, kind: str = "legendre", domain=None):
    """Evaluate the truncated expansion at points ``x``."""
    x = _as_tensor(x)
    coeffs = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
    phi = basis_functions(kind, coeffs.shape[0], x, _domain(x, domain))
    return coeffs @ phi
