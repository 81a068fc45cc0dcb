"""Blocked exact-GP fit: the Gram, its Cholesky factor and the solves in (block x block) tiles.

Port of ``climateparameterizations_jl_tpu/ops/blocked_gp.py``. The fit of
``closures/gp.py::gp_fit`` decomposed into host-orchestrated tile ops: Gram
tiles built on demand (each consumed once), a right-looking blocked
Cholesky, and blocked triangular substitution:

    for j:  L[j][j]       = chol( K[j][j] - sum_{k<j} L[j][k] L[j][k]^T )
            L[i][j] (i>j) = ( K[i][j] - sum_{k<j} L[i][k] L[j][k]^T ) L[j][j]^{-T}

so the full Gram never sits beside its factor: peak memory is the lower
tiles of ``L`` (about ``4 n^2`` bytes in f64) plus one transient tile. The
JAX module exists because one f64 program over a 16,384^2 Gram did not
compile for the TPU; here it bounds the peak memory of an f64 fit at that
size. It has no kernel of its own: the tiles are the plain linear algebra
the JAX module also does outside any kernel (``torch.linalg.cholesky_ex``,
``solve_triangular``, matmuls), and the Gram tiles use ``closures/gp.py``'s
kernel functions in the fit's dtype (the f32 Gram kernel does not apply to
an f64 fit). The jitter is ``gp_fit``'s: ``max(K) * jitter_scale``.
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.closures.gp import GPModel, _cholesky, default_jitter


def _blocks(n: int, block: int) -> list:
    """Tile start offsets (the last tile may be smaller)."""
    return list(range(0, n, block))


def _chol_tile(A, jitter):
    return _cholesky(A + jitter * torch.eye(A.shape[0], dtype=A.dtype, device=A.device))


def _trsm_right(Aij, Ljj):  # Aij Ljj^{-T}, from Ljj X^T = Aij^T
    return torch.linalg.solve_triangular(Ljj, Aij.T, upper=False).T


def _fwd_tile(Ljj, B):  # Ljj^{-1} B
    return torch.linalg.solve_triangular(Ljj, B, upper=False)


def _bwd_tile(Ljj, B):  # Ljj^{-T} B
    return torch.linalg.solve_triangular(Ljj.T, B, upper=True)


def blocked_gram_cholesky(kernel, x, z, block: int = 4096, jitter_scale=None):
    """Lower Cholesky tiles of the jittered Gram of ``x``; returns ``(tiles, jitter)``.

    ``tiles[(i, j)]`` (``j <= i``) are the blocks of ``L`` with
    ``L L^T = K + jitter I``; the jitter comes from the tiles' maxima before
    any factorization (the Gram tiles are built again on demand after).
    """
    x = torch.as_tensor(x)
    starts = _blocks(x.shape[0], block)
    nb = len(starts)
    xs = [x[s: s + block] for s in starts]
    if jitter_scale is None:
        jitter_scale = default_jitter(x.dtype)

    kmax = None
    for i in range(nb):
        for j in range(i + 1):
            m = torch.max(kernel.gram(xs[i], xs[j], z))
            kmax = m if kmax is None else torch.maximum(kmax, m)
    jitter = kmax * jitter_scale

    tiles: dict = {}
    for j in range(nb):
        Ajj = kernel.gram(xs[j], xs[j], z)
        for k in range(j):
            Ajj = Ajj - tiles[(j, k)] @ tiles[(j, k)].T
        tiles[(j, j)] = _chol_tile(Ajj, jitter)
        for i in range(j + 1, nb):
            Aij = kernel.gram(xs[i], xs[j], z)
            for k in range(j):
                Aij = Aij - tiles[(i, k)] @ tiles[(j, k)].T
            tiles[(i, j)] = _trsm_right(Aij, tiles[(j, j)])
    return tiles, jitter


def _cho_solve_blocks(tiles: dict, bs: list) -> list:
    """``(L L^T)^{-1} B`` on row blocks ``(b_j, D)``: blocked forward, then backward substitution."""
    nb = len(bs)
    ys = []
    for j in range(nb):  # L y = B
        rhs = bs[j]
        for k in range(j):
            rhs = rhs - tiles[(j, k)] @ ys[k]
        ys.append(_fwd_tile(tiles[(j, j)], rhs))
    xs: list = [None] * nb
    for j in reversed(range(nb)):  # L^T x = y
        rhs = ys[j]
        for i in range(j + 1, nb):
            rhs = rhs - tiles[(i, j)].T @ xs[i]
        xs[j] = _bwd_tile(tiles[(j, j)], rhs)
    return xs


def blocked_cho_solve(tiles: dict, B, block: int = 4096):
    """``(L L^T)^{-1} B`` from Cholesky tiles; ``B`` is ``(n,)`` or ``(n, k)``."""
    B = torch.as_tensor(B)
    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    bs = [B[s: s + block] for s in _blocks(B.shape[0], block)]
    out = torch.cat(_cho_solve_blocks(tiles, bs), dim=0)
    return out[:, 0] if squeeze else out


def gp_fit_blocked(x_train, y_train, kernel, z, block: int = 4096, jitter_scale=None):
    """Exact-GP fit in tiles; returns ``(model, tiles)``.

    The math of ``closures.gp.gp_fit`` (jittered Gram, Cholesky, ``alpha =
    K^{-1} y``). ``model.chol`` is ``None``: the factor lives in ``tiles``
    (pass them to :func:`gp_uncertainty_blocked` / :func:`blocked_cho_solve`);
    assembling the ``(n, n)`` factor would undo the memory bound.
    """
    x_train = torch.as_tensor(x_train)
    y_train = torch.as_tensor(y_train, device=x_train.device)
    tiles, _ = blocked_gram_cholesky(kernel, x_train, z, block, jitter_scale)
    alpha = blocked_cho_solve(tiles, y_train, block)
    model = GPModel(kernel=kernel, x_train=x_train, z=None if z is None else torch.as_tensor(z), alpha=alpha,
                    chol=None)
    return model, tiles


def gp_uncertainty_blocked(model: GPModel, tiles: dict, x, block: int = 4096, query_chunk: int = 4096):
    """Posterior variance through the tiled factor: ``k(x, x) - sum(kx^T * (K^{-1} kx))``.

    ``gp_uncertainty`` parity (``gaussian_process.jl:130-139``): the train
    axis rides the factor's blocking and the queries go in chunks, so the
    cross-Gram and the solve stay tile-sized.
    """
    x = torch.as_tensor(x)
    x = x.reshape(1, -1) if x.dim() < 2 else x
    xt = model.x_train
    t_starts = _blocks(xt.shape[0], block)
    outs = []
    for s in range(0, x.shape[0], query_chunk):
        xq = x[s: s + query_chunk]
        rows = [model.kernel.gram(xt[ts: ts + block], xq, model.z) for ts in t_starts]  # (b_j, m) each
        vs = _cho_solve_blocks(tiles, rows)
        acc = model.kernel.self_variance(xq)
        for r, v in zip(rows, vs):
            acc = acc - torch.sum(r * v, dim=0)
        outs.append(acc)
    return torch.cat(outs, dim=0)
