"""Exact Gaussian-process regression for flux closures.

Port of ``climateparameterizations_jl_tpu/closures/gp.py`` (reference
``src/GaussianProcesses/``: ``kernels.jl``, ``distances.jl``,
``gaussian_process.jl``, ``GaussianProcesses.jl``). Every distance is a
pairwise matrix from one feature transform and a Gram-trick matmul; a fit
is one Cholesky; prediction for a batch of states is one matmul.

Two Gram backends, as the JAX package's ``"xla"`` and ``"pallas"``:

- ``"plain"``: torch ops in any dtype (the f64 default), differentiable by
  autograd.
- ``"cuda"``: the hand-written fused kernel ``csrc/gram.cu`` through
  ``ops/gram.py::gram_cuda_diff`` (f32, analytic backward). On CPU tensors
  it runs the kernel's plain version.

Factorizations use ``torch.linalg.cholesky_ex``. Where it reports a matrix
that is not positive definite, the factor is filled with NaN, as JAX's
``cholesky`` returns NaNs: a failed grid point then loses the argmin of
:func:`select_best_kernel` instead of raising.

Constructors (:func:`get_kernel`, :func:`default_spectral_mixture`,
``SpectralMixtureKernel.from_hyperparameters``) put their tensors on the
card unless the caller passes ``device``; the fitting functions work on the
device of their inputs.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from functools import partial

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.ops.gram import _sq_distances, gram_cuda_diff

BACKENDS = ("plain", "cuda")

# ---------------------------------------------------------------------------
# Distances (feature transforms + pairwise l2)
# ---------------------------------------------------------------------------


def _derivative_features(X, z):
    """H^1 transform: first differences over dz (``distances.jl:3,36``)."""
    dz = torch.diff(torch.as_tensor(z, dtype=X.dtype, device=X.device))
    return torch.diff(X, dim=-1) / dz


def _antiderivative_features(X, z):
    """H^-1 transform: first differences times dz (``distances.jl:45``)."""
    dz = torch.diff(torch.as_tensor(z, dtype=X.dtype, device=X.device))
    return torch.diff(X, dim=-1) * dz


_DISTANCE_TRANSFORMS = {
    "euclidean": lambda X, z: X,
    "derivative": _derivative_features,
    "antiderivative": _antiderivative_features,
}


def pairwise_sq_distances(A, B):
    """``(m, n)`` squared l2 distances via the Gram trick (one matmul)."""
    return _sq_distances(A, B)[0]


def distance_matrix(A, B, z, metric: str = "euclidean"):
    """Pairwise distances after the metric's feature transform."""
    tf = _DISTANCE_TRANSFORMS[metric]
    return torch.sqrt(pairwise_sq_distances(tf(A, z), tf(B, z)))


def _promoted(*tensors):
    """The tensors cast to their common dtype (JAX's promotion of 0-d operands)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return tuple(t.to(dtype) for t in tensors)


def _mm(a, b):
    a, b = _promoted(a, b)
    return a @ b


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GPKernel:
    """Stationary kernel: family + (sigma, gamma, alpha) + distance metric + Gram backend.

    Families (ids of the reference's ``get_kernel``, ``GaussianProcesses.jl:125-143``):
      1 squared_exponential: ``sigma * exp(-d^2 / 2 gamma^2)``
      2 matern12:            ``sigma * exp(-d / gamma)``
      3 matern32:            ``sigma * (1 + c) exp(-c)``, ``c = sqrt(3) d / gamma``
      4 matern52:            ``sigma * (1 + c + h) exp(-c)``, ``c = sqrt(5) d / gamma``,
                             ``h = 5 d^2 / (3 gamma^2)``
      5 rational_quadratic:  ``sigma * (1 + d^2 / (2 alpha gamma^2))^-alpha``

    ``backend`` is ``"plain"`` (torch ops, any dtype) or ``"cuda"`` (the
    fused Gram kernel, f32, analytic backward).
    """

    gamma: torch.Tensor
    sigma: torch.Tensor
    alpha: torch.Tensor
    family: str = "squared_exponential"
    metric: str = "euclidean"
    backend: str = "plain"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown Gram backend {self.backend!r}; expected one of {BACKENDS}")

    def __call__(self, d):
        d, g, s, a = _promoted(torch.as_tensor(d), self.gamma, self.sigma, self.alpha)
        if self.family == "squared_exponential":
            return s * torch.exp(-(d**2) / (2.0 * g**2))
        if self.family == "matern12":
            return s * torch.exp(-d / g)
        if self.family == "matern32":
            c = math.sqrt(3.0) * d / g
            return s * (1.0 + c) * torch.exp(-c)
        if self.family == "matern52":
            c = math.sqrt(5.0) * d / g
            h = 5.0 * d**2 / (3.0 * g**2)
            return s * (1.0 + c + h) * torch.exp(-c)
        if self.family == "rational_quadratic":
            return s * (1.0 + d**2 / (2.0 * a * g**2)) ** (-a)
        raise ValueError(f"unknown kernel family {self.family!r}")

    def gram(self, A, B, z):
        """Kernel matrix from feature matrices ``(n, D) x (m, D) -> (n, m)``."""
        if self.backend == "cuda":
            tf = _DISTANCE_TRANSFORMS[self.metric]
            return gram_cuda_diff(self.family, tf(A, z), tf(B, z), self.gamma, self.sigma, self.alpha)
        return self(distance_matrix(A, B, z, self.metric))

    def self_variance(self, x):
        """``k(x, x)`` for each row (prior variance), shape ``(m,)``."""
        return self(torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device))


@dataclasses.dataclass(frozen=True)
class SpectralMixtureKernel:
    """Spectral-mixture-product kernel (GPML ``covSM``; reference ``kernels.jl:133-204``).

    ``K(a, b) = prod_d sum_q w_q^2 exp(-0.5 (2 pi tau_d)^2 gamma_dq) cos(2 pi tau_d mu_dq)``
    with ``tau = a - b``. Isotropic form: ``(Q,)`` hyperparameter rows shared
    across dimensions; ARD form: ``(D, Q)``. The product over feature
    dimensions is a loop carrying the ``(n, m)`` Gram slab, never the
    ``(n, m, D, Q)`` tensor. Plain torch ops only (no kernel backend).
    """

    w: torch.Tensor
    mu: torch.Tensor
    gamma: torch.Tensor
    metric: str = "euclidean"

    @classmethod
    def from_hyperparameters(cls, hyp, D: int | None = None, dtype=torch.float64, device=None):
        """Reference constructors: flat ``3Q`` vector (isotropic) or ``3DQ`` (ARD)."""
        hyp = torch.as_tensor(hyp, dtype=dtype, device=resolve_device(device))
        if D is None:
            Q = hyp.shape[0] // 3
            if 3 * Q != hyp.shape[0]:
                raise ValueError("isotropic SM kernel needs a length-3Q hyperparameter vector")
            return cls(w=hyp[:Q], mu=hyp[Q:2 * Q], gamma=hyp[2 * Q:])
        Q = hyp.shape[0] // (3 * D)
        if Q == 0 or 3 * D * Q != hyp.shape[0]:
            raise ValueError(
                f"ARD SM kernel with D={D} needs a length-3*D*Q hyperparameter vector, got {hyp.shape[0]}"
            )

        def r(a):  # Julia's column-major reshape to (D, Q)
            return a.reshape(Q, D).T

        return cls(w=r(hyp[:D * Q]), mu=r(hyp[D * Q:2 * D * Q]), gamma=r(hyp[2 * D * Q:]))

    def _per_dim(self, tau, w, mu, gamma):
        """``sum_q w_q^2 h((2 pi tau)^2 gamma_q, 2 pi tau mu_q)`` on an ``(n, m)`` slab."""
        t = 2.0 * math.pi * tau[..., None]
        return torch.sum((w**2) * torch.exp(-0.5 * t**2 * gamma) * torch.cos(t * mu), dim=-1)

    def _rows(self, D: int):
        return tuple(p.expand(D, *p.shape) if p.dim() == 1 else p for p in (self.w, self.mu, self.gamma))

    def gram(self, A, B, z=None):
        if self.metric != "euclidean":
            if z is None:
                raise ValueError(f"metric {self.metric!r} needs the grid z")
            tf = _DISTANCE_TRANSFORMS[self.metric]
            A, B = tf(A, z), tf(B, z)
        D = A.shape[-1]
        w, mu, gamma = self._rows(D)
        K = torch.ones((A.shape[0], B.shape[0]), dtype=A.dtype, device=A.device)
        for d in range(D):
            K = K * self._per_dim(A[:, d, None] - B[None, :, d], w[d], mu[d], gamma[d])
        return K

    def __call__(self, d):
        raise TypeError("SpectralMixtureKernel is not distance-based; use .gram(A, B)")

    def self_variance(self, x):
        w = self._rows(x.shape[-1])[0]
        return torch.prod(torch.sum(w**2, dim=-1)).expand(x.shape[0]).to(x.dtype)


_FAMILY_IDS = {1: "squared_exponential", 2: "matern12", 3: "matern32", 4: "matern52", 5: "rational_quadratic"}

#: Components used when the grid search parameterizes a spectral-mixture
#: kernel by a single length scale (see :func:`default_spectral_mixture`).
SM_DEFAULT_Q = 3


def default_spectral_mixture(length_scale, Q: int = SM_DEFAULT_Q, metric: str = "euclidean", dtype=torch.float64,
                             device=None) -> SpectralMixtureKernel:
    """Isotropic Q-component SM kernel parameterized by ONE length scale.

    The q = 0 component is a squared exponential of that length scale (its
    spectral density is a zero-mean Gaussian of std ``1 / (2 pi l)``);
    higher components add harmonics at multiples of that std. This gives
    the grid search a 1-D axis for kernel id 6.
    """
    ls = torch.as_tensor(length_scale, dtype=dtype, device=resolve_device(device))
    sd = 1.0 / (2.0 * math.pi * ls)
    w = torch.full((Q,), 1.0 / math.sqrt(Q), dtype=dtype, device=ls.device)
    mu = torch.arange(Q, dtype=dtype, device=ls.device) * sd
    gamma = (sd**2).expand(Q).clone()
    return SpectralMixtureKernel(w=w, mu=mu, gamma=gamma, metric=metric)


def get_kernel(kernel_id: int, log_gamma, log_sigma: float = 0.0, metric: str = "euclidean", alpha: float = 1.0,
               dtype=torch.float64, backend: str = "plain", device=None):
    """Factory with the reference's ``10^x`` hyperparameter transform.

    Ids 1-5 build a :class:`GPKernel`. Id 6 builds a
    :class:`SpectralMixtureKernel`: a length-``3Q`` vector passes through
    untransformed; a scalar is the log10 length scale of
    :func:`default_spectral_mixture`.
    """
    device = resolve_device(device)
    if kernel_id == 6:
        hyp = torch.as_tensor(log_gamma, dtype=dtype, device=device)
        if hyp.dim() == 0:
            return default_spectral_mixture(10.0**hyp, metric=metric, dtype=dtype, device=device)
        sm = SpectralMixtureKernel.from_hyperparameters(hyp, dtype=dtype, device=device)
        return dataclasses.replace(sm, metric=metric)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    return GPKernel(gamma=t(10.0**log_gamma), sigma=t(10.0**log_sigma), alpha=t(alpha),
                    family=_FAMILY_IDS[kernel_id], metric=metric, backend=backend)


# ---------------------------------------------------------------------------
# Exact GP
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GPModel:
    """Fitted exact GP: training inputs, Cholesky factor and weights.

    ``x_train (n, D_in)``; ``alpha (n, D_out)``; ``chol``: lower Cholesky
    factor of the jittered kernel matrix; ``z``: grid for the distance
    transforms.
    """

    kernel: GPKernel | SpectralMixtureKernel
    x_train: torch.Tensor
    z: torch.Tensor | None
    alpha: torch.Tensor
    chol: torch.Tensor


_NUMPY_FLOATS = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}


def default_jitter(dtype) -> float:
    """``sqrt(eps)`` of ``dtype``, as numpy computes it in that dtype (the JAX package's value)."""
    return float(np.sqrt(np.finfo(_NUMPY_FLOATS[dtype]).eps))


def _cholesky(K):
    """Lower factor of (a batch of) SPD matrices; a NaN lower triangle where the factorization failed."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None], float("nan"), L).tril()


def _cho_solve(chol, y):
    """``K^{-1} y`` from the lower factor; ``y`` is ``(n,)`` or ``(n, k)``, ``chol`` may be batched."""
    chol, y = _promoted(chol, y)
    rhs = y[:, None] if y.dim() == 1 else y
    out = torch.cholesky_solve(rhs.expand(*chol.shape[:-2], *rhs.shape), chol)
    return out[..., 0] if y.dim() == 1 else out


def _jittered(K, jitter_scale):
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + torch.amax(K, dim=(-2, -1), keepdim=True) * jitter_scale * eye


def gp_fit(x_train, y_train, kernel, z, jitter_scale: float | None = None) -> GPModel:
    """Fit the posterior weights (robust Cholesky; ``gaussian_process.jl:48-82``).

    The jitter is ``max(K) * jitter_scale`` on the diagonal, with the
    dtype-aware default ``sqrt(eps)`` of the Gram's dtype.
    """
    x_train = torch.as_tensor(x_train)
    y_train = torch.as_tensor(y_train, device=x_train.device)
    K = kernel.gram(x_train, x_train, z)
    if jitter_scale is None:
        jitter_scale = default_jitter(K.dtype)
    chol = _cholesky(_jittered(K, jitter_scale))
    alpha = _cho_solve(chol, y_train)
    return GPModel(kernel=kernel, x_train=x_train, z=None if z is None else torch.as_tensor(z),
                   alpha=alpha, chol=chol)


def gp_fit_multi(x_train, y_trains, kernels, z, jitter_scale: float | None = None) -> list:
    """Fit several exact GPs that share the SAME predictors with as few factorizations as possible.

    - Plain-backend :class:`GPKernel` s of one (family, metric) share one
      distance matrix; equal hyperparameters share one factorization with
      their targets stacked, and distinct ones factorize as one batched
      Cholesky.
    - Anything else (kernel backend, spectral mixture) is fitted alone with
      :func:`gp_fit`, as in the JAX package.

    Every returned model holds the same ``x_train`` and ``z`` objects, which
    ``models/gp_closure.py`` relies on to build one Gram for all three
    fluxes. Returns a list of :class:`GPModel`, index-aligned with
    ``y_trains``.
    """
    x_train = torch.as_tensor(x_train)
    z = None if z is None else torch.as_tensor(z, device=x_train.device)
    ys_orig = [torch.as_tensor(y, device=x_train.device) for y in y_trains]
    was_1d = [y.dim() == 1 for y in ys_orig]
    ys = [y[:, None] if y.dim() == 1 else y for y in ys_orig]
    if len(ys) != len(kernels):
        raise ValueError(f"{len(ys)} target sets for {len(kernels)} kernels")
    out: list = [None] * len(ys)

    groups: dict = {}
    for i, k in enumerate(kernels):
        if isinstance(k, GPKernel) and k.backend == "plain":
            groups.setdefault((k.family, k.metric), []).append(i)
        else:
            out[i] = gp_fit(x_train, ys_orig[i], k, z, jitter_scale)

    for (family, metric), idxs in groups.items():
        d = distance_matrix(x_train, x_train, z, metric)
        unique: dict = {}
        for i in idxs:
            k = kernels[i]
            unique.setdefault((float(k.gamma), float(k.sigma), float(k.alpha)), []).append(i)
        members = list(unique.values())
        batch = GPKernel(
            gamma=torch.stack([kernels[m[0]].gamma for m in members])[:, None, None],
            sigma=torch.stack([kernels[m[0]].sigma for m in members])[:, None, None],
            alpha=torch.stack([kernels[m[0]].alpha for m in members])[:, None, None],
            family=family, metric=metric,
        )
        K = batch(d)
        chols = _cholesky(_jittered(K, default_jitter(K.dtype) if jitter_scale is None else jitter_scale))
        for j, member_idxs in enumerate(members):
            alpha_cat = _cho_solve(chols[j], torch.cat([ys[i] for i in member_idxs], dim=-1))
            offset = 0
            for i in member_idxs:
                alpha = alpha_cat[:, offset:offset + ys[i].shape[-1]]
                out[i] = GPModel(kernel=kernels[i], x_train=x_train, z=z,
                                 alpha=alpha[:, 0] if was_1d[i] else alpha, chol=chols[j])
                offset += ys[i].shape[-1]
    return out


def _atleast_2d(x):
    x = torch.as_tensor(x)
    return x.reshape(1, -1) if x.dim() < 2 else x


def gp_predict(model: GPModel, x):
    """Mean prediction for a batch ``(m, D_in) -> (m, D_out)`` (one matmul; ``gaussian_process.jl:112-117``)."""
    x = _atleast_2d(x)
    return _mm(model.kernel.gram(x, model.x_train, model.z), model.alpha)


def gp_uncertainty(model: GPModel, x):
    """Posterior variance at each query point (``gaussian_process.jl:130-139``)."""
    x = _atleast_2d(x)
    kx = model.kernel.gram(x, model.x_train, model.z)  # (m, n)
    v = _cho_solve(model.chol, kx.T)  # (n, m)
    prior, kxT, v = _promoted(model.kernel.self_variance(x), kx.T, v)
    return prior - torch.sum(kxT * v, dim=0)


def mean_log_marginal_loss(model: GPModel, y_train, add_constant: bool = False):
    """Mean (over output dims) NEGATIVE log marginal likelihood, a loss to minimize.

    ``0.5 y^T K^-1 y`` per output dim, plus the logdet and ``2 pi`` constants
    when ``add_constant`` (``gaussian_process.jl:182-202``).
    """
    y = torch.as_tensor(y_train, device=model.alpha.device)
    if y.dim() == 1:
        y = y[:, None]
    n, D = y.shape
    alpha = model.alpha if model.alpha.dim() == 2 else model.alpha[:, None]
    total = 0.5 * torch.sum(y * alpha) / D
    if add_constant:
        total = total + torch.sum(torch.log(torch.diagonal(model.chol))) + 0.5 * n * math.log(2.0 * math.pi)
    return total


def _is_numeric(v) -> bool:
    if isinstance(v, (bool, str)) or v is None or isinstance(v, torch.Tensor):
        return False
    try:
        return np.issubdtype(np.asarray(v).dtype, np.number)
    except (TypeError, ValueError):
        return False


def optimize_kernel_hyperparameters(x_train, y_train, kernel, z, iters: int = 100, learning_rate: float = 0.05):
    """Type-II maximum likelihood: adam on the mean negative log marginal likelihood.

    Every hyperparameter (``gamma, sigma, alpha`` of a :class:`GPKernel`, or
    the ``w, mu, gamma`` mixture of a :class:`SpectralMixtureKernel`) moves
    under gradients through the Cholesky factorization; positive ones in
    log space. Both Gram backends work: ``"plain"`` by autograd and
    ``"cuda"`` through the kernel's analytic backward (f32). The optimizer
    is ``torch.optim.Adam`` with optax's defaults (``b1=0.9, b2=0.999,
    eps=1e-8``), whose update is ``optax.adam``'s.

    Returns ``(kernel, losses)``: the fitted hyperparameters and the loss
    before each of the ``iters`` updates.
    """
    x_train = torch.as_tensor(x_train)
    y_train = torch.as_tensor(y_train, device=x_train.device)
    positive = {"gamma", "sigma", "alpha"} if isinstance(kernel, GPKernel) else {"gamma"}
    # Python and numpy scalars become tensors first, or they would be
    # skipped and nothing would be optimized.
    kernel = dataclasses.replace(kernel, **{
        f.name: torch.as_tensor(np.asarray(getattr(kernel, f.name), np.float64), device=x_train.device)
        for f in dataclasses.fields(kernel) if _is_numeric(getattr(kernel, f.name))
    })
    fields = [f.name for f in dataclasses.fields(kernel) if isinstance(getattr(kernel, f.name), torch.Tensor)]
    if not fields:
        raise ValueError("optimize_kernel_hyperparameters: kernel exposes no numeric hyperparameters")

    raw = {}
    for name in fields:
        v = getattr(kernel, name).detach()
        raw[name] = (torch.log(v) if name in positive else v.clone()).requires_grad_(True)

    def from_raw():
        return dataclasses.replace(kernel, **{n: (torch.exp(v) if n in positive else v) for n, v in raw.items()})

    optimizer = torch.optim.Adam(list(raw.values()), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(iters):
        optimizer.zero_grad(set_to_none=True)
        # add_constant=True: the logdet term penalizes overfit length scales.
        loss = mean_log_marginal_loss(gp_fit(x_train, y_train, from_raw(), z), y_train, add_constant=True)
        loss.backward()
        optimizer.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        fitted = from_raw()
    return dataclasses.replace(fitted, **{n: getattr(fitted, n).detach() for n in fields}), losses


# ---------------------------------------------------------------------------
# Model selection (grid search)
# ---------------------------------------------------------------------------


def gp_flux_model(x_train, y_train, z, kernel: GPKernel):
    """The reference's ``gp_model`` (``GaussianProcesses.jl:77-101``): fit, and a predict function."""
    model = gp_fit(x_train, y_train, kernel, z)
    return model, partial(gp_predict, model)


def error_per_gamma(x_train, y_train, x_val, y_val, z, kernel_id: int, log_gammas, metric: str = "euclidean",
                    log_sigma: float = 0.0):
    """Held-out MSE for each log gamma (``GaussianProcesses.jl:60-74``).

    For kernel ids 1-5 the whole grid is one batch: the distance matrices
    are built once, then every gamma's Gram, jitter, Cholesky, solve and
    validation MSE run along a leading grid axis (the JAX package's vmap).
    f32 inputs on the card loop over the grid instead: each gamma's two
    Grams (training and validation) on the Gram kernel, two launches per
    grid point, then its own factorization, so a gamma's error does not
    depend on how many gammas share a batch (the card's batched linear
    algebra rounds by the batch's size: ``chip_smoke.py`` phase 43 at world
    4, where each rank fits 2 of the 8 gammas). CPU inputs, and f64 ones
    that the f32 kernel would round, take the plain version. The spectral
    mixture (id 6) has no distance form and loops over the grid. A grid
    point whose factorization fails scores NaN.
    """
    x_train = torch.as_tensor(x_train)
    dev = x_train.device
    y_train, x_val, y_val = (torch.as_tensor(a, device=dev) for a in (y_train, x_val, y_val))
    z = None if z is None else torch.as_tensor(z, device=dev)
    dtype = x_train.dtype
    log_gammas = torch.as_tensor(np.asarray(log_gammas), dtype=dtype, device=dev)
    if kernel_id == 6:
        errs = []
        for lg in log_gammas:
            kernel = default_spectral_mixture(10.0**lg, metric=metric, dtype=dtype, device=dev)
            pred = gp_predict(gp_fit(x_train, y_train, kernel, z), x_val)
            errs.append(torch.mean((pred - y_val) ** 2))
        return [float(e) for e in torch.stack(errs).tolist()]
    sigma = torch.as_tensor(10.0**log_sigma, dtype=dtype, device=dev)
    alpha = torch.as_tensor(1.0, dtype=dtype, device=dev)
    if dev.type == "cuda" and dtype == torch.float32:
        errs = []
        for lg in log_gammas:
            kernel = GPKernel(gamma=10.0**lg, sigma=sigma, alpha=alpha, family=_FAMILY_IDS[kernel_id], metric=metric,
                              backend="cuda")
            K = kernel.gram(x_train, x_train, z)
            pred = _mm(kernel.gram(x_val, x_train, z), _cho_solve(_cholesky(_jittered(K, default_jitter(K.dtype))),
                                                                   y_train))
            errs.append(torch.mean((pred - y_val) ** 2))
        return [float(e) for e in torch.stack(errs).tolist()]
    kernel = GPKernel(gamma=(10.0**log_gammas)[:, None, None], sigma=sigma, alpha=alpha,
                      family=_FAMILY_IDS[kernel_id], metric=metric)
    K = kernel(distance_matrix(x_train, x_train, z, metric))  # (G, n, n)
    alpha = _cho_solve(_cholesky(_jittered(K, default_jitter(K.dtype))), y_train)
    pred = _mm(kernel(distance_matrix(x_val, x_train, z, metric)), alpha)
    err = (pred - y_val) ** 2
    return [float(e) for e in torch.mean(err.reshape(err.shape[0], -1), dim=1).tolist()]


def select_best_kernel(errors_by_kid: dict, log_gammas, metric: str, log_sigma: float, dtype, device=None):
    """Pick the (family, gamma) minimizing held-out error across a grid.

    ``errors_by_kid``: ``{kernel_id: sequence of errors per log_gamma}``.
    NaN points never win the argmin; raises if every point is non-finite.
    """
    best = (None, float("inf"))
    for kid, errs in errors_by_kid.items():
        errs = np.where(np.isfinite(errs), np.asarray(errs, float), np.inf)
        i = int(np.argmin(errs))
        if errs[i] < best[1]:
            kernel = get_kernel(kid, float(log_gammas[i]), log_sigma, metric, dtype=dtype, device=device)
            best = (kernel, float(errs[i]))
    if best[0] is None:
        raise ValueError("kernel grid search failed: every (family, gamma) point had non-finite error")
    return best


def best_kernel(x_train, y_train, x_val, y_val, z, kernel_ids=(1, 2, 3, 4), log_gammas=None,
                metric: str = "euclidean", log_sigma: float = 0.0):
    """Grid search over kernel families x log gamma (``GaussianProcesses.jl:30-49``).

    Returns ``(kernel, mse)`` minimizing held-out MSE, on the device of ``x_train``.
    """
    x_train = torch.as_tensor(x_train)
    if log_gammas is None:
        log_gammas = np.linspace(-1.5, 1.5, 10)
    errors = {
        kid: error_per_gamma(x_train, y_train, x_val, y_val, z, kid, log_gammas, metric, log_sigma)
        for kid in kernel_ids
    }
    return select_best_kernel(errors, log_gammas, metric, log_sigma, x_train.dtype, device=x_train.device)
