"""Ensemble Kalman Inversion for parameter calibration with uncertainty.

Port of ``climateparameterizations_jl_tpu/train/eki.py``. Perturbed-observation
EKI (Iglesias, Law & Stuart 2013): each iteration

    u_j <- u_j + C_ug (C_gg + s^2 I)^{-1} (y + eta_j - G(theta_j)),   eta_j ~ N(0, s^2 I),

in an unconstrained logit space mapped through a sigmoid onto the box
priors, so the update never leaves the box. The final ensemble spread is the
uncertainty estimate. The Kalman update uses the ensemble-subspace
(Woodbury) form, so only a ``(J, J)`` system is ever solved, however long the
observation vector:

    (C_gg + s^2 I_d)^{-1} = s^{-2} (I_d - G'^T B^{-1} G'),   B = (J - 1) s^2 I_J + G' G'^T,

with ``G'`` the centered ensemble predictions ``(J, d)``. That ``(J, J)``
solve is a library call on a tiny matrix (no TPU kernel computes it).

The JAX package vmaps a single-member forward map over the ensemble. Here
the forward map takes the whole ``(J, p)`` population and returns ``(J, d)``
(:func:`eki_calibrate`): the calibrations put the J parameter sets on the
solve's batch axis, so one forward evaluation is one solve. The noise is
drawn from an explicit ``torch.Generator``.

Over a mesh (``parallel/sharding.py::make_mesh``) each rank evaluates its
``J / N`` members and one ``all_gather`` per evaluation assembles ``g``;
every rank then runs the same Kalman update. The draws (the initial
ensemble and every ``eta``) are rank 0's, broadcast, so the ranks' updates
cannot drift apart whatever their generators hold.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class EKIResult:
    """Calibration output: constrained ensemble and summary statistics."""

    names: tuple
    ensemble: torch.Tensor  # (J, p) final constrained parameters
    theta_mean: torch.Tensor  # (p,)
    theta_std: torch.Tensor  # (p,) ensemble spread = UQ
    misfit_history: list  # mean data misfit per iteration


def _to_constrained(u, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(u)


def _to_unconstrained(theta, lo, hi):
    p = torch.clamp((theta - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def kalman_step(u, g, y, eta, noise_std):
    """The EKI step given the observation perturbations ``eta`` ``(J, d)``; returns the new ``(J, p)``.

    ``G' Z = (GR - G' G'^T W) / s^2 = (J - 1) W`` exactly (from ``B W =
    GR``): substituting it avoids the f32 cancellation of differencing two
    ``O(|g|^2)`` matrices and dividing by the tiny ``s^2``.
    """
    J = u.shape[0]
    s2 = noise_std**2
    u_c = u - torch.mean(u, dim=0, keepdim=True)
    g_c = g - torch.mean(g, dim=0, keepdim=True)
    R = y[None, :] + eta - g  # innovations with perturbed observations
    B = (J - 1) * s2 * torch.eye(J, dtype=u.dtype, device=u.device) + g_c @ g_c.T
    GR = g_c @ R.T
    L, info = torch.linalg.cholesky_ex(B)
    # B is positive definite in exact arithmetic; where f32 rounding says
    # otherwise, solve it by LU.
    W = torch.cholesky_solve(GR, L) if int(info) == 0 else torch.linalg.solve(B, GR)
    return u + (u_c.T @ W).T


def eki_update(u, g, y, noise_std, generator: torch.Generator | None = None):
    """One perturbed-observation EKI step in unconstrained space.

    ``u``: ``(J, p)`` ensemble, ``g``: ``(J, d)`` forward evaluations,
    ``y``: ``(d,)`` observations. ``eta ~ N(0, noise_std^2)`` is drawn from
    ``generator`` (a CPU ``torch.Generator``) and moved to ``g``'s device.
    """
    eta = noise_std * torch.randn(g.shape, generator=generator, dtype=g.dtype).to(g.device)
    return kalman_step(u, g, y, eta, noise_std)


def eki_calibrate(forward_fn: Callable, y_obs, priors: dict, generator: torch.Generator | None = None,
                  n_ensemble: int = 64, n_iterations: int = 10, noise_std: float | None = None,
                  batch_size: int | None = None, mesh=None, inflation: float = 1.0,
                  tempered: bool = True) -> EKIResult:
    """Calibrate ``forward_fn``'s parameters to ``y_obs`` with EKI.

    ``forward_fn(values)`` maps a ``(J, p)`` population (columns in the
    order of ``priors``) to ``(J, d)`` predictions; ``priors`` maps names to
    uniform ``(lo, hi)`` bounds. ``noise_std`` defaults to 1% of the
    observations' standard deviation. ``batch_size`` evaluates the
    population in chunks of that many members. ``generator`` (a CPU
    ``torch.Generator``, seed 0 by default) draws the initial ensemble and
    every noise; the JAX package draws from ``jax.random``, so the two runs
    do not draw the same numbers.

    ``tempered=True`` anneals the updates: each of the ``n_iterations``
    steps uses noise variance ``n_iterations * s^2``. Without it, when the
    model error dwarfs ``noise_std`` (as for a physics closure against LES
    data), the first update collapses the ensemble onto a corner of the
    prior box, where it freezes. ``inflation > 1`` multiplies the spread
    after each update. ``mesh`` splits the population over its ranks (module
    docstring): ``n_ensemble`` must divide by the mesh size (``ValueError``),
    and ``batch_size`` is then ignored, as in the JAX package.
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    names = tuple(priors.keys())
    y = torch.as_tensor(y_obs)
    lo = torch.tensor([priors[n][0] for n in names], dtype=y.dtype, device=y.device)
    hi = torch.tensor([priors[n][1] for n in names], dtype=y.dtype, device=y.device)
    if noise_std is None:
        noise_std = 0.01 * float(torch.std(y, correction=0))
    axis = None
    if mesh is not None:
        from climateparameterizations_jl_tpu_torch.parallel import world

        axis = world.axis_of(mesh)
        if n_ensemble % axis.size:
            raise ValueError(f"n_ensemble={n_ensemble} must divide over the {axis.size}-rank mesh")
        batch_size = None

    def draw(fn, shape):  # rank 0's draw on every rank
        x = fn(shape, generator=generator, dtype=y.dtype).to(y.device)
        return x if axis is None else world.broadcast(x, axis)

    theta0 = lo + (hi - lo) * draw(torch.rand, (n_ensemble, len(names)))
    u = _to_unconstrained(theta0, lo, hi)
    # Tempering: each of the N steps assimilates likelihood^(1/N), noise std sqrt(N) s.
    step_noise = noise_std * (float(n_iterations) ** 0.5 if tempered else 1.0)

    def evaluate(theta):
        if axis is not None:
            k = n_ensemble // axis.size
            g = forward_fn(theta[axis.rank * k: (axis.rank + 1) * k])
            return world.all_gather(g.contiguous(), axis).reshape(n_ensemble, *g.shape[1:])
        if batch_size is None:
            return forward_fn(theta)
        return torch.cat([forward_fn(theta[i: i + batch_size]) for i in range(0, theta.shape[0], batch_size)])

    # Diverged members (stiff parameter draws blowing up the forward solve)
    # must not poison the update: bound every prediction to a wide band
    # around the data, so innovations stay large but finite in f32.
    span = float(torch.max(y) - torch.min(y)) + 1e-12
    g_lo, g_hi = float(torch.min(y)) - 100.0 * span, float(torch.max(y)) + 100.0 * span

    def sanitized_eval(theta):
        with torch.no_grad():
            g = evaluate(theta)
        return torch.clamp(torch.where(torch.isfinite(g), g, g_hi), g_lo, g_hi)

    misfits = []
    for _ in range(n_iterations):
        g = sanitized_eval(_to_constrained(u, lo, hi))
        misfits.append(float(torch.mean((g - y[None, :]) ** 2)))
        u = kalman_step(u, g, y, step_noise * draw(torch.randn, g.shape), step_noise)
        if inflation != 1.0:
            u_mean = torch.mean(u, dim=0, keepdim=True)
            u = u_mean + inflation * (u - u_mean)

    theta = _to_constrained(u, lo, hi)
    # The last entry is the misfit of the returned ensemble (the loop's
    # entries lag the parameters by one Kalman step).
    misfits.append(float(torch.mean((sanitized_eval(theta) - y[None, :]) ** 2)))
    return EKIResult(names=names, ensemble=theta, theta_mean=torch.mean(theta, dim=0),
                     theta_std=torch.std(theta, dim=0, correction=0), misfit_history=misfits)


def calibrate_kpp_eki(ds, tsteps, Nz: int, generator: torch.Generator | None = None, priors: dict | None = None,
                      n_ensemble: int = 64, n_iterations: int = 10, base_params=None, n_substeps: int = 1,
                      mesh=None, inflation: float = 1.0):
    """KPP calibration by EKI (the reference's unfinished ``train_kpp.jl:78-99``).

    Returns ``(KPPParameters at the ensemble mean, EKIResult)``; the result's
    spread is the posterior uncertainty. The forward map is the population
    map of ``train/kpp_calibration.py``: the J parameter sets ride the KPP
    solve's batch axis, so each forward evaluation is one solve (one Thomas
    launch per step on the card). ``mesh`` splits the population over its
    ranks, as in :func:`eki_calibrate`.
    """
    from climateparameterizations_jl_tpu_torch.physics.kpp import KPPParameters
    from climateparameterizations_jl_tpu_torch.train.kpp_calibration import (
        DEFAULT_PRIORS,
        _with_overrides,
        make_kpp_forward_fn,
    )

    priors = priors if priors is not None else dict(DEFAULT_PRIORS)
    names = tuple(priors.keys())
    base = base_params if base_params is not None else KPPParameters.default(device=ds.T.device)
    forward, y = make_kpp_forward_fn(ds, tsteps, Nz, base, names, n_substeps)
    result = eki_calibrate(forward, y, priors, generator=generator, n_ensemble=n_ensemble,
                           n_iterations=n_iterations, mesh=mesh, inflation=inflation)
    calibrated = _with_overrides(base, names, [result.theta_mean[i] for i in range(len(names))])
    return calibrated, result
