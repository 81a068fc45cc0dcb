"""GP-closure differential equation: GP flux models driving the column ODE.

Port of ``climateparameterizations_jl_tpu/models/gp_closure.py`` (reference
``wind_mixing/run_GP_DE.jl:103-213``): three exact-GP flux models (scaled
state -> full scaled flux profile, boundary faces included) replace the
MLPs inside the column equation of ``models/wind_mixing.py::_tendencies``.
Unlike the MLP closure, the GP predicts all ``Nz + 1`` faces directly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from climateparameterizations_jl_tpu_torch.closures.gp import GPModel, _mm, gp_predict
from climateparameterizations_jl_tpu_torch.models.timestepper import solve_fixed_step
from climateparameterizations_jl_tpu_torch.models.wind_mixing import WindMixingModel, _tendencies


class FluxGPs(NamedTuple):
    uw: GPModel
    vw: GPModel
    wT: GPModel


def _share_gram(gps: FluxGPs) -> bool:
    """True when the three GPs provably share one cross-kernel matrix.

    ``gp_fit_multi`` hands the three fluxes the SAME predictor, kernel and
    grid objects, so identity checks suffice.
    """
    ms = (gps.uw, gps.vw, gps.wT)
    if any(m.alpha.dim() != 2 for m in ms):
        return False  # the stacked-alpha concat below assumes (n, D_out)
    if not (ms[0].x_train is ms[1].x_train is ms[2].x_train and ms[0].z is ms[1].z is ms[2].z):
        return False
    k0, k1, k2 = (m.kernel for m in ms)
    if not (type(k0) is type(k1) is type(k2)):
        return False
    for f in dataclasses.fields(k0):
        v0, v1, v2 = (getattr(k, f.name) for k in (k0, k1, k2))
        same = (v0 == v1 == v2) if isinstance(v0, (str, bool)) else (v0 is v1 is v2)
        if not same:
            return False
    return True


def share_train_inputs(gps: FluxGPs) -> FluxGPs:
    """Rebind value-equal training inputs (and equal kernels) to ONE object so `_share_gram` fires.

    Per-flux sequential fits leave three distinct but equal ``x_train`` /
    ``z`` tensors, and the GP-DE would then build three cross-Grams per
    stage where one suffices. Leaves are compared by value once; models
    that do not match are returned unchanged, so this is always safe.
    """
    ms = (gps.uw, gps.vw, gps.wT)
    x0, z0 = ms[0].x_train, ms[0].z
    if not all(m.x_train.shape == x0.shape and m.z.shape == z0.shape for m in ms[1:]):
        return gps
    if not all(torch.equal(m.x_train, x0) and torch.equal(m.z, z0) for m in ms[1:]):
        return gps
    k0 = ms[0].kernel

    def _kernel_equal(k) -> bool:
        if type(k) is not type(k0):
            return False
        for f in dataclasses.fields(k0):
            v0, v = getattr(k0, f.name), getattr(k, f.name)
            if isinstance(v0, (str, bool)):
                if v0 != v:
                    return False
            elif not torch.equal(v0, v):
                return False
        return True

    all_kernels_equal = all(_kernel_equal(m.kernel) for m in ms[1:])
    rebound = []
    for m in ms:
        m = dataclasses.replace(m, x_train=x0, z=z0)
        if all_kernels_equal:
            m = dataclasses.replace(m, kernel=k0)
        rebound.append(m)
    return FluxGPs(*rebound)


def gp_closure_rhs(model: WindMixingModel, gps: FluxGPs, x, t):
    """``dx/dt_hat`` with GP-predicted scaled flux faces; batches over rows.

    ``x``: ``(..., 3 Nz)`` scaled state(s). When the three GPs share their
    kernel and predictors (``gp_fit_multi``), the cross-Gram, the dominant
    cost of each stage, is built ONCE and the three predictions are one
    stacked-alpha matmul.
    """
    batch_shape = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if _share_gram(gps):
        gram = gps.uw.kernel.gram(flat, gps.uw.x_train, gps.uw.z)
        out = _mm(gram, torch.cat([gps.uw.alpha, gps.vw.alpha, gps.wT.alpha], dim=-1))
        n1 = gps.uw.alpha.shape[-1]
        n2 = n1 + gps.vw.alpha.shape[-1]
        uw, vw, wT = out[..., :n1], out[..., n1:n2], out[..., n2:]
    else:
        uw, vw, wT = (gp_predict(m, flat) for m in (gps.uw, gps.vw, gps.wT))
    uw = uw.reshape(*batch_shape, -1)
    vw = vw.reshape(*batch_shape, -1)
    wT = wT.reshape(*batch_shape, -1)
    return _tendencies(model, x, uw, vw, wT)


def solve_gp_closure(model: WindMixingModel, gps: FluxGPs, x0, t0, dt_save, n_save: int, n_substeps: int = 4,
                     method: str = "rk4"):
    """Integrate the GP-closure DE (``run_GP_DE.jl:181-192``, ROCK4 -> fixed-step RK4)."""
    def rhs(x, t):
        return gp_closure_rhs(model, gps, x, t)

    return solve_fixed_step(rhs, x0, t0, dt_save, n_save, n_substeps, method, checkpoint=False)
