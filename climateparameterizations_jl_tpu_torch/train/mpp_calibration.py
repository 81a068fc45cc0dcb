"""Calibration of the five mPP diffusivity parameters against LES trajectories.

Port of ``climateparameterizations_jl_tpu/train/mpp_calibration.py``
(reference ``wind_mixing/src/diffusivity_parameter_optimisation.jl:35-231``):
the parameters are rescaled to O(1) by their initial values, the
physics-only NDE (no flux MLPs) is solved over the training window, the
six-channel loss is applied, and a box-constrained optimizer (``lb = 0``,
``ub = 10`` in scaled units) walks the parameters: projected adam, sgd or
L-BFGS with gradients through the solve (:func:`optimise_mpp_parameters`),
or Ensemble Kalman Inversion (:func:`calibrate_mpp_eki`), whose J parameter
sets ride the solve's batch axis, so one forward evaluation of the whole
population is one solve (one Thomas launch per substep on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data.containers import TrainingBatch
from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs, WindMixingModel
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters
from climateparameterizations_jl_tpu_torch.train.loss import apply_loss_scalings, nde_loss_channels
from climateparameterizations_jl_tpu_torch.train.nde import (
    NDETrainConfig,
    _make_optimizer,
    _solve,
    determine_loss_scalings,
    optimizer_step,
)

NO_NNS = FluxNNs(uw=None, vw=None, wT=None)
MPP_NAMES = ("nu_0", "nu_minus", "delta_Ri", "Ri_c", "Pr")


def _floats(params: MPPParameters) -> MPPParameters:
    return MPPParameters(**{f.name: float(getattr(params, f.name)) for f in dataclasses.fields(params)})


def optimise_mpp_parameters(model: WindMixingModel, batch: TrainingBatch, config: NDETrainConfig,
                            initial: MPPParameters | None = None, lb: float = 0.0, ub: float = 10.0, callback=None):
    """Fit ``(nu_0, nu_minus, Ri_c, delta_Ri, Pr)``; returns ``(params, history)``.

    The search space is ``theta = p / p_init``, clipped to ``[lb, ub]``
    without autograd after every update (projected gradient, the reference's
    box, ``diffusivity_parameter_optimisation.jl:197``). ``config.optimizer``
    picks adam, sgd or lbfgs (one outer L-BFGS iteration per update; its
    curvature pairs carry across the clipped updates). ``history`` holds
    ``(loss, parameters as floats)`` at each evaluated pre-update iterate;
    the returned parameters are the best EVALUATED iterate, not the last
    (the post-final-update parameters were never evaluated).
    ``callback(i, loss, params)`` runs after each update.
    """
    p0 = initial if initial is not None else model.mpp
    init_vec = p0.as_vector().detach()

    def unscale(theta):
        return MPPParameters.from_vector(theta * init_vec)

    loss_scalings = determine_loss_scalings(dataclasses.replace(model, mpp=p0), NO_NNS, batch, config)

    def loss_fn(theta):
        m = dataclasses.replace(model, mpp=unscale(theta))
        pred = _solve(m, NO_NNS, batch, config)
        scaled = apply_loss_scalings(nde_loss_channels(pred, batch.targets, model.Nz, config.train_gradient),
                                     loss_scalings)
        return scaled.total(), scaled

    theta = torch.ones_like(init_vec)
    optimizer = _make_optimizer(config, theta)
    pending = []
    for i in range(config.maxiters):
        before = theta.detach().clone()
        total, _ = optimizer_step(optimizer, loss_fn, theta)
        with torch.no_grad():
            theta.clamp_(lb, ub)
        pending.append((total, before))
        if callback is not None:
            callback(i, float(total), unscale(before))
    losses = torch.stack([t for t, _ in pending]).tolist() if pending else []
    history = [(loss, _floats(unscale(th))) for loss, (_, th) in zip(losses, pending)]
    best = pending[int(np.argmin(losses))][1] if pending else theta.detach()
    return unscale(best), history


def calibrate_mpp_eki(model: WindMixingModel, batch: TrainingBatch, config: NDETrainConfig,
                      generator: torch.Generator | None = None, priors: dict | None = None, n_ensemble: int = 64,
                      n_iterations: int = 8, mesh=None, inflation: float = 1.0):
    """mPP calibration by Ensemble Kalman Inversion; returns ``(MPPParameters, EKIResult)``.

    Forward map: the physics-only trajectory over the training window, with
    the J parameter sets on the solve's batch axis: states ``(S, J, 3 Nz)``
    and each overridden parameter a ``(J, 1)`` tensor, which broadcasts
    against the ``(S, J, Nz + 1)`` faces. Observations: the LES targets.
    ``priors`` maps parameter names to boxes (default ``[p / 10, 10 p]``
    around the model's values, in the JAX package's name order); the order
    of the names is the priors', never a positional convention.
    ``generator`` seeds :func:`~.eki.eki_calibrate`.
    """
    from climateparameterizations_jl_tpu_torch.train.eki import eki_calibrate

    if priors is None:
        priors = {name: (0.1 * float(getattr(model.mpp, name)), 10.0 * float(getattr(model.mpp, name)))
                  for name in MPP_NAMES}
        degenerate = [n for n, (lo, hi) in priors.items() if hi <= lo]
        if degenerate:
            raise ValueError(f"calibrate_mpp_eki: default multiplicative priors are degenerate for zero-valued "
                             f"parameter(s) {degenerate}: pass explicit `priors` boxes for them")
    names = tuple(priors.keys())

    def with_values(values):
        """The model's mPP with ``values[..., i]`` as parameter ``names[i]``."""
        return dataclasses.replace(model.mpp, **{n: values[..., i] for i, n in enumerate(names)})

    def forward(values):  # (J, p) -> (J, d)
        J = values.shape[0]
        m = dataclasses.replace(model, mpp=with_values(values[:, None, :]))
        x0 = batch.x0[..., None, :].expand(*batch.x0.shape[:-1], J, batch.x0.shape[-1])
        pred = _solve(m, NO_NNS, dataclasses.replace(batch, x0=x0), config)  # (..., J, Nt, 3 Nz)
        return torch.movedim(pred, -3, 0).reshape(J, -1)

    result = eki_calibrate(forward, batch.targets.reshape(-1), priors, generator=generator, n_ensemble=n_ensemble,
                           n_iterations=n_iterations, mesh=mesh, inflation=inflation)
    return with_values(result.theta_mean), result
