"""Direct supervised flux regression (NN pre-training).

Port of ``climateparameterizations_jl_tpu/train/nn.py`` (reference
``wind_mixing/src/NN_training.jl``: loss = ``MSE(flux) + gradient_scaling
* MSE(d flux/dz)``, ``NN_training.jl:219-231``). Full batch or mini-batch
adam with optax's defaults (``torch.optim.Adam(betas=(0.9, 0.999),
eps=1e-8)``); optional spatial causality, soft (a penalty) or hard (the
acausal weights re-zeroed after every update). The JAX package scans the
full-batch epochs in one dispatch; here they run as a loop, with the same
iterates. :func:`train_flux_nn_ensemble` trains a stack of same-shape
closures (deep-ensemble members, or members x fluxes) under one adam.
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import (
    _leaves,
    _rebuild,
    apply_closure,
    apply_spatial_causality_mask_,
    spatial_causality_penalty,
)
from climateparameterizations_jl_tpu_torch.core.operators import d_face_to_center

CAUSALITY_MODES = ("none", "soft", "hard")


def flux_nn_loss(nn, x, y, gradient_scaling: float = 0.0, dz_hat: float | None = None, causality_weight: float = 0.0):
    """MSE on the predicted interior fluxes, plus an optional flux-gradient penalty.

    ``x``: ``(B, n_in)`` scaled predictors; ``y``: ``(B, Nz + 1)`` scaled
    target faces. The closure predicts the ``Nz - 1`` interior faces; the
    boundary faces come from the targets (they are BCs, not learnable).
    ``causality_weight > 0`` adds the soft spatial-causality penalty on the
    first dense layer (``train_free_convection_nde.jl:184-200``).
    """
    pred = torch.cat([y[..., :1], apply_closure(nn, x), y[..., -1:]], dim=-1)
    loss = torch.mean((pred - y) ** 2)
    if gradient_scaling and dz_hat is not None:
        dpred = d_face_to_center(pred, dz_hat)
        dy = d_face_to_center(y, dz_hat)
        loss = loss + gradient_scaling * torch.mean((dpred - dy) ** 2)
    if causality_weight:
        loss = loss + causality_weight * spatial_causality_penalty(nn)
    return loss


def train_flux_nn(nn, x, y, learning_rate: float = 1e-3, epochs: int = 200, batch_size: int | None = None,
                  gradient_scaling: float = 0.0, dz_hat: float | None = None, generator: torch.Generator | None = None,
                  callback=None, causality: str = "none", causality_weight: float = 1.0):
    """Train one flux closure (``MLP`` or ``ConvMLP``); returns ``(nn, per-epoch loss history)``.

    ``nn`` is not modified: training runs on a copy, returned with its
    tensors detached. With ``batch_size=None`` every epoch is one full-batch
    step; otherwise each epoch shuffles the rows with ``generator`` (a CPU
    ``torch.Generator``, seed 0 by default; the JAX package draws from
    ``jax.random``, so its mini-batches differ), drops the last partial
    batch and records the mean of its batch losses. ``callback(epoch, loss,
    nn)`` runs after each epoch. ``causality``: ``"none"``, ``"soft"``
    (``causality_weight`` times the penalty on the acausal first-layer
    weights) or ``"hard"`` (those of every layer zeroed first and after every
    update; ``free_convection/src/training.jl:24-42``).
    """
    if causality not in CAUSALITY_MODES:
        raise ValueError(f"unknown causality mode {causality!r} (expected 'none', 'soft' or 'hard')")
    soft_w = causality_weight if causality == "soft" else 0.0
    hard = causality == "hard"
    nn = _rebuild(nn, [p.detach().clone().requires_grad_(True) for p in _leaves(nn)])
    if hard:
        apply_spatial_causality_mask_(nn)
    optimizer = torch.optim.Adam(_leaves(nn), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def step(xb, yb):
        optimizer.zero_grad(set_to_none=True)
        loss = flux_nn_loss(nn, xb, yb, gradient_scaling, dz_hat, soft_w)
        loss.backward()
        optimizer.step()
        if hard:
            apply_spatial_causality_mask_(nn)
        return loss.detach()

    n = x.shape[0]
    if batch_size is not None:
        batch_size = min(batch_size, n)  # an oversized batch must not skip every step
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
    history = []
    for epoch in range(epochs):
        if batch_size is None:
            loss = step(x, y)
        else:
            perm = torch.randperm(n, generator=generator).to(x.device)
            losses = [step(x[perm[s:s + batch_size]], y[perm[s:s + batch_size]])
                      for s in range(0, n - batch_size + 1, batch_size)]
            values = torch.stack(losses).tolist()
            loss = sum(values) / len(values)  # the epoch's mean, not its last batch
        history.append(loss)
        if callback is not None:
            callback(epoch, float(loss), nn)
    history = torch.stack(history).tolist() if batch_size is None and history else [float(v) for v in history]
    return _rebuild(nn, [p.detach() for p in _leaves(nn)]), history


def train_flux_nn_ensemble(stacked_nn, x, ys, learning_rate: float = 1e-3, epochs: int = 200,
                           gradient_scaling: float = 0.0, dz_hat: float | None = None, causality: str = "none",
                           causality_weight: float = 1.0):
    """Train a STACK of same-shape closures (a leading member axis on every tensor) on shared inputs.

    ``ys`` carries the targets with a matching leading axis; ``x`` is shared.
    Every epoch is one full-batch step of one adam over the stacked tensors
    on the SUM of the member losses: adam is elementwise, so each member
    trains exactly as its solo :func:`train_flux_nn` run. ``causality`` as
    there (``"hard"`` masks each member first and after every update).
    ``stacked_nn`` is not modified. Returns ``(stacked_nn, history)`` with
    history ``(K, epochs)`` floats.
    """
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import ensemble_size, unstack_members

    if causality not in CAUSALITY_MODES:
        raise ValueError(f"unknown causality mode {causality!r} (expected 'none', 'soft' or 'hard')")
    soft_w = causality_weight if causality == "soft" else 0.0
    hard = causality == "hard"
    ys = torch.as_tensor(ys)
    n = ensemble_size(stacked_nn)
    stacked_nn = _rebuild(stacked_nn, [p.detach().clone().requires_grad_(True) for p in _leaves(stacked_nn)])

    def mask_all():
        for nn in unstack_members(stacked_nn):
            apply_spatial_causality_mask_(nn)

    if hard:
        mask_all()
    optimizer = torch.optim.Adam(_leaves(stacked_nn), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(epochs):
        optimizer.zero_grad(set_to_none=True)
        losses = torch.stack([flux_nn_loss(nn, x, ys[k], gradient_scaling, dz_hat, soft_w)
                              for k, nn in enumerate(unstack_members(stacked_nn))])
        torch.sum(losses).backward()
        optimizer.step()
        if hard:
            mask_all()
        history.append(losses.detach())
    history = torch.stack(history, dim=1).tolist() if history else [[] for _ in range(n)]
    return _rebuild(stacked_nn, [p.detach() for p in _leaves(stacked_nn)]), history
