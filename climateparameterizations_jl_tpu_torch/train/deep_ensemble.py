"""Deep ensembles of the NDE closures: K members trained as K independent runs.

Port of ``climateparameterizations_jl_tpu/train/deep_ensemble.py``. The K
closures ride a leading member axis of every tensor of a STACKED closure
(:func:`stack_members`). The objective is the SUM of the member losses, so
with an elementwise optimizer (adam, sgd) each member's gradient and update
are its solo run's. History entries and callbacks carry the member MEAN.

The JAX package vmaps the whole scanned solve over the member axis. The
port's implicit solves go through an ``autograd.Function`` over a ctypes
kernel, which has no vmap rule, so each path takes one of two forms:

- the member loop (:func:`make_ensemble_loss_fn`): one solve per member
  view ``W[m]`` of the stacked tensors. Gradients reach the stacked tensors
  exactly, at K times the launches of a solo step;
- the member fold (:func:`make_folded_ensemble_loss_fn`): the members ride
  the solve's batch axis through one block-diagonal chain
  (:class:`~..models.wind_mixing.MemberPackedFluxNNs`), so each implicit
  solve is ONE Thomas launch for all members.

The free-convection trainer loops over its members: its closure may be a
:class:`~..closures.mlp.ConvMLP`, which has no block-diagonal form, and at
the K = 4 of the flagship ensembles the loop costs four solo launches.
Evaluation-side bands are in ``eval/ensemble_uq.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from climateparameterizations_jl_tpu_torch.data.containers import TrainingBatch
from climateparameterizations_jl_tpu_torch.models.wind_mixing import WindMixingModel, pack_member_flux_nns
from climateparameterizations_jl_tpu_torch.train.checkpoint import _map_leaves, _tensors, save_checkpoint
from climateparameterizations_jl_tpu_torch.train.loss import (
    LossChannels,
    apply_loss_scalings,
    calculate_loss_scalings,
    nde_loss_channels,
)
from climateparameterizations_jl_tpu_torch.train.nde import (
    CurriculumStage,
    NDETrainConfig,
    _make_optimizer,
    _require_uniform,
    _solve,
    _train_loop,
    determine_loss_scalings,
    resolve_tridiag_backend,
    resume_train_state,
)


def _rebuild(tree, leaves: list):
    """``tree`` with its tensors replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return _map_leaves(tree, lambda _key, _leaf: next(it))


def stack_members(members: Sequence) -> object:
    """Stack same-structure closures on a new leading member axis."""
    if not members:
        raise ValueError("stack_members: need at least one member")
    per_member = [_tensors(m) for m in members]
    return _rebuild(members[0], [torch.stack(xs) for xs in zip(*per_member, strict=True)])


def member(stacked, m: int):
    """Member ``m`` of a stacked closure: views ``x[m]``, through which gradients reach ``x``."""
    return _map_leaves(stacked, lambda _key, x: x[m])


def unstack_members(stacked) -> list:
    """Inverse of :func:`stack_members`: the list of per-member closures (views)."""
    return [member(stacked, m) for m in range(ensemble_size(stacked))]


def ensemble_size(stacked) -> int:
    """Number of members (leading dim of every tensor)."""
    leaves = _tensors(stacked)
    if not leaves:
        raise ValueError("ensemble_size: empty pytree")
    n = leaves[0].shape[0]
    if any(leaf.shape[0] != n for leaf in leaves[1:]):
        raise ValueError("ensemble_size: inconsistent leading member axis")
    return int(n)


def init_ensemble(generator: torch.Generator, n_members: int, init_fn: Callable) -> object:
    """Stack ``n_members`` closures ``init_fn(generator)``, drawn one after another from ``generator``.

    The JAX package splits one key into ``n_members``; here the members take
    successive draws of one ``torch.Generator``, so they differ as the JAX
    package's do but not by the same numbers.
    """
    if n_members < 1:
        raise ValueError(f"init_ensemble: n_members must be >= 1 (got {n_members})")
    return stack_members([init_fn(generator) for _ in range(n_members)])


def _check_independent_optimizer(config: NDETrainConfig):
    # lbfgs's line search picks ONE step size from the summed loss, coupling
    # the members; adam/sgd updates are elementwise, so stacked == solo.
    if config.optimizer not in ("adam", "sgd"):
        raise ValueError(f"deep ensembles require an elementwise optimizer (adam/sgd); {config.optimizer!r} couples "
                         f"members through its shared linesearch scalar")


def _stack_channels(channels: list) -> LossChannels:
    return LossChannels(**{f.name: torch.stack([getattr(c, f.name) for c in channels])
                           for f in dataclasses.fields(LossChannels)})


def _mean_channels(stacked: LossChannels) -> LossChannels:
    return LossChannels(**{f.name: torch.mean(getattr(stacked, f.name), dim=0)
                           for f in dataclasses.fields(LossChannels)})


def _folded_predictions(model: WindMixingModel, stacked_nns, batch: TrainingBatch, config: NDETrainConfig):
    """All members' trajectories from ONE solve with the members on its batch axis: ``(M, S[, K], Nt, 3 Nz)``."""
    folded = pack_member_flux_nns(stacked_nns)
    if folded is None:
        raise ValueError("member fold requires packable (same-depth, same-activation) MLP members")
    M = folded.n_members
    x0 = batch.x0[..., None, :].expand(*batch.x0.shape[:-1], M, batch.x0.shape[-1])
    # pack_nns=False: the members are fused already.
    pred = _solve(model, folded, dataclasses.replace(batch, x0=x0), dataclasses.replace(config, pack_nns=False))
    return torch.movedim(pred, -3, 0)  # (S[, K], M, Nt, 3 Nz) -> (M, S[, K], Nt, 3 Nz)


def ensemble_loss_scalings(model: WindMixingModel, stacked_nns, batch: TrainingBatch, config: NDETrainConfig,
                           member_fold: bool = False) -> LossChannels:
    """Per-member loss scalings, stacked on the member axis.

    ``train.nde.determine_loss_scalings`` member by member: each member's
    auto-balance pre-solve uses its own initial weights, as K solo runs
    would; ``member_fold=True`` runs the K pre-solves as one folded solve.
    """
    n = ensemble_size(stacked_nns)
    if config.training_fractions is None:
        ones = LossChannels.ones(config.gradient_scaling if config.train_gradient else 0.0, batch.x0.device)
        return _map_leaves(ones, lambda _key, x: x.expand(n).clone())
    if not member_fold:
        return _stack_channels([determine_loss_scalings(model, m, batch, config)
                                for m in unstack_members(stacked_nns)])
    with torch.no_grad():
        return _stack_channels([
            calculate_loss_scalings(nde_loss_channels(pred, batch.targets, model.Nz, config.train_gradient),
                                    config.training_fractions, config.train_gradient)
            for pred in _folded_predictions(model, stacked_nns, batch, config)])


def _member_losses(preds, targets, stacked_scalings: LossChannels, Nz: int, train_gradient: bool):
    """``(sum of the member totals, member-mean channels)`` of per-member trajectories."""
    scaled = []
    for m, pred in enumerate(preds):
        channels = nde_loss_channels(pred, targets, Nz, train_gradient)
        scaled.append(apply_loss_scalings(channels, member(stacked_scalings, m)))
    channels = _stack_channels(scaled)
    return torch.sum(channels.total()), _mean_channels(channels)


def make_ensemble_loss_fn(model: WindMixingModel, batch: TrainingBatch, stacked_scalings: LossChannels,
                          config: NDETrainConfig) -> Callable:
    """``loss(stacked_nns) -> (sum of member totals, member-mean channels)``, one solve per member.

    The member-sum has no cross-member terms, so one backward trains all K
    members as K solo runs would.
    """

    def loss_fn(stacked_nns):
        preds = [_solve(model, m, batch, config) for m in unstack_members(stacked_nns)]
        return _member_losses(preds, batch.targets, stacked_scalings, model.Nz, config.train_gradient)

    return loss_fn


def make_folded_ensemble_loss_fn(model: WindMixingModel, batch: TrainingBatch, stacked_scalings: LossChannels,
                                 config: NDETrainConfig) -> Callable:
    """Member-FOLDED ensemble loss: :func:`make_ensemble_loss_fn`'s contract, one solve for all members.

    The members ride the solve's batch axis, states ``(S[, K], M, 3 Nz)``,
    through one block-diagonal chain built once per call; every implicit
    solve is one Thomas launch over ``3 x S[K] x M`` systems. The result
    equals the member loop's up to the order of the matmul sums.
    """

    def loss_fn(stacked_nns):
        return _member_losses(_folded_predictions(model, stacked_nns, batch, config), batch.targets,
                              stacked_scalings, model.Nz, config.train_gradient)

    return loss_fn


def resume_ensemble_train_state(checkpoint_dir: str, stacked_nns, optimizer: str = "adam"):
    """Stacked ``(params, opt_state)`` of an ensemble checkpoint (``train.nde.resume_train_state``)."""
    return resume_train_state(checkpoint_dir, stacked_nns, optimizer)


def _member_mean_callback(callback, n_members: int):
    """Report the member-MEAN loss to ``callback``.

    The objective is the member SUM; the channels are member means, so an
    unwrapped callback would log a ``loss`` K times ``sum(channels)``.
    """
    if callback is None:
        return None
    return lambda i, total, channels=None, *rest: callback(i, total / n_members, channels, *rest)


def train_free_convection_deep_ensemble(model, stacked_nn, T0, targets, t, config: NDETrainConfig, callback=None,
                                        project=None):
    """Free-convection analogue of :func:`train_wind_mixing_deep_ensemble`; returns ``(stacked_nn, history)``.

    ``train.nde.train_free_convection_nde`` over a stacked closure: the summed
    member MSE trains the K members as K independent runs (elementwise
    optimizer required), one solve per member (module docstring).
    ``project`` (an in-place constraint such as
    ``closures.mlp.apply_spatial_causality_mask_``) is applied to each
    member view after every update. History entries carry the member-MEAN
    loss in the T channel.
    """
    from climateparameterizations_jl_tpu_torch.models.free_convection import solve_free_convection_nde

    _check_independent_optimizer(config)
    t = torch.as_tensor(t)
    _require_uniform(t, "train_free_convection_deep_ensemble")
    n_save = t.shape[0] - 1
    dt_save = (t[-1] - t[0]) / n_save
    backend = resolve_tridiag_backend(config.tridiag_backend, n_save * config.n_substeps, T0.device)

    def loss_fn(stacked):
        totals = []
        for nn in unstack_members(stacked):
            traj = solve_free_convection_nde(model, nn, T0, t[0], dt_save, n_save, config.n_substeps, config.method,
                                             tridiag_backend=backend)
            totals.append(torch.mean((torch.movedim(traj, 0, -2) - targets) ** 2))
        totals = torch.stack(totals)
        mean = torch.mean(totals)
        zero = torch.zeros_like(mean)
        return torch.sum(totals), LossChannels(u=zero, v=zero, T=mean, dudz=zero, dvdz=zero, dTdz=zero)

    def proj(stacked):
        for nn in unstack_members(stacked):
            project(nn)

    cb = _member_mean_callback(callback, ensemble_size(stacked_nn))
    stacked_nn, history, _ = _train_loop(loss_fn, stacked_nn, _make_optimizer(config, stacked_nn), config.maxiters,
                                         cb, project=None if project is None else proj)
    return stacked_nn, history


def train_wind_mixing_deep_ensemble(model: WindMixingModel, stacked_nns, batch: TrainingBatch, config: NDETrainConfig,
                                    stages: Sequence[CurriculumStage] | None = None,
                                    full_batch_fn: Callable | None = None, callback=None,
                                    checkpoint_dir: str | None = None, resume_from: str | None = None,
                                    member_fold: bool = False):
    """Train K stacked flux-MLP triples through the NDE solve at once; returns ``(stacked_nns, history)``.

    ``train.nde.train_wind_mixing_nde``'s contract (curriculum stages with
    the optimizer state carried across them, checkpoint after every stage,
    resume) over a stacked closure; history entries are member-MEAN
    channels. ``member_fold=True`` puts the members on the solve's batch
    axis (:func:`make_folded_ensemble_loss_fn`) instead of the member loop:
    the same numbers up to summation order, K times fewer launches.
    """
    make_loss = make_folded_ensemble_loss_fn if member_fold else make_ensemble_loss_fn
    _check_independent_optimizer(config)
    n_members = ensemble_size(stacked_nns)

    opt_state = None
    if resume_from is not None:
        stacked_nns, opt_state = resume_ensemble_train_state(resume_from, stacked_nns, config.optimizer)

    def _save(nns, opt_state, stage_idx):
        if checkpoint_dir is not None:
            save_checkpoint(checkpoint_dir, {"params": nns, "opt_state": opt_state},
                            {"stage": stage_idx, "optimizer": config.optimizer,
                             "learning_rate": config.learning_rate, "ensemble": n_members})

    _require_uniform(batch.t, "train_wind_mixing_deep_ensemble")
    cb = _member_mean_callback(callback, n_members)
    if stages is None:
        scalings = ensemble_loss_scalings(model, stacked_nns, batch, config, member_fold)
        loss_fn = make_loss(model, batch, scalings, config)
        stacked_nns, history, opt_state = _train_loop(loss_fn, stacked_nns, _make_optimizer(config, stacked_nns),
                                                      config.maxiters, cb, opt_state)
        _save(stacked_nns, opt_state, 0)
        return stacked_nns, history

    history = []
    for i, stage in enumerate(stages):
        stage_batch = full_batch_fn(stage.tsteps)
        _require_uniform(stage_batch.t, f"ensemble curriculum stage {i}")
        stage_config = dataclasses.replace(config, n_substeps=stage.n_substeps) if stage.n_substeps else config
        scalings = ensemble_loss_scalings(model, stacked_nns, stage_batch, stage_config, member_fold)
        loss_fn = make_loss(model, stage_batch, scalings, stage_config)
        optimizer = _make_optimizer(stage_config, stacked_nns, stage.learning_rate)
        stacked_nns, h, opt_state = _train_loop(loss_fn, stacked_nns, optimizer, stage.maxiters, cb, opt_state)
        history.extend(h)
        _save(stacked_nns, opt_state, i)
    return stacked_nns, history
