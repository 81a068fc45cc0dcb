"""A-posteriori (embedded) closure training: gradients through the host column.

Port of ``climateparameterizations_jl_tpu/train/embedded.py``. The
reference trains its NDEs against a simplified column
(``wind_mixing/src/NDE_training.jl:167-374``) and then embeds them in
Oceananigans (``wind_mixing/src/NDE_oceananigans.jl:331-475``), whose
implicit diffusion, dimensional surface fluxes and time step differ from
the training-time NDE; it cannot train through the host model. Here every
op of the host column (``embed/column_model.py``) is differentiable,
including the batched backward-Euler solve, whose gradient is one
transposed solve (implicit function theorem): on the card each host step
is one Thomas launch forward, one in the checkpoint's recompute and one in
the backward pass. The host is built by the same builders the embedded
evaluation uses, so the trained dynamics are the ones ``evaluate
--embedded`` scores.

The loss matches NDE training: trajectories are scaled by the training
scalings and go through the six-channel loss of ``train/loss.py``, so
curriculum stages, auto-balanced fractions and the history format carry
over. The trainers run on the port's ``train/nde.py`` loop (adam's state
carries across stages; checkpoints in the JAX package's format).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries, scaled_state_array
from climateparameterizations_jl_tpu_torch.embed.column_model import (
    HostColumnModel,
    HostColumnState,
    host_for_free_convection,
    host_for_wind_mixing,
    run_embedded_column,
)
from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs, WindMixingModel, join_uvT
from climateparameterizations_jl_tpu_torch.train.loss import (
    LossChannels,
    apply_loss_scalings,
    calculate_loss_scalings,
    nde_loss_channels,
)
from climateparameterizations_jl_tpu_torch.train.nde import (
    CurriculumStage,
    NDETrainConfig,
    _require_uniform,
    resolve_tridiag_backend,
    train_stages,
)


@dataclasses.dataclass(frozen=True)
class EmbeddedBatch:
    """What one a-posteriori training step consumes, for ``S`` sims.

    ``state0``: dimensional host states at the window start, ``(S, Nz)``
    per field. ``targets``: SCALED truth trajectories ``(S, Nt, 3 Nz)``
    (``(S, Nt, Nz)`` of T for free convection). ``t``: dimensional save
    times ``(Nt,)``, shared by the sims.
    """

    state0: HostColumnState
    targets: torch.Tensor
    t: torch.Tensor


def _window(ds: ColumnTimeSeries, tsteps):
    """``(t_arr, idx, i0, t_row)`` of a window of saved frames, refusing indices out of range."""
    t_arr = np.asarray(tsteps)
    n_frames = ds.t.shape[-1]
    if int(t_arr.max()) >= n_frames or int(t_arr.min()) < 0:
        raise ValueError(
            f"tsteps range [{int(t_arr.min())}, {int(t_arr.max())}] out of range for {n_frames} saved frames")
    idx = torch.as_tensor(t_arr, dtype=torch.long, device=ds.T.device)
    t_row = ds.t.reshape(-1, n_frames)[0] if ds.t.dim() > 1 else ds.t
    return idx, int(t_arr[0]), t_row.index_select(0, idx)


def embedded_training_tensors(ds: ColumnTimeSeries, scalings, tsteps) -> EmbeddedBatch:
    """A-posteriori training tensors of a stacked suite ``(S, Nt, ...)``.

    No scaled BC faces to freeze (the host owns its dimensional boundary
    fluxes): dimensional initial states plus scaled targets.
    """
    idx, i0, t = _window(ds, tsteps)
    targets = scaled_state_array(ds, scalings).index_select(-2, idx)  # (S, Nt, 3Nz)
    state0 = HostColumnState(u=ds.u[..., i0, :], v=ds.v[..., i0, :], T=ds.T[..., i0, :])
    return EmbeddedBatch(state0=state0, targets=targets, t=t)


def host_from_suite(model: WindMixingModel, ds: ColumnTimeSeries) -> HostColumnModel:
    """The training host: :func:`host_for_wind_mixing` over the suite's per-sim BCs (leading ``(S,)`` axes)."""
    return host_for_wind_mixing(model, ds.u_top, ds.theta_top, ds.theta_bottom,
                                diurnal_amplitude=ds.diurnal_amplitude)


def _host_dt(batch: EmbeddedBatch, n_save: int, n_substeps: int):
    """The host step of a window: its span over ``n_save * n_substeps`` steps, in the state's dtype."""
    return ((batch.t[-1] - batch.t[0]) / (n_save * n_substeps)).to(batch.state0.T.dtype)


def _solve_embedded(host: HostColumnModel, nns: FluxNNs, batch: EmbeddedBatch, config: NDETrainConfig):
    """Scaled ``(S, Nt, 3 Nz)`` trajectory of the host column over the window.

    ``config.n_substeps`` host steps per save interval; the implicit solve
    runs on ``resolve_tridiag_backend(config.tridiag_backend, ...)`` (the
    Thomas kernel for CUDA state). Each save interval is checkpointed, so
    long windows backprop in the memory of the carry.
    """
    n_save = batch.t.shape[0] - 1
    traj = run_embedded_column(
        host, nns, batch.state0, _host_dt(batch, n_save, config.n_substeps), n_save, config.n_substeps,
        tridiag_backend=resolve_tridiag_backend(config.tridiag_backend, n_save * config.n_substeps,
                                                batch.state0.T.device),
        t0=batch.t[0], remat=True,
    )
    s = host.scalings
    scaled = join_uvT(s.u.scale(traj.u), s.v.scale(traj.v), s.T.scale(traj.T))
    return torch.movedim(scaled, 0, -2)  # (S, Nt, 3Nz)


def make_embedded_loss_fn(host: HostColumnModel, batch: EmbeddedBatch, loss_scalings: LossChannels,
                          config: NDETrainConfig) -> Callable:
    """Six-channel loss over all simulations at once; ``loss_fn(nns) -> (total, channels)``."""

    def loss_fn(nns):
        pred = _solve_embedded(host, nns, batch, config)
        channels = nde_loss_channels(pred, batch.targets, host.Nz, config.train_gradient)
        scaled = apply_loss_scalings(channels, loss_scalings)
        return scaled.total(), scaled

    return loss_fn


def determine_embedded_loss_scalings(host: HostColumnModel, nns: FluxNNs, batch: EmbeddedBatch,
                                     config: NDETrainConfig) -> LossChannels:
    """Fixed ``gradient_scaling`` weights, or auto-balanced from a pre-solve against the host (no autograd)."""
    if config.training_fractions is None:
        return LossChannels.ones(config.gradient_scaling if config.train_gradient else 0.0,
                                 batch.state0.T.device)
    with torch.no_grad():
        pred = _solve_embedded(host, nns, batch, config)
        channels = nde_loss_channels(pred, batch.targets, host.Nz, config.train_gradient)
        return calculate_loss_scalings(channels, config.training_fractions, config.train_gradient)


def _scalar_constant(x, name: str):
    """A suite-batched physical constant reduced to a 0-d tensor, refusing members that disagree."""
    x = torch.as_tensor(x)
    arr = x.detach().cpu().numpy().reshape(-1)
    if not np.allclose(arr, arr[0]):
        raise ValueError(f"free-convection suite members disagree on {name}: {arr}")
    return x.reshape(-1)[0]


def host_from_fc_suite(model, ds: ColumnTimeSeries) -> HostColumnModel:
    """The FC training host: :func:`host_for_free_convection` over the suite's per-sim surface and bottom BCs."""
    return host_for_free_convection(
        model, _scalar_constant(ds.f, "f"), _scalar_constant(ds.g, "g"), _scalar_constant(ds.alpha, "alpha"),
        Ftheta=ds.theta_top, dTdz_bottom=ds.theta_bottom,
    )


def embedded_fc_training_tensors(ds: ColumnTimeSeries, T_scaling, tsteps) -> EmbeddedBatch:
    """FC a-posteriori tensors: dimensional initial states (u = v = 0) plus SCALED ``(S, Nt, Nz)`` T targets,
    the truth :func:`train.nde.train_free_convection_nde` fits."""
    idx, i0, t = _window(ds, tsteps)
    targets = T_scaling.scale(ds.T.index_select(-2, idx))
    zeros = torch.zeros_like(ds.T[..., i0, :])
    return EmbeddedBatch(state0=HostColumnState(u=zeros, v=zeros, T=ds.T[..., i0, :]), targets=targets, t=t)


def _solve_embedded_fc(host: HostColumnModel, nn, batch: EmbeddedBatch, config: NDETrainConfig):
    """Scaled ``(S, Nt, Nz)`` temperature trajectory of the FC host column."""
    n_save = batch.t.shape[0] - 1
    traj = run_embedded_column(
        host, FluxNNs(uw=None, vw=None, wT=nn), batch.state0, _host_dt(batch, n_save, config.n_substeps), n_save,
        config.n_substeps,
        tridiag_backend=resolve_tridiag_backend(config.tridiag_backend, n_save * config.n_substeps,
                                                batch.state0.T.device),
        t0=batch.t[0], remat=True,
    )
    return torch.movedim(host.scalings.T.scale(traj.T), 0, -2)


def make_embedded_fc_loss_fn(host: HostColumnModel, batch: EmbeddedBatch, config: NDETrainConfig) -> Callable:
    """Plain temperature MSE in scaled space (``free_convection/src/training.jl:55-62``); ``(total, channels)``."""

    def loss_fn(nn):
        pred = _solve_embedded_fc(host, nn, batch, config)
        total = torch.mean((pred - batch.targets) ** 2)
        zero = torch.zeros_like(total)
        return total, LossChannels(u=zero, v=zero, T=total, dudz=zero, dvdz=zero, dTdz=zero)

    return loss_fn


def _stages(stages, tsteps, config: NDETrainConfig, where: str):
    if stages is not None:
        return stages
    if tsteps is None:
        raise ValueError(f"{where}: pass tsteps or stages")
    return [CurriculumStage(tsteps=tsteps, maxiters=config.maxiters, learning_rate=config.learning_rate)]


def train_embedded_free_convection(model, nn, ds: ColumnTimeSeries, config: NDETrainConfig, tsteps=None,
                                   stages: Sequence[CurriculumStage] | None = None, callback=None,
                                   checkpoint_dir: str | None = None, resume_from: str | None = None, project=None):
    """Train the FC heat-flux NN through the embedded conv-adj host column; returns ``(nn, history)``.

    The host is the one ``evaluate-fc --embedded`` scores
    (``oceananigans_nn.jl:42-211``), built by :func:`host_from_fc_suite`.
    ``model`` is a :class:`~..models.free_convection.FreeConvectionModel`
    (its scalings, kappa and base closure). The stages run on
    :func:`~..train.nde.train_stages` (checkpoints after each stage to
    ``checkpoint_dir``).
    """
    host = host_from_fc_suite(model, ds)

    def stage_loss_fn(i, stage, stage_config, nn):
        batch = embedded_fc_training_tensors(ds, model.T_scaling, stage.tsteps)
        _require_uniform(batch.t, f"train_embedded_free_convection stage {i}")
        return make_embedded_fc_loss_fn(host, batch, stage_config)

    return train_stages(nn, _stages(stages, tsteps, config, "train_embedded_free_convection"), stage_loss_fn, config,
                        callback, checkpoint_dir, resume_from, project)


def train_embedded_wind_mixing(model: WindMixingModel, nns: FluxNNs, ds: ColumnTimeSeries, config: NDETrainConfig,
                               tsteps=None, stages: Sequence[CurriculumStage] | None = None, callback=None,
                               checkpoint_dir: str | None = None, resume_from: str | None = None):
    """Train the flux NNs through the embedded host column (a-posteriori); returns ``(nns, history)``.

    ``ds`` is the stacked training suite ``(S, Nt, ...)``; ``tsteps`` the
    window (ignored when ``stages`` drive a curriculum). From ``config``:
    ``n_substeps`` (host steps per save interval), ``tridiag_backend``, the
    optimizer, learning rate and iterations, and the six-channel loss
    settings; ``method``, ``fast_assembly`` and ``pack_nns`` do not apply
    (the host stepper is its own implicit, dimensional scheme). The stages
    run on :func:`~..train.nde.train_stages`.
    """
    host = host_from_suite(model, ds)

    def stage_loss_fn(i, stage, stage_config, nns):
        batch = embedded_training_tensors(ds, model.scalings, stage.tsteps)
        _require_uniform(batch.t, f"train_embedded_wind_mixing stage {i}")
        loss_scalings = determine_embedded_loss_scalings(host, nns, batch, stage_config)
        return make_embedded_loss_fn(host, batch, loss_scalings, stage_config)

    return train_stages(nns, _stages(stages, tsteps, config, "train_embedded_wind_mixing"), stage_loss_fn, config,
                        callback, checkpoint_dir, resume_from)
