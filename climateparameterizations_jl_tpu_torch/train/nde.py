"""NDE training: gradients through the split solve, and the train loop.

Partial port of ``climateparameterizations_jl_tpu/train/nde.py``: the
config, the solver dispatch, the six-channel loss, the loss-scaling
pre-solve, the optimizers (``torch.optim.Adam`` / ``SGD``, whose updates
equal ``optax.adam`` / ``optax.sgd`` for the same hyperparameters) and the
train loop. The curriculum loop (``train_wind_mixing_nde``,
``CurriculumStage``), checkpoint saving and multiple shooting are later
work (``ROADMAP.md``). The JAX package jits one XLA program per step; here
the step runs eagerly, so on the card it is bound by kernel launches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.data.containers import TrainingBatch
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    WindMixingModel,
    pack_flux_nns,
    resolve_fast_assembly,
    solve_wind_mixing_nde,
    solve_wind_mixing_split,
)
from climateparameterizations_jl_tpu_torch.train.loss import (
    LossChannels,
    apply_loss_scalings,
    calculate_loss_scalings,
    nde_loss_channels,
)


@dataclasses.dataclass(frozen=True)
class NDETrainConfig:
    """Hyperparameters for one NDE training run/stage (every field of the JAX config)."""

    learning_rate: float = 1e-3
    maxiters: int = 200
    n_substeps: int = 4
    method: str = "rk4"  # "rk4" | "heun" | "euler" | "split"
    train_gradient: bool = True
    gradient_scaling: float = 5e-3
    training_fractions: dict | None = None  # {"T":, "dTdz":, "profile":}
    optimizer: str = "adam"
    pack_nns: bool = True  # fuse the 3 flux MLPs into one matmul chain
    # "scan" | "pcr" | "cuda" | "auto" for the split stepper's implicit solve
    # (resolve_tridiag_backend).
    tridiag_backend: str = "auto"
    split_unroll: int = 1  # the JAX package's substep-scan unroll; no effect here
    # "auto" resolves to "fold" for the split stepper where the configuration
    # supports it (resolve_fast_assembly); False/True/"fold" force a variant.
    fast_assembly: bool | str = "auto"
    implicit_solve_grad: bool = True  # IFT gradients through the implicit solves


def nn_parameters(nns) -> list:
    """The tensors of a :class:`FluxNNs` (or one ``MLP``), in field order."""
    if nns is None:
        return []
    if isinstance(nns, tuple) and hasattr(nns, "_fields"):
        return [p for m in nns for p in nn_parameters(m)]
    return [*nns.weights, *nns.biases]


def _make_optimizer(config: NDETrainConfig, params, lr=None) -> torch.optim.Optimizer:
    """The configured optimizer over the tensors of ``params`` (made trainable here).

    ``adam`` uses optax's defaults (``b1=0.9, b2=0.999, eps=1e-8``), for
    which ``torch.optim.Adam``'s update is optax's.
    """
    lr = config.learning_rate if lr is None else lr
    leaves = [p.requires_grad_(True) for p in nn_parameters(params)]
    if config.optimizer == "adam":
        return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if config.optimizer == "sgd":
        return torch.optim.SGD(leaves, lr=lr)
    if config.optimizer == "lbfgs":
        raise NotImplementedError("the lbfgs optimizer is not ported yet (ROADMAP.md, queue 1 item 14)")
    raise ValueError(f"unknown optimizer {config.optimizer!r}")


def _require_uniform(t, where: str):
    """Fixed-step solvers integrate on a uniform save grid: refuse non-uniform ``t``."""
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    dt = np.diff(np.asarray(t, np.float64), axis=-1)
    if dt.size and not np.allclose(dt, dt[..., :1], rtol=1e-4):
        raise ValueError(f"{where}: tsteps must be uniformly spaced (got save intervals {dt.ravel()[:4]}...)")


# The JAX package's scan/PCR crossover in inner steps per solve window,
# measured on a TPU between two XLA graphs (train/nde.py:120-131 there). The
# port's "auto" does not use it: on the card the kernel is one launch per
# solve, where the plain backends take dozens (scan: 2N per solve; pcr: five
# rounds of about 20 elementwise ops at N = 32), whatever the window length.
PCR_MIN_INNER_STEPS = 128


def resolve_tridiag_backend(backend: str, n_inner_steps: int, device=None) -> str:
    """Resolve ``"auto"``: the CUDA kernel for CUDA state, ``"scan"`` on the CPU.

    ``n_inner_steps`` is the window length the JAX package decides by; on
    the card one kernel launch per solve wins at any length (``chip_smoke.py``
    times the training step both ways). Other values pass through.
    """
    del n_inner_steps
    if backend != "auto":
        return backend
    return "cuda" if torch.device(device if device is not None else "cpu").type == "cuda" else "scan"


def solve_with_config(model: WindMixingModel, nns, bcs, x0, t0, dt_save, n_save: int, config: NDETrainConfig):
    """Dispatch to the configured solver, honoring every solver knob.

    Returns the raw ``(n_save + 1, ..., 3 Nz)`` trajectory.
    """
    fast_assembly = resolve_fast_assembly(model, nns, config.method, config.fast_assembly)
    if config.method == "split":
        return solve_wind_mixing_split(
            model, nns, bcs, x0, t0, dt_save, n_save, config.n_substeps,
            tridiag_backend=resolve_tridiag_backend(config.tridiag_backend, n_save * config.n_substeps, x0.device),
            unroll=config.split_unroll,
            fast_assembly=fast_assembly,
            implicit_solve_grad=config.implicit_solve_grad,
        )
    return solve_wind_mixing_nde(model, nns, bcs, x0, t0, dt_save, n_save, config.n_substeps, config.method,
                                 fast_assembly=fast_assembly)


def _solve(model: WindMixingModel, nns, batch: TrainingBatch, config: NDETrainConfig):
    """The batch's trajectories, ``(S, Nt, 3 Nz)``."""
    if config.pack_nns:
        # One block matmul chain instead of 9 small matmuls per RHS; the pack
        # is differentiable, so gradients reach the per-flux MLPs.
        packed = pack_flux_nns(nns)
        if packed is not None:
            nns = packed
    t = batch.t
    n_save = t.shape[0] - 1
    dt_save = float((t[-1] - t[0]) / n_save)
    if batch.t0 is not None:
        raise NotImplementedError("per-row start times (multiple shooting) are not ported yet (ROADMAP.md)")
    traj = solve_with_config(model, nns, batch.bcs, batch.x0, float(t[0]), dt_save, n_save, config)
    return torch.movedim(traj, 0, -2)


def make_wind_mixing_loss_fn(model: WindMixingModel, batch: TrainingBatch, loss_scalings: LossChannels,
                             config: NDETrainConfig) -> Callable:
    """Loss over all simulations at once; ``loss_fn(nns) -> (total, channels)``."""

    def loss_fn(nns):
        pred = _solve(model, nns, batch, config)
        channels = nde_loss_channels(pred, batch.targets, model.Nz, config.train_gradient)
        scaled = apply_loss_scalings(channels, loss_scalings)
        return scaled.total(), scaled

    return loss_fn


def determine_loss_scalings(model: WindMixingModel, nns, batch: TrainingBatch, config: NDETrainConfig) -> LossChannels:
    """Fixed ``gradient_scaling`` weights, or auto-balanced from a pre-solve.

    Parity: ``determine_loss_scalings`` (``NDE_training.jl:256-288``). The
    pre-solve runs without autograd.
    """
    if config.training_fractions is None:
        return LossChannels.ones(config.gradient_scaling if config.train_gradient else 0.0, batch.x0.device)
    with torch.no_grad():
        pred = _solve(model, nns, batch, config)
        channels = nde_loss_channels(pred, batch.targets, model.Nz, config.train_gradient)
        return calculate_loss_scalings(channels, config.training_fractions, config.train_gradient)


def _train_loop(loss_fn, params, optimizer: torch.optim.Optimizer, maxiters: int, callback=None):
    """``maxiters`` optimizer steps on ``params`` (updated in place).

    Returns ``(params, history, optimizer)``; ``history`` holds each
    iteration's channels as floats, fetched from the device once at the end
    unless a ``callback(i, total, channels, params)`` asks for them per step.
    """
    pending = []
    for i in range(maxiters):
        optimizer.zero_grad(set_to_none=True)
        total, channels = loss_fn(params)
        total.backward()
        optimizer.step()
        channels = LossChannels(**{f.name: getattr(channels, f.name).detach() for f in dataclasses.fields(channels)})
        if callback is not None:
            callback(i, float(total), channels, params)
        pending.append(channels)
    return params, [ch.as_floats() for ch in pending], optimizer
