"""NDE training: gradients through the wind-mixing solve, curriculum, checkpoints.

Port of ``climateparameterizations_jl_tpu/train/nde.py`` for the wind-mixing
NDE: the config, the solver dispatch (per-row start times of
multiple-shooting batches included), the six-channel loss, the
loss-scaling pre-solve, the optimizers (``torch.optim.Adam`` / ``SGD``,
whose updates equal ``optax.adam`` / ``optax.sgd`` for the same
hyperparameters, and ``torch.optim.LBFGS`` with a strong-Wolfe line search
where the JAX package runs ``optax.lbfgs`` with its zoom line search: two
algorithms that reach the same minimum by other iterates), the train loop, the curriculum
(:class:`CurriculumStage`, :func:`train_wind_mixing_nde`) and resuming
from a saved train state, and the free-convection trainer
(:func:`train_free_convection_nde`). The JAX package jits one XLA program
per step; here the step runs eagerly, so on the card it is bound by kernel
launches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import _leaves
from climateparameterizations_jl_tpu_torch.data.containers import TrainingBatch
from climateparameterizations_jl_tpu_torch.models.free_convection import FreeConvectionModel, solve_free_convection_nde
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    WindMixingModel,
    pack_flux_nns,
    resolve_fast_assembly,
    solve_wind_mixing_nde,
    solve_wind_mixing_split,
)
from climateparameterizations_jl_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_optax_state,
    optax_state,
    optax_state_skeleton,
    save_checkpoint,
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


@dataclasses.dataclass(frozen=True)
class CurriculumStage:
    """One curriculum window: which tsteps to fit and for how many iterations.

    ``n_substeps`` (optional) overrides the config's substeps per save
    interval for this stage: a strided stage (the reference's ``1:9:1153``)
    scales it by the stride, or the inner physical step grows stride-fold.
    """

    tsteps: Sequence[int]
    maxiters: int
    learning_rate: float = 1e-3
    n_substeps: int | None = None


def nn_parameters(nns) -> list:
    """The tensors of a :class:`FluxNNs`, one ``MLP`` or one ``ConvMLP``, in field order."""
    if nns is None:
        return []
    if isinstance(nns, tuple) and hasattr(nns, "_fields"):
        return [p for m in nns for p in nn_parameters(m)]
    return _leaves(nns)


# optax.lbfgs keeps the last 10 curvature pairs. torch's LBFGS gives its line
# search max_eval minus one evaluations, and max_eval defaults to 5/4 of
# max_iter: with one iteration per step() that is none, so the first trial
# step is always taken. 1 + 25 restores the search's own default of 25.
LBFGS_MEMORY, LBFGS_MAX_EVAL = 10, 26


def _make_optimizer(config: NDETrainConfig, params, lr=None) -> torch.optim.Optimizer:
    """The configured optimizer over the tensors of ``params`` (made trainable here).

    ``params`` is a closure tree or one tensor. ``adam`` uses optax's
    defaults (``b1=0.9, b2=0.999, eps=1e-8``), for which
    ``torch.optim.Adam``'s update is optax's. ``lbfgs`` ignores the learning
    rate, as ``optax.lbfgs()`` does: its strong-Wolfe line search sets the
    step, one outer iteration per ``step(closure)`` (:func:`optimizer_step`),
    with optax's memory of 10 pairs.
    """
    lr = config.learning_rate if lr is None else lr
    leaves = [params] if isinstance(params, torch.Tensor) else nn_parameters(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    if config.optimizer == "adam":
        return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if config.optimizer == "sgd":
        return torch.optim.SGD(leaves, lr=lr)
    if config.optimizer == "lbfgs":
        return torch.optim.LBFGS(leaves, lr=1.0, max_iter=1, max_eval=LBFGS_MAX_EVAL, history_size=LBFGS_MEMORY,
                                 line_search_fn="strong_wolfe")
    raise ValueError(f"unknown optimizer {config.optimizer!r}")


def optimizer_step(optimizer: torch.optim.Optimizer, loss_fn, params):
    """One update of ``params``; returns ``(total, aux)`` of ``loss_fn(params)`` before it.

    Adam and SGD take one gradient; L-BFGS re-evaluates ``loss_fn`` in its
    line search through a closure, and the first evaluation (at the
    pre-update parameters) is the one returned.
    """
    if isinstance(optimizer, torch.optim.LBFGS):
        first = []

        def closure():
            optimizer.zero_grad(set_to_none=True)
            total, aux = loss_fn(params)
            total.backward()
            if not first:
                first.append((total.detach(), aux))
            return total

        optimizer.step(closure)
        return first[0]
    optimizer.zero_grad(set_to_none=True)
    total, aux = loss_fn(params)
    total.backward()
    optimizer.step()
    return total.detach(), aux


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
    # Multiple-shooting batches carry per-row start times (t0 is (S K,)); they
    # broadcast through the steppers' t0 + i dt_save, so the diurnal top BC
    # keeps each window's phase.
    t0 = batch.t0 if batch.t0 is not None else float(t[0])
    traj = solve_with_config(model, nns, batch.bcs, batch.x0, t0, dt_save, n_save, config)
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


def _train_loop(loss_fn, params, optimizer: torch.optim.Optimizer, maxiters: int, callback=None, opt_state=None,
                project=None):
    """``maxiters`` optimizer steps on ``params`` (updated in place).

    ``opt_state`` (optax layout, :func:`~..train.checkpoint.optax_state`)
    is loaded into ``optimizer`` first: the moments and step count carry
    over from an earlier stage or a saved run. L-BFGS has no optax layout
    here: it starts with no curvature pairs and returns ``opt_state=None``. ``project(params)``
    (optional) re-applies a parameter constraint in place, without
    autograd, after every optimizer update. Returns ``(params, history,
    opt_state)``; ``history`` holds each iteration's channels as floats,
    fetched from the device once at the end unless a ``callback(i, total,
    channels, params)`` asks for them per step.
    """
    if opt_state is not None:
        load_optax_state(optimizer, params, opt_state)
    pending = []
    for i in range(maxiters):
        total, channels = optimizer_step(optimizer, loss_fn, params)
        if project is not None:
            with torch.no_grad():
                project(params)
        channels = LossChannels(**{f.name: getattr(channels, f.name).detach() for f in dataclasses.fields(channels)})
        if callback is not None:
            callback(i, float(total), channels, params)
        pending.append(channels)
    state = None if isinstance(optimizer, torch.optim.LBFGS) else optax_state(optimizer, params)
    return params, [ch.as_floats() for ch in pending], state


def resume_train_state(checkpoint_dir: str, nns, optimizer: str = "adam"):
    """``(params, opt_state)`` saved by a run's ``checkpoint_dir`` (either package's).

    Parity: the reference restores ADAM's state from a previous run's
    extracted file (``wind_mixing/train_NDE_args.jl:140-146``). The JAX
    package builds the optimizer-state skeleton from an optax optimizer's
    ``init``; here ``optimizer`` names it (``"adam"`` or ``"sgd"``). Leaves
    take the dtype and device of ``nns``. L-BFGS has no optax layout here:
    its run restores the params alone and starts with no curvature pairs
    (``opt_state=None``), as each curriculum stage does.
    """
    if optimizer == "lbfgs":
        state, _ = load_checkpoint(checkpoint_dir, {"params": nns})
        return state["params"], None
    skeleton = {"params": nns, "opt_state": optax_state_skeleton(optimizer, nns)}
    state, _ = load_checkpoint(checkpoint_dir, skeleton)
    return state["params"], state["opt_state"]


def train_stages(params, stages: Sequence[CurriculumStage], stage_loss_fn: Callable, config: NDETrainConfig,
                 callback=None, checkpoint_dir: str | None = None, resume_from: str | None = None, project=None):
    """Run a curriculum: one optimizer per stage, the optimizer state carried across stages.

    ``stage_loss_fn(i, stage, stage_config, params)`` builds stage ``i``'s
    ``loss_fn`` from the params the stage starts with; ``stage_config`` is
    ``config`` with the stage's ``n_substeps`` where it sets one. Each
    stage has its own optimizer at its own learning rate, and the optimizer
    state carries across stages, as the JAX package carries optax's
    (adam's step count keeps counting, so its bias correction does not
    restart). ``resume_from`` restores params and optimizer state first;
    ``checkpoint_dir`` saves both after every stage, in the JAX package's
    format. Returns ``(params, history)``, a list of per-iteration channel
    dicts.
    """
    opt_state = None
    if resume_from is not None:
        params, opt_state = resume_train_state(resume_from, params, config.optimizer)
    history = []
    for i, stage in enumerate(stages):
        stage_config = dataclasses.replace(config, n_substeps=stage.n_substeps) if stage.n_substeps else config
        loss_fn = stage_loss_fn(i, stage, stage_config, params)
        optimizer = _make_optimizer(stage_config, params, stage.learning_rate)
        params, h, opt_state = _train_loop(loss_fn, params, optimizer, stage.maxiters, callback, opt_state, project)
        history.extend(h)
        if checkpoint_dir is not None:
            save_checkpoint(checkpoint_dir, {"params": params, "opt_state": opt_state},
                            {"stage": i, "optimizer": config.optimizer, "learning_rate": config.learning_rate})
    return params, history


def train_wind_mixing_nde(model: WindMixingModel, nns, batch: TrainingBatch, config: NDETrainConfig,
                          stages: Sequence[CurriculumStage] | None = None, full_batch_fn: Callable | None = None,
                          callback=None, checkpoint_dir: str | None = None, resume_from: str | None = None):
    """Train the three flux MLPs through the NDE solve; returns ``(nns, history)``.

    With ``stages``, ``full_batch_fn(tsteps)`` builds each stage's batch
    (curriculum training, :func:`train_stages`); without, ``batch`` is one
    stage of ``config.maxiters`` iterations. ``checkpoint_dir`` saves params
    and optimizer state after every stage; ``resume_from`` restores both
    first. ``history`` is a list of per-iteration channel dicts.
    """
    _require_uniform(batch.t, "train_wind_mixing_nde")
    if stages is None:
        stages = [CurriculumStage(tsteps=None, maxiters=config.maxiters, learning_rate=config.learning_rate)]

    def stage_loss_fn(i, stage, stage_config, nns):
        stage_batch = batch if stage.tsteps is None else full_batch_fn(stage.tsteps)
        _require_uniform(stage_batch.t, f"curriculum stage {i}")
        loss_scalings = determine_loss_scalings(model, nns, stage_batch, stage_config)
        return make_wind_mixing_loss_fn(model, stage_batch, loss_scalings, stage_config)

    return train_stages(nns, stages, stage_loss_fn, config, callback, checkpoint_dir, resume_from)


def train_free_convection_nde(model: FreeConvectionModel, nn, T0, targets, t, config: NDETrainConfig, callback=None,
                              project=None):
    """Train the heat-flux closure through the free-convection NDE solve; returns ``(nn, history)``.

    ``T0``: ``(S, Nz)`` scaled initial profiles; ``targets``: ``(S, Nt,
    Nz)`` scaled truth; ``t``: ``(Nt,)`` non-dimensional save times, uniformly
    spaced. The loss is the plain MSE over all sims and frames (reference
    ``free_convection/src/training.jl:55-62``), reported as the ``T``
    channel of :class:`LossChannels`. ``project(nn)`` (optional) re-applies
    a constraint in place after every update (the hard causality mask:
    ``closures/mlp.py::apply_spatial_causality_mask_``). The split solver's
    implicit solves run on ``resolve_tridiag_backend(config.tridiag_backend,
    ...)``: the Thomas kernel for card tensors, ``"scan"`` on the CPU. A
    fresh optimizer serves the call, as in the JAX package.
    """
    t = torch.as_tensor(t)
    _require_uniform(t, "train_free_convection_nde")
    n_save = t.shape[0] - 1
    dt_save = (t[-1] - t[0]) / n_save
    backend = resolve_tridiag_backend(config.tridiag_backend, n_save * config.n_substeps, T0.device)

    def loss_fn(nn):
        traj = solve_free_convection_nde(model, nn, T0, t[0], dt_save, n_save, config.n_substeps, config.method,
                                         tridiag_backend=backend)
        total = torch.mean((torch.movedim(traj, 0, -2) - targets) ** 2)
        zero = torch.zeros_like(total)
        return total, LossChannels(u=zero, v=zero, T=total, dudz=zero, dvdz=zero, dTdz=zero)

    nn, history, _ = _train_loop(loss_fn, nn, _make_optimizer(config, nn), config.maxiters, callback, project=project)
    return nn, history
