"""Device-mesh parallelism on ``torch.distributed``: sharded NDE training, deep ensembles, column ensembles, GP search.

Port of ``climateparameterizations_jl_tpu/parallel/sharding.py``. The JAX
package annotates arrays with ``NamedSharding`` and lets GSPMD partition one
jitted program and insert the collectives. Here one process runs per device
(``parallel/world.py``), a placed tensor is the rank's local shard (a plain
tensor), and every collective is written out:

- data parallelism over simulations (:func:`make_sharded_nde_train_step`,
  :func:`make_sharded_embedded_train_step`): parameters replicated (a
  broadcast from rank 0, :func:`replicate`), the batch split
  (:func:`shard_training_batch`, :func:`shard_embedded_problem`). The loss
  is a mean over all simulations, so each rank weights its local loss by
  ``S_local / S``; the gradients, the loss and its six channels then meet in
  ONE ``all_reduce`` of ``n_parameters + 7`` elements, whatever the batch
  and the window. Adam runs the same update on every rank;
- member parallelism (:func:`make_sharded_deep_ensemble_train_step`): the
  stacked members are split, the batch replicated, and no gradient crosses
  ranks; one ``all_reduce`` of 7 scalars sums the loss and its channels
  over the members;
- forward ensembles (:func:`make_sharded_ensemble_solver`,
  :func:`make_sharded_suite_ensemble_solver` on a 2-D ``("sim", "ens")``
  mesh): each rank solves its own columns, with no collective;
- the GP kernel search (:func:`sharded_kernel_search`): each rank fits its
  slice of the gamma grid, then one ``all_gather`` of the errors.

A mesh is a ``DeviceMesh`` over the initialized world (NCCL on cards, gloo
on the CPU) or, with no process group, the one device of today's runs
(:func:`make_mesh`). Every implicit solve goes through the port's solvers,
on the card the Thomas kernel ``csrc/thomas.cu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.parallel import world
from climateparameterizations_jl_tpu_torch.train.checkpoint import _map_leaves, _tensors, load_optax_state, optax_state
from climateparameterizations_jl_tpu_torch.train.loss import LossChannels

_START_A_WORLD = ("start one with torchrun (torchrun --nproc-per-node N -m climateparameterizations_jl_tpu_torch.cli "
                  "...), parallel.world.join_world(), or parallel.world.spawn_world(fn, N)")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, axis_name: str = "batch", device=None):
    """A 1-D mesh named ``axis_name`` over the world, or one device where no process group is initialized.

    In a world of N ranks the mesh is a ``DeviceMesh`` over all of them;
    ``n_devices`` must then be ``None`` or N. With no world, ``n_devices``
    ``None`` or 1 gives ``device`` (the card unless the caller asks for the
    CPU), and more raises ``RuntimeError`` saying how to start a world.
    """
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"make_mesh needs at least one device, got n_devices={n_devices}")
    if not dist.is_initialized():
        if n_devices is not None and n_devices > 1:
            raise RuntimeError(f"make_mesh({n_devices}): no world of {n_devices} ranks is running; {_START_A_WORLD}")
        return resolve_device(device)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise RuntimeError(f"make_mesh({n_devices}) in a world of {size} ranks: a mesh spans the whole world; "
                           f"{_START_A_WORLD}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (size,), mesh_dim_names=(axis_name,))


def make_mesh_2d(n_sim: int, n_ens: int, axis_names: tuple = ("sim", "ens")):
    """2-D mesh, simulations on one axis and ensemble members on the other, over a world of ``n_sim * n_ens`` ranks.

    Rank ``r`` sits at ``(r // n_ens, r % n_ens)``.
    """
    size = dist.get_world_size() if dist.is_initialized() else 1
    if size != n_sim * n_ens:
        raise RuntimeError(f"make_mesh_2d({n_sim}, {n_ens}) needs a world of {n_sim * n_ens} ranks, not {size}; "
                           f"{_START_A_WORLD}")
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh_2d: no process group is initialized; {_START_A_WORLD}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (n_sim, n_ens), mesh_dim_names=tuple(axis_names))


def _copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy (NCCL takes contiguous buffers only)."""
    return x.detach().clone(memory_format=torch.contiguous_format)


def _block(x: torch.Tensor, dim: int, axis: world.Axis) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a contiguous copy); ``dim`` must divide by the axis."""
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"axis of {n} does not divide over {axis.size} ranks")
    k = n // axis.size
    return _copy(x.narrow(dim, axis.rank * k, k)) if axis.size > 1 else x


def _broadcast_copy(x: torch.Tensor, axis: world.Axis) -> torch.Tensor:
    """Rank 0's ``x`` in a new tensor of ``x``'s layout (a transposed weight stays transposed, so its products take
    the same path, and round alike, on every rank and in a one-device run)."""
    out = torch.empty_like(x)
    return out.copy_(world.broadcast(_copy(x), axis))


def replicate(tree, mesh):
    """Every tensor of ``tree`` broadcast from rank 0, so the replicas are equal bit for bit."""
    axis = world.axis_of(mesh)
    dev = world.device_of(mesh)
    return _map_leaves(tree, lambda _k, x: _broadcast_copy(x.to(dev), axis))


def _place(tree, n_rows: int, axis: world.Axis, dev):
    """Split the leaves whose leading dimension is ``n_rows`` over ``axis``; broadcast the rest from rank 0."""
    def place(_key, x):
        x = x.to(dev)
        if x.dim() >= 1 and x.shape[0] == n_rows:
            return _block(x, 0, axis)
        return _broadcast_copy(x, axis)

    return _map_leaves(tree, place)


def _check_divides(n: int, axis: world.Axis, what: str) -> None:
    if n % axis.size:
        raise ValueError(f"{what}={n} does not divide over the {axis.size}-rank mesh")


def shard_training_batch(batch, mesh, axis_name: str = "batch"):
    """The batch's simulation axis split over the mesh; shared leaves (save times, tau) replicated.

    Leaves whose leading dimension equals the number of simulations ``S``
    (``batch.x0.shape[0]``) become this rank's ``S / N`` rows; ``S`` not
    divisible by the mesh raises ``ValueError``.
    """
    axis = world.axis_of(mesh, axis_name if not isinstance(mesh, torch.device) else None)
    S = batch.x0.shape[0]
    _check_divides(S, axis, "simulations S")
    return _place(batch, S, axis, world.device_of(mesh))


def shard_embedded_problem(host, batch, mesh, axis_name: str = "batch"):
    """Split the simulation axis of an embedded problem: both the batch and the host's per-sim fluxes.

    Per-sim data lives in two trees, the ``EmbeddedBatch`` and the
    ``HostColumnModel`` (surface and bottom fluxes on a leading ``(S,)``
    axis); leaves whose leading dimension is ``S = batch.targets.shape[0]``
    are split, physical scalars and save times replicated. Returns
    ``(host, batch)``.
    """
    axis = world.axis_of(mesh, axis_name if not isinstance(mesh, torch.device) else None)
    S = batch.targets.shape[0]
    _check_divides(S, axis, "simulations S")
    dev = world.device_of(mesh)
    return _place(host, S, axis, dev), _place(batch, S, axis, dev)


def shard_ensemble_members(stacked, mesh, axis_name: str = "batch"):
    """This rank's block of the leading member axis of every tensor of a stacked tree (``K`` must divide)."""
    axis = world.axis_of(mesh, axis_name if not isinstance(mesh, torch.device) else None)
    dev = world.device_of(mesh)
    return _map_leaves(stacked, lambda _k, x: _block(x.to(dev), 0, axis))


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

_CHANNELS = tuple(f.name for f in dataclasses.fields(LossChannels))


def _optimizer(name: str, config, params) -> torch.optim.Optimizer:
    """``"adam"`` or ``"sgd"`` over the leaves of ``params`` at ``config.learning_rate`` (``optax.adam(lr)`` /
    ``optax.sgd(lr)``)."""
    from climateparameterizations_jl_tpu_torch.train.nde import _make_optimizer

    if name not in ("adam", "sgd"):
        raise ValueError(f"sharded steps take an elementwise optimizer (adam, sgd); got {name!r}")
    return _make_optimizer(dataclasses.replace(config, optimizer=name), params)


def _sharded_step(loss_fn, optimizer: str, config, axis: world.Axis, weight: float, n_means: int,
                  reduce_grads: bool = True):
    """``step(nns, opt_state) -> (nns, opt_state, total, channels)``: ``train/nde.py::optimizer_step`` on a copy of
    ``nns``, the ranks meeting in one all_reduce between the backward pass and the update.

    ``loss_fn(nns) -> (total, channels)`` is this rank's loss; ``weight``
    multiplies it before the backward pass (the local share of a global
    mean). An optimizer step pre-hook sums the loss and channels (and with
    ``reduce_grads`` the gradients) over ``axis``; the summed channels are
    divided by ``n_means``. With no group (one device) the step is
    ``optimizer_step`` alone. ``opt_state`` is in optax's layout (``None``: a
    fresh optimizer); the input ``nns`` are not modified.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import optimizer_step

    def step(nns, opt_state):
        params = _map_leaves(nns, lambda _k, x: x.detach().clone())
        opt = _optimizer(optimizer, config, params)
        if opt_state is not None:
            load_optax_state(opt, params, opt_state)
        local, reduced = [], []

        def weighted(p):
            total, channels = loss_fn(p)
            local.append(torch.stack([total.detach(), *(getattr(channels, n).detach() for n in _CHANNELS)]))
            return (total if weight == 1.0 else total * weight), channels

        def all_reduce(_opt, _args, _kwargs):
            leaves = _tensors(params) if reduce_grads else []
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
            stats = local[-1].to(_tensors(params)[0].dtype)
            flat = torch.cat([g.reshape(-1) for g in grads] + [stats if weight == 1.0 else stats * weight])
            world.all_reduce(flat, axis)
            offset = 0
            for p, g in zip(leaves, grads):
                p.grad = flat[offset: offset + g.numel()].view_as(g).clone()
                offset += g.numel()
            reduced.append(flat[offset:] / torch.tensor([1.0] + [float(n_means)] * len(_CHANNELS), dtype=flat.dtype,
                                                        device=flat.device))

        if axis.group is not None:
            opt.register_step_pre_hook(all_reduce)
        total, channels = optimizer_step(opt, weighted, params)
        if reduced:
            total, channels = reduced[0][0], LossChannels(**dict(zip(_CHANNELS, reduced[0][1:])))
        new = _map_leaves(params, lambda _k, x: x.detach())
        return new, optax_state(opt, params), total, channels

    return step


def make_sharded_nde_train_step(model, batch, config, optimizer, loss_scalings: LossChannels | None = None, mesh=None):
    """One data-parallel NDE training step: ``step(nns, opt_state) -> (nns, opt_state, total, channels)``.

    ``batch`` is this rank's block from :func:`shard_training_batch` on
    ``mesh`` (default: the world's 1-D mesh, or one device), ``nns``
    replicated (:func:`replicate`), ``opt_state`` in optax's layout
    (``train/checkpoint.py::optax_state_skeleton`` is ``optax.adam``'s
    ``init``; ``None`` starts fresh). ``optimizer`` is ``"adam"`` or
    ``"sgd"`` at ``config.learning_rate``. Each rank solves its own sims
    (every implicit solve on the Thomas kernel on the card), weights its
    loss by ``S_local / S``, and one ``all_reduce`` of the gradients, the
    loss and the six channels makes ``total`` and ``channels`` the global
    ones. The input ``nns`` are not modified.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import make_wind_mixing_loss_fn

    mesh = make_mesh(device=batch.x0.device) if mesh is None else mesh
    axis = world.axis_of(mesh)
    scalings = loss_scalings if loss_scalings is not None else LossChannels.ones(config.gradient_scaling,
                                                                                  batch.x0.device)
    loss_fn = make_wind_mixing_loss_fn(model, batch, scalings, config)

    return _sharded_step(loss_fn, optimizer, config, axis, 1.0 / axis.size, 1)


def make_sharded_embedded_train_step(host, batch, config, optimizer, loss_scalings: LossChannels | None = None,
                                     free_convection: bool = False, mesh=None):
    """One data-parallel a-posteriori step through the host column: ``step(nns, opt_state) -> (nns, opt_state,
    total, channels)``.

    The wind-mixing flavor steps ``train/embedded.py::make_embedded_loss_fn``
    (``nns`` a ``FluxNNs`` triple); ``free_convection=True`` steps the FC
    heat-flux loss (``nns`` one MLP). ``host`` and ``batch`` are this rank's
    blocks from :func:`shard_embedded_problem`; the reduction is
    :func:`make_sharded_nde_train_step`'s.
    """
    from climateparameterizations_jl_tpu_torch.train.embedded import make_embedded_fc_loss_fn, make_embedded_loss_fn

    dev = batch.targets.device
    mesh = make_mesh(device=dev) if mesh is None else mesh
    axis = world.axis_of(mesh)
    if free_convection:
        loss_fn = make_embedded_fc_loss_fn(host, batch, config)
    else:
        scalings = loss_scalings if loss_scalings is not None else LossChannels.ones(config.gradient_scaling, dev)
        loss_fn = make_embedded_loss_fn(host, batch, scalings, config)

    return _sharded_step(loss_fn, optimizer, config, axis, 1.0 / axis.size, 1)


def make_sharded_deep_ensemble_train_step(model, batch, config, optimizer, stacked_scalings, mesh,
                                          axis_name: str = "batch"):
    """One member-parallel deep-ensemble step: ``step(stacked_nns, opt_state) -> (stacked_nns, opt_state, total,
    mean_channels)``.

    The dual of :func:`make_sharded_nde_train_step`: the stacked
    parameters, optimizer state and ``stacked_scalings`` are this rank's
    ``K / N`` members (:func:`shard_ensemble_members`), the batch replicated.
    Each rank trains its members (``train/deep_ensemble.py::
    make_ensemble_loss_fn``, one solve per member) with no gradient
    collective; one ``all_reduce`` of 7 scalars gives the member sum of the
    loss and the member mean of the channels.
    """
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import ensemble_size, make_ensemble_loss_fn

    axis = world.axis_of(mesh, axis_name if not isinstance(mesh, torch.device) else None)
    loss_fn = make_ensemble_loss_fn(model, batch, stacked_scalings, config)
    k_local = ensemble_size(stacked_scalings)

    def summed(params):  # member-mean channels -> member sums, which the reduction adds up
        total, mean = loss_fn(params)
        if axis.group is None:
            return total, mean
        return total, LossChannels(**{n: getattr(mean, n) * k_local for n in _CHANNELS})

    return _sharded_step(summed, optimizer, config, axis, 1.0, k_local * axis.size, reduce_grads=False)


# ---------------------------------------------------------------------------
# forward ensembles
# ---------------------------------------------------------------------------


def make_sharded_ensemble_solver(model, config, mesh, axis_name: str = "batch"):
    """The forward ensemble solver: ``solve(nns, bcs, x0, t0, dt_save, n_save)`` on this rank's members.

    ``x0`` ``(E_local, 3 Nz)`` and per-member BCs are this rank's blocks
    (:func:`shard_ensemble_members`) on the mesh's device; the result is the
    local ``(n_save + 1, E_local, 3 Nz)`` trajectory of
    ``train/nde.py::solve_with_config`` with ``config``'s solver knobs, run
    without autograd: on one device the batched split solve (one Thomas
    launch per substep for all members), and no collective.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import solve_with_config

    dev = world.device_of(mesh)

    def solve(nns, bcs, x0, t0, dt_save, n_save: int):
        if x0.device != dev:
            raise ValueError(f"x0 lies on {x0.device}, the mesh on {dev}")
        with torch.no_grad():
            return solve_with_config(model, nns, bcs, x0, t0, dt_save, n_save, config)

    return solve


def make_sharded_suite_ensemble_solver(model, config, mesh):
    """Forward solver for an ``(S, E, 3 Nz)`` suite-of-ensembles block on a 2-D ``(sim, ens)`` mesh.

    ``solve(nns, bcs, x0, t0, dt_save, n_save)`` takes the whole block and
    solves this rank's ``(S / n_sim, E / n_ens)`` tile: sims over the first
    mesh axis, members over the second, per-simulation ``(S,)`` BCs over the
    sim axis only. Returns the local ``(n_save + 1, S_local, E_local, 3 Nz)``
    trajectory; no collective.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import solve_with_config

    sim, ens = (world.axis_of(mesh, n) for n in mesh.mesh_dim_names)
    dev = world.device_of(mesh)

    def solve(nns, bcs, x0, t0, dt_save, n_save: int):
        S, E = x0.shape[:2]
        _check_divides(S, sim, "simulations S")
        _check_divides(E, ens, "members E")
        x0 = _block(_block(x0.to(dev), 0, sim), 1, ens)
        bcs = _map_leaves(bcs, lambda _k, b: _block(b.to(dev), 0, sim) if b.dim() == 1 else b.to(dev))
        with torch.no_grad():
            return solve_with_config(model, nns, bcs, x0, t0, dt_save, n_save, config)

    return solve


# ---------------------------------------------------------------------------
# GP kernel search
# ---------------------------------------------------------------------------


def sharded_kernel_search(mesh, x_train, y_train, x_val, y_val, z, kernel_ids=(1, 2, 3, 4), log_gammas=None,
                          metric: str = "euclidean", log_sigma: float = 0.0, axis_name: str = "batch"):
    """GP kernel grid search with the gamma grid split over the mesh; returns ``(kernel, mse)`` as ``best_kernel``.

    The grid (default ``linspace(-1.5, 1.5, 2 N)``) is padded with its last
    value to a multiple of the mesh size; each rank fits its slice through
    ``closures/gp.py::error_per_gamma``, as ``best_kernel`` does on one
    device (every Gram on the Gram kernel ``csrc/gram.cu`` for f32 inputs on
    the card), then one ``all_gather`` of the errors and
    :func:`select_best_kernel` on every rank.
    """
    from climateparameterizations_jl_tpu_torch.closures.gp import error_per_gamma, select_best_kernel

    axis = world.axis_of(mesh, axis_name if not isinstance(mesh, torch.device) else None)
    dev = world.device_of(mesh)
    x_train = torch.as_tensor(x_train).to(dev)
    if log_gammas is None:
        log_gammas = np.linspace(-1.5, 1.5, 2 * axis.size)
    log_gammas = np.asarray(log_gammas, dtype=np.float64)
    G = log_gammas.shape[0]
    Gp = -(-G // axis.size) * axis.size
    padded = np.concatenate([log_gammas, np.full(Gp - G, log_gammas[-1])])
    n = Gp // axis.size
    mine = padded[axis.rank * n: (axis.rank + 1) * n]
    local = torch.tensor([error_per_gamma(x_train, y_train, x_val, y_val, z, kid, mine, metric, log_sigma)
                          for kid in kernel_ids], dtype=torch.float64, device=dev)  # (n_kid, n)
    errors = world.all_gather(local, axis).permute(1, 0, 2).reshape(len(kernel_ids), Gp)[:, :G].cpu().numpy()
    return select_best_kernel(dict(zip(kernel_ids, errors)), log_gammas, metric, log_sigma, x_train.dtype, device=dev)
