"""The multi-device dry run: every sharded path of the parallel layer on one mesh, with its collectives.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``
(``:67-270``), which shards each path over an ``n``-device mesh and runs it
once. :func:`dryrun_multichip` runs, on every rank of a world, the paths of
:data:`PATHS` on the inputs of ``setups`` (default: :func:`default_setups`,
the JAX dry run's small shapes), and returns for each path:

- ``world`` and ``backend``;
- ``collectives``: the log of the collectives the path issued
  (``parallel/world.py::CollectiveLog.summary``: op, elements, count);
- ``launches``: the Thomas and Gram kernel launches of the path (the
  counters of ``ops/_cuda.py``; 0 on the CPU, where the plain versions
  run);
- ``seconds``: the path's wall time (the card synchronized);
- ``local``: the shapes this rank held;
- ``sharded``: the path's result assembled from every rank (numpy arrays);
- ``unsharded``: with ``reference=True``, on rank 0, the same inputs
  through the port's single-device entries (numpy arrays), to hold
  ``sharded`` against: ``train/nde.py::optimizer_step`` over the path's
  loss for the training steps, ``solve_with_config`` for the ensembles,
  ``closures/gp.py::best_kernel``, ``eki_calibrate`` without a mesh,
  ``les_step`` and ``double_gyre_step``;
- ``replicas_equal``: for the training steps, whether every rank's
  parameters are equal bit for bit.

Assembling, the reference run and the replica check happen outside the
logged and timed part. The JAX package's tests and its dry run are the
reference this module's results are held to on the CPU (gloo);
``chip_smoke.py`` runs it on NCCL at the flagship widths.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from climateparameterizations_jl_tpu_torch.parallel import world

PATHS = ("nde_step", "deep_ensemble_step", "embedded_step", "embedded_fc_step", "ensemble_solver",
         "suite_ensemble_solver", "kernel_search", "eki", "les", "gyre")


def _np(x):
    return x.detach().cpu().numpy()


def _flat(tree) -> torch.Tensor:
    from climateparameterizations_jl_tpu_torch.train.checkpoint import _tensors

    return torch.cat([t.detach().reshape(-1) for t in _tensors(tree)])


def _gathered(x: torch.Tensor, axis: world.Axis) -> torch.Tensor:
    """``(size, *x.shape)``: every rank's ``x`` (the world's default group where ``axis`` has none)."""
    if not dist.is_initialized():
        return x[None]
    return world.all_gather(x.to(world.local_device()).contiguous(), _world_axis() if axis.group is None else axis)


def _world_axis() -> world.Axis:
    if not dist.is_initialized():
        return world.Axis(None, 0, 1)
    return world.Axis(dist.group.WORLD, dist.get_rank(), dist.get_world_size())


def _replicas_equal(x: torch.Tensor) -> bool:
    blocks = _gathered(x, _world_axis())
    return all(torch.equal(blocks[0], b) for b in blocks[1:])


def _launches() -> dict:
    from climateparameterizations_jl_tpu_torch.ops import _cuda

    return {"thomas": _cuda.THOMAS.launches, "gram": _cuda.GRAM.launches}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the paths: run(setup, mesh) -> (outputs, local shapes, replicated tensor or None); ref(setup, dev) -> outputs
# ---------------------------------------------------------------------------


def _step_outputs(new, total, channels) -> dict:
    return {"total": total, "channels": torch.stack([getattr(channels, f.name) for f in dataclasses.fields(channels)]),
            "params": _flat(new)}


def _nde_step(s, mesh):
    from climateparameterizations_jl_tpu_torch.parallel.sharding import (
        make_sharded_nde_train_step,
        replicate,
        shard_training_batch,
    )

    batch = shard_training_batch(s["batch"], mesh)
    nns = replicate(s["nns"], mesh)

    def run():
        step = make_sharded_nde_train_step(s["model"], batch, s["config"], s["optimizer"], mesh=mesh)
        return step(nns, None)

    return run, {"x0": tuple(batch.x0.shape), "targets": tuple(batch.targets.shape)}


def _one_device_step(s, loss_fn, nns) -> dict:
    """One update of a copy of ``nns`` by the single-device step, ``train/nde.py::optimizer_step``."""
    from climateparameterizations_jl_tpu_torch.train.checkpoint import _map_leaves
    from climateparameterizations_jl_tpu_torch.train.nde import _make_optimizer, optimizer_step

    params = _map_leaves(nns, lambda _k, x: x.detach().clone())
    opt = _make_optimizer(dataclasses.replace(s["config"], optimizer=s["optimizer"]), params)
    total, channels = optimizer_step(opt, loss_fn, params)
    return _step_outputs(params, total, channels)


def _nde_step_ref(s, dev):
    from climateparameterizations_jl_tpu_torch.train.loss import LossChannels
    from climateparameterizations_jl_tpu_torch.train.nde import make_wind_mixing_loss_fn

    scalings = LossChannels.ones(s["config"].gradient_scaling, dev)
    return _one_device_step(s, make_wind_mixing_loss_fn(s["model"], s["batch"], scalings, s["config"]), s["nns"])


def _pick(result):
    new, _, total, channels = result
    return new, total, channels


def _deep_ensemble_step(s, mesh):
    from climateparameterizations_jl_tpu_torch.parallel.sharding import (
        make_sharded_deep_ensemble_train_step,
        replicate,
        shard_ensemble_members,
    )

    stacked = shard_ensemble_members(s["stacked"], mesh)
    scalings = shard_ensemble_members(s["scalings"], mesh)
    batch = replicate(s["batch"], mesh)

    def run():
        step = make_sharded_deep_ensemble_train_step(s["model"], batch, s["config"], s["optimizer"], scalings, mesh)
        return step(stacked, None)

    return run, {"members": tuple(stacked.uw.weights[0].shape) if hasattr(stacked, "uw") else None,
                 "x0": tuple(batch.x0.shape)}


def _deep_ensemble_step_ref(s, dev):
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import make_ensemble_loss_fn

    return _one_device_step(s, make_ensemble_loss_fn(s["model"], s["batch"], s["scalings"], s["config"]), s["stacked"])


def _embedded(free_convection: bool):
    def run_path(s, mesh):
        from climateparameterizations_jl_tpu_torch.parallel.sharding import (
            make_sharded_embedded_train_step,
            replicate,
            shard_embedded_problem,
        )

        host, batch = shard_embedded_problem(s["host"], s["batch"], mesh)
        nns = replicate(s["nns"], mesh)

        def run():
            step = make_sharded_embedded_train_step(host, batch, s["config"], s["optimizer"],
                                                    free_convection=free_convection, mesh=mesh)
            return step(nns, None)

        return run, {"targets": tuple(batch.targets.shape), "state0_T": tuple(batch.state0.T.shape)}

    def ref(s, dev):
        from climateparameterizations_jl_tpu_torch.train.embedded import make_embedded_fc_loss_fn, make_embedded_loss_fn
        from climateparameterizations_jl_tpu_torch.train.loss import LossChannels

        if free_convection:
            loss_fn = make_embedded_fc_loss_fn(s["host"], s["batch"], s["config"])
        else:
            scalings = LossChannels.ones(s["config"].gradient_scaling, dev)
            loss_fn = make_embedded_loss_fn(s["host"], s["batch"], scalings, s["config"])
        return _one_device_step(s, loss_fn, s["nns"])

    return run_path, ref


def _ensemble_solver(s, mesh):
    from climateparameterizations_jl_tpu_torch.parallel.sharding import (
        make_sharded_ensemble_solver,
        shard_ensemble_members,
    )

    x0, bcs = shard_ensemble_members((s["x0"], s["bcs"]), mesh)
    solver = make_sharded_ensemble_solver(s["model"], s["config"], mesh)
    return (lambda: solver(s["nns"], bcs, x0, s["t0"], s["dt_save"], s["n_save"])), {"x0": tuple(x0.shape)}


def _ensemble_solver_ref(s, dev):
    from climateparameterizations_jl_tpu_torch.train.nde import solve_with_config

    with torch.no_grad():
        return {"trajectory": solve_with_config(s["model"], s["nns"], s["bcs"], s["x0"], s["t0"], s["dt_save"],
                                                s["n_save"], s["config"])}


def suite_mesh_shape(world_size: int) -> tuple:
    """``(n_sim, n_ens)`` of the dry run's 2-D mesh: two members' ranks where the world allows, else one."""
    return (world_size // 2, 2) if world_size >= 4 and world_size % 2 == 0 else (world_size, 1)


def _suite_ensemble_solver(s, mesh):
    from climateparameterizations_jl_tpu_torch.parallel.sharding import (
        make_mesh_2d,
        make_sharded_suite_ensemble_solver,
    )

    mesh2 = make_mesh_2d(*suite_mesh_shape(world.axis_of(mesh).size))
    solver = make_sharded_suite_ensemble_solver(s["model"], s["config"], mesh2)
    return (lambda: solver(s["nns"], s["bcs"], s["x0"], s["t0"], s["dt_save"], s["n_save"])), {"mesh": mesh2.shape}


_suite_ensemble_solver_ref = _ensemble_solver_ref


def _kernel_search_args(s):
    return (s["x_train"], s["y_train"], s["x_val"], s["y_val"], s["z"]), dict(
        kernel_ids=s["kernel_ids"], log_gammas=s["log_gammas"], metric=s.get("metric", "euclidean"))


def _kernel_search(s, mesh):
    from climateparameterizations_jl_tpu_torch.parallel.sharding import sharded_kernel_search

    args, kw = _kernel_search_args(s)
    size = world.axis_of(mesh).size
    n_gammas = 2 * size if s["log_gammas"] is None else len(s["log_gammas"])
    return (lambda: sharded_kernel_search(mesh, *args, **kw)), {"gammas": -(-n_gammas // size)}


def _kernel_search_outputs(result) -> dict:
    kernel, mse = result
    return {"mse": torch.tensor(mse, dtype=torch.float64),
            "gamma": torch.as_tensor(kernel.gamma).detach().double().reshape(()).cpu(),
            "family": torch.tensor(float(["squared_exponential", "matern12", "matern32", "matern52",
                                          "rational_quadratic"].index(kernel.family)))}


def _kernel_search_ref(s, dev):
    from climateparameterizations_jl_tpu_torch.closures.gp import best_kernel

    args, kw = _kernel_search_args(s)
    if kw["log_gammas"] is None:  # the sharded search's default grid at this world
        kw["log_gammas"] = np.linspace(-1.5, 1.5, 2 * _world_axis().size)
    return _kernel_search_outputs(best_kernel(*args, **kw))


def _eki_kw(s):
    return dict(generator=torch.Generator().manual_seed(s["seed"]), n_ensemble=s["n_ensemble"],
                n_iterations=s["n_iterations"], noise_std=s.get("noise_std"))


def _eki(s, mesh):
    from climateparameterizations_jl_tpu_torch.train.eki import eki_calibrate

    return (lambda: eki_calibrate(s["forward"], s["y_obs"], s["priors"], mesh=mesh, **_eki_kw(s))), {
        "members": s["n_ensemble"] // world.axis_of(mesh).size}


def _eki_outputs(result) -> dict:
    return {"ensemble": result.ensemble, "theta_mean": result.theta_mean,
            "misfit_history": torch.tensor(result.misfit_history, dtype=torch.float64)}


def _eki_ref(s, dev):
    from climateparameterizations_jl_tpu_torch.train.eki import eki_calibrate

    return _eki_outputs(eki_calibrate(s["forward"], s["y_obs"], s["priors"], **_eki_kw(s)))


def _les(s, mesh):
    from climateparameterizations_jl_tpu_torch.parallel.les_sharding import (
        make_les_mesh,
        make_sharded_les_stepper,
        shard_les_state,
    )

    ymesh = make_les_mesh() if dist.is_initialized() else mesh
    state = shard_les_state(s["state"], ymesh)
    step = make_sharded_les_stepper(s["config"], ymesh, s["dt"], s["method"], n_substeps=s["n_steps"])
    return (lambda: step(state, 0.0)), {"T": tuple(state.T.shape)}


def _les_ref(s, dev):
    from climateparameterizations_jl_tpu_torch.data.les import les_step

    state, dt = s["state"], s["dt"]
    with torch.no_grad():
        for k in range(s["n_steps"]):
            state = les_step(s["config"], state, dt, s["method"], t=k * dt)
    return {f: getattr(state, f) for f in ("u", "v", "w", "T")}


def _gyre_kw(s):
    return {k: s.get(k) for k in ("nn", "T_scaling", "wT_scaling", "T_remap", "nn_stability_gate")}


def _gyre(s, mesh):
    from climateparameterizations_jl_tpu_torch.parallel.gyre_sharding import (
        make_gyre_mesh,
        make_sharded_gyre_stepper,
        shard_gyre_state,
    )

    ymesh = make_gyre_mesh() if dist.is_initialized() else mesh
    state = shard_gyre_state(s["state"], ymesh)
    step = make_sharded_gyre_stepper(s["model"], ymesh, s["dt"], n_substeps=s["n_steps"], **_gyre_kw(s))
    return (lambda: step(state)), {"T": tuple(state.T.shape), "v": tuple(state.v.shape)}


def _gyre_ref(s, dev):
    from climateparameterizations_jl_tpu_torch.embed.double_gyre import double_gyre_step

    state, kw = s["state"], _gyre_kw(s)
    with torch.no_grad():
        for _ in range(s["n_steps"]):
            state = double_gyre_step(s["model"], state, s["dt"], kw["nn"], kw["T_scaling"], kw["wT_scaling"],
                                     T_remap=kw["T_remap"], nn_stability_gate=kw["nn_stability_gate"])
    return {f: getattr(state, f) for f in ("u", "v", "T", "eta")}


# ---------------------------------------------------------------------------
# assembling the sharded results from every rank
# ---------------------------------------------------------------------------


def _assemble(name: str, out) -> tuple[dict, torch.Tensor | None]:
    """``(global outputs, replicated tensor to check or None)`` of a path's raw result on this rank."""
    wa = _world_axis()
    if name in ("nde_step", "embedded_step", "embedded_fc_step"):
        outputs = _step_outputs(*_pick(out))
        return outputs, outputs["params"]
    if name == "deep_ensemble_step":
        new, total, channels = _pick(out)
        outputs = _step_outputs(new, total, channels)
        from climateparameterizations_jl_tpu_torch.train.checkpoint import _map_leaves

        # Members are split: stack every rank's block along the member axis.
        outputs["params"] = _flat(_map_leaves(new, lambda _k, x: _gathered(x, wa).reshape(-1, *x.shape[1:])))
        return outputs, torch.stack([outputs["total"], *outputs["channels"]])
    if name == "ensemble_solver":
        blocks = _gathered(out, wa)  # (N, Nt, E_local, F)
        return {"trajectory": torch.cat(list(blocks), dim=1)}, None
    if name == "suite_ensemble_solver":
        n_sim, n_ens = suite_mesh_shape(wa.size)
        blocks = _gathered(out, wa)  # (N, Nt, S_l, E_l, F), rank = sim * n_ens + ens
        rows = [torch.cat([blocks[i * n_ens + j] for j in range(n_ens)], dim=2) for i in range(n_sim)]
        return {"trajectory": torch.cat(rows, dim=1)}, None
    if name == "kernel_search":
        outputs = _kernel_search_outputs(out)
        return outputs, torch.stack([outputs["mse"], outputs["gamma"]])
    if name == "eki":
        outputs = _eki_outputs(out)
        return outputs, outputs["ensemble"]
    if name == "les":
        return {f: torch.cat(list(_gathered(getattr(out, f), wa)), dim=0) for f in ("u", "v", "w", "T")}, None
    if name == "gyre":
        outputs = {f: torch.cat(list(_gathered(getattr(out, f), wa)), dim=0) for f in ("u", "T", "eta")}
        v = _gathered(out.v, wa)  # face blocks share their end faces
        outputs["v"] = torch.cat([*(b[:-1] for b in v), v[-1][-1:]], dim=0)
        return outputs, None
    raise ValueError(f"unknown path {name!r}")


_RUNNERS = {
    "nde_step": (_nde_step, _nde_step_ref),
    "deep_ensemble_step": (_deep_ensemble_step, _deep_ensemble_step_ref),
    "embedded_step": _embedded(False),
    "embedded_fc_step": _embedded(True),
    "ensemble_solver": (_ensemble_solver, _ensemble_solver_ref),
    "suite_ensemble_solver": (_suite_ensemble_solver, _suite_ensemble_solver_ref),
    "kernel_search": (_kernel_search, _kernel_search_ref),
    "eki": (_eki, _eki_ref),
    "les": (_les, _les_ref),
    "gyre": (_gyre, _gyre_ref),
}


def run_path(name: str, setup: dict, mesh, reference: bool = True) -> dict:
    """One path of :func:`dryrun_multichip` on ``mesh``; see the module docstring for the record."""
    prepare, ref = _RUNNERS[name]
    dev = world.device_of(mesh)
    run, local = prepare(setup, mesh)
    _sync(dev)
    before = _launches()
    t0 = time.perf_counter()
    with world.recording() as log:
        out = run()
        _sync(dev)
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _launches().items()}
    outputs, replicated = _assemble(name, out)
    record = {
        "world": dist.get_world_size() if dist.is_initialized() else 1,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "collectives": log.summary(), "launches": launches, "seconds": seconds, "local": local,
        "sharded": {k: _np(v) for k, v in outputs.items()},
        "replicas_equal": None if replicated is None else _replicas_equal(replicated),
    }
    if reference and world.is_rank0():  # the assembled result lives on every rank; rank 0 holds it to one device
        record["unsharded"] = {k: _np(v) for k, v in ref(setup, dev).items()}
    return record


def dryrun_multichip(mesh, setups: dict | None = None, paths=None, reference: bool = True) -> dict:
    """Run every sharded path on ``mesh`` (every rank calls it); returns ``{path: record}``.

    ``setups`` maps path names to their inputs (whole, unsharded, on the
    mesh's device; the paths place them); missing ones come from
    :func:`default_setups`. ``paths`` selects and orders the paths
    (default :data:`PATHS`).
    """
    names, setups = paths or PATHS, setups or {}
    if any(name not in setups for name in names):
        setups = {**default_setups(world.device_of(mesh), world.axis_of(mesh).size), **setups}
    return {name: run_path(name, setups[name], mesh, reference) for name in names}


def default_setups(device, world_size: int, sims_per_rank: int = 2, n_save: int = 4, Nz: int = 32) -> dict:
    """The JAX dry run's small inputs for every path, made from seeds on ``device``.

    ``sims_per_rank`` simulations (and members, columns) per rank,
    ``n_save`` saves per window. The LES and the gyre take four rows per
    rank (the WENO5 halo needs three).
    """
    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.closures.mlp import free_convection_mlp, wind_mixing_mlp
    from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
    from climateparameterizations_jl_tpu_torch.data.containers import TrainingBatch
    from climateparameterizations_jl_tpu_torch.data.les import LESConfig, initial_state
    from climateparameterizations_jl_tpu_torch.embed.column_model import (
        HostColumnState,
        host_for_free_convection,
        host_for_wind_mixing,
    )
    from climateparameterizations_jl_tpu_torch.embed.double_gyre import DoubleGyreModel, DoubleGyreState
    from climateparameterizations_jl_tpu_torch.models.free_convection import FreeConvectionModel
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import BoundaryConditions, FluxNNs, join_uvT
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import ensemble_loss_scalings, init_ensemble
    from climateparameterizations_jl_tpu_torch.train.embedded import EmbeddedBatch
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    dev = torch.device(device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    S = sims_per_rank * world_size
    model, nns, _, _ = benchmarks.make_setup(Nz, 1, 0, device=dev)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.normal(size=(S, 3 * Nz)) * 0.1, dtype=torch.float32, device=dev)
    zeros = torch.zeros(S, dtype=torch.float32, device=dev)
    bcs = BoundaryConditions(uw_bot=zeros, uw_top=zeros - 0.5, vw_bot=zeros, vw_top=zeros, wT_bot=zeros,
                             wT_top=zeros + 0.3, diurnal_amplitude=zeros)
    batch = TrainingBatch(x0=x0, targets=x0[:, None, :].repeat(1, n_save + 1, 1), bcs=bcs,
                          t=torch.linspace(0.0, 1e-3, n_save + 1, device=dev), tau=f32(691200.0))
    config = NDETrainConfig(n_substeps=2, method="split")
    gen = torch.Generator().manual_seed(7)
    stacked = init_ensemble(gen, S, lambda g: FluxNNs(*(wind_mixing_mlp(g, Nz, scale=1e-3, device=dev)
                                                        for _ in range(3))))
    host = host_for_wind_mixing(model, zeros - 1e-4, zeros + 5e-6, zeros + 0.01)
    T0 = torch.tensor(19.0 + 0.01 * np.arange(Nz), dtype=torch.float32, device=dev) + torch.zeros(S, Nz, device=dev)
    state0 = HostColumnState(u=torch.zeros_like(T0), v=torch.zeros_like(T0), T=T0)
    sc = model.scalings
    target = join_uvT(sc.u.scale(state0.u), sc.v.scale(state0.v), sc.T.scale(state0.T))[:, None, :]
    ebatch = EmbeddedBatch(state0=state0, targets=target.repeat(1, n_save + 1, 1),
                           t=torch.linspace(0.0, 300.0 * n_save, n_save + 1, device=dev))
    T_scaling = ZeroMeanUnitVarianceScaling(f32(19.0), f32(0.5))
    fc_model = FreeConvectionModel(H=f32(256.0), tau=f32(691200.0), T_scaling=T_scaling,
                                   wT_scaling=ZeroMeanUnitVarianceScaling(f32(0.0), f32(1e-5)), bottom_flux=f32(0.0),
                                   top_flux=f32(0.0), kappa=f32(10.0), Nz=Nz)
    fc_host = host_for_free_convection(fc_model, f32(1e-4), f32(9.80665), f32(2e-4), Ftheta=zeros + 2e-5,
                                       dTdz_bottom=zeros + 0.01)
    fc_batch = EmbeddedBatch(state0=state0, targets=T_scaling.scale(T0)[:, None, :].repeat(1, n_save + 1, 1),
                             t=ebatch.t)
    gp_rng = np.random.default_rng(1)
    Xg = torch.tensor(np.sort(gp_rng.uniform(-2, 2, size=24))[:, None], dtype=torch.float32, device=dev)
    Xv = torch.tensor(np.linspace(-1.8, 1.8, 12)[:, None], dtype=torch.float32, device=dev)
    A = torch.tensor(gp_rng.normal(size=(6, 2)), dtype=torch.float32, device=dev)
    les_config = LESConfig.default(Nx=8, Ny=4 * world_size, Nz=8, device=dev)
    gyre = DoubleGyreModel.default(Nx=8, Ny=4 * world_size, Nz=8, device=dev)
    n_sim, n_ens = suite_mesh_shape(world_size)
    x2 = torch.tensor(rng.normal(size=(n_sim, 2 * n_ens, 3 * Nz)) * 0.1, dtype=torch.float32, device=dev)
    zeros2 = torch.zeros(n_sim, dtype=torch.float32, device=dev)
    return {
        "nde_step": dict(model=model, nns=nns, batch=batch, config=config, optimizer="adam"),
        "deep_ensemble_step": dict(model=model, stacked=stacked, batch=batch, config=config, optimizer="adam",
                                   scalings=ensemble_loss_scalings(model, stacked, batch, config)),
        "embedded_step": dict(host=host, nns=nns, batch=ebatch, config=config, optimizer="adam"),
        "embedded_fc_step": dict(host=fc_host, nns=free_convection_mlp(torch.Generator().manual_seed(3), Nz,
                                                                        device=dev),
                                 batch=fc_batch, config=config, optimizer="adam"),
        "ensemble_solver": dict(model=model, nns=nns, bcs=bcs, x0=x0, config=config, t0=0.0, dt_save=1e-4,
                                n_save=n_save),
        "suite_ensemble_solver": dict(
            model=model, nns=nns, x0=x2, config=config, t0=0.0, dt_save=1e-4, n_save=2,
            bcs=BoundaryConditions(uw_bot=zeros2, uw_top=zeros2 - 0.5, vw_bot=zeros2, vw_top=zeros2, wT_bot=zeros2,
                                   wT_top=zeros2 + 0.3, diurnal_amplitude=zeros2)),
        "kernel_search": dict(x_train=Xg, y_train=torch.sin(Xg), x_val=Xv, y_val=torch.sin(Xv),
                              z=torch.zeros(1, device=dev), kernel_ids=(1,),
                              log_gammas=np.linspace(-0.5, 0.5, 2 * world_size)),
        "eki": dict(forward=lambda v: v @ A.T, y_obs=A @ f32([0.5, 1.5]), priors={"a": (0.0, 1.0), "b": (0.0, 3.0)},
                    n_ensemble=4 * world_size, n_iterations=2, noise_std=1e-2, seed=5),
        "les": dict(config=les_config, state=initial_state(les_config, torch.Generator().manual_seed(3), noise=1e-3),
                    dt=10.0, method="rk3", n_steps=1),
        "gyre": dict(model=gyre, state=DoubleGyreState.rest(gyre), dt=1800.0, n_steps=1),
    }
