"""The ranks' side of the parallel-layer tests: runs in spawned gloo worlds and imports no JAX.

``tests/test_torch_parallel.py``, ``test_torch_parallel_fields.py`` and
``test_torch_collective_audit.py`` build their inputs in the test process
(the JAX package's setups carried over through numpy), spawn one world with
``parallel/world.py::spawn_world`` and call one function of this module on
every rank. Each function runs every case of its file on the world and
returns plain data (numpy arrays, shapes, logs, exception texts); the tests
read rank 0's result, and the replicas' bits where they must agree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io

import torch

from climateparameterizations_jl_tpu_torch.parallel import dryrun, sharding, world


ENSEMBLE_ARGV = ("ensemble", "--sims", "strong_wind", "--nz", "16", "--n-save", "12", "--n-members", "8", "--n-steps",
                 "4", "--n-substeps", "2")


def _raises(fn) -> str | None:
    """``"ValueError: ..."`` of what ``fn()`` raised, ``None`` if it returned."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test checks the type
        return f"{type(e).__name__}: {e}"
    return None


def _paths(setups: dict, mesh) -> dict:
    return {name: dryrun.run_path(name.split(":")[0], setup, mesh) for name, setup in setups.items()}


def sharding_cases(setups: dict, ckpt_dir: str) -> dict:
    """Every 1-D case of ``test_torch_parallel.py`` on this world, and a sharded checkpoint written to ``ckpt_dir``."""
    from climateparameterizations_jl_tpu_torch.train.checkpoint import save_checkpoint_dcp
    from climateparameterizations_jl_tpu_torch.train.eki import eki_calibrate

    torch.set_num_threads(1)
    mesh = sharding.make_mesh()
    out = {"paths": _paths(setups, mesh), "rank": world.axis_of(mesh).rank}
    batch = setups["nde_step:f32"]["batch"]
    eki = setups["eki:f32"]
    out["raises"] = {
        "make_mesh_too_many": _raises(lambda: sharding.make_mesh(2 * world.axis_of(mesh).size)),
        "batch_indivisible": _raises(lambda: sharding.shard_training_batch(dataclasses.replace(batch, x0=batch.x0[:3]),
                                                                           mesh)),
        "members_indivisible": _raises(lambda: sharding.shard_ensemble_members(torch.zeros(3, 2), mesh)),
        "eki_indivisible": _raises(lambda: eki_calibrate(eki["forward"], eki["y_obs"], eki["priors"], mesh=mesh,
                                                          n_ensemble=2 * world.axis_of(mesh).size + 1,
                                                          n_iterations=1)),
    }
    # The member-sharded deep ensemble and a replicated closure in one checkpoint.
    de = setups["deep_ensemble_step:f32"]
    state = {"members": sharding.shard_ensemble_members(de["stacked"], mesh), "nns": setups["nde_step:f32"]["nns"],
             "count": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint_dcp(ckpt_dir, state, {"stage": "dcp"}, mesh=mesh, sharded=("['members']",))
    out["saved_local_members"] = tuple(state["members"].uw.weights[0].shape)
    # The ensemble command in this world: each rank its members, rank 0 alone writes and prints.
    from climateparameterizations_jl_tpu_torch.cli import main as cli

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out["ensemble_rc"] = cli.main(["--device", "cpu", *ENSEMBLE_ARGV, "--output", f"{ckpt_dir}_ensemble"])
    out["ensemble_printed"] = printed.getvalue()
    return out


def restore_case(ckpt_dir: str, skeleton) -> dict:
    """Restore ``ckpt_dir`` into the whole ``skeleton`` on a world of one rank."""
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_checkpoint_dcp

    mesh = sharding.make_mesh()
    state, meta = load_checkpoint_dcp(ckpt_dir, skeleton, mesh=mesh, sharded=("['members']",))
    return {"state": state, "meta": meta, "world": world.axis_of(mesh).size}


def field_cases(setups: dict) -> dict:
    """The LES, gyre and 2-D-mesh cases of ``test_torch_parallel_fields.py`` on this world."""
    from climateparameterizations_jl_tpu_torch.parallel.gyre_sharding import (
        make_gyre_mesh,
        make_sharded_gyre_stepper,
        run_double_gyre_sharded,
    )
    from climateparameterizations_jl_tpu_torch.parallel.les_sharding import make_les_mesh, make_sharded_les_stepper

    torch.set_num_threads(1)
    mesh = sharding.make_mesh()
    size = world.axis_of(mesh).size
    out = {"paths": _paths(setups, mesh)}
    g = setups["gyre:f64"]  # every rank's frames of its own rows; the test assembles them
    traj = run_double_gyre_sharded(g["model"], g["state"], g["dt"], n_save=2, save_every=g["n_steps"] // 2,
                                   mesh=make_gyre_mesh(), max_steps_per_dispatch=4)
    out["gyre_run"] = {f: getattr(traj, f).numpy() for f in ("u", "v", "T", "eta")}
    les, gyre = setups["les:f32"]["config"], setups["gyre:f32"]["model"]
    out["raises"] = {
        "les_ny_indivisible": _raises(lambda: make_sharded_les_stepper(dataclasses.replace(les, Ny=4 * size + 1),
                                                                       make_les_mesh(), 10.0)),
        "gyre_ny_indivisible": _raises(lambda: make_sharded_gyre_stepper(dataclasses.replace(gyre, Ny=4 * size + 1),
                                                                         make_gyre_mesh(), 1800.0)),
        "suite_indivisible": _raises(lambda: sharding.make_mesh_2d(size, 2)),
    }
    return out


def audit_cases(sims_per_rank: tuple, windows: tuple) -> dict:
    """``dryrun_multichip`` with its default setups at each ``(sims_per_rank, n_save)``: the logs and local shapes."""
    torch.set_num_threads(1)
    mesh = sharding.make_mesh()
    out = {}
    for spr, n_save in zip(sims_per_rank, windows):
        setups = dryrun.default_setups(world.device_of(mesh), world.axis_of(mesh).size, spr, n_save)
        records = dryrun.dryrun_multichip(mesh, setups, reference=False)
        out[(spr, n_save)] = {k: {"collectives": r["collectives"], "local": r["local"]} for k, r in records.items()}
    from climateparameterizations_jl_tpu_torch.train.checkpoint import _tensors

    nns = dryrun.default_setups(torch.device("cpu"), 1)["nde_step"]["nns"]
    out["n_params"] = sum(t.numel() for t in _tensors(nns))
    return out
