"""Port parity: the parallel layer's 1-D paths on a gloo world of 2 ranks (``parallel/sharding.py``, EKI over a mesh,
sharded checkpoints).

One world of ``WORLD = 2`` spawned ranks (``parallel/world.py::spawn_world``)
runs every case through ``tests/torch_parallel_worker.py``, which imports no
JAX: each path of ``parallel/dryrun.py`` on the JAX package's setups of
``tests/test_parallel.py`` (``make_wind_batch(S=8)``,
``make_embedded_wind_problem(8)``, ``make_embedded_fc_problem(8)``), carried
over through numpy, in float32 and float64. The JAX references run here, in
the test process, on ``make_mesh(WORLD)`` of the 8-virtual-device CPU mesh
of ``tests/conftest.py``, in float64. Tolerances:

- the port's world-2 result against its single-device run of the same
  inputs (float32; ``dryrun``'s reference: ``train/nde.py::optimizer_step``
  over the path's loss, ``solve_with_config``, ``best_kernel``,
  ``eki_calibrate`` without a mesh), at the JAX tests' tolerances for the
  same function: the data-parallel step's
  total ``rtol=1e-5`` and parameters ``rtol=1e-4, atol=1e-7`` (also the
  embedded steps, trained with sgd as there); the ensemble solvers
  ``rtol=1e-5, atol=1e-7``; the member-parallel step, the kernel search and
  EKI run the same operations on each member, grid point or rank, so they
  are held equal;
- the port's world-2 result against the JAX package's mesh-2 result
  (float64), at the port's parity tolerance for the unsharded functions:
  ``RTOL = 1e-9`` of each quantity's scale (``test_torch_training.py``,
  ``test_torch_embedded_training.py``, ``test_torch_deep_ensemble.py``). EKI
  draws its noise from ``torch.Generator`` here and ``jax.random`` there, so
  the two runs are held to reducing the same misfit;
- replicated results (parameters, losses, the Kalman ensemble) are equal on
  both ranks bit for bit.

Indivisible sizes (S, K, ``n_ensemble``) raise ``ValueError``. The sharded
checkpoint is written at world 2 (each rank its members, the replicated
closure once) and restored at world 1, both on gloo, as the JAX package's
``test_orbax_roundtrip``.
"""

import concurrent.futures
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from helpers import make_embedded_fc_problem, make_embedded_wind_problem, make_wind_batch, make_wind_model_nns
from test_torch_gp import _data

from climateparameterizations_jl_tpu.models.wind_mixing import BoundaryConditions as JBCs
from climateparameterizations_jl_tpu.parallel import sharding as jsh
from climateparameterizations_jl_tpu.train import deep_ensemble as jde
from climateparameterizations_jl_tpu.train.nde import NDETrainConfig as JConfig
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.data.containers import TrainingBatch
from climateparameterizations_jl_tpu_torch.models.wind_mixing import BoundaryConditions
from climateparameterizations_jl_tpu_torch.parallel import world
from climateparameterizations_jl_tpu_torch.train.checkpoint import _map_leaves, _tensors
from climateparameterizations_jl_tpu_torch.train.embedded import EmbeddedBatch
from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

WORLD = 2
RTOL = 1e-9
GP_RTOL = 1e-8
STEPS = ("nde_step", "embedded_step", "embedded_fc_step")
f64 = jnp.float64


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(f64) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _t(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _port_batch(jb, dtype):
    return TrainingBatch(x0=_t(jb.x0, dtype), targets=_t(jb.targets, dtype), bcs=from_reference(jb.bcs, "cpu", dtype),
                         t=_t(jb.t, dtype), tau=_t(jb.tau, dtype))


def _port_ebatch(jb, dtype):
    return EmbeddedBatch(state0=from_reference(jb.state0, "cpu", dtype), targets=_t(jb.targets, dtype),
                         t=_t(jb.t, dtype))


def _suite_inputs(dtype):
    rng = np.random.default_rng(2)
    S, E = 4, 6
    x0 = rng.normal(size=(S, E, 96)) * 0.1
    per_sim = rng.normal(size=(S,)) * 0.1
    z = np.zeros(S)
    return x0, dict(uw_bot=z, uw_top=per_sim - 0.5, vw_bot=z, vw_top=z, wT_bot=z, wT_top=z + 0.3, diurnal_amplitude=z)


def _gp_data():
    """``test_torch_gp.py::test_grid_search_matches_jax``'s problem (euclidean here): training set, targets, validation
    set and its targets."""
    x, y, xq, _ = _data(n=48, seed=4)
    xv = xq[:15]
    return x, y, xv, np.sin(xv.sum(1, keepdims=True)) * np.ones((1, 3))


def _linear_eki():
    A = np.random.default_rng(1).normal(size=(6, 2))
    return A, A @ np.array([0.5, 1.5])


def _jax_problems():
    """The JAX package's setups (float32, as its tests build them)."""
    model, nns = make_wind_model_nns()
    _, _, host, ebatch = make_embedded_wind_problem(8)
    fc_nn, fc_host, fc_batch = make_embedded_fc_problem(8)
    stacked = jde.init_ensemble(jax.random.PRNGKey(7), 4, _member)
    return dict(model=model, nns=nns, batch=make_wind_batch(8), host=host, ebatch=ebatch, fc_nn=fc_nn,
                fc_host=fc_host, fc_batch=fc_batch, stacked=stacked)


def _member(key):
    from climateparameterizations_jl_tpu.closures.mlp import wind_mixing_mlp
    from climateparameterizations_jl_tpu.models.wind_mixing import FluxNNs

    return FluxNNs(*[wind_mixing_mlp(k, 32, scale=1e-3) for k in jax.random.split(key, 3)])


def _port_setups(jp: dict, dtype, tag: str) -> dict:
    """Every path's inputs in the port, from the JAX setups, in ``dtype``."""
    conv = lambda o: from_reference(o, "cpu", dtype)  # noqa: E731
    model, nns, batch = conv(jp["model"]), conv(jp["nns"]), _port_batch(jp["batch"], dtype)
    config = NDETrainConfig(n_substeps=2, method="split")
    stacked = conv(jp["stacked"])
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import ensemble_loss_scalings

    rng = np.random.default_rng(1)
    E = 16
    x0 = _t(rng.normal(size=(E, 96)) * 0.1, dtype)
    zeros = torch.zeros(E, dtype=dtype)
    bcs = BoundaryConditions(uw_bot=zeros, uw_top=zeros - 0.5, vw_bot=zeros, vw_top=zeros, wT_bot=zeros,
                             wT_top=zeros + 0.3, diurnal_amplitude=zeros)
    sx0, sbcs = _suite_inputs(dtype)
    xg, yg, xv, yv = _gp_data()
    A, y = _linear_eki()
    At = _t(A, dtype)
    return {
        f"nde_step:{tag}": dict(model=model, nns=nns, batch=batch, config=config, optimizer="adam"),
        f"deep_ensemble_step:{tag}": dict(model=model, stacked=stacked, batch=batch, config=config, optimizer="adam",
                                          scalings=ensemble_loss_scalings(model, stacked, batch, config)),
        f"embedded_step:{tag}": dict(host=conv(jp["host"]), nns=nns, batch=_port_ebatch(jp["ebatch"], dtype),
                                     config=NDETrainConfig(n_substeps=2), optimizer="sgd"),
        f"embedded_fc_step:{tag}": dict(host=conv(jp["fc_host"]), nns=conv(jp["fc_nn"]),
                                        batch=_port_ebatch(jp["fc_batch"], dtype),
                                        config=NDETrainConfig(n_substeps=2), optimizer="sgd"),
        f"ensemble_solver:{tag}": dict(model=model, nns=nns, bcs=bcs, x0=x0, config=config, t0=0.0, dt_save=1e-3,
                                       n_save=3),
        f"suite_ensemble_solver:{tag}": dict(model=model, nns=nns, x0=_t(sx0, dtype), config=config, t0=0.0,
                                             dt_save=1e-3, n_save=3,
                                             bcs=BoundaryConditions(**{k: _t(v, dtype) for k, v in sbcs.items()})),
        f"kernel_search:{tag}": dict(x_train=_t(xg, dtype), y_train=_t(yg, dtype), x_val=_t(xv, dtype),
                                     y_val=_t(yv, dtype), z=None, kernel_ids=(1, 2, 3, 4),
                                     log_gammas=np.linspace(-1.5, 1.5, 2 * WORLD)),
        f"eki:{tag}": dict(forward=_LinearMap(At), y_obs=_t(y, dtype), priors={"a": (0.0, 1.0), "b": (0.0, 3.0)},
                           n_ensemble=8 * WORLD, n_iterations=3, noise_std=1e-2, seed=5),
    }


@dataclasses.dataclass
class _LinearMap:
    """``v -> v @ A^T`` for a ``(J, p)`` population (picklable, for the spawned ranks)."""

    A: torch.Tensor

    def __call__(self, v):
        return v @ self.A.T


def _jax_references(jp: dict) -> dict:
    """The JAX package's results on ``make_mesh(WORLD)``, float64."""
    jp = {k: _f64(v) for k, v in jp.items()}
    mesh = jsh.make_mesh(WORLD)
    out = {}
    config = JConfig(n_substeps=2, method="split")
    adam, sgd = optax.adam(1e-3), optax.sgd(1e-3)
    with mesh:
        nns_r = jsh.replicate(jp["nns"], mesh)
        step = jsh.make_sharded_nde_train_step(jp["model"], jsh.shard_training_batch(jp["batch"], mesh), config, adam)
        out["nde_step"] = _step_out(step(nns_r, adam.init(nns_r)))
        for name, nn, host, batch, fc in (("embedded_step", jp["nns"], jp["host"], jp["ebatch"], False),
                                          ("embedded_fc_step", jp["fc_nn"], jp["fc_host"], jp["fc_batch"], True)):
            h, b = jsh.shard_embedded_problem(host, batch, mesh)
            nn_r = jsh.replicate(nn, mesh)
            estep = jsh.make_sharded_embedded_train_step(h, b, JConfig(n_substeps=2), sgd, free_convection=fc)
            out[name] = _step_out(estep(nn_r, sgd.init(nn_r)))
        scalings = jde.ensemble_loss_scalings(jp["model"], jp["stacked"], jp["batch"], config)
        st = jsh.shard_ensemble_members(jp["stacked"], mesh)
        dstep = jsh.make_sharded_deep_ensemble_train_step(jp["model"], jsh.replicate(jp["batch"], mesh), config, adam,
                                                          jsh.shard_ensemble_members(scalings, mesh), mesh)
        out["deep_ensemble_step"] = _step_out(dstep(st, adam.init(st)))
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.normal(size=(16, 96)) * 0.1, f64)
    zeros = jnp.zeros((16,), f64)
    bcs = JBCs(uw_bot=zeros, uw_top=zeros - 0.5, vw_bot=zeros, vw_top=zeros, wT_bot=zeros, wT_top=zeros + 0.3,
               diurnal_amplitude=zeros)
    solver = jsh.make_sharded_ensemble_solver(jp["model"], config, mesh)
    with mesh:
        out["ensemble_solver"] = {"trajectory": np.asarray(solver(jp["nns"], bcs, x0, f64(0.0), f64(1e-3), 3))}
    sx0, sbcs = _suite_inputs(None)
    mesh2 = jsh.make_mesh_2d(WORLD, 1)
    solver2 = jsh.make_sharded_suite_ensemble_solver(jp["model"], config, mesh2)
    with mesh2:
        traj = solver2(jp["nns"], JBCs(**{k: jnp.asarray(v, f64) for k, v in sbcs.items()}), jnp.asarray(sx0, f64),
                       f64(0.0), f64(1e-3), 3)
    out["suite_ensemble_solver"] = {"trajectory": np.asarray(traj)}
    xg, yg, xv, yv = _gp_data()
    kernel, mse = jsh.sharded_kernel_search(mesh, xg, yg, xv, yv, None, kernel_ids=(1, 2, 3, 4),
                                            log_gammas=np.linspace(-1.5, 1.5, 2 * WORLD))
    out["kernel_search"] = {"mse": np.float64(mse), "gamma": np.float64(kernel.gamma)}
    from climateparameterizations_jl_tpu.train.eki import eki_calibrate

    A, y = _linear_eki()
    Aj = jnp.asarray(A, f64)
    res = eki_calibrate(lambda v: Aj @ v, jnp.asarray(y, f64), {"a": (0.0, 1.0), "b": (0.0, 3.0)},
                        key=jax.random.PRNGKey(5), n_ensemble=8 * WORLD, n_iterations=3, noise_std=1e-2, mesh=mesh)
    out["eki"] = {"misfit_history": np.asarray(res.misfit_history)}
    return out


def _step_out(result):
    new, _, total, channels = result
    return {"total": np.asarray(total), "params": np.concatenate([np.ravel(a) for a in jax.tree.leaves(new)]),
            "channels": np.asarray([channels.u, channels.v, channels.T, channels.dudz, channels.dvdz, channels.dTdz])}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jp = _jax_problems()
    setups = {**_port_setups(jp, torch.float32, "f32"), **_port_setups(jp, torch.float64, "f64")}
    ckpt = str(tmp_path_factory.mktemp("dcp") / "run")
    skeleton = {"members": _map_leaves(setups["deep_ensemble_step:f32"]["stacked"], lambda _k, x: torch.zeros_like(x)),
                "nns": _map_leaves(setups["nde_step:f32"]["nns"], lambda _k, x: torch.zeros_like(x)),
                "count": torch.zeros((), dtype=torch.int32)}

    def port():  # the spawned worlds: write at world 2, then restore at world 1
        ranks = world.spawn_world(worker.sharding_cases, WORLD, (setups, ckpt))
        return ranks, world.spawn_world(worker.restore_case, 1, (ckpt, skeleton))[0]

    # The ranks run in their own processes while JAX compiles its references here.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(port)
        jax_refs = _jax_references(jp)
        ranks, restored = spawned.result()
    return dict(ranks=ranks, paths=ranks[0]["paths"], jax=jax_refs, setups=setups, restored=restored, ckpt=ckpt)


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, (what, float(np.abs(got - want).max()) / scale)


@pytest.mark.parametrize("path", STEPS)
def test_data_parallel_step_matches_world_one(run, path):
    """World 2 against world 1 (float32): total ``rtol=1e-5``, parameters ``rtol=1e-4, atol=1e-7``."""
    rec = run["paths"][f"{path}:f32"]
    np.testing.assert_allclose(rec["sharded"]["total"], rec["unsharded"]["total"], rtol=1e-5)
    np.testing.assert_allclose(rec["sharded"]["params"], rec["unsharded"]["params"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(rec["sharded"]["channels"], rec["unsharded"]["channels"], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("path", (*STEPS, "deep_ensemble_step"))
def test_step_matches_jax_mesh(run, path):
    """World 2 against the JAX package's ``make_mesh(2)`` step (float64): ``RTOL = 1e-9`` of each quantity's scale."""
    got, want = run["paths"][f"{path}:f64"]["sharded"], run["jax"][path]
    for key in ("total", "channels", "params"):
        _close(got[key], want[key], RTOL, f"{path}.{key}")


@pytest.mark.parametrize("path", (*STEPS, "deep_ensemble_step", "kernel_search", "eki"))
def test_replicas_equal_bit_for_bit(run, path):
    """Replicated results (parameters and losses; the kernel choice; the Kalman ensemble) are the same bits on
    every rank."""
    for dtype in ("f32", "f64"):
        assert run["paths"][f"{path}:{dtype}"]["replicas_equal"] is True
    a, b = (r["paths"][f"{path}:f32"]["sharded"] for r in run["ranks"])
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def test_data_parallel_step_is_one_all_reduce_of_the_parameters(run):
    """The gradients, the loss and its six channels meet in one all_reduce of ``n_parameters + 7`` elements;
    each rank holds ``S / 2`` sims."""
    rec = run["paths"]["nde_step:f32"]
    n_params = rec["sharded"]["params"].size
    assert rec["collectives"] == [{"op": "all_reduce", "elements": n_params + 7, "count": 1}]
    assert rec["local"] == {"x0": (4, 96), "targets": (4, 5, 96)}


def test_member_parallel_step_matches_world_one(run):
    """Each rank trains its own members with no gradient collective: equal to the world-1 step, and the only
    collective is the 7-scalar member sum of the loss."""
    rec = run["paths"]["deep_ensemble_step:f32"]
    for key in ("params", "total", "channels"):
        np.testing.assert_allclose(rec["sharded"][key], rec["unsharded"][key], rtol=1e-6, atol=0, err_msg=key)
    assert rec["collectives"] == [{"op": "all_reduce", "elements": 7, "count": 1}]
    assert rec["local"]["members"][0] == 2


@pytest.mark.parametrize("path", ("ensemble_solver", "suite_ensemble_solver"))
def test_ensemble_solvers_match_world_one_and_jax(run, path):
    """Members (and sims) split, no collective: ``rtol=1e-5, atol=1e-7`` against world 1 (float32); ``RTOL``
    against the JAX mesh (float64)."""
    rec = run["paths"][f"{path}:f32"]
    np.testing.assert_allclose(rec["sharded"]["trajectory"], rec["unsharded"]["trajectory"], rtol=1e-5, atol=1e-7)
    assert rec["collectives"] == []
    _close(run["paths"][f"{path}:f64"]["sharded"]["trajectory"], run["jax"][path]["trajectory"], RTOL, path)


def test_kernel_search_matches_world_one_and_jax(run):
    """The gamma grid split over the ranks: the same choice as world 1, and the JAX mesh's within ``GP_RTOL = 1e-8``
    (``test_torch_gp.py::test_grid_search_matches_jax``); one all_gather."""
    rec = run["paths"]["kernel_search:f64"]
    for key in ("mse", "gamma", "family"):
        assert rec["sharded"][key] == rec["unsharded"][key], key
    _close(rec["sharded"]["mse"], run["jax"]["kernel_search"]["mse"], GP_RTOL, "mse")
    _close(rec["sharded"]["gamma"], run["jax"]["kernel_search"]["gamma"], GP_RTOL, "gamma")
    assert rec["collectives"] == [{"op": "all_gather", "elements": 4 * 2 * WORLD, "count": 1}]


def test_eki_over_mesh(run):
    """Each rank evaluates its members; rank 0's draws are broadcast, so world 2 equals world 1 up to the order
    of the gathered sums, and both reduce the misfit as the JAX package's mesh run does."""
    for dtype, tol in (("f32", 1e-5), ("f64", 1e-12)):
        rec = run["paths"][f"eki:{dtype}"]
        for key in ("ensemble", "theta_mean", "misfit_history"):
            np.testing.assert_allclose(rec["sharded"][key], rec["unsharded"][key], rtol=tol, atol=tol, err_msg=key)
        assert rec["sharded"]["misfit_history"][-1] < rec["sharded"]["misfit_history"][0]
    ops = {c["op"] for c in run["paths"]["eki:f32"]["collectives"]}
    assert ops == {"all_gather", "broadcast"}
    jm = run["jax"]["eki"]["misfit_history"]
    assert jm[-1] < jm[0]


@pytest.mark.parametrize("case", ["make_mesh_too_many", "batch_indivisible", "members_indivisible", "eki_indivisible"])
def test_indivisible_sizes_raise(run, case):
    """S, K and ``n_ensemble`` that do not divide over the world raise ``ValueError``; a mesh wider than the world
    raises and says how to start one."""
    msg = run["ranks"][0]["raises"][case]
    if case == "make_mesh_too_many":
        assert msg.startswith("RuntimeError") and "torchrun --nproc-per-node" in msg
    else:
        assert msg is not None and msg.startswith("ValueError"), msg


def test_ensemble_command_splits_members_over_the_world(run, tmp_path, capsys):
    """``ensemble`` in a world of 2: each rank solves 4 of the 8 members, rank 0 alone prints and writes; the
    statistics equal the one-device command's (``rtol=1e-5`` of each field's scale, float32)."""
    from climateparameterizations_jl_tpu_torch.cli import main as tcli

    printed = [r["ensemble_printed"] for r in run["ranks"]]
    assert [r["ensemble_rc"] for r in run["ranks"]] == [0, 0]
    assert json.loads(printed[0].strip().splitlines()[-1])["members"] == 8 and printed[1] == ""
    assert tcli.main(["--device", "cpu", *worker.ENSEMBLE_ARGV, "--output", str(tmp_path / "one")]) == 0
    capsys.readouterr()
    with np.load(f"{run['ckpt']}_ensemble/ensemble.npz") as got, np.load(tmp_path / "one" / "ensemble.npz") as want:
        for k in ("mean", "std", "t"):
            _close(got[k], want[k], 1e-5, k)


def test_sharded_checkpoint_restores_at_world_one(run):
    """Written at world 2 (each rank its two members, the replicated closure once), restored whole at world 1."""
    assert run["ranks"][0]["saved_local_members"][0] == 2
    got = run["restored"]
    assert got["meta"] == {"stage": "dcp"} and got["world"] == 1
    for key, setup, field in (("members", "deep_ensemble_step:f32", "stacked"), ("nns", "nde_step:f32", "nns")):
        want = _tensors(run["setups"][setup][field])
        got_leaves = _tensors(got["state"][key])
        assert len(got_leaves) == len(want) > 0
        for a, b in zip(got_leaves, want):
            assert torch.equal(a, b), key
    assert int(got["state"]["count"]) == 3
