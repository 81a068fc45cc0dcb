"""Port parity: the column ensemble on one card (``parallel/sharding.py``, ``ensemble``, ``bench_column_ensemble``).

On one device the JAX package's mesh-sharded ensemble solver is the batched
split solve, so the port's ``make_sharded_ensemble_solver`` must equal
``train/nde.py::solve_with_config`` on the same batch (bit for bit: the
same function). ``make_mesh`` of more than one device needs a world of that
many ranks and raises without one. The ``ensemble`` command runs in both packages on the same suite (the
JAX stand-in columns in float32, handed over through numpy), the same
deep-ensemble checkpoint (member 0 of ``runs/wm_flagship_ens4``) and the
same perturbation (the JAX command's ``jax.random`` draw, handed to the
port in place of its ``torch.Generator`` draw); ``ensemble.npz`` and the
JSON line agree to ``ENS_RTOL = 1e-4`` of each field's scale: both solve
in float32, and the packages round the split solve's products and the
closure's sums differently, a few ulps per substep (measured 2.2e-6 in std, 2.1e-7 in
the mean).
"""

import importlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri
from climateparameterizations_jl_tpu_torch.parallel import sharding
from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, solve_with_config
from test_torch_eval_profile import _column, _to_torch

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
REPO = Path(__file__).resolve().parents[1]
ENS_RTOL = 1e-4


def test_make_mesh_is_one_device():
    """With no process group the mesh is one device; a mesh of 2 needs a world of 2 and says how to start one."""
    assert sharding.make_mesh(device="cpu") == torch.device("cpu")
    assert sharding.make_mesh(1, device="cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node N"):
        sharding.make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="spawn_world"):
        sharding.make_mesh_2d(2, 1)
    with pytest.raises(ValueError):
        sharding.make_mesh(0, device="cpu")


@pytest.mark.parametrize("backend", ["scan", "cuda"])
def test_sharded_solver_equals_batched_solve(backend, monkeypatch):
    """The solver on a one-device mesh is ``solve_with_config``: equal trajectories, ``(Nt, E, 3 Nz)``; one
    stacked solve of ``(3, E, Nz)`` per substep for all members (on the CPU "cuda" runs the kernel's plain
    version)."""
    model, nns, bcs, x0 = benchmarks.column_ensemble_setup(16, 16, device="cpu")
    config = NDETrainConfig(n_substeps=3, method="split", tridiag_backend=backend)
    solver = sharding.make_sharded_ensemble_solver(model, config, sharding.make_mesh(device="cpu"))
    shapes = []
    original = tri._thomas_cuda
    monkeypatch.setattr(tri, "_thomas_cuda", lambda *a: shapes.append(tuple(a[3].shape)) or original(*a))
    got = solver(nns, bcs, x0, 0.0, 3e-5, 2)
    assert shapes == ([(3, 16, 16)] * 6 if backend == "cuda" else [])  # 2 saves x 3 substeps
    with torch.no_grad():
        want = solve_with_config(model, nns, bcs, x0, 0.0, 3e-5, 2, config)
    assert got.shape == (3, 16, 48) and not got.requires_grad
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="mesh"):
        sharding.make_sharded_ensemble_solver(model, config, torch.device("meta"))(
            nns, bcs, x0, 0.0, 3e-5, 1)


def test_ensemble_command_matches_jax(tmp_path, capsys):
    """``ensemble`` of a deep-ensemble checkpoint (member 0) on a two-sim suite, both packages, one perturbation."""
    argv = ["ensemble", "--sims", "strong_wind,strong_wind_weak_cooling", "--nz", "32", "--n-save", "12",
            "--checkpoint", str(REPO / "runs" / "wm_flagship_ens4"), "--n-members", "16", "--n-steps", "5",
            "--n-substeps", "2", "--perturbation", "0.05", "--seed", "3"]
    seeds = {"strong_wind": 0, "strong_wind_weak_cooling": 1}

    def jax_suite(names, Nz, *args, **kw):
        columns = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), _column(seeds[n], NT=12, NZ=Nz)) for n in names]
        return jc.stack_datasets(columns)

    noise = jax.random.normal(jax.random.PRNGKey(3), (16, 96), jnp.float32)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_load_suite", jax_suite)
        mp.setattr(tcli, "_load_suite", lambda names, *a, device=None, **k: _to_torch(jax_suite(names, *a)))
        mp.setattr(tcli, "_ensemble_perturbation", lambda seed, E, width, device: torch.tensor(np.asarray(noise)))
        assert jcli.main([*argv, "--output", jout]) == 0
        want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert tcli.main(["--device", "cpu", *argv, "--output", tout]) == 0
        out = capsys.readouterr().out
    got_line = json.loads(out.strip().splitlines()[-1])
    assert "runs member 0" in out
    assert {k: got_line[k] for k in ("members", "frames", "finite")} == {"members": 16, "frames": 5, "finite": True}
    assert {k: want_line[k] for k in ("members", "frames", "finite")} == {"members": 16, "frames": 5, "finite": True}
    np.testing.assert_allclose(got_line["final_mean_spread"], want_line["final_mean_spread"], rtol=ENS_RTOL)
    with np.load(os.path.join(tout, "ensemble.npz")) as g, np.load(os.path.join(jout, "ensemble.npz")) as w:
        assert sorted(g.files) == sorted(w.files) == ["mean", "std", "t"]
        for k in w.files:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k], w[k], rtol=ENS_RTOL, atol=ENS_RTOL * float(np.abs(w[k]).max()), err_msg=k)
    assert float(np.load(os.path.join(tout, "ensemble.npz"))["std"][-1].mean()) > 0.01


def test_ensemble_command_physics_only(tmp_path, capsys):
    """Without a checkpoint the run is physics only; the members come from the port's generator (seeded)."""
    argv = ["--device", "cpu", "ensemble", "--sims", "strong_wind", "--nz", "16", "--n-save", "12", "--n-members", "8",
            "--n-steps", "4", "--n-substeps", "2"]
    assert tcli.main([*argv, "--output", str(tmp_path / "a")]) == 0
    assert tcli.main([*argv, "--output", str(tmp_path / "b")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["members"] == 8 and line["frames"] == 4 and line["finite"]
    with np.load(tmp_path / "a" / "ensemble.npz") as a, np.load(tmp_path / "b" / "ensemble.npz") as b:
        assert all(np.array_equal(a[k], b[k]) for k in ("mean", "std", "t"))
        assert a["mean"].shape == (4, 48)
