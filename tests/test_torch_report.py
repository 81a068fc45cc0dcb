"""Port parity: ``eval/report.py::training_report`` against the JAX package's.

One simulation made with numpy from a seed and MLPs drawn by
``jax.random`` (``tests/test_torch_eval_profile.py``'s float64 wind case),
carried over by ``bridge.from_reference``, go through both reports with
both solvers (rk4 first, with the embedded host pair; then split), a loss
history and the comparison animation. The two write the same files and the
same ``summary.json`` keys; every ``profile_<solver>.npz`` array and every
summary value is held to ``RTOL = 1e-8`` of its scale, the tolerance
``nde_profile`` itself is held to. The training-loss figure is drawn from
the history alone and equals JAX's pixel for pixel. Without matplotlib the
port still writes every array and the summary and names the figures it did
not draw on stderr.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from climateparameterizations_jl_tpu.embed import column_model as jcm
from climateparameterizations_jl_tpu.eval import profile as jprof
from climateparameterizations_jl_tpu.eval import report as jreport
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.eval import report as treport
from test_torch_eval_profile import RTOL, _same_dict, _to_torch, _wind, jit_reference_harness

TSTEPS = np.arange(0, 12, 2)
HISTORY = [{"iter": i, "loss": 1.0 / (i + 1)} for i in range(6)]
KW = dict(history=HISTORY, n_substeps=2, gif_stride=4)


def _port_args(ds, model, nns):
    return from_reference(model, "cpu", torch.float64), from_reference(nns, "cpu", torch.float64), _to_torch(ds)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    ds, model, nns = _wind(False)
    root = tmp_path_factory.mktemp("report")
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_harness(mp)
        mp.setattr(jprof, "_solve_scaled", jax.jit(jprof._solve_scaled, static_argnames=("solver", "n_substeps")))
        mp.setattr(jcm, "run_paired_columns", jax.jit(jcm.run_paired_columns,
                                                      static_argnames=("n_save", "save_every", "tridiag_backend")))
        mp.setattr(jcm, "diagnose_host_fluxes", jax.jit(jcm.diagnose_host_fluxes))
        want = jreport.training_report(model, nns, ds, TSTEPS, str(root / "jax"), **KW)
    got = treport.training_report(*_port_args(ds, model, nns), TSTEPS, str(root / "port"), **KW)
    return root, got, want


def test_files_outputs_and_summary_match_jax(reports):
    root, got, want = reports
    assert sorted(os.listdir(root / "port")) == sorted(os.listdir(root / "jax")) == sorted(
        ["training_loss.png", "profile_rk4.npz", "profile_split.npz", "loss_rk4.png", "loss_split.png",
         "comparison.gif", "summary.json"])
    assert list(got) == list(want)
    for key in want:
        if key != "summary":
            assert got[key] == want[key].replace(str(root / "jax"), str(root / "port"))
    with open(root / "port" / "summary.json") as f, open(root / "jax" / "summary.json") as g:
        port, jax_ = json.load(f), json.load(g)
    assert list(port) == list(jax_) == list(got["summary"])
    assert {"nde_rk4", "embedded_rk4", "embedded_baseline_rk4", "nde_split", "kpp_split"} <= set(port)
    for k in jax_:
        assert port[k] == pytest.approx(jax_[k], rel=RTOL), k


@pytest.mark.parametrize("solver", ["rk4", "split"])
def test_profiles_match_jax(reports, solver):
    root, _, _ = reports
    with np.load(root / "port" / f"profile_{solver}.npz") as got, np.load(root / "jax" / f"profile_{solver}.npz") as want:
        _same_dict({k: got[k] for k in got.files}, {k: want[k] for k in want.files})
        assert ("embedded_T" in want.files) == (solver == "rk4")


def test_training_loss_figure_equals_jax(reports):
    root, _, _ = reports
    got, want = (np.asarray(Image.open(root / d / "training_loss.png")) for d in ("port", "jax"))
    assert np.array_equal(got, want)


def test_without_matplotlib_arrays_summary_and_one_stderr_line(monkeypatch, tmp_path, capsys):
    ds, model, nns = _wind(False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "climateparameterizations_jl_tpu_torch.eval.animations", raising=False)
    args = _port_args(ds, model, nns)
    with pytest.raises(RuntimeError, match="matplotlib"):
        treport.training_report(*args, TSTEPS, str(tmp_path / "a"), **KW)
    out = treport.training_report(*args, TSTEPS[:3], str(tmp_path / "b"), **{**KW, "animate": False},
                                  include_embedded=False)
    assert sorted(os.listdir(tmp_path / "b")) == ["profile_rk4.npz", "profile_split.npz", "summary.json"]
    assert sorted(out) == ["profile_rk4", "profile_split", "summary"]
    err = capsys.readouterr().err.strip().splitlines()
    assert err == ["figures not drawn (matplotlib cannot be imported): training_loss.png, loss_rk4.png, loss_split.png"]
