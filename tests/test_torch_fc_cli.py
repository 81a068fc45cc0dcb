"""Port parity: the ``train-fc-nde``, ``train-nn`` and ``evaluate-fc`` commands against the JAX package's.

The counterparts of ``tests/test_cli.py::test_train_fc_nde`` and
``test_train_nn_checkpoint`` at their ``TINY`` sizes, with ``--device cpu``.
Each command runs in both packages on the same tiny suite from the same
initial weights: the port's suite loader and initializers are replaced, for
the run, by the JAX package's (data through numpy, closures through
``bridge.from_reference``; ``train-nn`` replays the JAX command's key
splits). The loss histories (flux pre-training, every NDE iteration, each
flux regression) and the saved weights are compared, and each package loads
the other's run directory.

Both commands work in float32. Tolerances: flux regression ``REG_RTOL``
(the same f32 products summed in other orders), NDE losses and weights
after the curriculum ``NDE_RTOL`` (the two packages round ``dt / dz^2``
and the closure's sums differently, a few ulps per substep carried through
the split solves, their IFT gradients and adam). ``evaluate-fc`` runs in
float64 on the stored JAX run's own truth (see ``EVAL_RTOL``).
"""

import dataclasses
import importlib
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.data import free_convection as jfcd
from climateparameterizations_jl_tpu.train import nn as jnn
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.closures import mlp as tmlp
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.data import free_convection as tfcd
from climateparameterizations_jl_tpu_torch.train import nn as tnn
from test_torch_eval_profile import _f64, jit_reference_harness

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
REPO = Path(__file__).resolve().parents[1]
TINY = ["--nz", "16", "--n-save", "12", "--dt-save", "600"]
FC = ["train-fc-nde", "--sim-ids", "1,4,8", *TINY, "--pretrain-epochs", "3", "--conv", "2", "--spatial-causality",
      "hard", "--curriculum", "6,13:2", "--maxiters", "2", "--n-substeps", "2", "--lr", "1e-3"]
NN = ["train-nn", "--sims", "strong_wind", *TINY, "--epochs", "5", "--hidden", "32", "--fluxes", "uw,vw,wT"]
REG_RTOL = 1e-5
NDE_RTOL = 1e-4


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        name: None if getattr(ds_jax, name) is None else torch.tensor(np.asarray(getattr(ds_jax, name)))
        for name in (f.name for f in dataclasses.fields(tc.ColumnTimeSeries))
    })


def _history(out):
    with open(os.path.join(out, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def _meta(out):
    with open(os.path.join(out, "meta.json")) as f:
        return json.load(f)


def _recording(fn, record):
    """``fn`` that appends the loss history it returns to ``record``."""
    def wrapper(*args, **kw):
        nn, history = fn(*args, **kw)
        record.append(history)
        return nn, history
    return wrapper


def _close(got, want, rtol):
    """Each pair of ``got`` and ``want`` within ``rtol`` relative and ``rtol`` of the entry's scale."""
    for g, w in zip(got, want, strict=True):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(float(np.abs(w).max()), 1e-30))


@pytest.fixture(scope="module")
def fc_runs(tmp_path_factory):
    """``train-fc-nde`` in both packages: ``(jax_out, port_out, jax pretrain history, port pretrain history)``."""
    root = tmp_path_factory.mktemp("fc")
    jout, tout = str(root / "jax"), str(root / "port")
    pre = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jnn, "train_flux_nn", _recording(jnn.train_flux_nn, pre["jax"]))
        assert jcli.main([*FC, "--output", jout]) == 0

        def jax_suite(ids, data_dir=None, Nz=32, Nz_les=128, n_save=96, dt_save=600.0, source="auto",
                      les_cache_dir=None, device=None):
            return [_to_torch(jfcd.load_free_convection_simulation(i, data_dir, Nz, Nz_les, n_save, dt_save, source,
                                                                   les_cache_dir)) for i in ids]

        def jax_conv(gen, Nz, conv_width=2, activation="relu", dtype=torch.float32, device=None):
            return from_reference(jmlp.free_convection_conv_mlp(jax.random.PRNGKey(0), Nz, conv_width, activation),
                                  device)

        mp.setattr(tfcd, "load_free_convection_suite", jax_suite)
        mp.setattr(tmlp, "free_convection_conv_mlp", jax_conv)
        mp.setattr(tnn, "train_flux_nn", _recording(tnn.train_flux_nn, pre["port"]))
        assert tcli.main(["--device", "cpu", *FC, "--output", tout]) == 0
    finally:
        mp.undo()
    return jout, tout, pre["jax"], pre["port"]


def test_train_fc_nde_matches_jax(fc_runs):
    jout, tout, jpre, tpre = fc_runs
    assert len(jpre) == len(tpre) == 1 and len(tpre[0]) == 3
    _close(tpre[0], jpre[0], REG_RTOL)
    jh, th = _history(jout), _history(tout)
    assert [h["iter"] for h in th] == [h["iter"] for h in jh] == [0, 1, 0, 1]
    for t, j in zip(th, jh):
        assert set(t) == set(j)
        _close([t[k] for k in sorted(t)], [j[k] for k in sorted(j)], NDE_RTOL)
    jm, tm = _meta(jout), _meta(tout)
    assert set(tm) == set(jm)
    for key in ("command", "sim_ids", "conv", "ensemble", "base_closure", "arch"):
        assert tm[key] == jm[key], key
    assert tm["arch"]["conv_width"] == 2
    for var in ("T", "wT"):
        for stat in ("mu", "sigma"):
            assert tm["scalings"][var][stat] == pytest.approx(jm["scalings"][var][stat], rel=1e-6)


def test_fc_run_directories_load_in_both_packages(fc_runs):
    jout, tout, _, _ = fc_runs
    jnn_j, _ = jcli._load_fc_nn(jout)
    jnn_t, _ = jcli._load_fc_nn(tout)
    tnn_t, meta = tcli._load_fc_nn(tout, "cpu")
    tnn_j, _ = tcli._load_fc_nn(jout, "cpu")
    assert isinstance(tnn_t, tmlp.ConvMLP) and meta["arch"]["conv_width"] == 2
    for a, b in zip(tmlp._leaves(tnn_j), jax.tree_util.tree_leaves(jnn_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # the port reads JAX's directory exactly
    for a, b in zip(tmlp._leaves(tnn_t), jax.tree_util.tree_leaves(jnn_t)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # and JAX reads the port's
    _close(tmlp._leaves(tnn_t), jax.tree_util.tree_leaves(jnn_j), NDE_RTOL)
    # Hard causality: every weight matrix lower-triangular after the curriculum.
    for W in tnn_t.mlp.weights:
        assert not bool(W[tmlp.spatial_causality_mask(W.shape)].any())


def test_train_fc_nde_defaults_and_refusals(tmp_path):
    out = str(tmp_path / "fc")
    assert tcli.main(["--device", "cpu", "train-fc-nde", *TINY, "--maxiters", "3", "--n-train-steps", "8",
                      "--n-substeps", "4", "--output", out]) == 0
    assert os.path.exists(os.path.join(out, "state.npz")) and len(_history(out)) == 3
    nn, meta = jcli._load_fc_nn(out)
    assert meta["arch"] == {"sizes": [16, 64, 64, 15], "activation": "relu"} and meta["sim_ids"] == [1]
    ens = str(tmp_path / "fc_ens")
    assert tcli.main(["--device", "cpu", "train-fc-nde", *TINY, "--maxiters", "2", "--n-train-steps", "6",
                      "--ensemble", "2", "--output", ens]) == 0
    stacked, ens_meta = tcli._load_fc_nn(ens, "cpu")
    assert ens_meta["ensemble"] == 2 and ens_meta["arch"] == meta["arch"]
    assert stacked.weights[0].shape == (2, 64, 16) and len(_history(ens)) == 2
    # --source les3d through a cache the JAX package wrote (id 1's profiles at the LES's 128 levels): the port reads
    # the JAX file, coarse-grains it as the JAX loader does, and trains on it.
    cache = str(tmp_path / "les_cache")
    jfcd.save_column_npz(os.path.join(cache, "les3d_sim1_N128_n12_dt600.npz"),
                         jfcd.load_free_convection_simulation(1, None, 128, n_save=12))
    want = jfcd.load_free_convection_simulation(1, None, 16, n_save=12, source="les3d", les_cache_dir=cache)
    got = tcli._load_fc_suite([1], 16, None, 12, 600.0, "les3d", "cpu", cache)
    for f in ("T", "wT", "t", "theta_top", "theta_bottom"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-6, atol=0)
    les = str(tmp_path / "fc_les3d")
    assert tcli.main(["--device", "cpu", "train-fc-nde", *TINY, "--source", "les3d", "--les-cache-dir", cache,
                      "--maxiters", "2", "--n-train-steps", "6", "--output", les]) == 0
    assert len(_history(les)) == 2 and all(np.isfinite(h["loss"]) for h in _history(les))


@pytest.fixture(scope="module")
def nn_runs(tmp_path_factory):
    """``train-nn`` in both packages: ``(jax_out, port_out, jax histories, port histories)``."""
    root = tmp_path_factory.mktemp("nn")
    jout, tout = str(root / "jax"), str(root / "port")
    hist = {"jax": [], "port": []}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jnn, "train_flux_nn", _recording(jnn.train_flux_nn, hist["jax"]))
        assert jcli.main([*NN, "--output", jout]) == 0
        keys = [jax.random.PRNGKey(0)]

        def jax_init(gen, sizes, activation="relu", dtype=torch.float32, scale=1.0, device=None):
            keys[0], k = jax.random.split(keys[0])  # the JAX command's split per flux
            return from_reference(jmlp.mlp_init(k, sizes, activation), device)

        mp.setattr(tcli, "_load_suite", lambda names, Nz, data_dir=None, n_save=288, dt_save=600.0, device=None:
                   _to_torch(jcli._load_suite(names, Nz, data_dir, n_save, dt_save)).to(device))
        mp.setattr(tmlp, "mlp_init", jax_init)
        mp.setattr(tnn, "train_flux_nn", _recording(tnn.train_flux_nn, hist["port"]))
        assert tcli.main(["--device", "cpu", *NN, "--output", tout]) == 0
    finally:
        mp.undo()
    return jout, tout, hist["jax"], hist["port"]


def test_train_nn_matches_jax(nn_runs):
    jout, tout, jh, th = nn_runs
    assert len(jh) == len(th) == 3
    for t, j in zip(th, jh):
        assert len(t) == 5
        _close(t, j, REG_RTOL)
    jnns, jmeta = jcli._load_nns(tout)  # JAX reads the port's directory
    tnns, tmeta = tcli._load_nns(jout, "cpu")  # and the port reads JAX's
    assert set(tmeta["arch"]) == set(jmeta["arch"]) == {"uw", "vw", "wT"}
    assert tmeta["arch"]["wT"] == {"sizes": [48, 32, 15], "activation": "relu"}
    for name in ("uw", "vw", "wT"):
        _close(jax.tree_util.tree_leaves(getattr(jnns, name)), tmlp._leaves(getattr(tnns, name)), REG_RTOL)


def test_train_nn_checkpoint(nn_runs):
    _, tout, _, _ = nn_runs
    assert os.path.exists(os.path.join(tout, "state.npz"))
    assert set(_meta(tout)["arch"]) == {"uw", "vw", "wT"} and _meta(tout)["command"] == "train-nn"


def test_train_fc_nde_ensemble_command(tmp_path, capsys):
    """``train-fc-nde --ensemble 2`` with pre-training and hard causality: the JAX command's meta; both load it."""
    argv = ["train-fc-nde", "--sim-ids", "1,4", *TINY, "--pretrain-epochs", "2", "--spatial-causality", "hard",
            "--curriculum", "6,13:2", "--maxiters", "2", "--n-substeps", "2", "--ensemble", "2"]
    tout, jout = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["--device", "cpu", *argv, "--output", tout]) == 0
    assert jcli.main([*argv, "--output", jout]) == 0
    printed = capsys.readouterr().out
    assert "[pretrain m1]" in printed
    tmeta, jmeta = _meta(tout), _meta(jout)
    assert sorted(tmeta) == sorted(jmeta) and tmeta["arch"] == jmeta["arch"] and tmeta["ensemble"] == 2
    jnn_t, _ = jcli._load_fc_nn(tout)
    tnn_j, _ = tcli._load_fc_nn(jout, "cpu")
    tnn_t, _ = tcli._load_fc_nn(tout, "cpu")
    assert jax.tree.leaves(jnn_t)[0].shape[0] == 2 and tnn_j.weights[0].shape[0] == 2
    for W in tnn_t.weights:
        assert not bool(W[:, tmlp.spatial_causality_mask(W.shape[1:])].any())
    hist = _history(tout)
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) and h["loss"] == pytest.approx(h["T"]) for h in hist)


# ``evaluate-fc`` of the flagship free-convection closure on its held-out ids, in both packages, on the truth the JAX
# command was run on: the first frames of ``runs/fc_flagship_eval/sim<i>.npz`` (its 3-D LES data, every 9,600 s),
# with each id's constants. The data and the checkpoint's weights are handed to both commands in float64 (the
# checkpoint loaders return the same weights cast up; the commands read the meta, scalings and base closure
# themselves), so each key is held to JAX within ``EVAL_RTOL`` of its scale. In float32 the two packages round the
# same solves differently, and a diagnosed flux of a nearly mixed layer (K dT/dz) can move by a tenth of its scale.
FC_FLAGSHIP, FC_FLAGSHIP_EVAL = REPO / "runs" / "fc_flagship", REPO / "runs" / "fc_flagship_eval"
FC_EVAL_FRAMES, EVAL_RTOL = 9, 1e-8
FC_EVAL_ARGV = ["evaluate-fc", "--checkpoint", str(FC_FLAGSHIP), "--sim-ids", "8,9", "--nz", "32", "--n-save", "8",
                "--dt-save", "9600", "--n-eval-steps", str(FC_EVAL_FRAMES), "--eval-stride", "1", "--n-substeps", "8",
                "--kpp-n-substeps", "16"]


def _stored_fc_truth(i: int):
    """Id ``i``'s first frames of the JAX run's truth as a JAX dataset, with the id's constants."""
    Qb, stratification = jfcd._SYNTHETIC_PARAMS[i]
    with np.load(FC_FLAGSHIP_EVAL / f"sim{i}.npz") as ev:
        T, wT, t = (ev[k][:FC_EVAL_FRAMES] for k in ("truth_T", "truth_wT", "t"))
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    g, alpha = 9.80665, 2e-4
    return jc.ColumnTimeSeries(
        u=f32(np.zeros_like(T)), v=f32(np.zeros_like(T)), T=f32(T), uw=f32(np.zeros_like(wT)),
        vw=f32(np.zeros_like(wT)), wT=f32(wT), t=f32(t), H=f32(256.0), f=f32(1e-4), g=f32(g), alpha=f32(alpha),
        beta=f32(8e-4), u_top=f32(0.0), theta_top=f32(Qb / (alpha * g)), theta_bottom=f32(stratification),
        diurnal_amplitude=f32(0.0))


def _stored_truth_cache(tmp_path, stored: dict) -> str:
    """A ``--les-cache-dir`` holding ``stored`` (id -> JAX dataset) under the les3d cache names of ``FC_EVAL_ARGV``'s
    save grid, written by the JAX package's ``save_column_npz``."""
    cache = str(tmp_path / "les_cache")
    for i, ds in stored.items():
        jfcd.save_column_npz(os.path.join(cache, f"les3d_sim{i}_N128_n8_dt9600.npz"), ds)
    return cache


def same_npz_files(got_dir, want_dir, names, rtol, ri_rtol=None):
    """Each ``.npz`` of ``names`` in ``got_dir`` has the keys and shapes of ``want_dir``'s, each value within
    ``rtol`` (a Richardson-number channel within ``ri_rtol`` where given)."""
    for name in names:
        with np.load(os.path.join(got_dir, name)) as got, np.load(os.path.join(want_dir, name)) as want:
            assert sorted(got.files) == sorted(want.files), name
            for k in want.files:
                assert got[k].shape == want[k].shape, (name, k)
                _close([got[k]], [want[k]], ri_rtol if ri_rtol is not None and k.endswith("_Ri") else rtol)


def test_evaluate_fc_command(tmp_path, capsys):
    """``evaluate-fc --embedded --netcdf`` equals the JAX command on the same truth and checkpoint: every npz value,
    the summary, the file names (the loss-matrix figure included) and each id's NetCDF pair: the port's, read back
    by its reader, equals its npz bit for bit, and where h5py is installed (the JAX writer's) it equals the JAX
    command's."""
    from climateparameterizations_jl_tpu_torch.data.netcdf import read_netcdf

    embedded = ["--embedded", "--netcdf"]
    jax_has_h5py = importlib.util.find_spec("h5py") is not None  # the JAX writer's; the port writes with its own code
    jax_embedded = embedded if jax_has_h5py else ["--embedded"]
    stored = {i: _f64(_stored_fc_truth(i)) for i in (8, 9)}
    nn, meta = jcli._load_fc_nn(str(FC_FLAGSHIP))
    nn = _f64(nn)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_harness(mp)
        mp.setattr(jcli, "_load_fc_nn", lambda directory: (nn, meta))
        mp.setattr(tcli, "_load_fc_nn", lambda directory, device=None: (from_reference(nn, device, torch.float64),
                                                                          meta))
        mp.setattr(jfcd, "load_free_convection_simulation", lambda i, *a, **k: stored[i])
        assert jcli.main([*FC_EVAL_ARGV, *jax_embedded, "--output", jout]) == 0
        # --source les3d reads the same truth from float64 cache files that the JAX package wrote.
        cache = _stored_truth_cache(tmp_path, stored)
        assert tcli.main(["--device", "cpu", *FC_EVAL_ARGV, "--embedded", "--source", "les3d", "--les-cache-dir",
                          cache, "--output", tout + "_les3d"]) == 0
        mp.setattr(tfcd, "load_free_convection_suite", lambda ids, *a, **k: [_to_torch(stored[i]) for i in ids])
        assert tcli.main(["--device", "cpu", *FC_EVAL_ARGV, *embedded, "--output", tout]) == 0
    capsys.readouterr()
    sim_dirs = [] if jax_has_h5py else ["sim8", "sim9"]
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout) + sim_dirs) and "loss_matrix.png" in os.listdir(tout)
    same_npz_files(tout, jout, ["sim8.npz", "sim9.npz"], EVAL_RTOL)
    same_npz_files(tout + "_les3d", jout, ["sim8.npz", "sim9.npz"], EVAL_RTOL)
    with np.load(os.path.join(tout, "sim8.npz")) as ev:
        assert ev["embedded_T"].shape == (FC_EVAL_FRAMES, 32) and ev["embedded_wT"].shape == (FC_EVAL_FRAMES, 33)
    with open(os.path.join(tout, "summary.json")) as f, open(os.path.join(jout, "summary.json")) as g:
        got, want = json.load(f), json.load(g)
    assert list(got) == list(want) == ["nde", "conv_adj", "kpp", "tke", "embedded", "embedded_baseline"]
    _close([got[k] for k in want], [want[k] for k in want], EVAL_RTOL)
    for i in (8, 9):
        with np.load(os.path.join(tout, f"sim{i}.npz")) as ev:
            for name, want in (("oceananigans_convective_adjustment.nc", {"T": ev["embedded_baseline_T"]}),
                               ("oceananigans_neural_network.nc", {"T": ev["embedded_T"], "wT": ev["embedded_wT"]})):
                variables, coords, attrs = read_netcdf(os.path.join(tout, f"sim{i}", name))
                assert sorted(variables) == sorted(want) and int(attrs["simulation_id"]) == i
                for k, v in want.items():
                    np.testing.assert_array_equal(variables[k][1], v, err_msg=f"sim{i} {name} {k}")
                np.testing.assert_array_equal(coords["time"], ev["t"])
    for i in (8, 9) if jax_has_h5py else ():
        for name in ("oceananigans_convective_adjustment.nc", "oceananigans_neural_network.nc"):
            (gv, gc, ga), (wv, wc, wa) = (read_netcdf(os.path.join(d, f"sim{i}", name)) for d in (tout, jout))
            assert sorted(gv) == sorted(wv) and sorted(gc) == sorted(wc) and int(ga["simulation_id"]) == i
            for k in wv:
                assert gv[k][0] == wv[k][0]
                _close([gv[k][1]], [wv[k][1]], EVAL_RTOL)
            for k in wc:
                _close([gc[k]], [wc[k]], EVAL_RTOL)
    argv = ["--device", "cpu", *FC_EVAL_ARGV]
    with pytest.raises(SystemExit, match="requires --embedded"):
        tcli.main([*argv, "--netcdf", "--output", str(tmp_path / "refused")])


def test_train_embedded_fc_command(tmp_path, capsys):
    """``train-embedded-fc`` from the flagship closure equals the JAX command on the same truth: history, weights
    and meta, and after a resume from each package's train state again; also with ``--source les3d`` reading the
    same truth from the JAX package's cache files.

    Both get ids 8 and 9 of the stored JAX run's truth and the checkpoint's weights in float64 (as
    ``test_evaluate_fc_command``); every loss and weight within ``EVAL_RTOL``.
    """
    stored = {i: _f64(_stored_fc_truth(i)) for i in (8, 9)}
    nn, meta = jcli._load_fc_nn(str(FC_FLAGSHIP))
    nn = _f64(nn)
    argv = ["train-embedded-fc", "--init-from", str(FC_FLAGSHIP), "--sim-ids", "8,9", "--nz", "32", "--n-save", "8",
            "--dt-save", "9600", "--substeps", "2", "--lr", "1e-3"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_load_fc_nn", lambda directory: (nn, meta))
        mp.setattr(tcli, "_load_fc_nn", lambda directory, device=None: (from_reference(nn, device, torch.float64),
                                                                          meta))
        mp.setattr(jfcd, "load_free_convection_simulation", lambda i, *a, **k: stored[i])
        # --source les3d reads the same truth from float64 cache files that the JAX package wrote.
        assert tcli.main(["--device", "cpu", *argv, "--curriculum", "4,7", "--maxiters", "2", "--source", "les3d",
                          "--les-cache-dir", _stored_truth_cache(tmp_path, stored), "--output", tout + "_les3d"]) == 0
        mp.setattr(tfcd, "load_free_convection_suite", lambda ids, *a, **k: [_to_torch(stored[i]) for i in ids])
        for out, main, device, resume in ((jout, jcli.main, [], []), (tout, tcli.main, ["--device", "cpu"], []),
                                          (jout + "_b", jcli.main, [], ["--resume-from", tout]),
                                          (tout + "_b", tcli.main, ["--device", "cpu"], ["--resume-from", jout])):
            stages = ["--curriculum", "5", "--maxiters", "1"] if resume else ["--curriculum", "4,7", "--maxiters", "2"]
            assert main([*device, *argv, *stages, *resume, "--output", out]) == 0
    capsys.readouterr()
    for got, want in ((tout, jout), (tout + "_b", jout + "_b"), (tout + "_les3d", jout)):
        got_h, want_h = _history(got), _history(want)
        assert len(got_h) == len(want_h) and all(np.isfinite(h["loss"]) for h in got_h)
        _close([h["loss"] for h in got_h], [h["loss"] for h in want_h], EVAL_RTOL)
        same_npz_files(got, want, ["state.npz"], EVAL_RTOL)
        with open(os.path.join(got, "meta.json")) as f, open(os.path.join(want, "meta.json")) as g:
            got_m, want_m = json.load(f), json.load(g)
        assert list(got_m) == list(want_m) and got_m["arch"] == want_m["arch"] == meta["arch"]
        assert got_m["command"] == "train-embedded-fc" and got_m["sim_ids"] == [8, 9]
        for v in ("T", "wT"):
            _close([got_m["scalings"][v]["mu"], got_m["scalings"][v]["sigma"]],
                   [want_m["scalings"][v]["mu"], want_m["scalings"][v]["sigma"]], EVAL_RTOL)
