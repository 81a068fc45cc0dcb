"""The port's CLI on the CPU: ``catalog``, ``train-nde`` (deep ensembles too), ``extract``, ``--config``,
``calibrate-kpp``, ``evaluate`` (with ``--embedded``, ``--write-jld2`` and ``--animate``), ``train-embedded``,
``double-gyre`` and ``benchmark``, and the parser against the JAX command's.

The counterparts of ``tests/test_cli.py`` at its ``TINY`` sizes, with
``--device cpu``. Run directories are read across the packages: the port's
output loads through the JAX package's ``_load_nns`` with the metadata the
JAX command writes for the same flags, and the trained checkpoint
``runs/wm_les_shoot16`` (calibrated mPP base) loads in both with equal MLPs
and equal mPP parameters. The two commands draw their initial weights from
different generators, so their losses are not compared here
(``tests/test_torch_nde_training.py`` holds training itself to JAX).
``evaluate --embedded --write-jld2`` and ``train-embedded`` are held to the
JAX commands by value, in float64; ``double-gyre`` to the JAX command's
output on the same basin and closure. The commands write the JAX commands'
figures under their names; without matplotlib, ``evaluate``, ``evaluate-fc``
and ``train-gp`` write every array and summary and name the figures they did
not draw on stderr, and ``--animate`` exits non-zero.
"""

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.physics.mpp import MPPParameters as JMPP
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.train import checkpoint as tck
from climateparameterizations_jl_tpu_torch.train import nde as tnde
from test_torch_eval_profile import _column, _f64, _to_torch, jit_reference_harness
from test_torch_fc_cli import EVAL_RTOL, same_npz_files

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
REPO = Path(__file__).resolve().parents[1]
SHOOT16 = str(REPO / "runs" / "wm_les_shoot16")
TINY = ["--nz", "16", "--n-save", "12", "--dt-save", "600"]
RI_RTOL = 1e-6
CHANNELS = ("u", "v", "T", "dudz", "dvdz", "dTdz")


def _main(argv):
    return tcli.main(["--device", "cpu", *argv])


def _history(out):
    return [json.loads(line) for line in open(os.path.join(out, "history.jsonl"))]


def _count(out):
    with np.load(os.path.join(out, "train_state", "state.npz")) as data:
        return int(data["['opt_state']/[0]/.count"])


def _meta(out):
    with open(os.path.join(out, "meta.json")) as f:
        return json.load(f)


def test_catalog_matches_jax(capsys):
    assert _main(["catalog"]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["catalog"]) == 0
    assert port == capsys.readouterr().out
    assert "strong_wind" in port and "wind_-5e-4_cooling_3e-8_new" in port


def test_module_invocation_runs_main():
    r = subprocess.run([sys.executable, "-m", "climateparameterizations_jl_tpu_torch.cli", "--device", "cpu",
                        "catalog"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "# wind_mixing catalog" in r.stdout


def test_train_nde_strided_curriculum(tmp_path, capsys):
    # A "window:stride" stage scales n_substeps by the stride (inner step dt_save / n_substeps).
    out = str(tmp_path / "nde_strided")
    assert _main(["train-nde", "--sims", "strong_wind", *TINY, "--maxiters", "2", "--curriculum", "6,12:3",
                  "--n-substeps", "2", "--output", out]) == 0
    assert "train-nde: loss" in capsys.readouterr().out
    hist = _history(out)
    assert [h["iter"] for h in hist] == [0, 1, 0, 1]
    assert all(math.isfinite(h["loss"]) and h["loss"] == pytest.approx(sum(h[c] for c in CHANNELS)) for h in hist)
    assert _count(out) == 4
    with open(os.path.join(out, "train_state", "meta.json")) as f:
        assert json.load(f) == {"stage": 1, "optimizer": "adam", "learning_rate": 0.02}


def test_train_nde_shooting_loads_in_jax(tmp_path, capsys, monkeypatch):
    """The slice's command: the 13:2 stage (6 intervals) trains on 3 shooting
    windows. Its directory loads through the JAX package's _load_nns, and its
    meta.json equals the JAX command's for the same flags."""
    from climateparameterizations_jl_tpu_torch.data import containers as tc

    flags = ["train-nde", "--sims", "strong_wind", *TINY, "--curriculum", "6,13:2", "--shooting", "3",
             "--n-substeps", "2", "--maxiters", "2"]
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    calls, original = [], tc.multiple_shooting_tensors

    def counting(ds, scalings, tsteps, n_windows, **kw):
        calls.append((list(tsteps), n_windows))
        return original(ds, scalings, tsteps, n_windows, **kw)

    monkeypatch.setattr(tc, "multiple_shooting_tensors", counting)
    assert _main([*flags, "--output", out]) == 0
    assert calls == [(list(range(0, 13, 2)), 3)]
    assert jcli.main([*flags, "--output", jout]) == 0
    capsys.readouterr()
    assert _meta(out) == _meta(jout)
    assert len(_history(out)) == len(_history(jout)) == 4
    jnns, jmeta = jcli._load_nns(out)
    tnns, tmeta = tcli._load_nns(out, "cpu")
    assert jmeta == tmeta
    for p, q in zip(tnde.nn_parameters(tnns), jax.tree.leaves(jnns)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    # And the JAX command's directory through the port.
    tnns, _ = tcli._load_nns(jout, "cpu")
    assert [tuple(p.shape) for p in tnde.nn_parameters(tnns)] == [np.shape(q) for q in jax.tree.leaves(jnns)]


def test_mpp_params_checkpoint_roundtrip(tmp_path, capsys):
    calibrated = {"nu_0": 2.5e-4, "nu_minus": 0.05, "Ri_c": 0.3, "delta_Ri": 0.8, "Pr": 1.2}
    mpp_file = tmp_path / "mpp_parameters.json"
    mpp_file.write_text(json.dumps(calibrated))
    out = str(tmp_path / "nde_mpp")
    assert _main(["train-nde", "--sims", "strong_wind", *TINY, "--maxiters", "1", "--mpp-params", str(mpp_file),
                  "--output", out]) == 0
    meta = _meta(out)
    for k, v in calibrated.items():
        assert meta["mpp"][k] == float(np.float32(v))
    restored = tcli._restore_mpp(meta, device="cpu")["mpp"]
    jrestored = jcli._restore_mpp(meta)["mpp"]
    for k, v in calibrated.items():
        assert float(getattr(restored, k)) == float(getattr(jrestored, k)) == float(np.float32(v))
    # A model rebuilt for the checkpoint takes its base; a meta without one keeps the defaults.
    ds = tcli._load_suite(["strong_wind"], 16, n_save=12, device="cpu")
    assert float(tcli._wind_model(ds, 16, **tcli._restore_mpp(meta, device="cpu")).mpp.Ri_c) == float(np.float32(0.3))
    assert float(tcli._wind_model(ds, 16, **tcli._restore_mpp({}, device="cpu")).mpp.Ri_c) == 0.25
    # Warm-starting from it trains over the default base unless --mpp-params names one, as the JAX
    # command does (its train-nde restores no base from --init-from).
    warm = ["train-nde", "--sims", "strong_wind", *TINY, "--maxiters", "1", "--init-from", out]
    assert _main([*warm, "--output", str(tmp_path / "bare")]) == 0
    assert _meta(str(tmp_path / "bare"))["mpp"] == jcli._mpp_meta(SimpleNamespace(mpp=JMPP.default()))
    assert _main([*warm, "--mpp-params", str(mpp_file), "--output", str(tmp_path / "kept")]) == 0
    assert _meta(str(tmp_path / "kept"))["mpp"] == meta["mpp"]
    capsys.readouterr()


def test_shoot16_checkpoint_restores_in_both_packages():
    """runs/wm_les_shoot16 was trained over calibrated mPP parameters: both
    packages load equal MLPs and restore the five fields from its meta."""
    jnns, jmeta = jcli._load_nns(SHOOT16)
    tnns, tmeta = tcli._load_nns(SHOOT16, "cpu")
    assert tmeta == jmeta and tmeta["mpp"]["Ri_c"] == pytest.approx(2.5, rel=1e-5)
    for p, q in zip(tnde.nn_parameters(tnns), jax.tree.leaves(jnns)):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    tm, jm = tcli._restore_mpp(tmeta, device="cpu")["mpp"], jcli._restore_mpp(jmeta)["mpp"]
    for k in tcli._MPP_FIELDS:
        want = np.float32(tmeta["mpp"][k])
        assert getattr(tm, k).dtype == torch.float32
        assert getattr(tm, k).item() == float(np.asarray(getattr(jm, k))) == float(want)
    assert tcli._MPP_FIELDS == jcli._MPP_FIELDS


def test_run_loader_reads_both_formats_and_refuses_ensembles(tmp_path):
    """One loader (``train/checkpoint.py::load_run``) serves the CLI and
    ``load_flux_nns``: a member missing from ``meta["arch"]`` loads as None
    (as JAX's ``_load_nns``), a directory without ``arch`` holds flagship
    MLPs, and a stacked ensemble (``meta["ensemble"] = 4``) loads with its
    leading member axis, equal to JAX's ``_load_nns``."""
    ens, ens_meta = tcli._load_nns(str(REPO / "runs" / "wm_flagship_ens4"), "cpu")
    jens, jens_meta = jcli._load_nns(str(REPO / "runs" / "wm_flagship_ens4"))
    assert ens_meta == jens_meta and ens_meta["ensemble"] == 4
    assert ens.uw.weights[0].shape == (4, 50, 96)
    for p, q in zip(tnde.nn_parameters(ens), jax.tree.leaves(jens)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    nns, meta = tck.load_run(SHOOT16, "cpu")
    assert meta == _meta(SHOOT16)
    tck.save_checkpoint(str(tmp_path / "bare"), nns, {"command": "x"})
    bare, bare_meta = tck.load_run(str(tmp_path / "bare"), "cpu")
    assert bare_meta == {"command": "x"}
    for p, q in zip(tnde.nn_parameters(bare), tnde.nn_parameters(tck.load_flux_nns(SHOOT16, "cpu"))):
        assert torch.equal(p, q)
    tcli._save_nns(str(tmp_path / "two"), nns._replace(vw=None), {"command": "x"})
    two, _ = tcli._load_nns(str(tmp_path / "two"), "cpu")
    jtwo, _ = jcli._load_nns(str(tmp_path / "two"))
    assert two.vw is None and jtwo.vw is None
    assert torch.equal(two.wT.weights[0], nns.wT.weights[0])


def test_extract_matches_jax(tmp_path, capsys):
    out = str(tmp_path / "run")
    assert _main(["train-nde", "--sims", "strong_wind", *TINY, "--maxiters", "1", "--curriculum", "4,6,8",
                  "--output", out]) == 0
    assert _main(["extract", out, str(tmp_path / "t")]) == 0
    assert jcli.main(["extract", out, str(tmp_path / "j")]) == 0
    losses = tck.load_extracted_losses(str(tmp_path / "t"))
    assert sorted(losses) == sorted(["iter", "loss", *CHANNELS])
    assert all(v.shape == (3,) and np.isfinite(v).all() for v in losses.values())
    jlosses = jax.tree.map(np.asarray, dict(np.load(tmp_path / "j" / "losses.npz")))
    for k, v in jlosses.items():
        np.testing.assert_array_equal(losses[k], v)
    assert _meta(str(tmp_path / "t")) == _meta(str(tmp_path / "j"))
    assert _meta(str(tmp_path / "t"))["n_iterations"] == 3
    with np.load(tmp_path / "t" / "train_state.npz") as data:
        assert int(data["['opt_state']/[0]/.count"]) == 3
    capsys.readouterr()


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_config_precedence(tmp_path, suffix):
    """Config values replace defaults; typed flags win, also when equal to the default or abbreviated."""
    cfg = tmp_path / f"c{suffix}"
    values = {"nz": 64, "maxiters": 7, "n_substeps": 3, "lr": 0.5, "device": "cpu"}
    if suffix == ".json":
        cfg.write_text(json.dumps(values))
    else:
        import yaml

        cfg.write_text(yaml.safe_dump(values))
    args = tcli._parse_args(["train-nde", "--config", str(cfg), "--nz", "32", "--maxit", "50", "--lr=0.1"])
    assert (args.nz, args.maxiters, args.lr) == (32, 50, 0.1)  # typed
    assert (args.n_substeps, args.device) == (3, "cpu")  # from the config
    args = tcli._parse_args(["--device", "meta", "train-nde", "--config", str(cfg)])
    assert (args.nz, args.maxiters, args.device) == (64, 7, "meta")


def test_config_file_drives_a_run(tmp_path, capsys):
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({"maxiters": 1, "curriculum": "5", "sims": "strong_wind", "nz": 16, "n_save": 12,
                               "device": "cpu"}))
    out = str(tmp_path / "cfg")
    assert tcli.main(["train-nde", "--config", str(cfg), "--output", out]) == 0
    assert len(_history(out)) == 1 and _meta(out)["nz"] == 16
    capsys.readouterr()


def test_resume_from_and_trace(tmp_path, capsys):
    first, second = str(tmp_path / "a"), str(tmp_path / "b")
    common = ["train-nde", "--sims", "strong_wind", *TINY, "--curriculum", "7", "--n-substeps", "2",
              "--maxiters", "2"]
    assert _main([*common, "--output", first, "--trace", str(tmp_path / "trace")]) == 0
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert _main([*common, "--output", second, "--resume-from", first]) == 0
    assert _count(first) == 2 and _count(second) == 4
    # The resumed run starts from the first run's final weights.
    nns, _ = tcli._load_nns(first, "cpu")
    params, opt_state = tnde.resume_train_state(os.path.join(first, "train_state"), nns)
    for p, q in zip(tnde.nn_parameters(params), tnde.nn_parameters(nns)):
        assert torch.equal(p, q)
    assert all(math.isfinite(h["loss"]) for h in _history(second))
    capsys.readouterr()


def test_unported_options_name_their_roadmap_items(tmp_path):
    """``--ensemble`` and ``--optimizer lbfgs`` run now; together they are refused, as in the JAX command
    (lbfgs's shared line search couples the members). An lbfgs run resumes from its params."""
    with pytest.raises(SystemExit, match="elementwise optimizer"):
        _main(["train-nde", "--sims", "strong_wind", *TINY, "--ensemble", "2", "--optimizer", "lbfgs",
               "--output", str(tmp_path / "e")])
    out = str(tmp_path / "l")
    assert _main(["train-nde", "--sims", "strong_wind", *TINY, "--optimizer", "lbfgs", "--maxiters", "2",
                  "--curriculum", "3", "--output", out]) == 0
    assert len(_history(out)) == 2 and all(math.isfinite(h["loss"]) for h in _history(out))
    with np.load(os.path.join(out, "train_state", "state.npz")) as data:
        assert all(k.startswith("['params']") for k in data.files)  # L-BFGS has no optax layout here
    # Resuming restores the params alone: strong Wolfe's sufficient decrease puts the first loss below the last one.
    back = str(tmp_path / "r")
    assert _main(["train-nde", "--sims", "strong_wind", *TINY, "--optimizer", "lbfgs", "--maxiters", "1",
                  "--curriculum", "3", "--resume-from", out, "--output", back]) == 0
    assert _history(back)[0]["loss"] < _history(out)[-1]["loss"]
    with pytest.raises(SystemExit):
        _main(["train-nde", "--sims", "strong_wind", *TINY, "--fast-assembly", "--smooth-nn",
               "--output", str(tmp_path / "f")])


def test_train_nde_ensemble_command(tmp_path, capsys):
    """``train-nde --ensemble 2`` writes the JAX command's meta and leaves; each package reads the other's run."""
    argv = ["train-nde", "--sims", "strong_wind", *TINY, "--curriculum", "4,7", "--n-substeps", "2",
            "--maxiters", "2", "--ensemble", "2"]
    tout, jout = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli.main(["--device", "cpu", *argv, "--output", tout]) == 0
    assert jcli.main([*argv, "--output", jout]) == 0
    capsys.readouterr()
    assert _meta(tout) == _meta(jout) and _meta(tout)["ensemble"] == 2
    with np.load(os.path.join(tout, "state.npz")) as t, np.load(os.path.join(jout, "state.npz")) as j:
        assert sorted(t.files) == sorted(j.files) and all(t[k].shape == j[k].shape for k in j.files)
    with np.load(os.path.join(tout, "train_state", "state.npz")) as t:
        assert int(t["['opt_state']/[0]/.count"]) == 4
    jnns, _ = jcli._load_nns(tout)
    tnns, _ = tcli._load_nns(jout, "cpu")
    assert tnns.uw.weights[0].shape[0] == 2 and jax.tree.leaves(jnns)[0].shape[0] == 2
    hist = _history(tout)
    assert len(hist) == 4 and all(h["loss"] == pytest.approx(sum(h[c] for c in CHANNELS)) for h in hist)
    # Warm start from an ensemble run: the sizes must agree.
    more = ["--device", "cpu", *argv[:-2], "--maxiters", "1", "--output", str(tmp_path / "w")]
    assert tcli.main([*more, "--ensemble", "2", "--init-from", tout, "--resume-from", tout]) == 0
    with pytest.raises(SystemExit, match="does not match --ensemble 3"):
        tcli.main([*more, "--ensemble", "3", "--init-from", tout])
    capsys.readouterr()


# The files the JAX package's ``evaluate`` and ``calibrate-kpp`` write (its ``cli/main.py`` ``cmd_evaluate``
# and ``cmd_calibrate_kpp``); ``tests/test_torch_eval_profile.py`` holds the profile's keys and values to JAX.
_CHANNELS6 = ("u", "v", "T", "du", "dv", "dT")
EVALUATION_KEYS = {
    "t", "zc", "zf", "truth_uw", "truth_vw", "truth_wT", "truth_Ri",
    *(f"{m}_{c}" for m in ("truth", "nde", "mpp", "kpp") for c in ("u", "v", "T")),
    *(f"{m}_{k}" for m in ("nde", "mpp") for k in ("uw", "vw", "wT", "nn_uw", "nn_vw", "nn_wT", "Ri")),
    *(f"kpp_{k}" for k in ("uw", "vw", "wT", "Ri")),
    *(f"losses_{m}_{c}" for m in ("nde", "mpp", "kpp") for c in _CHANNELS6),
    *(f"loss_{m}{g}" for m in ("nde", "mpp", "kpp") for g in ("", "_gradient")),
}
EMBEDDED_KEYS = {
    *(f"{m}_{k}" for m in ("embedded", "embedded_baseline") for k in ("u", "v", "T", "uw", "vw", "wT", "Ri")),
    *(f"losses_{m}_{c}" for m in ("embedded", "embedded_baseline") for c in _CHANNELS6),
    *(f"loss_{m}{g}" for m in ("embedded", "embedded_baseline") for g in ("", "_gradient")),
}
UNCERTAINTY_KEYS = {"t", "zc", "zf", "n_members", "losses_member_T", "losses_ensemble_mean_T",
                    *(f"ensemble_{c}_{s}" for c in ("u", "v", "T") for s in ("mean", "std"))}


@pytest.mark.parametrize("method", ["random", "gradient", "eki"])
def test_calibrate_kpp_command(tmp_path, capsys, method):
    """Each method writes the JAX command's ``kpp_parameters.json`` keys; the values lie in the priors."""
    out = str(tmp_path / method)
    extra = ["--n-ensemble", "6", "--n-eki-iters", "2"] if method == "eki" else ["--n-plugin", "4",
                                                                                  "--n-line-search", "2"]
    assert _main(["calibrate-kpp", "--sims", "strong_wind,strong_wind_weak_cooling", *TINY, "--n-train-steps", "6",
                  "--calibration-method", method, *extra, "--output", out]) == 0
    capsys.readouterr()
    with open(os.path.join(out, "kpp_parameters.json")) as f:
        result = json.load(f)
    priors = {"CSL": (0.01, 0.99), "CNL": (0.0, 8.0), "Cb_T": (0.0, 6.0), "CKE": (0.0, 5.0)}
    if method == "eki":
        assert set(result) == {*priors, "misfit"} and all(set(result[n]) == {"mean", "std"} for n in priors)
        values = {n: result[n]["mean"] for n in priors}
        assert math.isfinite(result["misfit"])
    else:
        assert set(result) == {*priors, "loss"} and math.isfinite(result["loss"])
        values = {n: result[n] for n in priors}
    assert all(priors[n][0] <= v <= priors[n][1] for n, v in values.items())


def test_evaluate_command(tmp_path, capsys):
    """``evaluate --embedded --write-jld2 --animate`` of the flagship closure equals the JAX command: every npz
    value, the summary, the file names (figures and the comparison GIF included; the coverage figure, drawn from the
    names alone, pixel for pixel) and the embedded pair's ``.jld2`` files: the port's, read back by its LESbrary
    reader, equal its npz bit for bit, and where h5py is installed (the JAX writer's) they equal the JAX command's.

    Both commands get the same simulations, one column made with numpy from
    a seed per catalog name, and the checkpoint's weights, in float64 (the
    loaders are replaced by ones returning them; the commands read the meta,
    the scaling context and the mPP base themselves), so each
    value is held to JAX within ``EVAL_RTOL`` of its key's scale. The
    Richardson numbers get ``RI_RTOL`` (6.4e-8 measured): in an unsheared
    layer Ri is N^2 over the 1e-7 floor of S^2, about 1e16 here, and carries
    the float64 roundoff of the temperature differences in N^2 up by as much.
    """
    argv = ["evaluate", "--checkpoint", str(REPO / "runs" / "wm_flagship_fold"), "--sims", "strong_wind",
            "--test-sims", "strong_wind_weak_cooling", "--nz", "32", "--n-save", "12", "--n-train-steps", "9",
            "--eval-stride", "2", "--n-substeps", "2", "--kpp-n-substeps", "2"]
    figures = ["--animate", "--animation-format", "gif", "--gif-stride", "4"]
    embedded = ["--embedded", "--write-jld2"]
    jax_has_h5py = importlib.util.find_spec("h5py") is not None  # the JAX writer's; the port writes with its own code
    jax_embedded = embedded if jax_has_h5py else ["--embedded"]
    seeds = {"strong_wind": 0, "strong_wind_weak_cooling": 1}

    def jax_suite(names, Nz, *args):
        columns = [_column(seeds[n], NT=12, NZ=Nz) for n in names]
        return jc.stack_datasets(columns) if len(columns) > 1 else columns[0]

    nns, meta = jcli._load_nns(str(REPO / "runs" / "wm_flagship_fold"))
    nns = _f64(nns)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_harness(mp)
        mp.setattr(jcli, "_load_nns", lambda directory: (nns, meta))
        mp.setattr(tcli, "_load_nns", lambda directory, device=None: (from_reference(nns, device, torch.float64),
                                                                       meta))
        mp.setattr(jcli, "_load_suite", jax_suite)
        mp.setattr(tcli, "_load_suite", lambda names, *a, device=None, **k: _to_torch(jax_suite(names, *a)))
        assert jcli.main([*argv, *jax_embedded, *figures, "--output", jout]) == 0
        assert _main([*argv, *embedded, *figures, "--output", tout]) == 0
    capsys.readouterr()
    sim_dir = [] if jax_has_h5py else ["strong_wind_weak_cooling"]
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout) + sim_dir)
    assert {"training_regions.png", "loss.png", "final_profiles.png", "comparison.gif"} <= set(os.listdir(tout))
    assert np.array_equal(*(np.asarray(Image.open(os.path.join(d, "training_regions.png"))) for d in (tout, jout)))
    with np.load(os.path.join(tout, "evaluation_strong_wind_weak_cooling.npz")) as ev:
        assert set(ev.files) == EVALUATION_KEYS | EMBEDDED_KEYS and ev["kpp_T"].shape == (5, 32)
        assert ev["embedded_T"].shape == (5, 32) and ev["embedded_wT"].shape == (5, 33)
    same_npz_files(tout, jout, ["evaluation_strong_wind_weak_cooling.npz"], EVAL_RTOL, RI_RTOL)
    with open(os.path.join(tout, "summary.json")) as f, open(os.path.join(jout, "summary.json")) as g:
        got, want = json.load(f), json.load(g)
    assert list(got) == list(want) == ["per_sim", "mean"]
    assert list(got["mean"]) == ["nde", "mpp", "kpp", "embedded", "embedded_baseline"]
    for part in ("per_sim", "mean"):
        assert list(got[part]) == list(want[part])
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k], rtol=EVAL_RTOL, err_msg=f"{part} {k}")
    from climateparameterizations_jl_tpu_torch.data.lesbrary import read_les_profiles

    with np.load(os.path.join(tout, "evaluation_strong_wind_weak_cooling.npz")) as ev:
        for tag, m in (("baseline", "embedded_baseline"), ("neural_network", "embedded")):
            saved = read_les_profiles(os.path.join(tout, "strong_wind_weak_cooling", f"{tag}.jld2"), dtype=np.float64)
            for field in ("u", "v", "T", "uw", "vw", "wT"):
                np.testing.assert_array_equal(getattr(saved, field).numpy(), ev[f"{m}_{field}"], err_msg=tag)
            np.testing.assert_array_equal(saved.t.numpy(), ev["t"])
    for tag in ("baseline", "neural_network") if jax_has_h5py else ():
        got_f, want_f = (read_les_profiles(os.path.join(d, "strong_wind_weak_cooling", f"{tag}.jld2"))
                         for d in (tout, jout))
        for field in ("u", "v", "T", "uw", "vw", "wT", "t", "H", "f", "g", "alpha", "beta", "u_top", "theta_top",
                      "theta_bottom"):
            a, b = getattr(got_f, field).numpy(), getattr(want_f, field).numpy()
            assert a.shape == b.shape, (tag, field)
            np.testing.assert_allclose(a, b, rtol=EVAL_RTOL, atol=EVAL_RTOL * max(float(np.abs(b).max()), 1e-30),
                                       err_msg=f"{tag} {field}")
    with pytest.raises(SystemExit, match="requires --embedded"):
        _main([*argv, "--write-jld2", "--output", str(tmp_path / "refused")])


def test_evaluate_ensemble_checkpoint(tmp_path, capsys):
    """An ensemble checkpoint (``runs/wm_flagship_ens4``): member 0 in the profile, the bands beside it."""
    out = str(tmp_path / "ens")
    assert _main(["evaluate", "--checkpoint", str(REPO / "runs" / "wm_flagship_ens4"), "--sims", "strong_wind",
                  "--test-sims", "strong_wind", "--nz", "32", "--n-save", "12", "--n-train-steps", "7",
                  "--eval-stride", "3", "--n-substeps", "2", "--output", out]) == 0
    assert "K=4" in capsys.readouterr().out
    with np.load(os.path.join(out, "uncertainty_strong_wind.npz")) as uq:
        assert set(uq.files) == UNCERTAINTY_KEYS and int(uq["n_members"]) == 4
    with np.load(os.path.join(out, "evaluation_strong_wind.npz")) as ev:
        assert set(ev.files) == EVALUATION_KEYS
    with open(os.path.join(out, "summary.json")) as f:
        assert set(json.load(f)["mean"]) == {"nde", "mpp", "kpp", "nde_ensemble_mean"}


def _json_same(got: dict, want: dict):
    """Equal dicts, floats within ``EVAL_RTOL``."""
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _json_same(got[k], w)
        elif isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=EVAL_RTOL), k
        else:
            assert got[k] == w, k


def _same_run_dirs(got_dir: str, want_dir: str, rtol: float):
    """Two run directories: the same history (every channel), weights and meta."""
    got_h, want_h = _history(got_dir), _history(want_dir)
    assert len(got_h) == len(want_h)
    for g, w in zip(got_h, want_h):
        assert list(g) == list(w)
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=rtol, atol=1e-300)
    same_npz_files(got_dir, want_dir, ["state.npz"], rtol)
    with open(os.path.join(got_dir, "meta.json")) as f, open(os.path.join(want_dir, "meta.json")) as g:
        _json_same(json.load(f), json.load(g))


def test_train_embedded_command(tmp_path, capsys):
    """``train-embedded`` from the flagship checkpoint equals the JAX command: history, weights and meta, and after a
    resume from each package's train state again.

    Both get the same float64 simulations (a column made with numpy from a seed per name, for the two training
    sims and the checkpoint's 18 scaling sims) and the checkpoint's weights in float64, over a two-stage curriculum
    with auto-balanced loss weights; every channel and weight within ``EVAL_RTOL``.
    """
    ckpt = str(REPO / "runs" / "wm_flagship_fold")
    nns, meta = jcli._load_nns(ckpt)
    nns = _f64(nns)
    names = ["strong_wind", "strong_wind_weak_cooling", *meta["sims"].split(",")]
    seeds = {n: i for i, n in enumerate(names)}

    def jax_suite(names, Nz, *args):
        columns = [_column(seeds[n], NT=12, NZ=Nz) for n in names]
        return jc.stack_datasets(columns) if len(columns) > 1 else columns[0]

    argv = ["train-embedded", "--init-from", ckpt, "--sims", "strong_wind,strong_wind_weak_cooling", "--nz", "32",
            "--n-save", "12", "--substeps", "2", "--lr", "1e-3", "--auto-balance"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_load_nns", lambda directory: (nns, meta))
        mp.setattr(tcli, "_load_nns", lambda directory, device=None: (from_reference(nns, device, torch.float64),
                                                                       meta))
        mp.setattr(jcli, "_load_suite", jax_suite)
        mp.setattr(tcli, "_load_suite", lambda names, *a, device=None, **k: _to_torch(jax_suite(names, *a)))
        first = ["--curriculum", "4,7", "--maxiters", "2"]
        assert jcli.main([*argv, *first, "--output", jout]) == 0
        assert _main([*argv, *first, "--output", tout]) == 0
        _same_run_dirs(tout, jout, EVAL_RTOL)
        with open(os.path.join(tout, "meta.json")) as f:
            got = json.load(f)
        assert got["sims"] == meta["sims"] and got["train_sims"] == "strong_wind,strong_wind_weak_cooling"
        assert got["command"] == "train-embedded" and set(got["mpp"]) == {"nu_0", "nu_minus", "Ri_c", "delta_Ri", "Pr"}
        assert _count(tout) == 4
        # Each resumes the other's train state for one more stage.
        more = ["--curriculum", "4", "--maxiters", "1"]
        assert jcli.main([*argv, *more, "--resume-from", tout, "--output", jout + "_b"]) == 0
        assert _main([*argv, *more, "--resume-from", jout, "--output", tout + "_b"]) == 0
        _same_run_dirs(tout + "_b", jout + "_b", EVAL_RTOL)
        assert _count(tout + "_b") == 5
    capsys.readouterr()
    with pytest.raises(SystemExit, match="deep-ensemble"):
        _main(["train-embedded", "--init-from", str(REPO / "runs" / "wm_flagship_ens4"), *TINY,
               "--output", str(tmp_path / "ens")])
    with pytest.raises(SystemExit, match="pass --sims"):
        _main(["train-embedded", *TINY, "--output", str(tmp_path / "none")])


def test_double_gyre_command(tmp_path, capsys):
    """``double-gyre`` with the free-convection closure equals the JAX command's output on a 16 x 12 x 32 basin;
    the port's ``--animate`` draws every saved frame into ``double_gyre.gif``.

    Both commands build the basin, the closure's remap and gate from the same flags and checkpoint, in float32:
    every saved field within ``F32_RTOL = 1e-4`` of its scale (the momentum starts from rest, so its first values
    are differences of order-one pressure and surface terms, which the packages round in their own orders).
    """
    F32_RTOL = 1e-4
    argv = ["double-gyre", "--checkpoint", str(REPO / "runs" / "fc_flagship"), "--nx", "16", "--ny", "12",
            "--nz-gyre", "32", "--days", "0.125", "--n-frames", "3", "--nn-stability-gate", "auto"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main([*argv, "--output", jout]) == 0
    assert _main([*argv, "--animate", "--output", tout]) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    with Image.open(os.path.join(tout, "double_gyre.gif")) as gif:
        assert gif.n_frames == 4
    assert "NN stability gate" in "\n".join(printed) and json.loads(printed[-1])["frames"] == 4
    with np.load(os.path.join(tout, "double_gyre.npz")) as got, np.load(os.path.join(jout, "double_gyre.npz")) as want:
        assert sorted(got.files) == sorted(want.files) == ["T", "eta", "psi", "u_surface", "v_surface"]
        for k in want.files:
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32
            scale = float(np.abs(want[k]).max())
            assert float(np.abs(got[k] - want[k]).max()) <= F32_RTOL * scale, k
    with pytest.raises(SystemExit, match="positive"):
        _main([*argv, "--nn-stability-gate", "0", "--output", str(tmp_path / "refused")])


def _options(parser) -> dict:
    """``{subcommand: its option strings}`` of a parser."""
    subs = parser._subparsers._group_actions[0].choices  # noqa: SLF001
    return {name: {o for a in sp._actions for o in a.option_strings} for name, sp in subs.items()}  # noqa: SLF001


def test_parser_has_every_jax_command_and_flag():
    """Every JAX subcommand, ``fetch`` included, parses in the port with every JAX flag."""
    jax_cmds, port_cmds = _options(jcli.build_parser()), _options(tcli.build_parser())
    assert set(jax_cmds) - set(port_cmds) == set()
    for name, flags in jax_cmds.items():
        assert flags <= port_cmds[name], (name, flags - port_cmds[name])
    with_format = {n for n, f in port_cmds.items() if "--animation-format" in f}
    assert with_format == {n for n, f in jax_cmds.items() if "--animation-format" in f} and len(with_format) == 11


FC_CHECKPOINT = str(REPO / "runs" / "fc_flagship")
NO_MPL = {
    "evaluate": (["evaluate", "--checkpoint", str(REPO / "runs" / "wm_flagship_fold"), "--sims", "strong_wind",
                  "--test-sims", "strong_wind_weak_cooling,strong_wind", "--nz", "32", "--n-save", "12",
                  "--n-train-steps", "5", "--eval-stride", "2", "--n-substeps", "2"],
                 ["evaluation_strong_wind.npz", "evaluation_strong_wind_weak_cooling.npz", "summary.json"],
                 "training_regions.png, loss.png, final_profiles.png, loss_matrix.png"),
    "evaluate-fc": (["evaluate-fc", "--checkpoint", FC_CHECKPOINT, "--sim-ids", "8,9", "--n-save", "8",
                     "--n-eval-steps", "5", "--eval-stride", "2", "--n-substeps", "2"],
                    ["sim8.npz", "sim9.npz", "summary.json"], "loss_matrix.png"),
    "train-gp": (["train-gp", "--sims", "strong_wind", "--test-sims", "strong_wind_weak_cooling", *TINY, "--fluxes",
                  "wT,uw", "--subsample", "8", "--kernel-ids", "1"], ["gp_report.json"],
                 "gp_uncertainty_uw.png, gp_uncertainty_wT.png"),
}


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib made unimportable, as on the card's machine (the figures module is imported anew)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "climateparameterizations_jl_tpu_torch.eval.animations", raising=False)


@pytest.mark.parametrize("command", list(NO_MPL))
def test_commands_without_matplotlib_write_arrays_and_name_the_figures(no_matplotlib, command, tmp_path, capsys):
    argv, files, undrawn = NO_MPL[command]
    out = tmp_path / "out"
    assert _main([*argv, "--output", str(out)]) == 0
    assert sorted(os.listdir(out)) == files
    err = capsys.readouterr().err.strip().splitlines()
    assert err == [f"figures not drawn (matplotlib cannot be imported): {undrawn}"]


@pytest.mark.parametrize("argv", [
    NO_MPL["evaluate"][0],
    ["double-gyre", "--nx", "8", "--ny", "8", "--nz-gyre", "4", "--days", "0.05"],
], ids=["evaluate", "double-gyre"])
def test_animate_without_matplotlib_exits_before_any_work(no_matplotlib, argv, tmp_path):
    with pytest.raises(SystemExit, match="matplotlib cannot be imported"):
        _main([*argv, "--animate", "--animation-format", "mp4", "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_benchmark_needs_a_card(tmp_path, monkeypatch):
    for argv in (["benchmark", "--suite", "--quick"], ["benchmark"]):
        with pytest.raises(RuntimeError, match="card"):
            _main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["benchmark", "--suite", "--quick"])
