"""Port parity: the flagship study (``studies/flagship_training.py``) against its port.

Both modules get the same reduced configuration: 2 training sims and 1
held-out sim of the flagship suites, ``N_FRAMES = 37``, two stages of 2
iterations (``STAGES``), 2 pretraining epochs. The suites are generated once
by the JAX package (f32) and handed to both modules through their
``load_suite``; the initial MLPs are JAX's ``build`` draw (seed 0), handed
over through ``bridge.from_reference``; the port's generator draws other
numbers, so nothing is re-seeded.

Tolerances:

- ``RTOL = 1e-8`` in float64: the same operations in the same order (the
  study's losses, weights and held-out MSEs).
- ``F32_RTOL = 1e-4`` in float32, where the two packages sum in other
  orders through the substeps and the backward pass (measured 1.5e-5 on the
  held-out NDE MSE). The held-out KPP MSEs in float32 are held to
  ``KPP_F32_RTOL = 1e-3``: the two packages' f32 KPP columns (held to each
  other within 5e-5 K in ``tests/test_torch_kpp_tke.py``) give MSEs 6.3e-4
  apart here; in float64 they agree to 1.3e-12.
- ``calibrate_mpp``: ``torch.optim.LBFGS`` (strong Wolfe) and
  ``optax.lbfgs`` (zoom) are other line searches, so the first loss (the
  same point) is held to ``RTOL`` and the best loss to ``LBFGS_FACTOR``
  times JAX's, the criterion of ``tests/test_torch_calibration.py``.

``PYTHONPATH=. python tests/test_torch_flagship_training.py`` evaluates
``runs/wm_flagship_fold`` at full size on the CPU with both studies and
prints each package's distance from the stored ``docs/flagship_run_fold.json``.
"""

import dataclasses
import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.studies import flagship_training as tft
from climateparameterizations_jl_tpu_torch.train import deep_ensemble as tde
from climateparameterizations_jl_tpu_torch.train import nde as tnde
from studies import flagship_training as jft

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
jde = importlib.import_module("climateparameterizations_jl_tpu.train.deep_ensemble")
RTOL, F32_RTOL, KPP_F32_RTOL, LBFGS_FACTOR = 1e-8, 1e-4, 1e-3, 1.05
TRAIN = ["wind_-5e-4_cooling_3e-8_new", "wind_-2e-4_heating_-1e-8_new"]
TEST = ["wind_-4.5e-4_cooling_2.5e-8"]
N_FRAMES = 37
STAGES = [(19, 6, 2, 1e-2), (37, 4, 2, 1e-3)]
DTYPES = {"float64": (jnp.float64, torch.float64, RTOL), "float32": (jnp.float32, torch.float32, F32_RTOL)}


def _close(got, want, rtol, scale_atol=1e-12):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale_atol * max(float(np.abs(want).max()), 1e-30))


def _weights_close(tnns, jnns, rtol):
    """Trained weights, each layer within ``rtol`` of its own scale: adam's normalized step moves a weight whose
    gradient is zero to rounding by up to its learning rate, in either package, so entry-wise digits of such
    weights carry no information (the losses above hold the trajectory)."""
    for got, want in zip(_leaves(tnns), jax.tree.leaves(jnns)):
        _close(got, want, rtol, scale_atol=rtol)


def _cast(tree, jdt):
    return jax.tree.map(lambda a: jnp.asarray(a, jdt) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a,
                        tree)


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    })


def _leaves(tnns) -> list:
    return [p.detach().numpy() for p in tnde.nn_parameters(tnns)]


@pytest.fixture(scope="module")
def jax_suites():
    """The JAX package's suites of the reduced configuration (f32), generated once per name list."""
    cache = {}

    def get(names):
        key = tuple(names)
        if key not in cache:
            cache[key] = jcli._load_suite(list(names), 32, None, N_FRAMES - 1, 600.0)
        return cache[key]

    return get


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the study's small matmuls lose more to thread hand-offs on a loaded CPU than they gain."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def configure(monkeypatch, jax_suites, dtype="float64"):
    """The reduced configuration on both modules, each ``load_suite`` handing over JAX's suite in ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    for mod in (jft, tft):
        monkeypatch.setattr(mod, "TRAIN_FILES", list(TRAIN))
        monkeypatch.setattr(mod, "TEST_FILES", list(TEST))
        monkeypatch.setattr(mod, "TRAIN_FILES_STANDARD", tuple(TRAIN))
        monkeypatch.setattr(mod, "TEST_FILES_STANDARD", tuple(TEST))
        monkeypatch.setattr(mod, "N_FRAMES", N_FRAMES)
        monkeypatch.setattr(mod, "STAGES", list(STAGES))
        monkeypatch.setattr(mod, "DATA_DIR", None)
    monkeypatch.setattr(jft, "load_suite", lambda names, Nz=32: _cast(jax_suites(names), jdt))
    monkeypatch.setattr(tft, "load_suite", lambda names, Nz=32, device=None: _to_torch(_cast(jax_suites(names), jdt)))


def built(monkeypatch, jax_suites, dtype):
    """JAX's ``build`` and the port's on the handed-over suite and weights: ``(jds, jmodel, jnns, tds, tmodel, tnns)``."""
    configure(monkeypatch, jax_suites, dtype)
    jdt, tdt, _ = DTYPES[dtype]
    jds, jmodel, jnns = _cast(jft.build(), jdt)
    tds, tmodel, tnns = tft.build(nns=from_reference(jnns, "cpu", tdt), device="cpu")
    return jds, jmodel, jnns, tds, tmodel, tnns


# ---------------------------------------------------------------------------
# constants, suites, build
# ---------------------------------------------------------------------------


def test_constants_are_the_jax_scripts():
    for name in ("TRAIN_FILES_STANDARD", "TEST_FILES_STANDARD", "TRAIN_FILES_DIURNAL", "TEST_FILES_DIURNAL",
                 "N_FRAMES", "STAGES", "DATA_DIR"):
        assert getattr(tft, name) == getattr(jft, name), name
    assert tft.TRAIN_FILES == jft.TRAIN_FILES and tft.TEST_FILES == jft.TEST_FILES


# The cases of tests/test_flagship_suite.py, held against the JAX function and resolved twice (idempotence).
SUITE_CASES = {
    "idempotent_mixed_extra": ("mixed", "wind_-1.5e-4_heating_-2e-8"),
    "standard": ("standard", None),
    "diurnal": ("diurnal", None),
    "mixed": ("mixed", None),
    "extra_train_strips_whitespace": ("standard", "wind_-1.5e-4_heating_-2e-8, wind_-2e-4_heating_-3.5e-8"),
    "diurnal_follows_membership": ("standard", "wind_-2e-4_diurnal_2e-8"),
}


@pytest.mark.parametrize("suite,extra", SUITE_CASES.values(), ids=SUITE_CASES.keys())
def test_suite_resolution(suite, extra):
    first = tft.resolve_suite(suite, extra)
    assert tft.resolve_suite(suite, extra) == first == jft.resolve_suite(suite, extra)
    train, test, diurnal = first
    base_train = {"standard": list(tft.TRAIN_FILES_STANDARD), "diurnal": list(tft.TRAIN_FILES_DIURNAL),
                  "mixed": list(tft.TRAIN_FILES_STANDARD) + list(tft.TRAIN_FILES_DIURNAL)}[suite]
    extras = [s.strip() for s in extra.split(",")] if extra else []
    assert train == base_train + extras
    assert test == {"standard": list(tft.TEST_FILES_STANDARD), "diurnal": list(tft.TEST_FILES_DIURNAL),
                    "mixed": list(tft.TEST_FILES_STANDARD) + list(tft.TEST_FILES_DIURNAL)}[suite]
    assert diurnal == (suite != "standard" or any("diurnal" in s for s in extras))


def test_load_suite_matches_jax_and_guards_data_dir(monkeypatch, jax_suites, tmp_path):
    """The port's own suite (its stand-ins generated by the port) against JAX's, and the --data-dir refusal."""
    monkeypatch.setattr(tft, "N_FRAMES", N_FRAMES)
    mine = tft.load_suite(TEST, device="cpu")
    theirs = jax_suites(TEST)
    for name in ("u", "v", "T", "uw", "vw", "wT", "t"):
        want = np.asarray(getattr(theirs, name), np.float64)
        got = getattr(mine, name).double().numpy()
        assert got.shape == want.shape == (N_FRAMES,) + want.shape[1:]
        # tests/test_torch_data.py's limits for the two f32 generators: 2e-3 of the field's scale, and in the fluxes
        # a floor of 8 ulps of T (1.9e-6 K) diffused by nu <= 0.1 m^2/s over the generator's dz = 256 m / 128 levels.
        floor = 8 * 1.9e-6 * 0.1 / 2.0 if name in ("uw", "vw", "wT") else 0.0
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max() + floor)
    monkeypatch.setattr(tft, "DATA_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match="1 suite members missing"):
        tft.load_suite(TEST, device="cpu")


def test_build_takes_weights_and_draws_from_a_generator(monkeypatch, jax_suites):
    jds, jmodel, jnns, tds, tmodel, tnns = built(monkeypatch, jax_suites, "float64")
    for field in ("H", "tau", "f", "g", "alpha", "kappa"):
        _close(getattr(tmodel, field).numpy(), np.asarray(getattr(jmodel, field)), 1e-12)
    for var in ("u", "v", "T", "uw", "vw", "wT"):
        for part in ("mu", "sigma"):
            _close(getattr(getattr(tmodel.scalings, var), part).numpy(),
                   np.asarray(getattr(getattr(jmodel.scalings, var), part)), 1e-12)
    for got, want in zip(_leaves(tnns), jax.tree.leaves(jnns)):
        np.testing.assert_array_equal(got, np.asarray(want))
    _, _, a = tft.build(seed=0, device="cpu")
    _, _, b = tft.build(seed=0, device="cpu")
    _, _, c = tft.build(seed=1, device="cpu")
    assert all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert not np.array_equal(_leaves(a)[0], _leaves(c)[0])
    assert tuple(a.uw.weights[0].shape) == (50, 96) and float(a.uw.weights[0].abs().max()) < 1e-3


# ---------------------------------------------------------------------------
# the pipeline: pretrain, calibrate_mpp, nde_train, evaluate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pipeline_matches_jax(monkeypatch, jax_suites, dtype):
    """pretrain, the two stages (their first and last losses, and the weights), and evaluate's nde / mpp / kpp."""
    jds, jmodel, jnns, tds, tmodel, tnns = built(monkeypatch, jax_suites, dtype)
    rtol = DTYPES[dtype][2]
    jnns, jpre, _ = jft.pretrain(jds, jmodel, jnns, epochs=2)
    tnns, tpre, _ = tft.pretrain(tds, tmodel, tnns, epochs=2)
    for flux in ("uw", "vw", "wT"):
        _close(tpre[flux], jpre[flux], rtol)
    _weights_close(tnns, jnns, rtol)
    # In float32 the first stage (lr 1e-2) is left out: adam's normalized step turns a sign difference of a gradient
    # entry at rounding size into a whole step, which at lr 1e-2 moved the next loss by 7.5e-4 (measured).
    stages = STAGES if dtype == "float64" else STAGES[1:]
    jnns, jrep = jft.nde_train(jds, jmodel, jnns, stages=stages)
    monkeypatch.setattr(tft, "STAGES", stages)
    tnns, trep = tft.nde_train(tds, tmodel, tnns)  # STAGES read when called
    assert [set(r) for r in trep] == [set(r) for r in jrep]
    for t, j in zip(trep, jrep):
        assert {k: t[k] for k in ("window", "stride", "maxiters", "lr", "shooting", "n_saveat", "inner_steps")} == {
            k: j[k] for k in ("window", "stride", "maxiters", "lr", "shooting", "n_saveat", "inner_steps")}
        _close([t["loss_initial"], t["loss_final"]], [j["loss_initial"], j["loss_final"]], rtol)
        _close(t["loss_curve"], j["loss_curve"], rtol)
    if dtype == "float64":  # in float32 the sign flips above reach single weights by a whole step
        _weights_close(tnns, jnns, rtol)
    jeval, teval = jft.evaluate(jmodel, jnns), tft.evaluate(tmodel, tnns)
    assert teval.keys() == jeval.keys() == set(TEST)
    for name in TEST:
        assert teval[name].keys() == jeval[name].keys()
        for key in jeval[name]:
            _close(teval[name][key], jeval[name][key], KPP_F32_RTOL if dtype == "float32" and "kpp" in key else rtol)


def test_calibrate_mpp_reaches_the_jax_minimum(monkeypatch, jax_suites):
    jds, jmodel, _, tds, tmodel, _ = built(monkeypatch, jax_suites, "float64")
    jfit, jinfo = jft.calibrate_mpp(jds, jmodel, maxiters=2, window=N_FRAMES, stride=4)
    tfit, tinfo = tft.calibrate_mpp(tds, tmodel, maxiters=2, window=200, stride=4)  # the window is cut to N_FRAMES
    assert tinfo.keys() == jinfo.keys() and tinfo["params"].keys() == jinfo["params"].keys()
    _close(tinfo["loss_initial"], jinfo["loss_initial"], RTOL)
    assert np.isfinite(tinfo["loss_final"]) and tinfo["loss_final"] < tinfo["loss_initial"]
    assert tinfo["loss_final"] <= LBFGS_FACTOR * jinfo["loss_final"], (tinfo["loss_final"], jinfo["loss_final"])
    assert {k: float(getattr(tfit.mpp, k)) for k in tinfo["params"]} == tinfo["params"]


def test_shooting_stage_matches_jax(monkeypatch, jax_suites):
    """--shooting 3 on the full-window stage (9 intervals: 3 windows of 12 substeps), float64."""
    jds, jmodel, jnns, tds, tmodel, tnns = built(monkeypatch, jax_suites, "float64")
    jnns, jrep = jft.nde_train(jds, jmodel, jnns, stages=STAGES, shooting=3)
    tnns, trep = tft.nde_train(tds, tmodel, tnns, shooting=3)
    assert [r["shooting"] for r in trep] == [r["shooting"] for r in jrep] == [0, 3]
    assert [r["inner_steps"] for r in trep] == [r["inner_steps"] for r in jrep] == [18, 12]
    for t, j in zip(trep, jrep):
        _close([t["loss_initial"], t["loss_final"]], [j["loss_initial"], j["loss_final"]], RTOL)
        _close(t["loss_curve"], j["loss_curve"], RTOL)


def test_member_folded_ensemble_matches_jax(monkeypatch, jax_suites):
    """--ensemble 2 --member-fold: pretraining, the stages' member-mean losses and the held-out bands, float64."""
    configure(monkeypatch, jax_suites, "float64")
    jds, jmodel, _ = _cast(jft.build(), jnp.float64)
    tds, tmodel, _ = tft.build(device="cpu")
    jmembers = [_cast(m, jnp.float64) for m in jft.build_ensemble_members(2)]
    tmembers = [from_reference(m, "cpu", torch.float64) for m in jmembers]
    jmembers, jpre, _ = jft.pretrain_ensemble(jds, jmodel, jmembers, epochs=2)
    tmembers, tpre, _ = tft.pretrain_ensemble(tds, tmodel, tmembers, epochs=2)
    assert tpre.keys() == jpre.keys()
    for m in jpre:
        for flux in jpre[m]:
            _close(tpre[m][flux], jpre[m][flux], RTOL)
    stages = [STAGES[-1]]
    jstacked, jrep = jft.nde_train_ensemble(jds, jmodel, jmembers, stages=stages, member_fold=True)
    tstacked, trep = tft.nde_train_ensemble(tds, tmodel, tmembers, stages=stages, member_fold=True)
    assert [set(r) for r in trep] == [set(r) for r in jrep]
    _close([trep[0]["loss_initial"], trep[0]["loss_final"]], [jrep[0]["loss_initial"], jrep[0]["loss_final"]],
           RTOL)
    jev, tev = jft.evaluate_ensemble(jmodel, jstacked), tft.evaluate_ensemble(tmodel, tstacked)
    for name in TEST:
        assert tev[name].keys() == jev[name].keys()
        assert tev[name]["calibration_role"] == jev[name]["calibration_role"]
        for key in ("nde_member0", "nde_members", "nde_ensemble_mean", "mpp", "kpp", "mean_band_K", "win_vs_mpp",
                    "win_vs_kpp"):
            _close(tev[name][key], jev[name][key], RTOL)
        # The inflation is fit on z = error / std, with two members a few pretraining epochs apart (std ~ 1e-7 K):
        # the division carries the spread's last digits into lambda (~4e5; measured 2e-6 apart).
        for key in ("lam_nll", "lam_coverage"):
            _close(tev[name][key], jev[name][key], 1e-5)
        assert tev[name]["coverage_2sigma"] == jev[name]["coverage_2sigma"]


def test_aposteriori_and_embedded_eval_match_jax(monkeypatch, jax_suites):
    """One a-posteriori iteration through the host column, and the held-out embedded evaluation, float64."""
    jds, jmodel, jnns, tds, tmodel, tnns = built(monkeypatch, jax_suites, "float64")
    jbefore, tbefore = jft.evaluate_embedded(jmodel, jnns), tft.evaluate_embedded(tmodel, tnns)
    for name in TEST:
        assert tbefore[name].keys() == jbefore[name].keys()
        for key in jbefore[name]:
            _close(tbefore[name][key], jbefore[name][key], RTOL)
    jnns, jinfo = jft.aposteriori_finetune(jds, jmodel, jnns, maxiters=1, window=N_FRAMES)
    tnns, tinfo = tft.aposteriori_finetune(tds, tmodel, tnns, maxiters=1)  # window: N_FRAMES when called
    assert tinfo.keys() == jinfo.keys()
    for key in ("window", "stride", "substeps", "n_saveat", "inner_steps"):
        assert tinfo[key] == jinfo[key]
    _close([tinfo["loss_initial"], tinfo["loss_final"]], [jinfo["loss_initial"], jinfo["loss_final"]], RTOL)
    _weights_close(tnns, jnns, RTOL)


# ---------------------------------------------------------------------------
# checkpoints and main
# ---------------------------------------------------------------------------


def test_checkpoints_cross_both_ways(monkeypatch, jax_suites, tmp_path):
    """save_nns of either study loads in the other package's _load_nns, mPP meta included."""
    jds, jmodel, jnns, tds, tmodel, tnns = built(monkeypatch, jax_suites, "float32")
    calibrated = dataclasses.replace(tmodel, mpp=dataclasses.replace(tmodel.mpp, nu_0=torch.tensor(2e-4)))
    tft.save_nns(tnns, str(tmp_path / "port"), model=calibrated)
    jloaded, jmeta = jcli._load_nns(str(tmp_path / "port"))
    for got, want in zip(_leaves(tnns), jax.tree.leaves(jloaded)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert jmeta["mpp"]["nu_0"] == pytest.approx(2e-4) and jmeta["sims"] == ",".join(TRAIN)
    assert float(jcli._restore_mpp(jmeta)["mpp"].nu_0) == pytest.approx(2e-4)
    jmeta_expected = {k: v for k, v in jmeta.items() if k != "command"}
    jft.save_nns(jnns, str(tmp_path / "jax"), model=jmodel)
    tloaded, tmeta = tcli._load_nns(str(tmp_path / "jax"), "cpu")
    for got, want in zip(_leaves(tloaded), jax.tree.leaves(jnns)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert {k: v for k, v in tmeta.items() if k not in ("command", "mpp")} == {
        k: v for k, v in jmeta_expected.items() if k != "mpp"}
    assert tmeta["mpp"] == jcli._mpp_meta(jmodel)
    # An ensemble crosses too (the stacked member axis).
    stacked = tde.stack_members(tft.build_ensemble_members(2, device="cpu"))
    tft.save_nns(stacked, str(tmp_path / "ens"), ensemble=2, model=tmodel)
    jens, jens_meta = jcli._load_nns(str(tmp_path / "ens"))
    assert jens_meta["ensemble"] == 2 and jde.ensemble_size(jens) == 2
    for got, want in zip(_leaves(stacked), jax.tree.leaves(jens)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _key_tree(obj):
    if isinstance(obj, dict):
        return {k: _key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [_key_tree(v) for v in obj]
    return None


def test_main_runs_through_its_flags(monkeypatch, jax_suites, tmp_path):
    """--mode train with --calibrate-mpp --smoke, both scripts: the --out JSON's keys at every level are JAX's; then
    the other modes and the refusals of the port's main on the CPU."""
    configure(monkeypatch, jax_suites, "float32")
    # The JAX script's nde_train binds its stages when it is defined: hand it the reduced ones.
    monkeypatch.setattr(jft, "nde_train", functools.partial(jft.nde_train, stages=[(w, s, 3, lr) for w, s, _, lr
                                                                                  in STAGES]))
    # Its calibration window (200 frames) is longer than the reduced suite: give it the suite's (the port cuts it).
    monkeypatch.setattr(jft, "calibrate_mpp", functools.partial(jft.calibrate_mpp, window=N_FRAMES))
    argv = ["--calibrate-mpp", "--smoke", "--pretrain-epochs", "2", "--shooting", "3"]
    jres = jft.main([*argv, "--save-nns", str(tmp_path / "jax"), "--out", str(tmp_path / "jax.json")])
    tres = tft.main(["--device", "cpu", *argv, "--save-nns", str(tmp_path / "port"), "--out",
                     str(tmp_path / "port.json")])
    assert _key_tree(json.loads((tmp_path / "port.json").read_text())) == _key_tree(
        json.loads((tmp_path / "jax.json").read_text()))
    assert [r["maxiters"] for r in tres["stages"]] == [3, 3] and [r["shooting"] for r in tres["stages"]] == [0, 3]
    assert tres["held_out"].keys() == set(TEST) and all(np.isfinite(v) for v in tres["held_out"][TEST[0]].values())
    # The JAX run's checkpoint, evaluated by the port's --eval-checkpoint over its calibrated mPP base, scores what
    # the JAX run scored (nde, mpp; the KPP columns are the f32 pipeline case's).
    teval = tft.main(["--device", "cpu", "--eval-checkpoint", str(tmp_path / "jax")])
    assert teval.keys() == {"eval_checkpoint", "ensemble", "held_out"} and teval["ensemble"] == 0
    for key in ("nde", "mpp"):
        _close(teval["held_out"][TEST[0]][key], jres["held_out"][TEST[0]][key], F32_RTOL)
    # The other modes and the split curriculum run through the port's main.
    out = tft.main(["--device", "cpu", "--mode", "embedded-eval", "--eval-checkpoint", str(tmp_path / "jax"),
                    "--ft-substeps", "9"])
    assert out["embedded_substeps"] == 9 and out["held_out"][TEST[0]].keys() == {
        "embedded", "embedded_twin", "nde", "mpp", "win_vs_twin"}
    out = tft.main(["--device", "cpu", "--mode", "aposteriori", "--eval-checkpoint", str(tmp_path / "jax"),
                    "--ft-maxiters", "1", "--save-nns", str(tmp_path / "apost")])
    assert out["finetune"]["maxiters"] == 1 and set(out["improvement"][TEST[0]]) == {
        "embedded_before", "embedded_after", "improvement", "win_vs_twin_after", "nde_before", "nde_after"}
    out = tft.main(["--device", "cpu", "--init-from", str(tmp_path / "port"), "--pretrain-epochs", "0", "--stages",
                    "1", "--host-matched-substeps", "--finish-aposteriori", "--ft-maxiters", "1", "--save-nns",
                    str(tmp_path / "fin")])
    assert [(r["window"], r["inner_steps"]) for r in out["stages"]] == [(37, 36)] and out["pretrain"] == {}
    assert (tmp_path / "fin_nde_stage" / "state.npz").exists() and "aposteriori" in out
    for bad, match in ((["--finish-aposteriori", "--ensemble", "2"], None),
                       (["--mode", "embedded-eval"], "needs --eval-checkpoint"),
                       (["--mode", "aposteriori"], "needs --eval-checkpoint"),
                       (["--init-from", str(tmp_path / "port"), "--ensemble", "2"], None)):
        with pytest.raises(SystemExit, match=match):
            tft.main(["--device", "cpu", *bad])
    with pytest.raises(RuntimeError, match="needs a card"):
        tft.main(["--device", "cpu", "--mode", "step-bench"])


def stored_gap_rows() -> dict:
    """``runs/wm_flagship_fold`` on the three held-out sims at full size in float32 on the CPU: the JAX study, the port
    on its own stand-ins and the port on the JAX package's suite, each beside ``docs/flagship_run_fold.json``."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    run = str(repo / "runs" / "wm_flagship_fold")
    stored = json.loads((repo / "docs" / "flagship_run_fold.json").read_text())["held_out"]
    jax_eval = jft.main(["--eval-checkpoint", run])["held_out"]
    own = tft.main(["--device", "cpu", "--eval-checkpoint", run])["held_out"]
    cache = {}

    def handed(names, Nz=32, device=None):
        if tuple(names) not in cache:
            cache[tuple(names)] = _to_torch(jcli._load_suite(list(names), Nz, None, jft.N_FRAMES - 1, 600.0))
        return cache[tuple(names)]

    tft.load_suite = handed
    on_jax_suite = tft.main(["--device", "cpu", "--eval-checkpoint", run])["held_out"]
    return {name: {key: {"stored": stored[name][key], "jax": jax_eval[name][key], "port": own[name][key],
                         "port_on_jax_suite": on_jax_suite[name][key]}
                   for key in ("nde", "mpp", "kpp", "kpp_ref_dt")} for name in stored}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name, row in stored_gap_rows().items():
        for key, v in row.items():
            print(f"{name} {key}: stored {v['stored']:.6e}; JAX {v['jax'] / v['stored'] - 1:+.3e} from stored; port "
                  f"{v['port'] / v['jax'] - 1:+.3e} from JAX; port on the JAX suite "
                  f"{v['port_on_jax_suite'] / v['jax'] - 1:+.3e} from JAX")
