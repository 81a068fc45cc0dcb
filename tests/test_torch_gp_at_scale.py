"""Port parity: the GP-at-scale study (``studies/gp_at_scale.py``) against its port.

Both run the whole study once on the same reduced configuration: the flagship
suite's study module (``studies/flagship_training.py`` and its port) set to
2 training sims and 1 held-out sim of ``N_FRAMES = 37`` frames, the suites
generated once by the JAX package and handed to both ``load_suite``s (as in
``tests/test_torch_flagship_training.py``), ``--selection-stride 2`` and
``--skip-pallas`` (the Gram kernel A/B is a timing; the port's ``--gram-only``
is checked on its own). n = 2 x 37 = 74 pairs, so every ladder holds one size.
The per-flux sequential f64 path then runs in both on the splices the port
wrote (``--selection-from``, ``--ladders-from``, ``--fidelity-from``), with
``--force-seq-f64 --blocked-above 40 --blocked-block 32``: the blocked fit.

Tolerances, measured on this configuration:

- ``F64 = 1e-6`` where the fit is well conditioned (the jitter sweep's levels
  of 1e-4 and more: measured 4.7e-7) and for the fused fit's f64 weights;
- ``COND = 1e-2`` for whatever goes through a fit at the dtype-default jitter
  (``sqrt(eps)``: 1.5e-8 in f64) on the near-duplicate snapshot rows, in f32
  or f64: the selection's validation MSEs, the fidelity numbers, the final
  fits' held-out MSEs and band widths, the f32 weights (of their scale). The
  two packages' Cholesky factorizations round differently and these Grams
  amplify it: measured up to 3.9e-3 (the f64 fidelity MSE) and 4.5e-3 (f32
  weights);
- ``GP_DE = 1e-1`` for the study's GP-DE MSEs, which integrate 36 frames on
  those weights (measured 5.5e-2 in f32, 1.5e-3 in f64); the DE itself is held
  to ``1e-8`` on well-conditioned f64 models handed over from JAX
  (``test_gp_de_frames_match_jax``);
- the band coverages to two of the 1,221 held-out entries (37 frames x 33
  faces): a prediction at a band's edge may fall on either side.
"""

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.studies import flagship_training as tft
from climateparameterizations_jl_tpu_torch.studies import gp_at_scale as tgs
from studies import flagship_training as jft

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
F64, COND, GP_DE = 1e-6, 1e-2, 1e-1
TRAIN = ["wind_-5e-4_cooling_3e-8_new", "wind_-2e-4_heating_-1e-8_new"]
TEST = ["wind_-4.5e-4_cooling_2.5e-8"]
N_FRAMES = 37
COVERAGE_ATOL = 2 / (N_FRAMES * 33)
COMMON = ["--selection-stride", "2", "--skip-pallas"]
SEQ = ["--force-seq-f64", "--blocked-above", "40", "--blocked-block", "32"]


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    })


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """Both studies run once (plain, then per-flux f64 on the port's splices): their result dicts."""
    jgs = importlib.import_module("studies.gp_at_scale")
    tmp = tmp_path_factory.mktemp("gp_at_scale")
    suites = {}

    def suite(names):
        key = tuple(names)
        if key not in suites:
            suites[key] = jcli._load_suite(list(names), 32, None, N_FRAMES - 1, 600.0)
        return suites[key]

    mp = pytest.MonkeyPatch()
    for mod in (jft, tft):
        mp.setattr(mod, "TRAIN_FILES", list(TRAIN))
        mp.setattr(mod, "TEST_FILES", list(TEST))
        mp.setattr(mod, "N_FRAMES", N_FRAMES)
        mp.setattr(mod, "DATA_DIR", None)
    mp.setattr(jft, "load_suite", lambda names, Nz=32: suite(names))
    mp.setattr(tft, "load_suite", lambda names, Nz=32, device=None: _to_torch(suite(names)))
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {"tmp": tmp}
        out["jax"] = jgs.main(["--platform", "cpu", *COMMON, "--out", str(tmp / "jax.json")])
        out["port"] = tgs.main(["--device", "cpu", *COMMON, "--out", str(tmp / "port.json")])
        splices = ["--selection-from", str(tmp / "port.json"), "--ladders-from", str(tmp / "port.json"),
                   "--fidelity-from", str(tmp / "port.json")]
        out["jax_seq"] = jgs.main(["--platform", "cpu", *COMMON, *SEQ, *splices, "--out", str(tmp / "jax_seq.json")])
        out["port_seq"] = tgs.main(["--device", "cpu", *COMMON, *SEQ, *splices, "--out", str(tmp / "port_seq.json")])
        out["port_spliced"] = tgs.main(["--device", "cpu", *COMMON, *SEQ, *splices, "--gp-full-from",
                                        str(tmp / "jax_seq.json"), "--out", str(tmp / "port_spliced.json")])
        out["model"] = tft.build(device="cpu")[1]
        out["jmodel"] = jft.build()[1]
        out["jds"] = suite(TRAIN)
    finally:
        torch.set_num_threads(before)
        mp.undo()
    return out


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return {k for key, v in tree.items() for k in {f"{prefix}{key}"} | _keys(v, f"{prefix}{key}/")}
    return set()


@pytest.mark.parametrize("run", ["", "_seq"])
def test_every_jax_key(studies, run):
    jax_keys, port_keys = _keys(studies["jax" + run]), _keys(studies["port" + run])
    # The Gram A/B's keys carry the port's backend names (gram_plain / gram_cuda); --skip-pallas leaves it out here.
    assert jax_keys <= port_keys, sorted(jax_keys - port_keys)
    saved = json.loads((studies["tmp"] / f"port{run}.json").read_text())
    assert _keys(saved) == port_keys and saved["backend"] == "cpu"


def test_selection_matches_jax(studies):
    jsel, tsel = studies["jax"]["selection"], studies["port"]["selection"]
    assert jsel.keys() == tsel.keys() == {"uw", "vw", "wT"}
    for flux in jsel:
        for key in ("kernel", "runner_up"):
            assert tsel[flux][key] == jsel[flux][key], flux
        for key in ("log_gamma", "runner_up_log_gamma"):
            assert tsel[flux][key] == jsel[flux][key], flux
        for key in ("val_mse", "runner_up_mse"):
            np.testing.assert_allclose(tsel[flux][key], jsel[flux][key], rtol=COND, err_msg=f"{flux} {key}")


def test_fit_weights_match_jax(studies):
    """The fused 3-flux fit of ``_timed_fit`` at the ladder's size, in f32 and f64, on the selected kernels."""
    from climateparameterizations_jl_tpu.closures.gp import get_kernel, gp_fit_multi

    jds, model = studies["jds"], studies["model"]
    sel = studies["port"]["selection"]
    for dtype, jdt, tdt, rtol in (("f64", jnp.float64, torch.float64, F64), ("f32", jnp.float32, torch.float32, COND)):
        jk = [get_kernel(tgs.FAMILY_IDS[sel[f]["kernel"]], sel[f]["log_gamma"], 0.0, "euclidean", dtype=jdt)
              for f in ("uw", "vw", "wT")]
        tk = [from_reference(k, "cpu") for k in jk]
        z = np.linspace(0.0, 1.0, 96)
        tds = _to_torch(jds)
        xs, jys, tys = None, [], []
        for flux in ("uw", "vw", "wT"):
            x, y = tgs._pairs(tds, model.scalings, flux, tdt)
            xs = x if xs is None else xs
            tys.append(y)
            jys.append(jnp.asarray(y.numpy()))
        n = xs.shape[0]
        want = gp_fit_multi(tgs._subset(jnp.asarray(xs.numpy()), n), [tgs._subset(y, n) for y in jys], jk,
                            jnp.asarray(z, jdt))
        got = tgs.fit_alphas(xs, tys, tk, torch.tensor(z, dtype=tdt), n)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w.alpha), rtol=rtol,
                                       atol=rtol * float(np.abs(np.asarray(w.alpha)).max()), err_msg=dtype)


@pytest.mark.parametrize("run", ["", "_seq"])
def test_final_fit_bands_and_gp_de_match_jax(studies, run):
    j, t = studies["jax" + run], studies["port" + run]
    assert t["n_full"] == j["n_full"] == 2 * N_FRAMES
    assert [r["n"] for r in t["build_f32"]] == [r["n"] for r in j["build_f32"]]
    assert [r["n"] for r in t["build_f64"]] == [r["n"] for r in j["build_f64"]]
    assert t["final_fit"] == j["final_fit"]
    assert t["jitter_used"] == j["jitter_used"]
    for key in ("mse_f32", "mse_f64", "max_abs_pred_diff", "rms_pred"):
        np.testing.assert_allclose(t["f32_vs_f64"][key], j["f32_vs_f64"][key], rtol=COND, err_msg=key)
    for trow, jrow in zip(t["jitter_sweep"], j["jitter_sweep"]):
        assert trow["jitter_scale"] == jrow["jitter_scale"]
        rtol = COND if jrow["jitter_scale"] == "dtype-default" else F64
        np.testing.assert_allclose(trow["val_mse"], jrow["val_mse"], rtol=rtol, err_msg=str(jrow["jitter_scale"]))
    assert t["gp_full"].keys() == j["gp_full"].keys() == {"uw", "vw", "wT"}
    for flux, row in j["gp_full"].items():
        trow = t["gp_full"][flux]
        assert (trow["n"], trow["dtype"]) == (row["n"], row["dtype"])
        np.testing.assert_allclose(trow["lam"], row["lam"], rtol=COND)
        for name, sim in row["sims"].items():
            tsim = trow["sims"][name]
            assert tsim["calibration_role"] == sim["calibration_role"]
            np.testing.assert_allclose([tsim["mse"], tsim["mean_posterior_std"]], [sim["mse"], sim["mean_posterior_std"]],
                                       rtol=COND, err_msg=f"{flux} {name}")
            for band in ("band_raw", "band_calibrated"):
                assert abs(tsim[band]["coverage"] - sim[band]["coverage"]) <= COVERAGE_ATOL + 1e-12
                np.testing.assert_allclose(tsim[band]["mean_band"], sim[band]["mean_band"], rtol=COND)
    if run == "_seq":
        assert t["final_fit"]["mode"] == "per-flux sequential" and t["seq_f64_fit_mode"] == "blocked (tile 32)"
    for key in ("trajectory_mse", "trajectory_mse_T", "trajectory_mse_T_stride9"):
        np.testing.assert_allclose(t["gp_de"][key], j["gp_de"][key], rtol=GP_DE, err_msg=key)
    assert t["gp_de"]["frames"] == j["gp_de"]["frames"] == N_FRAMES
    assert t["gp_de"]["fused_gram"] == j["gp_de"]["fused_gram"]
    # The stored NDE run used the LES suite: no MSE of it stands beside a run on the synthetic stand-ins.
    assert t["gp_de"]["nde_mse_T_same_sim"] is None


def test_gp_de_frames_match_jax(studies):
    """The first GP-DE frames of the study's stage 6 on well-conditioned f64 models (jitter 1e-4) handed over."""
    from climateparameterizations_jl_tpu.closures.gp import get_kernel, gp_fit_multi
    from climateparameterizations_jl_tpu.data.containers import direct_regression_pairs, scaled_state_array
    from climateparameterizations_jl_tpu.models.gp_closure import FluxGPs, solve_gp_closure
    from climateparameterizations_jl_tpu_torch.models.gp_closure import solve_gp_closure as t_solve

    jds, jmodel = studies["jds"], studies["jmodel"]
    sel = studies["port"]["selection"]
    x, ys = None, []
    for flux in ("uw", "vw", "wT"):
        xf, yf = direct_regression_pairs(jds, jmodel.scalings, flux)
        x = xf if x is None else x
        ys.append(jnp.asarray(yf, jnp.float64))
    x = jnp.asarray(x, jnp.float64)
    kernels = [get_kernel(tgs.FAMILY_IDS[sel[f]["kernel"]], sel[f]["log_gamma"], 0.0, "euclidean", dtype=jnp.float64)
               for f in ("uw", "vw", "wT")]
    jgps = FluxGPs(*gp_fit_multi(x, ys, kernels, jnp.linspace(0.0, 1.0, 96), jitter_scale=1e-4))
    x0 = jnp.asarray(scaled_state_array(jds, jmodel.scalings)[0, 0], jnp.float64)
    dt_hat = float(600.0 / float(jmodel.tau))
    want = solve_gp_closure(jmodel, jgps, x0, 0.0, dt_hat, 4, n_substeps=2)
    got = t_solve(from_reference(jmodel, "cpu"), from_reference(jgps, "cpu"), torch.tensor(np.asarray(x0)), 0.0, dt_hat,
                  4, n_substeps=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-8 * float(np.abs(want).max()))
    assert float((got[-1] - got[0]).abs().max()) > 1e-6


def test_gp_full_splice_reads_the_jax_json(studies):
    """--gp-full-from on the JAX script's json and side file: every flux spliced, its band rows kept as written."""
    j, t = studies["jax_seq"], studies["port_spliced"]
    assert t["final_fit"] == j["final_fit"]
    for flux, row in j["gp_full"].items():
        assert t["gp_full"][flux]["spliced_from"].endswith("jax_seq.json")
        assert {k: v for k, v in t["gp_full"][flux].items() if k != "spliced_from"} == row
    np.testing.assert_allclose(t["gp_de"]["trajectory_mse"], j["gp_de"]["trajectory_mse"], rtol=GP_DE)


def test_gram_only_keys(tmp_path):
    out = tgs.main(["--device", "cpu", "--gram-only", "--smoke", "--out", str(tmp_path / "g.json")])
    # The JAX script's keys, with its backends' names mapped onto the port's ("xla" -> plain, "pallas" -> cuda).
    assert set(out) == {"backend", "gram_n", "x64", "gram_plain", "gram_cuda"}
    assert json.loads((tmp_path / "g.json").read_text()) == out
    assert out["gram_n"] == 256 and out["gram_cuda"]["n_train"] == 256 and out["gram_plain"]["median_s"] > 0
