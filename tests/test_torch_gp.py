"""Port parity: the GP closure path (``closures/gp.py``, ``models/gp_closure.py``, ``train-gp``).

The same inputs, made with a numpy seed, go through the JAX package and the
port on the CPU. The kernel backends are compared as each package runs them
here: JAX's ``"pallas"`` Gram in interpret mode, the port's ``"cuda"`` Gram
through its plain version (CPU tensors never launch the kernel).

Tolerances, with their reasons:

- f64 (``F64``: ``rtol=1e-6, atol=1e-9``): the same algorithm on both
  sides; LAPACK and the matmuls sum in other orders, and the jittered
  kernel matrix has a condition number up to ``1 / sqrt(eps_f64) ~ 7e7``,
  which amplifies f64 roundoff (1.1e-16, times n <= 48) to ~4e-7.
- f32 (``F32``: ``rtol=atol=2e-3``): the f32 jitter ``sqrt(eps_f32) = 3.45e-4``
  bounds the condition number by ~2.9e3, which amplifies f32 roundoff
  (1.2e-7) to ~3.5e-4 in the weights; the diagonal of a training Gram is
  an f32 cancellation (``aa + bb - 2ab``) whose noise differs between the
  packages (``ops/gram.py``).
- ``train-gp`` runs on data handed over from the JAX package (each
  package's own f32 synthetic data differ, ``tests/test_torch_data.py``),
  cast to f64 so that the reports agree to ``F64``; the f32 Gram of the
  ``cuda`` / ``pallas`` ML-II loop to ``rtol=1e-4`` (measured 1.1e-5).
"""

import dataclasses
import importlib
import json
import os
import sys
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from climateparameterizations_jl_tpu.closures import gp as jgp
from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.models import gp_closure as jgc
from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.closures import gp as tgp
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.models import gp_closure as tgc

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
_jax_load_suite = jcli._load_suite

F64 = dict(rtol=1e-6, atol=1e-9)
F32 = dict(rtol=2e-3, atol=2e-3)
TOL = {np.float64: F64, np.float32: F32}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _data(n=40, m=25, D=6, k=3, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D))
    y = np.concatenate([np.sin(x.sum(1, keepdims=True)), np.cos(x[:, :k - 1])], axis=1)
    xq = rng.normal(size=(m, D))
    return x.astype(dtype), y.astype(dtype), xq.astype(dtype), np.linspace(0.0, 1.0, D)


def _kernels(family, dtype, gamma=1.3, sigma=0.9, alpha=1.4, metric="euclidean", backend="plain"):
    jk = jgp.GPKernel(gamma=jnp.asarray(gamma, dtype), sigma=jnp.asarray(sigma, dtype), alpha=jnp.asarray(alpha, dtype),
                      family=family, metric=metric, backend={"plain": "xla", "cuda": "pallas"}[backend])
    t = lambda v: torch.tensor(v, dtype=TDTYPE[dtype])  # noqa: E731
    return jk, tgp.GPKernel(gamma=t(gamma), sigma=t(sigma), alpha=t(alpha), family=family, metric=metric,
                            backend=backend)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("family,metric,gamma", [("squared_exponential", "euclidean", 1.3),
                                                 ("matern32", "derivative", 1.3),
                                                 ("rational_quadratic", "antiderivative", 0.25)])
def test_fit_predict_uncertainty_and_loss_match_jax(dtype, family, metric, gamma):
    # gamma of the order of the distances keeps the f32 problems well conditioned
    # (antiderivative features are differences times dz = 0.2: short distances).
    x, y, xq, z = _data(dtype=dtype)
    jk, tk = _kernels(family, dtype, gamma=gamma, metric=metric)
    jm = jgp.gp_fit(x, y, jk, z)
    tm = tgp.gp_fit(torch.tensor(x), torch.tensor(y), tk, torch.tensor(z))
    tol = TOL[dtype]
    assert tm.alpha.dtype == TDTYPE[dtype]
    _close(tm.chol, jm.chol, tol)
    _close(tm.alpha, jm.alpha, tol)
    _close(tgp.gp_predict(tm, torch.tensor(xq)), jgp.gp_predict(jm, xq), tol)
    _close(tgp.gp_uncertainty(tm, torch.tensor(xq)), jgp.gp_uncertainty(jm, xq), tol)
    for add_constant in (False, True):
        _close(tgp.mean_log_marginal_loss(tm, torch.tensor(y), add_constant),
               jgp.mean_log_marginal_loss(jm, y, add_constant), tol)
    # 1-D targets, as gp_fit accepts them.
    _close(tgp.gp_fit(torch.tensor(x), torch.tensor(y[:, 0]), tk, torch.tensor(z)).alpha,
           jgp.gp_fit(x, y[:, 0], jk, z).alpha, tol)


@pytest.mark.parametrize("family", ["squared_exponential", "matern52"])
def test_cuda_backend_fit_matches_jax_pallas(family):
    x, y, xq, z = _data(dtype=np.float32, seed=1)
    jk, tk = _kernels(family, np.float32, backend="cuda")
    jm = jgp.gp_fit(x, y, jk, z)
    tm = tgp.gp_fit(torch.tensor(x), torch.tensor(y), tk, torch.tensor(z))
    _close(tm.alpha, jm.alpha, F32)
    _close(tgp.gp_predict(tm, torch.tensor(xq)), jgp.gp_predict(jm, xq), F32)
    _close(tgp.gp_uncertainty(tm, torch.tensor(xq)), jgp.gp_uncertainty(jm, xq), F32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fit_multi_matches_jax_and_shares_inputs(dtype):
    x, y, xq, z = _data(dtype=dtype, seed=2)
    ys = [y, 2.0 * y[:, :2], y[:, 0], -y, y[:, 1:]]
    specs = [("squared_exponential", 1.3), ("squared_exponential", 1.3), ("squared_exponential", 0.7),
             ("matern12", 1.1), (None, None)]
    jks, tks = [], []
    for family, gamma in specs:
        if family is None:  # a spectral-mixture kernel is fitted alone
            jks.append(jgp.default_spectral_mixture(1.5, dtype=dtype))
            tks.append(tgp.default_spectral_mixture(1.5, dtype=TDTYPE[dtype], device="cpu"))
        else:
            jk, tk = _kernels(family, dtype, gamma=gamma)
            jks.append(jk)
            tks.append(tk)
    jms = jgp.gp_fit_multi(x, ys, jks, z)
    tms = tgp.gp_fit_multi(torch.tensor(x), [torch.tensor(v) for v in ys], tks, torch.tensor(z))
    for jm, tm in zip(jms, tms):
        _close(tm.alpha, jm.alpha, TOL[dtype])
        _close(tgp.gp_predict(tm, torch.tensor(xq)), jgp.gp_predict(jm, xq), TOL[dtype])
    assert all(m.x_train is tms[0].x_train and m.z is tms[0].z for m in tms)
    assert tms[0].chol.data_ptr() == tms[1].chol.data_ptr()  # equal hyperparameters share one factorization
    with pytest.raises(ValueError, match="target sets"):
        tgp.gp_fit_multi(torch.tensor(x), [torch.tensor(y)], tks[:2], torch.tensor(z))


def test_kernel_ids_and_spectral_mixture_match_jax():
    x, _, xq, z = _data(D=4, seed=3)
    for kid in (1, 2, 3, 4, 5, 6):
        jk = jgp.get_kernel(kid, 0.2, 0.1, "derivative", alpha=1.5)
        tk = tgp.get_kernel(kid, 0.2, 0.1, "derivative", alpha=1.5, device="cpu")
        _close(tk.gram(torch.tensor(x), torch.tensor(xq), torch.tensor(z)), jk.gram(x, xq, z), F64)
        _close(tk.self_variance(torch.tensor(xq)), jk.self_variance(xq), F64)
    hyp = np.arange(1, 4 * 3 * 2 + 1) / 10.0  # ARD form: D = 4, Q = 2
    jsm = jgp.SpectralMixtureKernel.from_hyperparameters(hyp, D=4)
    tsm = tgp.SpectralMixtureKernel.from_hyperparameters(hyp, D=4, device="cpu")
    for name in ("w", "mu", "gamma"):
        _close(getattr(tsm, name), getattr(jsm, name), F64)
    _close(tsm.gram(torch.tensor(x), torch.tensor(xq)), jsm.gram(x, xq), F64)
    with pytest.raises(ValueError, match="3\\*D\\*Q"):
        tgp.SpectralMixtureKernel.from_hyperparameters(hyp[:-1], D=4, device="cpu")


def test_grid_search_matches_jax():
    x, y, xq, z = _data(n=48, seed=4)
    xv, yv = xq[:15], np.sin(xq[:15].sum(1, keepdims=True)) * np.ones((1, 3))
    log_gammas = np.linspace(-1.0, 1.0, 5)
    for kid in (1, 2, 5, 6):
        want = jgp.error_per_gamma(x, y, xv, yv, z, kid, log_gammas, "derivative")
        got = tgp.error_per_gamma(torch.tensor(x), torch.tensor(y), torch.tensor(xv), torch.tensor(yv),
                                  torch.tensor(z), kid, log_gammas, "derivative")
        np.testing.assert_allclose(got, want, rtol=1e-8)
    jk, jerr = jgp.best_kernel(x, y, xv, yv, z, kernel_ids=(1, 3, 6), log_gammas=log_gammas)
    tk, terr = tgp.best_kernel(torch.tensor(x), torch.tensor(y), torch.tensor(xv), torch.tensor(yv), torch.tensor(z),
                               kernel_ids=(1, 3, 6), log_gammas=log_gammas)
    assert type(tk).__name__ == type(jk).__name__ and getattr(tk, "family", None) == getattr(jk, "family", None)
    np.testing.assert_allclose(terr, jerr, rtol=1e-8)
    _close(tk.gamma, jk.gamma, F64)
    tm, predict = tgp.gp_flux_model(torch.tensor(x), torch.tensor(y), torch.tensor(z), tk)
    _close(predict(torch.tensor(xv)), jgp.gp_flux_model(x, y, z, jk)[1](xv), F64)


def test_failed_grid_point_is_nan_and_loses_the_argmin():
    # Small integer features make every f32 distance exact (d2 = 0 on the
    # diagonal). At log10 gamma = -25, gamma^2 underflows to 0 in f32, so the
    # diagonal of K is 0/0 = NaN and the factorization fails: in JAX (NaN
    # factor) and in the port (cholesky_ex reports it, the factor is NaN-filled).
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, size=(24, 5)).astype(np.float32)
    y = rng.normal(size=(24, 2)).astype(np.float32)
    xv, yv = x[:6] + 1.0, y[:6]
    log_gammas = np.array([-25.0, 0.0, 0.5, 1.0])
    want = jgp.error_per_gamma(x, y, xv, yv, None, 1, log_gammas)
    got = tgp.error_per_gamma(torch.tensor(x), torch.tensor(y), torch.tensor(xv), torch.tensor(yv), None, 1, log_gammas)
    assert np.isnan(want[0]) and np.isnan(got[0])
    np.testing.assert_allclose(got[1:], want[1:], **F32)
    jk, jerr = jgp.select_best_kernel({1: want}, log_gammas, "euclidean", 0.0, jnp.float32)
    tk, terr = tgp.select_best_kernel({1: got}, log_gammas, "euclidean", 0.0, torch.float32, device="cpu")
    assert float(tk.gamma) == float(jk.gamma) != 1e-25 and np.isfinite(terr)
    with pytest.raises(ValueError, match="every"):
        tgp.select_best_kernel({1: [float("nan")] * 4}, log_gammas, "euclidean", 0.0, torch.float32, device="cpu")


def test_indefinite_matrix_gives_nan_factor_as_in_jax():
    # A negative jitter makes the jittered Gram indefinite: JAX's cholesky
    # returns NaNs, torch.linalg.cholesky would raise; the port NaN-fills.
    x, y, _, z = _data(n=12)
    jk, tk = _kernels("squared_exponential", np.float64)
    jm = jgp.gp_fit(x, y, jk, z, jitter_scale=-2.0)
    tm = tgp.gp_fit(torch.tensor(x), torch.tensor(y), tk, torch.tensor(z), jitter_scale=-2.0)
    lower = np.tril_indices(12)
    for chol in (np.asarray(jm.chol), tm.chol.numpy()):
        assert np.isnan(chol[lower]).all() and (np.triu(chol, 1) == 0.0).all()
    assert torch.isnan(tm.alpha).all()


@pytest.mark.parametrize("backend,dtype,tol", [("plain", np.float64, dict(rtol=1e-7, atol=1e-10)),
                                               ("cuda", np.float32, dict(rtol=1e-4, atol=1e-5))])
def test_ml2_matches_jax(backend, dtype, tol):
    x, y, _, z = _data(n=32, seed=6, dtype=dtype)
    jk, tk = _kernels("rational_quadratic", dtype, gamma=2.0, sigma=0.5, alpha=1.0, backend=backend)
    jfit, jlosses = jgp.optimize_kernel_hyperparameters(x, y, jk, z, iters=6)
    tfit, tlosses = tgp.optimize_kernel_hyperparameters(torch.tensor(x), torch.tensor(y), tk, torch.tensor(z), iters=6)
    np.testing.assert_allclose(tlosses, jlosses, **tol)
    for name in ("gamma", "sigma", "alpha"):
        _close(getattr(tfit, name), getattr(jfit, name), tol)
    assert tlosses[-1] < tlosses[0] and tfit.backend == backend


def test_ml2_spectral_mixture_and_python_scalars_match_jax():
    x, y, _, z = _data(n=24, D=3, seed=7)
    jfit, jlosses = jgp.optimize_kernel_hyperparameters(x, y, jgp.default_spectral_mixture(0.8), z, iters=3)
    tfit, tlosses = tgp.optimize_kernel_hyperparameters(
        torch.tensor(x), torch.tensor(y), tgp.default_spectral_mixture(0.8, device="cpu"), torch.tensor(z), iters=3)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-7)
    for name in ("w", "mu", "gamma"):
        _close(getattr(tfit, name), getattr(jfit, name), dict(rtol=1e-7, atol=1e-10))
    # Python-scalar hyperparameters are optimized too (not silently skipped).
    jk = jgp.GPKernel(gamma=1.0, sigma=1.0, alpha=1.0)
    tk = tgp.GPKernel(gamma=1.0, sigma=1.0, alpha=1.0)
    jfit, jlosses = jgp.optimize_kernel_hyperparameters(x, y, jk, z, iters=3)
    tfit, tlosses = tgp.optimize_kernel_hyperparameters(torch.tensor(x), torch.tensor(y), tk, torch.tensor(z), iters=3)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-7)
    assert float(tfit.gamma) != 1.0


def _flux_gps(pkg, x, ys, kernel, z):
    fit = jgp.gp_fit_multi if pkg == "jax" else tgp.gp_fit_multi
    models = fit(x, ys, [kernel] * 3, z)
    return (jgc.FluxGPs if pkg == "jax" else tgc.FluxGPs)(*models)


@pytest.mark.parametrize("backend,dtype,tol", [("plain", np.float64, F64), ("cuda", np.float32, F32)])
def test_solve_gp_closure_matches_jax(backend, dtype, tol):
    Nz = 8
    jmodel, _, _, _ = graft._make_setup(Nz=Nz, n_columns=1)
    tmodel = from_reference(jmodel, "cpu")
    rng = np.random.default_rng(8)
    x = (0.3 * rng.normal(size=(30, 3 * Nz))).astype(dtype)
    ys = [(0.1 * rng.normal(size=(30, Nz + 1))).astype(dtype) for _ in range(3)]
    x0 = x[:5] + (0.01 * rng.normal(size=(5, 3 * Nz))).astype(dtype)
    z = np.linspace(0.0, 1.0, 3 * Nz)
    jk, tk = _kernels("matern52", dtype, gamma=2.0, sigma=1.0, backend=backend)
    jgps = _flux_gps("jax", x, ys, jk, jnp.asarray(z))  # one z object, so JAX shares the Gram too
    tgps = _flux_gps("torch", torch.tensor(x), [torch.tensor(v) for v in ys], tk, torch.tensor(z))
    assert tgc._share_gram(tgps) and jgc._share_gram(jgps)
    want = jgc.solve_gp_closure(jmodel, jgps, x0, 0.0, 1e-4, 3, n_substeps=2)
    got = tgc.solve_gp_closure(tmodel, tgps, torch.tensor(x0), 0.0, 1e-4, 3, n_substeps=2)
    assert got.shape == (4, 5, 3 * Nz) and torch.isfinite(got).all()
    assert float((got[-1] - got[0]).abs().max()) > 1e-6  # the state moved
    _close(got, want, tol)
    # Without shared objects each flux predicts alone; same trajectory.
    split = tgc.FluxGPs(*(dataclasses.replace(m, x_train=m.x_train.clone()) for m in tgps))
    assert not tgc._share_gram(split) and tgc._share_gram(tgc.share_train_inputs(split))
    _close(tgc.solve_gp_closure(tmodel, split, torch.tensor(x0), 0.0, 1e-4, 3, n_substeps=2), want, tol)


def test_bridge_carries_gp_models():
    x, y, xq, z = _data(n=20, seed=9)
    jk = jgp.GPKernel(gamma=jnp.float64(1.2), sigma=jnp.float32(0.8), alpha=jnp.float64(1.0), backend="pallas")
    jgps = jgc.FluxGPs(*jgp.gp_fit_multi(x, [y, y, y], [jgp.get_kernel(3, 0.1)] * 3, z))
    tk = from_reference(jk, "cpu")
    assert tk.backend == "cuda" and tk.gamma.dtype == torch.float64 and tk.sigma.dtype == torch.float32
    assert from_reference(dataclasses.replace(jk, backend="xla"), "cpu").backend == "plain"
    tgps = from_reference(jgps, "cpu")
    assert isinstance(tgps, tgc.FluxGPs) and tgps.uw.alpha.dtype == torch.float64
    np.testing.assert_array_equal(tgps.vw.chol.numpy(), np.asarray(jgps.vw.chol))
    _close(tgp.gp_predict(tgps.wT, torch.tensor(xq)), jgp.gp_predict(jgps.wT, xq), F64)
    sm = from_reference(jgp.default_spectral_mixture(0.5), "cpu")
    assert isinstance(sm, tgp.SpectralMixtureKernel) and sm.w.dtype == torch.float64


def _handed_over(ds_jax, device="cpu"):
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    }).to(device)


def test_direct_regression_pairs_match_jax():
    ds = _jax_load_suite(["strong_wind"], 8, n_save=6, dt_save=600.0)
    scalings = jc.fit_wind_mixing_scalings(ds)
    tds = _handed_over(ds)
    tscalings = tc.fit_wind_mixing_scalings(tds)
    for flux in ("uw", "vw", "wT"):
        jx, jy = jc.direct_regression_pairs(ds, scalings, flux)
        tx, ty = tc.direct_regression_pairs(tds, tscalings, flux)
        assert tx.shape == (7, 24) and ty.shape == (7, 9)
        _close(tx, jx, dict(rtol=1e-5, atol=1e-5))
        _close(ty, jy, dict(rtol=1e-5, atol=1e-5))
    with pytest.raises(KeyError):
        tc.direct_regression_pairs(tds, tscalings, "uT")


# --- train-gp: the JAX command's TINY size (tests/test_cli.py), data handed over in f64 --------------------

TINY = ["--nz", "16", "--n-save", "12", "--dt-save", "600"]
CLI_CASES = {
    "ml2_cuda_integrate": ["--sims", "strong_wind", "--fluxes", "wT", "--subsample", "12", "--kernel-ids", "1,2",
                           "--optimize-hyperparams", "--hyperopt-iters", "5", "--integrate", "--gram-backend", "cuda"],
    "loo_spectral_mixture": ["--sims", "strong_wind,free_convection", "--fluxes", "wT", "--subsample", "12",
                             "--kernel-ids", "1,6"],
}


def _f64_suite(*args, **kwargs):
    ds = _jax_load_suite(*args, **kwargs)
    return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64) if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating)
                        else v, ds)


def _run_cli(pkg, case, out):
    args = ["train-gp", "--test-sims", "strong_wind_weak_cooling", *TINY, *CLI_CASES[case], "--output", out]
    if pkg == "jax":
        args = [a.replace("cuda", "pallas") for a in args]
        # The JAX command's PNG comes from a stand-in module: importing the
        # real one loads matplotlib, seconds of test time for a plot unused here.
        no_plot = types.SimpleNamespace(plot_gp_uncertainty=lambda *a, **k: None)
        with mock.patch.object(jcli, "_load_suite", _f64_suite), \
                mock.patch.dict(sys.modules, {"climateparameterizations_jl_tpu.eval.animations": no_plot}):
            assert jcli.main(["--platform", "cpu", *args]) == 0
    else:
        def handed(*a, device=None, **k):
            return _handed_over(_f64_suite(*a, **k), device)

        with mock.patch.object(tcli, "_load_suite", handed):
            assert tcli.main(["--device", "cpu", *args]) == 0
    with open(os.path.join(out, "gp_report.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_train_gp_matches_jax(case, tmp_path, capsys):
    want = _run_cli("jax", case, str(tmp_path / "jax"))
    got = _run_cli("torch", case, str(tmp_path / "torch"))
    assert not os.path.exists(tmp_path / "torch" / "gp_uncertainty_wT.png")
    assert sorted(got) == sorted(want)
    tol = dict(rtol=1e-4) if "cuda" in case else F64
    for key, section in want.items():
        assert sorted(got[key]) == sorted(section)
        for name, value in section.items():
            if isinstance(value, str):
                assert got[key][name] == value
            else:
                np.testing.assert_allclose(got[key][name], value, **tol, err_msg=f"{key}.{name}")
    if "integrate" in case:
        assert "ML-II" in capsys.readouterr().out and want["gp_de"]["frames"] == 13


def test_train_gp_on_its_own_data(tmp_path, capsys):
    # The port's own synthetic suite (f32), as the JAX command's test runs it.
    out = str(tmp_path / "gp")
    assert tcli.main(["--device", "cpu", "train-gp", "--sims", "strong_wind", "--test-sims",
                      "strong_wind_weak_cooling", *TINY, "--fluxes", "wT", "--subsample", "8", "--output", out]) == 0
    with open(os.path.join(out, "gp_report.json")) as f:
        report = json.load(f)
    assert np.isfinite(report["wT"]["mse"]) and report["wT"]["mean_posterior_variance"] >= 0.0
    assert f"train-gp[wT]: kernel {report['wT']['kernel']}" in capsys.readouterr().out


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_gp_entry_points_raise_without_card(no_card, tmp_path):
    for make in (lambda: tgp.get_kernel(1, 0.0), lambda: tgp.default_spectral_mixture(1.0),
                 lambda: tgp.SpectralMixtureKernel.from_hyperparameters(np.ones(3)),
                 lambda: benchmarks.gp_inputs(8, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["train-gp", *TINY, "--output", str(tmp_path)])


@pytest.mark.parametrize("bench", [
    lambda: benchmarks.bench_gp(8, 4, device="cpu"),
    lambda: benchmarks.bench_gp_ml2_step(8, 4, device="cpu"),
    lambda: benchmarks.bench_gram(8, 8, 4, device="cpu"),
    lambda: benchmarks.bench_cholesky(8, 8, device="cpu"),
], ids=["bench_gp", "bench_gp_ml2_step", "bench_gram", "bench_cholesky"])
def test_gp_benches_refuse_cpu(bench):
    with pytest.raises(RuntimeError, match="card"):
        bench()


def test_ml2_loss_and_grad_backends_agree_on_cpu():
    # The smoke's kernel-vs-plain ML-II check, at a small size on the CPU (both plain here).
    loss_c, grad_c = benchmarks.ml2_loss_and_grad(64, 12, "cuda", device="cpu")
    loss_p, grad_p = benchmarks.ml2_loss_and_grad(64, 12, "plain", device="cpu")
    assert grad_c.shape == (3,) and torch.isfinite(grad_c).all()
    np.testing.assert_allclose(float(loss_c), float(loss_p), rtol=1e-5)
    np.testing.assert_allclose(grad_c.numpy(), grad_p.numpy(), rtol=1e-3, atol=1e-4)
