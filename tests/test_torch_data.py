"""Port parity: the catalog, the synthetic LES stand-ins and the data path.

The JAX package's ``data/`` and ``core/coarse_grain.py`` are the reference.
Where the point is the algorithm the data are float64 on both sides
(``rtol=1e-10``: the same operations in the same order). The generator's
own working precision is f32; there the stiff mPP switch (``tanh`` of the
Richardson number) amplifies the last-ulp differences between XLA's and
PyTorch's f32 transcendentals, so fields agree to ``2e-3`` of their largest
entry after 20 saves (measured up to 1.0e-3), the cross-platform drift the
JAX package records for the same generator (``data/synthetic.py:42-57``),
and fluxes to an absolute floor of a few T ulps diffused by the mPP ``nu``
(``F32_FLUX_FLOOR``).
"""

import dataclasses
import importlib


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.core import coarse_grain as jcg
from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.data import registry as jr
from climateparameterizations_jl_tpu.data import synthetic as js
from climateparameterizations_jl_tpu.physics.mpp import MPPParameters as JMPP
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.core import coarse_grain as tcg
from climateparameterizations_jl_tpu_torch.core import scalings as tsc
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.data import registry as tr
from climateparameterizations_jl_tpu_torch.data import synthetic as ts
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters as TMPP

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")  # the package re-exports main()

FIELDS = ("u", "v", "T", "uw", "vw", "wT", "t")
# f32 flux floor: an ulp of T ~ 19 (1.9e-6 K) diffused by nu <= 0.1 m^2/s over
# dz = 16 m is 1.2e-8 in wT (and in uw, vw for u, v ulps); 8 such ulps.
F32_FLUX_FLOOR = 1e-7
SMALL = dict(Nz=16, n_save=20)


def _close(got, want, rtol=1e-10, scale_atol=1e-12, floor=0.0):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale_atol * max(float(np.abs(want).max()), 1e-30) + floor)


def _close_f32(got, want, field):
    _close(got, want, rtol=0, scale_atol=2e-3, floor=F32_FLUX_FLOOR if field in ("uw", "vw", "wT") else 0.0)


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    })


def _jax64(**kw):
    return js.synthetic_wind_mixing_les(dtype=jnp.float64, mpp=JMPP.default(jnp.float64), **SMALL, **kw)


def test_catalog_matches_jax():
    assert tr.WIND_MIXING_CATALOG == jr.WIND_MIXING_CATALOG
    for name in tr.WIND_MIXING_CATALOG:
        assert dataclasses.astuple(tr.simulation_parameters(name)) == dataclasses.astuple(jr.simulation_parameters(name))
        assert tr.lesbrary_relative_path(name) == jr.lesbrary_relative_path(name)
    with pytest.raises(KeyError):
        tr.simulation_parameters("wind_fast")


def test_unported_sources_raise():
    # The 3-D LES is not ported; a data_dir without the name's file falls back
    # to the synthetic stand-in, as in the JAX package (files: test_torch_lesbrary.py).
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tr.load_simulation("wind_-5e-4_new", source="les3d")
    small = dict(Nz_les=16, n_save=2)
    assert torch.equal(tr.load_simulation("wind_-5e-4_new", data_dir="/nonexistent", **small).T,
                       tr.load_simulation("wind_-5e-4_new", **small).T)
    assert torch.equal(tcli._load_suite(["wind_-5e-4_new"], 8, data_dir="/nonexistent", device="cpu", **small).T,
                       tcli._load_suite(["wind_-5e-4_new"], 8, device="cpu", **small).T)


def test_three_layer_profile():
    z = np.linspace(-256.0, 0.0, 41)
    _close(ts.three_layer_profile(torch.tensor(z)), js.three_layer_profile(jnp.asarray(z)), rtol=1e-14)


@pytest.mark.parametrize("diurnal", [False, True])
def test_generator_matches_jax_f64(diurnal):
    kw = dict(Qu=-2e-4, Qb=-1e-8, diurnal=diurnal)
    j = _jax64(**kw)
    t = ts.synthetic_wind_mixing_les(dtype=torch.float64, mpp=TMPP.default(torch.float64, "cpu"), **SMALL, **kw)
    for f in FIELDS:  # near-zero diurnal fluxes: sin() of a large argument, so atol on the field's scale
        _close(getattr(t, f), getattr(j, f), scale_atol=1e-10)
    for f in ("u_top", "theta_top", "theta_bottom", "diurnal_amplitude", "H", "f", "alpha"):
        _close(getattr(t, f), getattr(j, f), rtol=1e-14)


@pytest.mark.parametrize("name", ["wind_-5e-4_cooling_3e-8_new", "wind_-5e-4_diurnal_3e-8", "strong_wind_no_coriolis"])
def test_load_simulation_matches_jax_f32(name):
    j = jr.load_simulation(name, Nz_les=16, n_save=20)
    t = tr.load_simulation(name, Nz_les=16, n_save=20)
    assert t.T.dtype == torch.float32 and t.T.device.type == "cpu"
    for f in FIELDS:
        _close_f32(getattr(t, f), getattr(j, f), f)


def test_batched_generator_matches_per_sim():
    # One batched split solve over members that share the column, against
    # the per-simulation generator: every op is per column, so the members
    # agree to a few f32 ulps of each field's scale.
    Qus, Qbs = [-5e-4, -2e-4, -3.5e-4], [3e-8, -1e-8, 0.0]
    batched = ts._synthetic_wind_mixing_les_batch(Qus, Qbs, **SMALL)
    for Qu, Qb, got in zip(Qus, Qbs, batched):
        want = ts.synthetic_wind_mixing_les(Qu=Qu, Qb=Qb, **SMALL)
        for f in FIELDS + ("u_top", "theta_top", "diurnal_amplitude"):
            np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), rtol=0,
                                       atol=8 * np.finfo(np.float32).eps * float(getattr(want, f).abs().max()))


@pytest.mark.parametrize("kind,N,n", [
    (kind, N, n) for kind in ("center", "face", "face_interp") for N, n in ((128, 32), (16, 8), (130, 33))
    if kind != "center" or N % n == 0  # center coarse-graining needs n | N
])
def test_coarse_grain_matches_jax(kind, N, n):
    phi = np.random.default_rng(N + n).normal(size=(3, 5, N))
    jfn = {"center": jcg.coarse_grain_center, "face": jcg.coarse_grain_face,
           "face_interp": jcg.coarse_grain_linear_interpolation}[kind]
    tfn = {"center": tcg.coarse_grain_center, "face": tcg.coarse_grain_face,
           "face_interp": tcg.coarse_grain_linear_interpolation}[kind]
    _close(tfn(torch.tensor(phi), n), jfn(jnp.asarray(phi), n), rtol=1e-12)


def _suite64():
    return [_jax64(Qu=-5e-4, Qb=3e-8), _jax64(Qu=-2e-4, Qb=-1e-8), _jax64(Qu=-3.5e-4, Qb=2e-8)]


def test_coarsen_enforce_stack_scalings_match_jax():
    jds = _suite64()
    j_coarse = [jc.enforce_surface_fluxes(jc.coarsen_dataset(d, 8)) for d in jds]
    t_coarse = [tc.enforce_surface_fluxes(tc.coarsen_dataset(_to_torch(d), 8)) for d in jds]
    jst, tst = jc.stack_datasets(j_coarse), tc.stack_datasets(t_coarse)
    for f in dataclasses.fields(tc.ColumnTimeSeries):
        _close(getattr(tst, f.name), getattr(jst, f.name), rtol=1e-12)
    for kind in ("zero_mean_unit_variance", "min_max"):
        jsc = jc.fit_wind_mixing_scalings(j_coarse, kind)
        tsc_ = tc.fit_wind_mixing_scalings(t_coarse, kind)
        for var in ("u", "v", "T", "uw", "vw", "wT"):
            for leaf in dataclasses.fields(getattr(tsc_, var)):
                _close(getattr(getattr(tsc_, var), leaf.name), getattr(getattr(jsc, var), leaf.name), rtol=1e-12)


def test_enforce_surface_fluxes_refuses_diurnal():
    ds = _to_torch(_jax64(Qu=-5e-4, Qb=3e-8, diurnal=True))
    with pytest.raises(ValueError, match="diurnal"):
        tc.enforce_surface_fluxes(ds)


@pytest.mark.parametrize("diurnal", [None, True])
def test_training_tensors_match_jax(diurnal):
    jst = jc.stack_datasets([jc.coarsen_dataset(d, 8) for d in _suite64()])
    tst = _to_torch(jst)
    jsc = jc.fit_wind_mixing_scalings(jst)
    tscl = tc.fit_wind_mixing_scalings(tst)
    tsteps = np.arange(2, 21, 3)
    jb = jc.training_tensors(jst, jsc, tsteps, diurnal=diurnal)
    tb = tc.training_tensors(tst, tscl, tsteps, diurnal=diurnal)
    for f in ("x0", "targets", "t", "tau"):
        _close(getattr(tb, f), getattr(jb, f), rtol=1e-12)
    for f in dataclasses.fields(tb.bcs):
        _close(getattr(tb.bcs, f.name), getattr(jb.bcs, f.name), rtol=1e-12)
    with pytest.raises(ValueError, match="out of range"):
        tc.training_tensors(tst, tscl, np.arange(0, 30, 3))


def test_scalings_roundtrip():
    x = torch.tensor(np.random.default_rng(3).normal(size=50) * 3 + 1)
    for kind in ("zero_mean_unit_variance", "min_max"):
        s = tsc.fit_scaling(x, kind)
        torch.testing.assert_close(s.unscale(s.scale(x)), x)
    with pytest.raises(ValueError):
        tsc.fit_scaling(x, "robust")


def test_load_suite_and_wind_model_match_jax():
    names = ["wind_-5e-4_cooling_3e-8_new", "wind_-2e-4_heating_-1e-8_new", "wind_-3.5e-4_cooling_2e-8_new"]
    kw = dict(n_save=20, dt_save=600.0, Nz_les=16)
    tsuite = tcli._load_suite(names, 8, device="cpu", **kw)
    jsuite = jcli._load_suite(names, 8, **kw)
    assert tsuite.T.shape == (3, 21, 8) and tsuite.uw.shape == (3, 21, 9)
    for f in FIELDS:
        _close_f32(getattr(tsuite, f), getattr(jsuite, f), f)
    assert tcli._suite_diurnal_flags(names + ["wind_-5e-4_diurnal_3e-8", "unknown"]) == \
        jcli._suite_diurnal_flags(names + ["wind_-5e-4_diurnal_3e-8", "unknown"])
    # The model from the same suite: scalings and constants.
    jm = jcli._wind_model(jc.stack_datasets([jc.coarsen_dataset(d, 8) for d in _suite64()]), 8)
    tm = tcli._wind_model(_to_torch(jc.stack_datasets([jc.coarsen_dataset(d, 8) for d in _suite64()])), 8)
    for f in ("H", "tau", "f", "g", "alpha", "kappa"):
        _close(getattr(tm, f), getattr(jm, f), rtol=1e-7)
    for var in ("u", "v", "T", "uw", "vw", "wT"):
        _close(getattr(tm.scalings, var).sigma, getattr(jm.scalings, var).sigma, rtol=1e-12)
    assert tm.Nz == 8 and tm.mpp.nu_0.device.type == "cpu"


def test_load_suite_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli._load_suite(["wind_-5e-4_new"], 8, n_save=2, Nz_les=16)


