"""Port parity: the LESbrary ``.jld2`` readers and writers, the netCDF files, and ``--data-dir``.

The counterpart of ``tests/test_reference_layouts.py`` (less its three
download tests: the port has no downloader). Its byte-faithful fixtures of
the reference's two layouts, built with raw h5py calls, are imported from
that file. The port's reader must return the JAX reader's arrays bit for
bit; each package's writers must produce the same HDF5 datasets; and each
package reads the other's files to the same arrays. The port reads and
writes with its own HDF5 code (``data/hdf5.py``): its round trips run with
h5py blocked. The JAX package and the fixtures need h5py, so the cases that
use them skip where it is missing.
"""

import dataclasses
import importlib
import importlib.util
import sys

import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.data import free_convection as jfcd
from climateparameterizations_jl_tpu.data import lesbrary as jl
from climateparameterizations_jl_tpu.data import netcdf as jnc
from climateparameterizations_jl_tpu.data import registry as jr
from climateparameterizations_jl_tpu.data import synthetic as js
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.data import free_convection as tfcd
from climateparameterizations_jl_tpu_torch.data import lesbrary as tl
from climateparameterizations_jl_tpu_torch.data import netcdf as tnc
from climateparameterizations_jl_tpu_torch.data import registry as tr
from test_reference_layouts import HALO, ITERS, make_fc_fieldset_fixture, make_windmixing_statistics_fixture

HAVE_H5PY = importlib.util.find_spec("h5py") is not None
if HAVE_H5PY:
    import h5py

needs_h5py = pytest.mark.skipif(not HAVE_H5PY, reason="the JAX package's readers and writers need h5py")
jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
FIELDS = [f.name for f in dataclasses.fields(tc.ColumnTimeSeries)]
WM_NAME = "wind_-5e-4_cooling_3e-8_new"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_dataset(got, want, fields=FIELDS):
    """Every field bit for bit: same dtype, shape and values (``None`` where the other is ``None``)."""
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        name: None if getattr(ds_jax, name) is None else torch.tensor(np.asarray(getattr(ds_jax, name)))
        for name in FIELDS
    })


def _h5_datasets(path) -> dict:
    """``{name: (dtype, shape, value)}`` of every dataset in an HDF5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, (obj.dtype, obj.shape, obj[()]))
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _same_files(a, b):
    da, db = _h5_datasets(a), _h5_datasets(b)
    assert sorted(da) == sorted(db)
    for name in da:
        assert da[name][:2] == db[name][:2], name
        np.testing.assert_array_equal(da[name][2], db[name][2], err_msg=name)


# ---------------------------------------------------------------------------
# The reference's layouts, read
# ---------------------------------------------------------------------------


@needs_h5py
@pytest.mark.parametrize("variant", ["model", "flat"])
def test_statistics_layout_parses_bit_for_bit(tmp_path, variant):
    path = str(tmp_path / f"stats_{variant}.jld2")
    expect = make_windmixing_statistics_fixture(path, variant)
    ds = tl.read_les_profiles(path)
    _same_dataset(ds, jl.read_les_profiles(path))
    for ours, theirs in [("T", "T"), ("u", "u"), ("v", "v"), ("wT", "wT"), ("uw", "wu"), ("vw", "wv")]:
        np.testing.assert_array_equal(_np(getattr(ds, ours)), expect["data"][theirs].astype(np.float32))
    assert float(ds.theta_top) == pytest.approx(expect["theta_top"], rel=1e-6)  # lesbrary_data.jl:164-165
    assert ds.T.device.type == "cpu"
    f64 = tl.read_les_profiles(path, dtype=np.float64)
    _same_dataset(f64, jl.read_les_profiles(path, dtype=np.float64))
    np.testing.assert_array_equal(_np(f64.T), expect["data"]["T"])


@needs_h5py
def test_iteration_keys_sort_numerically(tmp_path):
    path = str(tmp_path / "stats.jld2")
    expect = make_windmixing_statistics_fixture(path)
    t = _np(tl.read_les_profiles(path).t)
    assert list(ITERS) != sorted(ITERS) and np.all(np.diff(t) > 0)
    np.testing.assert_array_equal(t, expect["t"].astype(np.float32))


@needs_h5py
def test_fc_fieldset_parses_with_halos_and_serialized_groups(tmp_path):
    path = str(tmp_path / "instantaneous_statistics_with_halos.jld2")
    expect = make_fc_fieldset_fixture(path)
    ds = tl.read_les_profiles(path)
    _same_dataset(ds, jl.read_les_profiles(path))
    np.testing.assert_array_equal(_np(ds.T), expect["T"].astype(np.float32))
    assert not np.any(_np(ds.T) == np.float32(999.0)), "halo cells leaked into T"
    assert float(ds.theta_top) == np.float32(expect["theta_top"])  # add_surface_fluxes.jl:2
    assert not ds.u.any() and not ds.v.any()


@needs_h5py
def test_fc_loader_reads_the_datadeps_layout(tmp_path):
    (tmp_path / "free_convection_3").mkdir()
    expect = make_fc_fieldset_fixture(str(tmp_path / "free_convection_3" / "instantaneous_statistics_with_halos.jld2"))
    got = tfcd.load_free_convection_simulation(3, data_dir=str(tmp_path), Nz=8)
    want = jfcd.load_free_convection_simulation(3, data_dir=str(tmp_path), Nz=8)
    assert got.T.shape == (len(ITERS), 8)
    for name in FIELDS:  # coarse-graining: f32 block means and interpolation, summed in other orders
        if getattr(want, name) is not None:
            np.testing.assert_allclose(_np(getattr(got, name)), np.asarray(getattr(want, name)), rtol=1e-6,
                                       atol=1e-6 * float(np.abs(np.asarray(getattr(want, name))).max()))
    np.testing.assert_allclose(_np(got.T).mean(-1), expect["T"].astype(np.float32).mean(-1), rtol=1e-6)
    # An id without a file falls back to its synthetic stand-in; a mixed suite loads in order.
    suite = tfcd.load_free_convection_suite([3, 1], data_dir=str(tmp_path), Nz=8, Nz_les=16, n_save=3)
    assert suite[0].T.shape == (len(ITERS), 8) and suite[1].T.shape == (4, 8)
    assert torch.equal(suite[1].T, tfcd.load_free_convection_simulation(1, Nz=8, Nz_les=16, n_save=3).T)


@needs_h5py
def test_load_simulation_reads_data_dir(tmp_path):
    """``data_dir`` no longer raises: the name's file is read (diurnal flag from the catalog), else synthetic."""
    path = tmp_path / tr.lesbrary_relative_path(WM_NAME)
    path.parent.mkdir(parents=True)
    make_windmixing_statistics_fixture(str(path))
    got = tr.load_simulation(WM_NAME, data_dir=str(tmp_path))
    _same_dataset(got, jr.load_simulation(WM_NAME, data_dir=str(tmp_path)))
    assert float(got.diurnal_amplitude) == 0.0
    diurnal = "wind_-5e-4_diurnal_3e-8"
    dpath = tmp_path / tr.lesbrary_relative_path(diurnal)
    make_windmixing_statistics_fixture(str(dpath))
    got = tr.load_simulation(diurnal, data_dir=str(tmp_path))
    _same_dataset(got, jr.load_simulation(diurnal, data_dir=str(tmp_path)))
    assert float(got.diurnal_amplitude) == float(got.theta_top) != 0.0
    assert tr.lesbrary_file("strong_wind", str(tmp_path)) is None


@needs_h5py
def test_cli_suite_mixes_files_and_stand_ins(tmp_path):
    path = tmp_path / tr.lesbrary_relative_path(WM_NAME)
    path.parent.mkdir(parents=True)
    make_windmixing_statistics_fixture(str(path))
    # The fixture has 4 frames; the stand-in gets the same number.
    names = [WM_NAME, "wind_-2e-4_cooling_1e-8_new"]
    got = tcli._load_suite(names, 8, data_dir=str(tmp_path), n_save=len(ITERS) - 1, Nz_les=16, device="cpu")
    file_only = jcli._load_suite([WM_NAME], 8, data_dir=str(tmp_path), n_save=len(ITERS) - 1, Nz_les=16)
    assert got.T.shape == (2, len(ITERS), 8)
    for name in ("u", "v", "T", "uw", "vw", "wT", "t", "theta_top"):
        np.testing.assert_allclose(_np(getattr(got, name))[0], np.asarray(getattr(file_only, name)), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(np.asarray(getattr(file_only, name))).max()))
    stand_in = tcli._load_suite(names[1:], 8, n_save=len(ITERS) - 1, Nz_les=16, device="cpu")
    assert torch.equal(got.T[1], stand_in.T)


# ---------------------------------------------------------------------------
# The writers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wm_ds():
    return js.synthetic_wind_mixing_les(Qu=-5e-4, Qb=3e-8, Nz=12, n_save=3, dt_save=600.0, n_substeps=2)


@pytest.fixture(scope="module")
def fc_ds():
    return js.synthetic_free_convection_les(Qb=5e-8, Nz=16, n_save=3, dt_save=600.0)


@needs_h5py
def test_statistics_writer_matches_jax(tmp_path, wm_ds):
    port_path, jax_path = str(tmp_path / "port" / "out.jld2"), str(tmp_path / "jax" / "out.jld2")
    tl.write_les_profiles(port_path, _to_torch(wm_ds), iteration_stride=600)
    jl.write_les_profiles(jax_path, wm_ds, iteration_stride=600)
    _same_files(port_path, jax_path)
    with h5py.File(port_path, "r") as fh:
        assert fh["grid/zC"].shape[0] == 12 + 2 * HALO and fh["timeseries/T/0"].shape == (12, 1, 1)
        assert fh["timeseries/wT/600"].shape == (13, 1, 1)
    # Each package reads the other's file to the same arrays.
    _same_dataset(tl.read_les_profiles(jax_path), jl.read_les_profiles(port_path))
    np.testing.assert_allclose(_np(tl.read_les_profiles(port_path).T), np.asarray(wm_ds.T), rtol=1e-6)


@needs_h5py
def test_fc_writer_matches_jax(tmp_path, fc_ds):
    port_path = str(tmp_path / "port" / "instantaneous_statistics_with_halos.jld2")
    jax_path = str(tmp_path / "jax" / "instantaneous_statistics_with_halos.jld2")
    tl.write_fc_fieldset(port_path, _to_torch(fc_ds))
    jl.write_fc_fieldset(jax_path, fc_ds)
    _same_files(port_path, jax_path)
    with h5py.File(port_path, "r") as fh:
        assert fh["timeseries/T/0"].shape == (16 + 2 * HALO, 1, 1) and "timeseries/T/serialized" in fh
        assert int(np.asarray(fh["grid/Hz"])[()]) == HALO and "parameters/temperature_flux" in fh
    _same_dataset(tl.read_les_profiles(jax_path), jl.read_les_profiles(port_path))
    back = tl.read_les_profiles(port_path)
    np.testing.assert_array_equal(_np(back.T), np.asarray(fc_ds.T))
    np.testing.assert_array_equal(_np(back.wT), np.asarray(fc_ds.wT))
    assert float(back.theta_top) == float(fc_ds.theta_top)


@needs_h5py
@pytest.mark.parametrize("layout", ["statistics", "fc_fieldset"])
def test_600_iterations_across_packages(tmp_path, layout):
    """600 frames: the JAX writer's file (a multi-level B-tree under h5py's defaults) read by the port equals
    JAX's read, and the port's file (600 link messages in one header) read by JAX equals the port's read."""
    ds = _random_series(600, 8, seed=1)
    as_jax = jc.ColumnTimeSeries(**{k: _np(getattr(ds, k)) for k in FIELDS if getattr(ds, k) is not None})
    jwrite, twrite = ((jl.write_les_profiles, tl.write_les_profiles) if layout == "statistics"
                      else (jl.write_fc_fieldset, tl.write_fc_fieldset))
    jax_path, port_path = str(tmp_path / "jax.jld2"), str(tmp_path / "port.jld2")
    jwrite(jax_path, as_jax, iteration_stride=600)
    twrite(port_path, ds, iteration_stride=600)
    _same_files(port_path, jax_path)
    _same_dataset(tl.read_les_profiles(jax_path), jl.read_les_profiles(jax_path))
    _same_dataset(tl.read_les_profiles(port_path), jl.read_les_profiles(port_path))
    for dtype in (np.float32, np.float64):
        _same_dataset(tl.read_les_profiles(jax_path, dtype=dtype), tl.read_les_profiles(port_path, dtype=dtype))
    assert tl.read_les_profiles(port_path).T.shape == (600, 8)


def _random_series(Nt, Nz, seed=0):
    """A :class:`ColumnTimeSeries` of random f32 profiles and constants (any values: the files carry them)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: torch.tensor(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    return tc.ColumnTimeSeries(u=f32(Nt, Nz), v=f32(Nt, Nz), T=20 + f32(Nt, Nz), uw=f32(Nt, Nz + 1),
                               vw=f32(Nt, Nz + 1), wT=f32(Nt, Nz + 1), t=torch.arange(Nt, dtype=torch.float32) * 600,
                               H=torch.tensor(256.0), f=torch.tensor(1e-4), g=torch.tensor(9.80665),
                               alpha=torch.tensor(2e-4), beta=torch.tensor(8e-4), u_top=torch.tensor(-5e-4),
                               theta_top=torch.tensor(3e-5), theta_bottom=torch.tensor(0.01))


def _buoyancy_round_trip(ds) -> float:
    """``theta_top`` as a statistics file gives it back: stored as ``theta alpha g``, read as ``/ alpha / g``."""
    c = [float(getattr(ds, k)) for k in ("theta_top", "alpha", "g")]
    return float(np.float32(c[0] * c[1] * c[2] / c[1] / c[2]))


@pytest.mark.parametrize("layout", ["statistics", "fc_fieldset", "netcdf"])
def test_port_round_trips_without_h5py(tmp_path, monkeypatch, layout):
    """The port writes and reads both ``.jld2`` layouts and the netCDF pair with h5py unimportable."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    ds = _random_series(5, 12)
    if layout == "netcdf":
        t, zc, zf, T_base, T_nn, wT = _nc_inputs()
        paths = tnc.write_paired_column_netcdf(str(tmp_path), zc, zf, t, T_base, T_nn, wT, {"simulation_id": 8})
        for path, want in zip(paths, ({"T": T_base}, {"T": T_nn, "wT": wT})):
            variables, coords, attrs = tnc.read_netcdf(path)
            assert sorted(variables) == sorted(want) and attrs == {"simulation_id": 8}
            for name, value in want.items():
                dims, got = variables[name]
                assert dims == ("time", "zF" if name == "wT" else "zC") and got.dtype == value.dtype
                np.testing.assert_array_equal(got, value)
            for dim, value in (("time", t), ("zC", zc), ("zF", zf)):
                if dim in coords:
                    np.testing.assert_array_equal(coords[dim], value)
        return
    path = str(tmp_path / f"{layout}.jld2")
    writer = tl.write_les_profiles if layout == "statistics" else tl.write_fc_fieldset
    writer(path, ds, iteration_stride=600)
    back = tl.read_les_profiles(path)
    fields = ["T", "wT", "t", "H", "theta_bottom"] + (
        ["u", "v", "uw", "vw", "f", "g", "alpha", "beta", "u_top"] if layout == "statistics" else ["theta_top"])
    _same_dataset(back, ds, fields)
    if layout == "statistics":
        assert float(back.theta_top) == _buoyancy_round_trip(ds)
    else:
        assert not back.u.any() and not back.uw.any()


# ---------------------------------------------------------------------------
# netCDF
# ---------------------------------------------------------------------------


def _nc_inputs():
    rng = np.random.default_rng(3)
    t, zc, zf = np.arange(4) * 600.0, np.linspace(-7.0, -1.0, 6), np.linspace(-8.0, 0.0, 7)
    return t, zc, zf, rng.normal(size=(4, 6)), rng.normal(size=(4, 6)), rng.normal(size=(4, 7)).astype(np.float32)


def _same_netcdf(a, b):
    va, ca, aa = a
    vb, cb, ab = b
    assert sorted(va) == sorted(vb) and sorted(ca) == sorted(cb) and sorted(aa) == sorted(ab)
    for name in va:
        assert va[name][0] == vb[name][0]
        assert va[name][1].dtype == vb[name][1].dtype
        np.testing.assert_array_equal(va[name][1], vb[name][1])
    for name in ca:
        np.testing.assert_array_equal(ca[name], cb[name])
    for key in aa:
        np.testing.assert_array_equal(aa[key], ab[key])


@needs_h5py
def test_netcdf_round_trips_across_packages(tmp_path):
    t, zc, zf, T_base, T_nn, wT = _nc_inputs()
    attrs = {"simulation": "free_convection_3", "dt": 600.0}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ports = tnc.write_paired_column_netcdf(str(tmp_path / "port"), torch.tensor(zc), zf, t, T_base,
                                           torch.tensor(T_nn), wT, attrs)
    jaxs = jnc.write_paired_column_netcdf(str(tmp_path / "jax"), zc, zf, t, T_base, T_nn, wT, attrs)
    for p, j in zip(ports, jaxs):
        assert p.split("/")[-1] == j.split("/")[-1]
        _same_netcdf(tnc.read_netcdf(p), jnc.read_netcdf(j))
        _same_netcdf(tnc.read_netcdf(j), jnc.read_netcdf(p))
        with h5py.File(p, "r") as fh:  # dimension scales attached as netCDF-4 walks them
            assert fh["T"].dims[1][0].name == "/zC" and fh.attrs["_NCProperties"]
    variables, coords, _ = tnc.read_netcdf(ports[1])
    assert variables["wT"][0] == ("time", "zF") and variables["wT"][1].dtype == np.float32
    np.testing.assert_array_equal(variables["T"][1], T_nn)
    with pytest.raises(ValueError, match="missing from coords"):
        tnc.write_netcdf(str(tmp_path / "bad.nc"), {"T": (("time", "z"), T_base)}, {"time": t})
    with pytest.raises(ValueError, match="dims for"):
        tnc.write_netcdf(str(tmp_path / "bad.nc"), {"T": (("time",), T_base)}, {"time": t})
    with pytest.raises(ValueError, match="data has"):
        tnc.write_netcdf(str(tmp_path / "bad.nc"), {"T": (("time", "zC"), T_base)}, {"time": t[:2], "zC": zc})
