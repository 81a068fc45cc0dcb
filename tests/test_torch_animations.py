"""Port parity: ``eval/animations.py``, every one of its figures against the JAX package's.

Both packages draw with the same matplotlib in this process, so a figure
drawn from the same numpy arrays gives the same pixels: each PNG, and each
frame of each GIF, is decoded with PIL and compared pixel for pixel. Where
a function computes before it draws, the computed arrays are compared
instead, to a stated tolerance: ``_isotherm_depth`` in float64 to
``RTOL = 1e-12``, the double gyre's streamfunction (one batched call over
the frames in the port, ``jax.vmap`` in JAX) on a handed-over float64 state
to ``RTOL``, and the polynomial reconstructions in ``tests/test_torch_utils.py``;
their animations are held to the JAX frame count and size. One animation
goes through the mp4 writer (OpenCV) and is decoded back. The inputs are
small (2-4 frames, a few levels): ``FuncAnimation`` and pillow are slow.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from climateparameterizations_jl_tpu.embed import double_gyre as jdg
from climateparameterizations_jl_tpu.eval import animations as janim
from climateparameterizations_jl_tpu_torch.embed import double_gyre as tdg
from climateparameterizations_jl_tpu_torch.eval import animations as tanim

RTOL = 1e-12
NT, NZ = 4, 8


def _evaluation(seed=0):
    rng = np.random.default_rng(seed)
    H = 64.0
    ev = {"t": 600.0 * 9 * np.arange(NT), "zc": (np.arange(NZ) + 0.5) * H / NZ - H, "zf": np.arange(NZ + 1) * H / NZ - H}
    for m in ("truth", "nde", "mpp", "kpp", "embedded"):
        ev[f"{m}_u"], ev[f"{m}_v"] = 0.05 * rng.normal(size=(NT, NZ)), 0.02 * rng.normal(size=(NT, NZ))
        ev[f"{m}_T"] = 19.0 + 0.01 * ev["zc"] + 1e-2 * rng.normal(size=(NT, NZ))
        for f in ("uw", "vw", "wT"):
            ev[f"{m}_{f}"] = 1e-5 * rng.normal(size=(NT, NZ + 1))
        ev[f"{m}_Ri"] = rng.uniform(-2.0, 3.0, size=(NT, NZ + 1))
        ev[f"losses_{m}_T"] = np.abs(rng.normal(size=NT)) * 1e-4 + 1e-8
    return ev


EV = _evaluation()
RNG = np.random.default_rng(1)
CURVES = np.geomspace(1.0, 1e-3, 3)[:, None] * (1.0 + np.linspace(0, 1, NT))[None, :]
UQ = {"ensemble_T_mean": EV["nde_T"], "ensemble_T_std": np.abs(EV["mpp_T"] - 19.0) * 0.1, "zc": EV["zc"],
      "n_members": 3}
GP = (RNG.normal(size=(5, 9)), RNG.normal(size=(5, 9)), np.abs(RNG.normal(size=5)))
LES_T = 19.0 + np.cumsum(RNG.normal(size=(2, 4, 5, 6)) * 0.1, axis=-1)
LES_W = RNG.normal(size=(2, 4, 5, 7)) * 1e-2

# name -> (file extension, draw(module, path)): figures drawn from their inputs alone.
DRAWN = {
    "animate_profiles": ("gif", lambda m, p: m.animate_profiles(
        {"truth": EV["truth_T"], "nde": EV["nde_T"]}, EV["zc"], EV["t"], p, xlabel="T", stride=2)),
    "animate_profiles_fluxes_comparison": ("gif", lambda m, p: m.animate_profiles_fluxes_comparison(
        EV, p, stride=3, models=("truth", "nde", "mpp", "kpp", "embedded"))),
    "plot_loss": ("png", lambda m, p: m.plot_loss({k: EV[f"losses_{k}_T"] for k in ("nde", "mpp", "kpp")}, EV["t"], p)),
    "plot_gp_uncertainty": ("png", lambda m, p: m.plot_gp_uncertainty(*GP, p, flux="uw", frame=2)),
    "plot_nde_ensemble_uncertainty": ("png", lambda m, p: m.plot_nde_ensemble_uncertainty(UQ, EV["truth_T"], p)),
    "plot_epoch_loss": ("png", lambda m, p: m.plot_epoch_loss(np.geomspace(1, 1e-3, 12), p)),
    "plot_loss_matrix": ("png", lambda m, p: m.plot_loss_matrix(
        {"nde": np.array([1e-3, 2e-3]), "kpp": np.array([5e-3, 1e-2])}, ["sim1", "sim2"], p)),
    "animate_training_data": ("gif", lambda m, p: m.animate_training_data(
        np.repeat(EV["truth_T"], 2, axis=-1), np.linspace(-64.0, 0.0, 2 * NZ), EV["truth_T"], EV["zc"], EV["t"], p,
        stride=2)),
    "animate_nde_loss": ("gif", lambda m, p: m.animate_nde_loss(CURVES, EV["t"], p)),
    "animate_les_slices": ("gif", lambda m, p: m.animate_les_slices(LES_T, LES_W, 64.0, p)),
    "plot_training_regions": ("png", lambda m, p: m.plot_training_regions(
        ["wind_-5e-4_cooling_3e-8_new", "wind_-2e-4_heating_-1e-8_new", "wind_-3.5e-4_diurnal_5e-8_new", "not_a_sim"],
        ["strong_wind_weak_cooling", "wind_-4.5e-4_cooling_2.5e-8"], p)),
    "plot_final_profiles": ("png", lambda m, p: m.plot_final_profiles(
        {"sim_a": EV, "sim_b": _evaluation(2), "sim_c": _evaluation(3)}, p, var="u")),
    "animate_les_3d": ("gif", lambda m, p: m.animate_les_3d(LES_T, 64.0, p)),
}


def _frames(path):
    with Image.open(path) as im:
        return [np.asarray(frame.convert("RGB")) for frame in ImageSequence.Iterator(im)]


def test_every_jax_name_is_ported():
    names = {n for n, v in vars(janim).items() if callable(v) and getattr(v, "__module__", None) == janim.__name__}
    assert len(names) == 18 and names <= set(vars(tanim))
    assert {*DRAWN, "animate_polynomial_decomposition", "animate_double_gyre", "_isotherm_depth", "save_animation",
            "_CV2Writer"} == names


@pytest.mark.parametrize("name", list(DRAWN))
def test_drawn_figure_equals_jax_pixel_for_pixel(name, tmp_path):
    ext, draw = DRAWN[name]
    want_path, got_path = str(tmp_path / f"jax.{ext}"), str(tmp_path / f"port.{ext}")
    assert draw(janim, want_path) == want_path
    assert draw(tanim, got_path) == got_path
    want, got = _frames(want_path), _frames(got_path)
    assert len(got) == len(want) >= 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.array_equal(g, w), f"frame {i}"


def test_tensors_draw_as_their_arrays(tmp_path):
    # The port's figures take tensors (on any device) as well as arrays.
    tensors = {k: torch.as_tensor(EV[f"losses_{k}_T"]) for k in ("nde", "mpp")}
    tanim.plot_loss(tensors, torch.as_tensor(EV["t"]), str(tmp_path / "t.png"))
    tanim.plot_loss({k: v.numpy() for k, v in tensors.items()}, EV["t"], str(tmp_path / "a.png"))
    assert np.array_equal(_frames(tmp_path / "t.png")[0], _frames(tmp_path / "a.png")[0])


def test_training_regions_none_without_a_catalog_name(tmp_path):
    assert tanim.plot_training_regions(["bespoke"], ["other"], str(tmp_path / "r.png")) is None
    assert not (tmp_path / "r.png").exists()


def test_isotherm_depth_matches_jax():
    Nz, H = 12, 96.0
    dz = H / Nz
    zc = (np.arange(Nz) + 0.5) * dz - H
    T = 10.0 + np.cumsum(np.random.default_rng(4).normal(size=(3, 5, 6, Nz)), axis=-1)
    T[0, 0, 0] = 99.0  # warmer than the isotherm throughout: the bottom
    T[0, 0, 1] = -99.0  # colder throughout: the top
    T[1, 1, 1, 4] += 30.0  # a warm intrusion
    for iso in (9.0, 10.5, 12.0):
        got, want = tanim._isotherm_depth(T, iso, zc, dz), np.asarray(janim._isotherm_depth(T, iso, zc, dz))
        assert got.shape == want.shape == (3, 5, 6)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * H)
    Nz, H = 8, 8.0
    zc = (np.arange(Nz) + 0.5) - H
    assert np.isclose(tanim._isotherm_depth(np.linspace(0.0, 7.0, Nz), 3.25, zc, 1.0), zc[3] + 0.25)
    assert np.isclose(tanim._isotherm_depth(np.array([0.0, 0, 0, 10, 0, 0, 10, 10]), 5.0, zc, 1.0), zc[2] + 0.5)


def test_polynomial_decomposition_animation_has_jax_frames(tmp_path):
    x = np.linspace(-1.0, 1.0, 33)
    f = np.tanh(3 * x) + 0.1 * x**2
    for m, name in ((janim, "jax.gif"), (tanim, "port.gif")):
        m.animate_polynomial_decomposition(f, x, str(tmp_path / name), kind="chebyshev", n_max=2)
    got, want = _frames(tmp_path / "port.gif"), _frames(tmp_path / "jax.gif")
    assert len(got) == len(want) == 2 and got[0].shape == want[0].shape


def test_double_gyre_streamfunction_and_animation_match_jax(tmp_path):
    Nx, Ny, Nz, Nt = 8, 6, 4, 2
    jm = jdg.DoubleGyreModel.default(Nx=Nx, Ny=Ny, Nz=Nz, dtype=jnp.float64)
    tm = tdg.DoubleGyreModel.default(Nx=Nx, Ny=Ny, Nz=Nz, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    u = 0.05 * rng.normal(size=(Nt, Ny, Nx + 1, Nz))
    u[:, :, [0, -1]] = 0.0
    T = 10.0 + rng.normal(size=(Nt, Ny, Nx, Nz))
    eta = 0.01 * rng.normal(size=(Nt, Ny, Nx))
    psi_jax = np.asarray(jax.vmap(lambda uu: jdg.barotropic_streamfunction(jm, uu))(jnp.asarray(u)))
    psi_port = tdg.barotropic_streamfunction(tm, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(psi_port, psi_jax, rtol=RTOL, atol=RTOL * float(np.abs(psi_jax).max()))
    for k in range(Nt):  # the batched call gives each frame's single-field result
        np.testing.assert_array_equal(tdg.barotropic_streamfunction(tm, torch.as_tensor(u[k])).numpy(), psi_port[k])
    janim.animate_double_gyre(types.SimpleNamespace(T=jnp.asarray(T), eta=jnp.asarray(eta), u=jnp.asarray(u)), jm,
                              str(tmp_path / "jax.gif"))
    tanim.animate_double_gyre(types.SimpleNamespace(T=torch.as_tensor(T), eta=torch.as_tensor(eta),
                                                    u=torch.as_tensor(u)), tm, str(tmp_path / "port.gif"))
    got, want = _frames(tmp_path / "port.gif"), _frames(tmp_path / "jax.gif")
    assert len(got) == len(want) == Nt and got[0].shape == want[0].shape


def test_mp4_through_opencv(tmp_path):
    import cv2

    path = tanim.animate_profiles({"truth": EV["truth_T"], "nde": EV["nde_T"]}, EV["zc"], EV["t"],
                                  str(tmp_path / "T.mp4"), xlabel="T")
    cap = cv2.VideoCapture(path)
    try:
        assert cap.isOpened() and int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == NT
        ok, frame = cap.read()
        assert ok and frame.shape == (600, 500, 3)  # figsize (5, 6) at 100 dpi
    finally:
        cap.release()
