"""Port parity: the evaluation harnesses (``eval/profile.py``) and the loss matrices (``eval/loss_matrix.py``).

One simulation made with numpy from a seed (Nz = 16, 12 saves of 600 s: a
cooling column mixing from the top, with noise), handed to both packages
in float64, with MLPs drawn by ``jax.random`` at scale 0.3 and carried over
by ``bridge.from_reference``. Each of ``nde_profile`` (split on a
constant-flux sim; rk4 on a diurnal one) and
``free_convection_profile`` must give every key of the JAX dict, in its
order, with its shape and its value within ``RTOL = 1e-8`` of the entry's
scale: the solves (NDE, mPP alone, convective adjustment, KPP, TKE) run the
same float64 operations, and the flux diagnostics go through one batched
call over the frames where JAX vmaps over them; so do the embedded
host-column runs (``include_embedded``), whose flux diagnostics take the
frames' times broadcast over the time axis. The loss matrices compare
float for float (``MATRIX_RTOL``: the same means in float64).
``nde_profile_from_saved`` reads a saved baseline / +NN pair written with
the JAX package's LESbrary writer (h5py) at another save interval than the
truth's.

The JAX harness runs its solves and diagnostics op by op, and on the CPU
each new operation compiles: ``jit_reference_harness`` hands it jitted
copies of the same functions, one compile each (about half the JAX side's
time). The computation is the JAX package's; only its compilation changes.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.core.scalings import ZeroMeanUnitVarianceScaling as JScaling
from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.eval import profile as jprof
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.models.free_convection import FreeConvectionModel as JFCModel
from climateparameterizations_jl_tpu.physics import kpp as jkpp
from climateparameterizations_jl_tpu.physics import tke as jtke
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.eval import profile as tprof

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
jlm = importlib.import_module("climateparameterizations_jl_tpu.eval.loss_matrix")  # the package exports a function of that name
tlm = importlib.import_module("climateparameterizations_jl_tpu_torch.eval.loss_matrix")  # so does the port's
RTOL, MATRIX_RTOL = 1e-8, 1e-12
NZ = 16
TSTEPS = np.arange(0, 12)


def _jit_keeping_key_order(fn):
    """``jax.jit(fn)`` for a ``fn`` that returns a dict: jit would sort its keys, the harness's order is kept."""
    keys: list = []

    @functools.wraps(fn)
    def values(*args):
        out = fn(*args)
        keys[:] = list(out)
        return list(out.values())

    jitted = jax.jit(values)
    return lambda *args: dict(zip(keys, jitted(*args), strict=True))


def jit_reference_harness(mp: pytest.MonkeyPatch):
    """Give the JAX package's ``eval/profile.py`` jitted copies of the functions it calls op by op."""
    solver_static = ("Nz", "n_substeps", "tridiag_backend", "diurnal")
    mp.setattr(jprof, "solve_kpp", jax.jit(jkpp.solve_kpp, static_argnames=solver_static))
    mp.setattr(jprof, "kpp_diagnostic_fluxes", jax.jit(jkpp.kpp_diagnostic_fluxes, static_argnames=("Nz",)))
    mp.setattr(jprof, "solve_tke", jax.jit(jtke.solve_tke, static_argnames=solver_static[:3]))
    mp.setattr(jtke, "tke_diagnostic_heat_flux", jax.jit(jtke.tke_diagnostic_heat_flux))
    mp.setattr(jprof, "_trajectory_diagnostics", _jit_keeping_key_order(jprof._trajectory_diagnostics))
    mp.setattr(jprof, "_ri", jax.jit(jprof._ri))


@pytest.fixture(scope="module", autouse=True)
def _jitted_reference():
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_harness(mp)
        yield


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)})


def _same_dict(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * max(float(np.abs(w).max()), 1e-30), err_msg=k)


def _column(seed: int, diurnal_amplitude: float = 0.0, H: float = 100.0, NT: int = 12, NZ: int = NZ):
    """One simulation as a JAX ``ColumnTimeSeries``: numpy profiles and fluxes from ``seed``, 0-d constants."""
    rng = np.random.default_rng(seed)
    zc, zf = (np.arange(NZ) + 0.5) * H / NZ - H, np.arange(NZ + 1) * H / NZ - H
    k = np.arange(NT)[:, None]
    mix = np.clip(1.0 - (-zc[None, :]) / (15.0 + 2.0 * k), 0.0, 1.0)
    T = 19.0 + 0.01 * (zc + H) - 0.03 * mix + 1e-3 * rng.normal(size=(NT, NZ))
    u = 0.05 * mix + 0.005 * rng.normal(size=(NT, NZ))
    v = -0.02 * mix + 0.005 * rng.normal(size=(NT, NZ))
    shape = np.clip((zf[None, :] + H) / H, 0.0, 1.0) ** 2
    u_top, theta_top = -4e-4, 1e-5
    uw = u_top * shape + 1e-6 * rng.normal(size=(NT, NZ + 1))
    vw = 1e-6 * rng.normal(size=(NT, NZ + 1))
    wT = theta_top * shape + 1e-7 * rng.normal(size=(NT, NZ + 1))
    for flux, top in ((uw, u_top), (vw, 0.0), (wT, theta_top)):
        flux[:, -1], flux[:, 0] = top, 0.0
    c = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    return jc.ColumnTimeSeries(u=c(u), v=c(v), T=c(T), uw=c(uw), vw=c(vw), wT=c(wT), t=c(600.0 * np.arange(NT)),
                               H=c(H), f=c(1e-4), g=c(9.81), alpha=c(2e-4), beta=c(8e-4), u_top=c(u_top),
                               theta_top=c(theta_top), theta_bottom=c(0.01), diurnal_amplitude=c(diurnal_amplitude))


def _wind(diurnal: bool):
    ds = _column(1 if diurnal else 0, 2e-5 if diurnal else 0.0)
    model = _f64(jcli._wind_model(ds, NZ, diurnal=diurnal))
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    nns = _f64(jwm.FluxNNs(*[jmlp.wind_mixing_mlp(k, NZ, scale=0.3) for k in keys]))
    return ds, model, nns


@pytest.fixture(scope="module")
def wind():
    return _wind(False)


def test_nde_profile_split_matches_jax(wind):
    ds, model, nns = wind
    want = jprof.nde_profile(model, nns, ds, TSTEPS, solver="split", n_substeps=2, kpp_n_substeps=2).to_dict()
    got = tprof.nde_profile(from_reference(model, "cpu", torch.float64), from_reference(nns, "cpu", torch.float64),
                            _to_torch(ds), TSTEPS, solver="split", n_substeps=2, kpp_n_substeps=2).to_dict()
    _same_dict(got, want)
    assert got["kpp_T"].shape == (12, NZ) and got["nde_uw"].shape == (12, NZ + 1)
    assert float(np.abs(got["nde_nn_wT"]).max()) > 0 and np.isfinite(got["loss_kpp"])


def test_nde_profile_rk4_diurnal_matches_jax():
    """rk4 on a diurnal sim: each frame's diagnostics use its own point of the daily cycle (one batched call)."""
    ds, model, nns = _wind(True)
    assert model.diurnal
    want = jprof.nde_profile(model, nns, ds, TSTEPS, solver="rk4", n_substeps=2).to_dict()
    got = tprof.nde_profile(from_reference(model, "cpu", torch.float64), from_reference(nns, "cpu", torch.float64),
                            _to_torch(ds), TSTEPS, solver="rk4", n_substeps=2).to_dict()
    _same_dict(got, want)
    top = got["mpp_wT"][:, -1]
    assert np.ptp(top) > 0.1 * np.abs(top).max()  # the surface flux cycles over the frames


def test_profiles_refuse_the_embedded_run_and_stacked_suites(wind):
    """The embedded run (``include_embedded``) of one simulation is JAX's, every key; on a stacked suite, or over
    non-uniform frames, the profile refuses, with the embedded run as without."""
    ds, model, nns = wind
    tmodel, tnns = from_reference(model, "cpu", torch.float64), from_reference(nns, "cpu", torch.float64)
    want = jprof.nde_profile(model, nns, ds, TSTEPS, include_embedded=True, include_kpp=False,
                             embedded_substeps=3).to_dict()
    got = tprof.nde_profile(tmodel, tnns, _to_torch(ds), TSTEPS, include_embedded=True, include_kpp=False,
                            embedded_substeps=3).to_dict()
    _same_dict(got, want)
    assert got["embedded_uw"].shape == (12, NZ + 1) and "loss_embedded_baseline_gradient" in got
    two = _to_torch(jc.stack_datasets([ds, ds]))
    for embedded in (False, True):
        with pytest.raises(ValueError, match="ONE held-out"):
            tprof.nde_profile(tmodel, tnns, two, TSTEPS, include_embedded=embedded)
        with pytest.raises(ValueError, match="uniformly spaced"):
            tprof.nde_profile(tmodel, tnns, _to_torch(ds), np.array([0, 1, 2, 4]), include_embedded=embedded)


def test_nde_profile_embedded_diurnal_matches_jax():
    """A diurnal sim: the embedded run's surface flux cycles, and each frame's diagnosed top wT is its own time's."""
    ds, model, nns = _wind(True)
    want = jprof.nde_profile(model, nns, ds, TSTEPS, solver="rk4", n_substeps=2, include_embedded=True,
                             include_kpp=False).to_dict()
    got = tprof.nde_profile(from_reference(model, "cpu", torch.float64), from_reference(nns, "cpu", torch.float64),
                            _to_torch(ds), TSTEPS, solver="rk4", n_substeps=2, include_embedded=True,
                            include_kpp=False).to_dict()
    _same_dict(got, want)
    top = got["embedded_wT"][:, -1]
    assert np.ptp(top) > 0.1 * np.abs(top).max()


def test_nde_profile_from_saved_matches_jax(wind, tmp_path):
    """A saved baseline / +NN pair at half the truth's save interval: matched by time, every key as JAX's."""
    pytest.importorskip("h5py")
    from climateparameterizations_jl_tpu.data import lesbrary as jles

    ds, model, _ = wind
    for tag, seed in (("baseline", 7), ("neural_network", 8)):
        saved = _column(seed, NT=23)
        jles.write_les_profiles(str(tmp_path / f"{tag}.jld2"),
                                dataclasses.replace(saved, t=jnp.asarray(300.0 * np.arange(23))))
    want = jprof.nde_profile_from_saved(str(tmp_path), model, ds, TSTEPS).to_dict()
    got = tprof.nde_profile_from_saved(str(tmp_path), from_reference(model, "cpu", torch.float64), _to_torch(ds),
                                       TSTEPS).to_dict()
    _same_dict(got, want)
    assert got["embedded_T"].shape == (12, NZ) and "loss_embedded_gradient" in got
    short = tmp_path / "short"  # saves end at 3,000 s, the truth's frames at 6,600 s
    short.mkdir()
    for tag in ("baseline", "neural_network"):
        jles.write_les_profiles(str(short / f"{tag}.jld2"), dataclasses.replace(
            _column(9, NT=11), t=jnp.asarray(300.0 * np.arange(11))))
    with pytest.raises(ValueError, match="do not cover"):
        tprof.nde_profile_from_saved(str(short), from_reference(model, "cpu", torch.float64), _to_torch(ds), TSTEPS)


@pytest.fixture(scope="module")
def free_convection():
    ds = _column(2)
    zeros = jnp.zeros_like(ds.u)
    ds = dataclasses.replace(ds, u=zeros, v=zeros, uw=jnp.zeros_like(ds.uw), vw=jnp.zeros_like(ds.vw),
                             u_top=jnp.float64(0.0))
    T_scaling, wT_scaling = JScaling.fit(ds.T), JScaling.fit(ds.wT)
    model = _f64(JFCModel(H=ds.H, tau=jnp.abs(ds.t[-1] - ds.t[0]), T_scaling=T_scaling, wT_scaling=wT_scaling,
                          bottom_flux=wT_scaling.scale(jnp.float64(0.0)), top_flux=wT_scaling.scale(ds.theta_top),
                          Nz=NZ))
    nn = _f64(jmlp.free_convection_mlp(jax.random.PRNGKey(11), NZ))
    return ds, model, nn


@pytest.mark.parametrize("base", ["convective_adjustment", "none"])
def test_free_convection_profile_matches_jax(free_convection, base):
    ds, model, nn = free_convection
    model = dataclasses.replace(model, base_closure=base)
    want = jprof.free_convection_profile(model, nn, ds, TSTEPS, n_substeps=2, kpp_n_substeps=2).to_dict()
    got = tprof.free_convection_profile(from_reference(model, "cpu", torch.float64),
                                        from_reference(nn, "cpu", torch.float64), _to_torch(ds), TSTEPS,
                                        n_substeps=2, kpp_n_substeps=2).to_dict()
    _same_dict(got, want)
    label = "conv_adj" if base == "convective_adjustment" else "base"
    assert f"losses_{label}_T" in got and got["tke_wT"].shape == (12, NZ + 1)
    # The embedded conv-adj pair (over a zero-physics host for the base-free model) and the NN heat flux.
    want = jprof.free_convection_profile(model, nn, ds, TSTEPS, n_substeps=2, include_kpp=False, include_tke=False,
                                         include_embedded=True, embedded_substeps=3).to_dict()
    got = tprof.free_convection_profile(from_reference(model, "cpu", torch.float64),
                                        from_reference(nn, "cpu", torch.float64), _to_torch(ds), TSTEPS,
                                        n_substeps=2, include_kpp=False, include_tke=False, include_embedded=True,
                                        embedded_substeps=3).to_dict()
    _same_dict(got, want)
    assert got["embedded_wT"].shape == (12, NZ + 1) and float(np.abs(got["embedded_wT"]).max()) > 0


def test_loss_matrices_and_epoch_replay_match_jax(free_convection):
    ds, model, nn = free_convection
    rng = np.random.default_rng(3)
    truth = rng.normal(size=(2, 12, NZ))
    sols = {"a": truth + 0.1 * rng.normal(size=truth.shape), "b": truth + rng.normal(size=truth.shape)}
    for fj, ft in ((jlm.loss_matrix, tlm.loss_matrix), (jlm.loss_per_timestep_matrix, tlm.loss_per_timestep_matrix)):
        want, got = fj(jnp.asarray(truth), sols), ft(torch.tensor(truth), sols)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=MATRIX_RTOL, atol=0)
    epochs = [nn, _f64(jmlp.free_convection_mlp(jax.random.PRNGKey(12), NZ))]
    T0 = model.T_scaling.scale(ds.T[0])
    want = jlm.solution_history(model, epochs, T0, 0.0, 1.0 / 11, 11, n_substeps=2)
    got = tlm.solution_history(from_reference(model, "cpu", torch.float64),
                               [from_reference(e, "cpu", torch.float64) for e in epochs], torch.tensor(np.asarray(T0)),
                               0.0, 1.0 / 11, 11, n_substeps=2)
    assert got.shape == (2, 12, NZ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=RTOL * float(np.abs(want).max()))
    truth_scaled = model.T_scaling.scale(ds.T)
    np.testing.assert_allclose(tlm.epoch_losses(got, torch.tensor(np.asarray(truth_scaled))),
                               jlm.epoch_losses(want, truth_scaled), rtol=RTOL)
