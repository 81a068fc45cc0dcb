"""Port parity: free convection, from the convective adjustment to NDE training.

The JAX package's ``core/convective_adjust.py``, ``physics/
convective_adjustment.py``, ``models/free_convection.py``, the
free-convection generator, ``data/free_convection.py``,
``data/flux_reconstruction.py``, ``train/nn.py`` and
``train/nde.py::train_free_convection_nde`` are the reference. Inputs come
from numpy seeds; models and closures cross through ``bridge.from_reference``.

Tolerances and their reasons:

- float64, the same operations in the same order: trajectories and
  gradients to ``1e-10`` relative (``F64``), the generator to ``1e-9``
  (its diagnosed ``wT`` is a difference of nearly equal temperatures in the
  mixed layer), trained weights and loss histories to ``1e-9``
  (``TRAIN_RTOL``: adam's ``sqrt(nu) + eps`` division amplifies a
  gradient's last-digit difference; ``tests/test_torch_training.py``).
- float32 split solves: ``F32_SCALE`` of the trajectory's largest entry.
  The two packages round ``dt / dz^2`` and the MLP's sums differently (XLA
  contracts multiply-adds), a few ulps per substep carried through the
  substeps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.core import convective_adjust as jca
from climateparameterizations_jl_tpu.core.scalings import ZeroMeanUnitVarianceScaling as JScaling
from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.data import flux_reconstruction as jfr
from climateparameterizations_jl_tpu.data import free_convection as jfcd
from climateparameterizations_jl_tpu.data import synthetic as js
from climateparameterizations_jl_tpu.models import free_convection as jfc
from climateparameterizations_jl_tpu.physics import convective_adjustment as jphys
from climateparameterizations_jl_tpu.train import nde as jnde
from climateparameterizations_jl_tpu.train import nn as jnn
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.closures import mlp as tmlp
from climateparameterizations_jl_tpu_torch.core import convective_adjust as tca
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling as TScaling
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.data import flux_reconstruction as tfr
from climateparameterizations_jl_tpu_torch.data import free_convection as tfcd
from climateparameterizations_jl_tpu_torch.data import synthetic as ts
from climateparameterizations_jl_tpu_torch.models import free_convection as tfc
from climateparameterizations_jl_tpu_torch.physics import convective_adjustment as tphys
from climateparameterizations_jl_tpu_torch.train import nde as tnde
from climateparameterizations_jl_tpu_torch.train import nn as tnn

F64 = 1e-10
GEN_RTOL = 1e-9
TRAIN_RTOL = 1e-9
F32_SCALE = 1e-4
S, NZ = 3, 8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=F64, scale=None):
    """``|got - want| <= rtol |want| + scale max|want|`` (``scale`` defaults to ``rtol``)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = rtol if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale * max(float(np.abs(want).max()), 1e-300))


def _leaves_close(got, want, rtol=F64):
    jl = jax.tree_util.tree_leaves(want)
    tl = tmlp._leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        _close(a, b, rtol)


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    })


def _jax_model(S=S, Nz=NZ, base_closure="convective_adjustment", dtype=jnp.float64, seed=0):
    """A model with per-simulation ``(S,)`` boundary fluxes (``S=None``: scalar fluxes)."""
    rng = np.random.default_rng(seed)
    shape = () if S is None else (S,)
    c = lambda v: jnp.asarray(v, dtype)  # noqa: E731
    return jfc.FreeConvectionModel(
        H=c(256.0), tau=c(691200.0), T_scaling=JScaling(c(19.0), c(0.5)), wT_scaling=JScaling(c(0.0), c(1e-5)),
        bottom_flux=c(0.1 * rng.normal(size=shape)), top_flux=c(1.0 + rng.normal(size=shape)), kappa=c(10.0),
        Nz=Nz, base_closure=base_closure,
    )


def _jax_closure(kind, Nz=NZ, dtype=jnp.float64, seed=1):
    key = jax.random.PRNGKey(seed)
    if kind == "conv":
        return jmlp.free_convection_conv_mlp(key, Nz, conv_width=2, dtype=dtype)
    if kind == "mlp":
        return jmlp.free_convection_mlp(key, Nz, dtype=dtype)
    return None


def _tdtype(dtype):
    return torch.float64 if dtype == jnp.float64 else torch.float32


def _port(obj, dtype=jnp.float64):
    return from_reference(obj, "cpu", _tdtype(dtype))


def _unstable_T0(S=S, Nz=NZ, seed=2):
    """Profiles with unstable kinks, so the convective-adjustment switch acts."""
    rng = np.random.default_rng(seed)
    return np.linspace(-1.0, 1.0, Nz) + 0.4 * rng.normal(size=(S, Nz))


# ---------------------------------------------------------------------------
# Convective adjustment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 12), (12,), (2, 3, 9), (4, 4)], ids=str)
def test_convective_adjust_profile_matches_jax(shape):
    x = np.random.default_rng(len(shape)).normal(size=shape)
    got = tca.convective_adjust_profile(torch.tensor(x))
    np.testing.assert_array_equal(_np(got), np.asarray(jca.convective_adjust_profile(jnp.asarray(x))))
    if shape[-1] >= 5:
        assert not np.array_equal(_np(got), x)  # the sweep did fix something


def test_convective_adjustment_flux_and_implicit_step_match_jax():
    T = _unstable_T0(5, 16)
    kappa, dt, dz = 10.0, 0.3, 1.0 / 16
    _close(tphys.convective_adjustment_flux(torch.tensor(T), dz, kappa),
           jphys.convective_adjustment_flux(jnp.asarray(T), dz, kappa), 1e-14)
    got = tphys.convective_adjustment_implicit_step(torch.tensor(T), dt, dz, kappa)
    _close(got, jphys.convective_adjustment_implicit_step(jnp.asarray(T), dt, dz, kappa), F64)
    # Zero-flux boundaries: the adjustment conserves heat.
    np.testing.assert_allclose(_np(got).sum(-1), T.sum(-1), rtol=1e-12)


# ---------------------------------------------------------------------------
# The model and its solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base", ["convective_adjustment", "none"])
@pytest.mark.parametrize("closure", ["mlp", "conv", None])
def test_rhs_matches_jax(closure, base):
    jm, jn = _jax_model(base_closure=base), _jax_closure(closure)
    T = _unstable_T0()
    want = jfc.free_convection_rhs(jm, jn, jnp.asarray(T), 0.0)
    _close(tfc.free_convection_rhs(_port(jm), _port(jn), torch.tensor(T), 0.0), want, 1e-12)
    _close(tfc.diagnose_wT(_port(jm), _port(jn), torch.tensor(T)), jfc.diagnose_wT(jm, jn, jnp.asarray(T)), 1e-12)


@pytest.mark.parametrize("base", ["convective_adjustment", "none"])
@pytest.mark.parametrize("method", ["rk4", "split"])
def test_solve_matches_jax_f64(method, base):
    jm, jn = _jax_model(base_closure=base), _jax_closure("mlp")
    T0 = _unstable_T0()
    want = jfc.solve_free_convection_nde(jm, jn, jnp.asarray(T0), 0.0, 1e-3, 4, n_substeps=3, method=method)
    got = tfc.solve_free_convection_nde(_port(jm), _port(jn), torch.tensor(T0), 0.0, 1e-3, 4, n_substeps=3,
                                        method=method)
    assert got.shape == (5, S, NZ)
    _close(got, want)


@pytest.mark.parametrize("method", ["rk4", "split"])
def test_gradient_matches_jax_f64(method):
    jm, jn = _jax_model(), _jax_closure("conv")
    T0, target = _unstable_T0(), np.random.default_rng(5).normal(size=(5, S, NZ))

    def jloss(nn):
        traj = jfc.solve_free_convection_nde(jm, nn, jnp.asarray(T0), 0.0, 1e-3, 4, n_substeps=3, method=method)
        return jnp.mean((traj - target) ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(jn)
    tn = _port(jn)
    leaves = [p.requires_grad_(True) for p in tmlp._leaves(tn)]
    traj = tfc.solve_free_convection_nde(_port(jm), tn, torch.tensor(T0), 0.0, 1e-3, 4, n_substeps=3, method=method)
    loss = torch.mean((traj - torch.tensor(target)) ** 2)
    loss.backward()
    _close(loss, jval)
    for p, g in zip(leaves, jax.tree_util.tree_leaves(jgrad)):
        _close(p.grad, g)


def test_split_solve_matches_jax_f32():
    jm, jn = _jax_model(dtype=jnp.float32), _jax_closure("mlp", dtype=jnp.float32)
    T0 = _unstable_T0().astype(np.float32)
    want = jfc.solve_free_convection_split(jm, jn, jnp.asarray(T0), 0.0, 1e-3, 6, n_substeps=4)
    got = tfc.solve_free_convection_split(_port(jm, jnp.float32), _port(jn, jnp.float32), torch.tensor(T0), 0.0,
                                          1e-3, 6, n_substeps=4)
    assert got.dtype == torch.float32
    _close(got, want, 0.0, F32_SCALE)


def test_split_backends_cuda_and_scan_agree_on_cpu():
    # On CPU tensors the "cuda" backend runs the kernel's plain version, _thomas_scan, on the same f32 inputs.
    m, n = _port(_jax_model(dtype=jnp.float32), jnp.float32), _port(_jax_closure("mlp", dtype=jnp.float32), jnp.float32)
    T0 = torch.tensor(_unstable_T0(), dtype=torch.float32)
    runs = [tfc.solve_free_convection_nde(m, n, T0, 0.0, 1e-3, 3, n_substeps=2, method="split", tridiag_backend=b)
            for b in ("scan", "cuda")]
    assert torch.equal(*runs)


def test_per_sim_fluxes_broadcast_left_aligned():
    # S == Nz - 1: a right-aligned broadcast of the (S,) fluxes would raise no shape error here.
    jm, jn = _jax_model(S=3, Nz=4), None
    T = _unstable_T0(3, 4)
    got = tfc.free_convection_rhs(_port(jm), jn, torch.tensor(T), 0.0)
    _close(got, jfc.free_convection_rhs(jm, jn, jnp.asarray(T), 0.0), 1e-12)
    for s in range(3):
        member = dataclasses.replace(jm, bottom_flux=jm.bottom_flux[s], top_flux=jm.top_flux[s])
        _close(got[s], jfc.free_convection_rhs(member, jn, jnp.asarray(T[s]), 0.0), 1e-12)


# The JAX suite's golden tests of the model (tests/test_models.py::TestFreeConvection,
# tests/test_physics.py::TestEncroachmentLaw), on the port.


def _golden_model(base_closure="convective_adjustment", top_flux=0.0, dtype=torch.float32):
    c = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    return tfc.FreeConvectionModel(
        H=c(256.0), tau=c(691200.0), T_scaling=TScaling(c(19.0), c(0.5)), wT_scaling=TScaling(c(0.0), c(1e-5)),
        bottom_flux=c(0.0), top_flux=c(top_flux), kappa=c(10.0), Nz=32, base_closure=base_closure,
    )


def _zero_closure():
    nn = tmlp.free_convection_mlp(torch.Generator().manual_seed(0), 32, device="cpu")
    return tmlp._rebuild(nn, [torch.zeros_like(p) for p in tmlp._leaves(nn)])


def test_stable_profile_stationary_without_forcing():
    T0 = torch.linspace(-1.0, 1.0, 32)
    traj = tfc.solve_free_convection_nde(_golden_model("none"), _zero_closure(), T0, 0.0, 1e-3, 5)
    np.testing.assert_allclose(_np(traj[-1]), _np(T0), atol=1e-6)


def test_conv_adj_mixes_unstable_profile():
    T0 = torch.linspace(1.0, -1.0, 32)  # unstable
    traj = tfc.solve_free_convection_nde(_golden_model(), _zero_closure(), T0, 0.0, 1e-4, 20, n_substeps=8)
    assert float(torch.var(traj[-1])) < float(torch.var(traj[0]))  # adjustment homogenizes
    np.testing.assert_allclose(float(traj[-1].sum()), float(traj[0].sum()), atol=1e-3)  # zero BC fluxes


def test_surface_cooling_cools_column():
    traj = tfc.solve_free_convection_nde(_golden_model(top_flux=1.0), _zero_closure(), torch.zeros(32), 0.0, 1e-4,
                                         10, n_substeps=4)
    assert float(traj[-1].sum()) < float(traj[0].sum())


@pytest.mark.parametrize("method", ["rk4", "split"])
def test_gradient_matches_finite_differences(method):
    """Discrete adjoint against central differences, f64 (the JAX suite's check of discretize-then-optimize)."""
    model = _golden_model(dtype=torch.float64)
    nn = tmlp.free_convection_mlp(torch.Generator().manual_seed(2), 32, dtype=torch.float64, device="cpu")
    T0 = torch.linspace(-1.0, 1.0, 32, dtype=torch.float64)

    def loss(nn):
        traj = tfc.solve_free_convection_nde(model, nn, T0, 0.0, 1e-3, 5, n_substeps=2, method=method)
        return torch.mean(traj ** 2)

    W = nn.weights[0].requires_grad_(True)
    loss(nn).backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in [W]) and float(W.grad.abs().max()) > 0
    eps = 1e-6
    for i, j in ((0, 0), (3, 7), (10, 20)):
        bump = torch.zeros_like(W)
        bump[i, j] = eps
        with torch.no_grad():
            plus = loss(dataclasses.replace(nn, weights=(W + bump,) + nn.weights[1:]))
            minus = loss(dataclasses.replace(nn, weights=(W - bump,) + nn.weights[1:]))
        np.testing.assert_allclose(float(W.grad[i, j]), float((plus - minus) / (2 * eps)), rtol=1e-5, atol=1e-10)


def test_convective_deepening_follows_sqrt_law():
    """Surface cooling into linear stratification deepens the mixed layer as
    h(t) = sqrt(2 F t / Gamma) (encroachment); the implicit conv-adj column
    tracks it within discretization error (the JAX suite measured 0.91-0.92)."""
    Nz, H, Gamma, F, t_end = 64, 128.0, 0.02, 1e-4, 86400.0
    zc = (np.arange(Nz) + 0.5) * (H / Nz) - H
    T0 = 20.0 + Gamma * (zc + H)
    c = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    Ts, ws = TScaling(c(20.0), c(1.0)), TScaling(c(0.0), c(1e-4))
    model = tfc.FreeConvectionModel(H=c(H), tau=c(t_end), T_scaling=Ts, wT_scaling=ws, bottom_flux=ws.scale(c(0.0)),
                                    top_flux=ws.scale(c(F)), Nz=Nz, base_closure="convective_adjustment")
    n_save = 24
    with torch.inference_mode():  # 4,800 substeps of eager ops: no autograd bookkeeping
        traj = tfc.solve_free_convection_nde(model, None, Ts.scale(c(T0)), 0.0, 1.0 / n_save, n_save, n_substeps=200,
                                             method="split")
    T = _np(Ts.unscale(traj))
    for frac in (0.5, 1.0):
        k = int(frac * n_save)
        h_theory = np.sqrt(2 * F * (frac * t_end) / Gamma)
        dev = np.abs(T[k] - T0)
        h_measured = -zc[dev > 0.02 * np.max(dev)].min()
        assert 0.8 < h_measured / h_theory < 1.15, (h_measured, h_theory)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

GEN = dict(Nz=16, n_save=6)


@pytest.fixture(scope="module")
def port_suite64():
    """All nine ids' stand-ins from one batched solve, float64."""
    params = [tfcd._SYNTHETIC_PARAMS[i] for i in range(1, 10)]
    return ts._synthetic_free_convection_les_batch([p[0] for p in params], [p[1] for p in params],
                                                   dtype=torch.float64, **GEN)


@pytest.mark.parametrize("sim_id", range(1, 10))
def test_synthetic_free_convection_matches_jax_f64(sim_id, port_suite64):
    Qb, strat = jfcd._SYNTHETIC_PARAMS[sim_id]
    assert tfcd._SYNTHETIC_PARAMS[sim_id] == (Qb, strat)
    want = js.synthetic_free_convection_les(Qb=Qb, stratification=strat, dtype=jnp.float64, **GEN)
    got = port_suite64[sim_id - 1]
    for f in dataclasses.fields(tc.ColumnTimeSeries):
        _close(getattr(got, f.name), getattr(want, f.name), GEN_RTOL)


def test_batched_generator_equals_single_id_call():
    # Elementwise per column: the batch changes no rounding (float32, bitwise).
    batch = ts._synthetic_free_convection_les_batch([1e-8, 7.5e-8], [2e-3, 1e-3], **GEN)
    for got, (Qb, strat) in zip(batch, [(1e-8, 2e-3), (7.5e-8, 1e-3)]):
        want = ts.synthetic_free_convection_les(Qb=Qb, stratification=strat, **GEN)
        for f in dataclasses.fields(tc.ColumnTimeSeries):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert not torch.equal(batch[0].T, batch[1].T)


@pytest.fixture(scope="module")
def jax_fc_suite():
    """Three ids from the JAX loader (f32, 16 LES levels, coarsened to Nz = 4) and their scalings."""
    dss = [jfcd.load_free_convection_simulation(i, Nz=4, Nz_les=16, n_save=6) for i in (1, 5, 7)]
    ds = jc.stack_datasets(dss)
    return dss, ds, JScaling.fit(ds.T.reshape(-1)), JScaling.fit(ds.wT.reshape(-1))


def test_loader_matches_jax_f32(jax_fc_suite):
    # f32 generation in both packages. Under the suite's x64 mode the JAX
    # generator forms the diffusion matrix's r kappa in f64 from weakly typed
    # scalars and rounds once; the port rounds r to f32 first. Those ulps,
    # through 24 substeps: T within 1e-5 of its scale (measured 1.5e-6), wT
    # (kappa times a difference of nearly equal T over dz) within 1e-3 of its scale.
    dss = jax_fc_suite[0]
    got = tfcd.load_free_convection_suite([1, 5, 7], Nz=4, Nz_les=16, n_save=6)
    for t, j in zip(got, dss):
        assert t.T.dtype == torch.float32 and t.T.shape == (7, 4)
        _close(t.T, j.T, 0.0, 1e-5)
        _close(t.wT, j.wT, 0.0, 1e-3)
        for f in ("t", "theta_top", "theta_bottom", "H"):
            _close(getattr(t, f), getattr(j, f), 0.0, 0.0)


def test_build_model_and_pairs_match_jax(jax_fc_suite):
    _, ds, jT, jw = jax_fc_suite
    tds, tT, tw = _to_torch(ds), _port(jT, jnp.float32), _port(jw, jnp.float32)
    jm = jfcd.build_free_convection_model(ds, jT, jw)
    tm = tfcd.build_free_convection_model(tds, tT, tw)
    assert tm.top_flux.shape == (3,) and tm.bottom_flux.shape == (3,) and tm.Nz == 4 == jm.Nz
    for f in ("H", "tau", "bottom_flux", "top_flux"):
        _close(getattr(tm, f), getattr(jm, f), 0.0, 0.0)
    # S == Nz - 1 == 3: the stacked RHS equals each member's own.
    T0 = tT.scale(tds.T[:, 0])
    _close(tfc.free_convection_rhs(tm, None, T0, 0.0), jfc.free_convection_rhs(jm, None, jT.scale(ds.T[:, 0]), 0.0),
           1e-6)
    x, y = tfcd.free_convection_regression_pairs(tds, tT, tw)
    jx, jy = jfcd.free_convection_regression_pairs(ds, jT, jw)
    assert x.shape == (21, 4) and y.shape == (21, 5)
    _close(x, jx, 0.0, 0.0)
    _close(y, jy, 0.0, 0.0)
    bad = dataclasses.replace(tds, H=tds.H * torch.tensor([1.0, 2.0, 1.0]))
    with pytest.raises(ValueError, match="column depth H"):
        tfcd.build_free_convection_model(bad, tT, tw)
    bad = dataclasses.replace(tds, t=tds.t * torch.tensor([[1.0], [2.0], [1.0]]))
    with pytest.raises(ValueError, match="time span tau"):
        tfcd.build_free_convection_model(bad, tT, tw)


def test_ids_sources_and_npz(tmp_path, caplog):
    import logging

    with caplog.at_level(logging.WARNING):
        for train, test in (([1, 2, 3, 4, 5, 6], [7, 8, 9]), ([1, 2], [2, 3]), ([1], [2]), ([1, 42], range(2, 10))):
            assert tfcd.validate_simulation_ids(train, test) == jfcd.validate_simulation_ids(train, test)
    with pytest.raises(KeyError):
        tfcd.load_free_convection_simulation(10)
    # source="les3d" reads the les3d cache that either package wrote (same name, same npz layout): a JAX-written
    # file loads in the port, a port-written one in the JAX package, each coarse-grained by both alike.
    cache = str(tmp_path / "les_cache")
    jfcd.save_column_npz(tfcd.les3d_cache_path(cache, 1, 16, 2, 600.0), js.synthetic_free_convection_les(
        Qb=1e-8, Nz=16, n_save=2, stratification=2e-3))
    tfcd.save_column_npz(tfcd.les3d_cache_path(cache, 2, 16, 2, 600.0), ts.synthetic_free_convection_les(
        Qb=2.5e-8, Nz=16, n_save=2, stratification=2e-3))
    for i in (1, 2):
        kw = dict(Nz=4, Nz_les=16, n_save=2, source="les3d", les_cache_dir=cache)
        got, want = tfcd.load_free_convection_simulation(i, **kw), jfcd.load_free_convection_simulation(i, **kw)
        for f in ("T", "wT", "t", "theta_top"):
            np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(getattr(want, f)), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="unknown source"):
        tfcd.load_free_convection_simulation(1, source="files")
    train, test = tfcd.load_data([1, 2], [3], Nz=4, Nz_les=16, n_save=2)
    assert set(train) == {1, 2} and set(test) == {3}
    # npz round trips in both directions (JAX writes, the port reads, and back).
    ds = js.synthetic_free_convection_les(Qb=5e-8, Nz=8, n_save=2)
    jfcd.save_column_npz(str(tmp_path / "j.npz"), ds)
    back = tfcd.load_column_npz(str(tmp_path / "j.npz"))
    tfcd.save_column_npz(str(tmp_path / "t.npz"), back)
    again = jfcd.load_column_npz(str(tmp_path / "t.npz"))
    for f in dataclasses.fields(tc.ColumnTimeSeries):
        np.testing.assert_array_equal(_np(getattr(back, f.name)), np.asarray(getattr(ds, f.name)))
        np.testing.assert_array_equal(np.asarray(getattr(again, f.name)), np.asarray(getattr(ds, f.name)))


def test_flux_reconstruction_matches_jax():
    rng = np.random.default_rng(7)
    u, v, T = (rng.normal(size=(2, 6, 8)) for _ in range(3))
    t = np.cumsum(rng.uniform(500.0, 700.0, size=(2, 6)), axis=-1)
    got = tfr.reconstruct_flux_profiles(*(torch.tensor(a) for a in (u, v, T, t)), 1e-4, 2.0)
    want = jfr.reconstruct_flux_profiles(*(jnp.asarray(a) for a in (u, v, T, t)), 1e-4, 2.0)
    for g, w in zip(got, want):
        _close(g, w, 1e-13)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _regression_data(n=40, Nz=NZ, seed=8):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, Nz)), rng.normal(size=(n, Nz + 1))


@pytest.mark.parametrize("closure,causality,gradient_scaling", [
    ("mlp", "none", 0.0), ("mlp", "soft", 0.5), ("conv", "hard", 0.0), ("mlp", "hard", 0.0),
])
def test_train_flux_nn_matches_jax(closure, causality, gradient_scaling):
    x, y = _regression_data()
    jn = _jax_closure(closure)
    kw = dict(learning_rate=1e-2, epochs=5, gradient_scaling=gradient_scaling, dz_hat=1.0 / NZ, causality=causality)
    jtrained, jhist = jnn.train_flux_nn(jn, jnp.asarray(x), jnp.asarray(y), **kw)
    start = _port(jn)
    ttrained, thist = tnn.train_flux_nn(start, torch.tensor(x), torch.tensor(y), **kw)
    _close(thist, jhist, TRAIN_RTOL)
    _leaves_close(ttrained, jtrained, TRAIN_RTOL)
    for p, q in zip(tmlp._leaves(start), tmlp._leaves(_port(jn))):
        assert torch.equal(p, q)  # the caller's closure is not modified
    assert all(not p.requires_grad for p in tmlp._leaves(ttrained))
    if causality == "hard":
        for W in tmlp._first_dense(ttrained).weights:
            assert not bool(W[tmlp.spatial_causality_mask(W.shape)].any())


def test_train_flux_nn_mini_batches():
    # One batch holding every row is the full batch up to the order of the mean's sum.
    x, y = (torch.tensor(a) for a in _regression_data())
    nn = _port(_jax_closure("mlp"))
    full, h_full = tnn.train_flux_nn(nn, x, y, epochs=3)
    one, h_one = tnn.train_flux_nn(nn, x, y, epochs=3, batch_size=1000, generator=torch.Generator().manual_seed(1))
    _close(h_one, h_full, 1e-12)
    _leaves_close(one, [p.numpy() for p in tmlp._leaves(full)], 1e-10)
    seen = []
    _, h = tnn.train_flux_nn(nn, x, y, epochs=2, batch_size=16, callback=lambda e, loss, n: seen.append((e, loss)))
    assert [e for e, _ in seen] == [0, 1] and [v for _, v in seen] == h  # 2 batches of 16, the last 8 rows dropped
    with pytest.raises(ValueError, match="causality"):
        tnn.train_flux_nn(nn, x, y, causality="strict")


@pytest.mark.parametrize("method,closure,hard", [("split", "conv", True), ("rk4", "mlp", False)])
def test_train_free_convection_nde_matches_jax(method, closure, hard):
    jm, jn = _jax_model(), _jax_closure(closure)
    T0 = _unstable_T0()
    targets = np.random.default_rng(9).normal(size=(S, 5, NZ)) * 0.3 + T0[:, None, :]
    t = np.linspace(0.0, 4e-3, 5)
    project = jmlp.apply_spatial_causality_mask if hard else None
    if hard:
        jn = jmlp.apply_spatial_causality_mask(jn)
    kw = dict(learning_rate=1e-2, maxiters=3, n_substeps=2, method=method)
    jtrained, jhist = jnde.train_free_convection_nde(jm, jn, jnp.asarray(T0), jnp.asarray(targets), jnp.asarray(t),
                                                     jnde.NDETrainConfig(**kw), project=project)
    ttrained, thist = tnde.train_free_convection_nde(
        _port(jm), _port(jn), torch.tensor(T0), torch.tensor(targets), torch.tensor(t), tnde.NDETrainConfig(**kw),
        project=tmlp.apply_spatial_causality_mask_ if hard else None)
    assert len(thist) == 3
    for th, jh in zip(thist, jhist):
        for name, value in th.items():
            _close(value, float(getattr(jh, name)), TRAIN_RTOL)
    _leaves_close(ttrained, jtrained, TRAIN_RTOL)
    with pytest.raises(ValueError, match="uniformly spaced"):
        tnde.train_free_convection_nde(_port(jm), _port(jn), torch.tensor(T0), torch.tensor(targets),
                                       torch.tensor([0.0, 1e-3, 3e-3, 4e-3, 5e-3]), tnde.NDETrainConfig(**kw))
