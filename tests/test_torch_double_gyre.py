"""Port parity: the 3-D double gyre (``embed/double_gyre.py``).

A 16 x 12 x 8 basin (the JAX defaults at a small grid) runs a few 1,800 s
steps in both packages in float64, from rest and from a stirred state,
with and without the free-convection MLP (drawn by ``jax.random``, carried
over by ``bridge.from_reference``), the stability gate and the T remap, and
with each advection scheme: every field within ``RTOL = 1e-10`` of its
scale (the same operations; the DCT products and cumulative sums may sum in
other orders). The float32 run is held to ``F32_RTOL = 1e-4`` of each
field's scale: the momentum starts from rest, so its first values are
differences of O(1) pressure and surface terms, where the packages' f32
roundings differ. The free-surface solve is held to JAX directly; the
run's frames are the steps taken one by one, and the JAX suite's invariants (volume, closed walls, w = 0 at
the bottom) hold on the port's run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures.mlp import free_convection_mlp
from climateparameterizations_jl_tpu.core.scalings import ZeroMeanUnitVarianceScaling as JScaling
from climateparameterizations_jl_tpu.embed import double_gyre as jdg
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.embed import double_gyre as tdg

RTOL, F32_RTOL = 1e-10, 1e-4
NX, NY, NZ = 16, 12, 8
FIELDS = ("u", "v", "T", "eta")


def _close(got, want, rtol, what=""):
    got, want = got.detach().cpu().numpy(), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale, what


def _models(dtype=jnp.float64, **static):
    jm = jdg.DoubleGyreModel.default(Nx=NX, Ny=NY, Nz=NZ, dtype=dtype, **static)
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    tm = tdg.DoubleGyreModel.default(Nx=NX, Ny=NY, Nz=NZ, dtype=tdtype, device="cpu", **static)
    return jm, tm, tdtype


def _nn(dtype):
    nn = jax.tree.map(lambda a: a.astype(dtype), free_convection_mlp(jax.random.PRNGKey(3), NZ))
    return nn, JScaling(jnp.asarray(10.0, dtype), jnp.asarray(5.0, dtype)), JScaling(jnp.asarray(1e-6, dtype),
                                                                                    jnp.asarray(1e-5, dtype))


def _stirred(jm, state, dtype, seed=0):
    """``state`` with a small random flow on the interior faces (walls kept at 0) and a perturbed eta."""
    rng = np.random.default_rng(seed)
    u = np.asarray(state.u).copy()
    v = np.asarray(state.v).copy()
    u[:, 1:-1] = 0.05 * rng.standard_normal(u[:, 1:-1].shape)
    v[1:-1] = 0.05 * rng.standard_normal(v[1:-1].shape)
    eta = 0.01 * rng.standard_normal(np.shape(state.eta))
    return dataclasses.replace(state, u=jnp.asarray(u, dtype), v=jnp.asarray(v, dtype), eta=jnp.asarray(eta, dtype))


# name -> (model statics, stirred start, with the NN, nn kwargs)
CASES = {
    "rest_no_nn": ({}, False, False, {}),
    "stirred_nn_weno": ({}, True, True, {}),
    "stirred_nn_gate_remap": ({}, True, True, {"T_remap": (17.6, 20.4), "nn_stability_gate": 1e-3}),
    "stirred_centered": ({"advection": "centered", "momentum_advection": "centered"}, True, False, {}),
    "linear_momentum_nn": ({"linear_momentum": True}, True, True, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_run_matches_jax(name):
    static, stirred, with_nn, nn_kw = CASES[name]
    jm, tm, tdtype = _models(**static)
    js = jdg.DoubleGyreState.rest(jm, jnp.float64)
    if stirred:
        js = _stirred(jm, js, jnp.float64)
    kw, tkw = dict(nn_kw), dict(nn_kw)
    if with_nn:
        nn, Ts, ws = _nn(jnp.float64)
        kw.update(nn=nn, T_scaling=Ts, wT_scaling=ws)
        tkw.update(nn=from_reference(nn, "cpu", tdtype), T_scaling=from_reference(Ts, "cpu", tdtype),
                   wT_scaling=from_reference(ws, "cpu", tdtype))
    want = jdg.run_double_gyre(jm, js, 1800.0, n_save=2, save_every=2, **kw)
    got = tdg.run_double_gyre(tm, from_reference(js, "cpu", tdtype), 1800.0, n_save=2, save_every=2, **tkw)
    for f in FIELDS:
        _close(getattr(got, f), getattr(want, f), RTOL, f"{name} {f}")
    _close(tdg.barotropic_streamfunction(tm, got.u[-1]), jdg.barotropic_streamfunction(jm, want.u[-1]), RTOL, "psi")


def test_float32_run_matches_jax():
    jm, tm, tdtype = _models(jnp.float32)
    nn, Ts, ws = _nn(jnp.float32)
    js = jdg.DoubleGyreState.rest(jm)
    want = jdg.run_double_gyre(jm, js, 1800.0, n_save=1, save_every=3, nn=nn, T_scaling=Ts, wT_scaling=ws)
    port = lambda x: from_reference(x, "cpu", tdtype)  # noqa: E731
    got = tdg.run_double_gyre(tm, tdg.DoubleGyreState.rest(tm), 1800.0, n_save=1, save_every=3, nn=port(nn),
                              T_scaling=port(Ts), wT_scaling=port(ws))
    for f in FIELDS:
        assert getattr(got, f).dtype == torch.float32
        _close(getattr(got, f), getattr(want, f), F32_RTOL, f"f32 {f}")


def test_free_surface_solve_and_operators_match_jax():
    jm, tm, _ = _models()
    rhs = np.random.default_rng(0).standard_normal((NY, NX))
    want = jdg.solve_free_surface(jm, jnp.asarray(rhs), 1800.0)
    got = tdg.solve_free_surface(tm, torch.tensor(rhs), 1800.0)
    _close(got, want, RTOL, "d_eta")
    # The discrete operator (1 - g H dt^2 lap_N) with zero-flux walls gives the right-hand side back.
    x = got.numpy()
    xp = np.pad(x, ((1, 1), (0, 0)), mode="edge")
    xq = np.pad(x, ((0, 0), (1, 1)), mode="edge")
    lap = (xp[2:] - 2 * x + xp[:-2]) / float(tm.dy) ** 2 + (xq[:, 2:] - 2 * x + xq[:, :-2]) / float(tm.dx) ** 2
    np.testing.assert_allclose(x - float(tm.g * tm.H) * 1800.0**2 * lap, rhs, atol=1e-8)
    js = _stirred(jm, jdg.DoubleGyreState.rest(jm, jnp.float64), jnp.float64)
    ts = from_reference(js, "cpu", torch.float64)
    _close(tdg.vertical_velocity(tm, ts.u, ts.v), jdg.vertical_velocity(jm, js.u, js.v), RTOL, "w")
    _close(tdg.hydrostatic_pressure(tm, ts.T), jdg.hydrostatic_pressure(jm, js.T), RTOL, "p")
    _close(tdg._laplacian_h(ts.u, tm.dx, tm.dy), jdg._laplacian_h(js.u, jm.dx, jm.dy), RTOL, "laplacian")


def test_invariants_on_the_port_run():
    """Volume conserved, closed walls and w = 0 at the bottom (``tests/test_embed.py::TestDoubleGyre``)."""
    _, tm, _ = _models(jnp.float32)
    traj = tdg.run_double_gyre(tm, tdg.DoubleGyreState.rest(tm), 1800.0, n_save=3, save_every=8)
    assert all(bool(torch.isfinite(getattr(traj, f)).all()) for f in FIELDS)
    assert float(traj.eta.mean(dim=(1, 2)).abs().max()) < 1e-6
    assert float(traj.u[:, :, 0].abs().max()) == float(traj.u[:, :, -1].abs().max()) == 0.0
    assert float(traj.v[:, 0].abs().max()) == float(traj.v[:, -1].abs().max()) == 0.0
    assert float(tdg.vertical_velocity(tm, traj.u[-1], traj.v[-1])[..., 0].abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown advection"):
        tdg.run_double_gyre(dataclasses.replace(tm, advection="upwind"), tdg.DoubleGyreState.rest(tm), 1800.0, 1, 1)


@pytest.mark.parametrize("n_save,save_every", [(1, 1), (2, 3), (3, 1), (1, 4)])
def test_run_saves_every_save_every_steps(n_save, save_every):
    """Frame k of a run is the state after k * save_every steps of ``double_gyre_step``, bit for bit."""
    _, tm, _ = _models()
    state = tdg.DoubleGyreState.rest(tm, torch.float64)
    traj = tdg.run_double_gyre(tm, state, 1800.0, n_save=n_save, save_every=save_every, unroll=7)
    assert traj.T.shape == (n_save + 1, NY, NX, NZ)
    for k in range(n_save + 1):
        for f in FIELDS:
            assert torch.equal(getattr(traj, f)[k], getattr(state, f)), (k, f)
        for _ in range(save_every):
            state = tdg.double_gyre_step(tm, state, 1800.0)


@pytest.mark.parametrize("entry", ["double_gyre_step", "run_double_gyre"])
def test_auto_backend_is_the_scan_on_the_cpu(entry):
    """The entry points default to ``"auto"``: the Thomas kernel for CUDA state, the plain scan on the CPU."""
    _, tm, _ = _models()
    s0 = tdg.DoubleGyreState.rest(tm, torch.float64)
    if entry == "double_gyre_step":
        auto, scan = tdg.double_gyre_step(tm, s0, 1800.0), tdg.double_gyre_step(tm, s0, 1800.0, tridiag_backend="scan")
    else:
        auto = tdg.run_double_gyre(tm, s0, 1800.0, n_save=2, save_every=2)
        scan = tdg.run_double_gyre(tm, s0, 1800.0, n_save=2, save_every=2, tridiag_backend="scan")
    for f in FIELDS:
        assert torch.equal(getattr(auto, f), getattr(scan, f)), f
