"""Port parity: the embedded host column (``embed/column_model.py``).

Host models, states and MLPs are made once with the JAX package (numpy and
``jax.random`` from fixed seeds) and carried over by
``bridge.from_reference``. Each configuration runs the paired columns
(baseline, +NN) in both packages and diagnoses their fluxes over the
saved frames: the port's one call with the frames' times broadcast over the
time axis, JAX's vmap over frames. In float64 every field agrees within
``RTOL = 1e-10`` of its scale (the same operations in the same order; the
Thomas sweeps and the cumulative sums may round differently by an ulp). The
float32 run is held to ``F32_RTOL = 1e-4`` of the field's scale: the f32
roundings of the two packages' elementwise chains differ (XLA fuses and
reorders them), the mPP tanh switch amplifies such differences, and 15 host
steps carry them.

The physics checks of the JAX suite (``tests/test_embed.py:90-130``) run on
the port too: the column's heat budget closes in float64, and the bottom
boundary flux keys on the prescribed gradient, not on a transient
instability at face 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures.mlp import free_convection_mlp, wind_mixing_mlp
from climateparameterizations_jl_tpu.core.scalings import ZeroMeanUnitVarianceScaling as JScaling
from climateparameterizations_jl_tpu.embed import column_model as jcm
from climateparameterizations_jl_tpu.models.wind_mixing import FluxNNs, WindMixingScalings
from climateparameterizations_jl_tpu.physics.mpp import MPPParameters
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.embed import column_model as tcm

RTOL, F32_RTOL = 1e-10, 1e-4
NZ, S, H = 16, 3, 256.0
DT, N_SAVE, SAVE_EVERY, T0 = 60.0, 5, 3, 1000.0


def _host(dtype=jnp.float64, batched=True, **overrides):
    d = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    sc = lambda mu, sigma: JScaling(d(mu), d(sigma))  # noqa: E731
    scalings = WindMixingScalings(u=sc(0.0, 0.1), v=sc(0.0, 0.1), T=sc(19.0, 0.5), uw=sc(0.0, 1e-4),
                                  vw=sc(0.0, 1e-4), wT=sc(0.0, 1e-5))
    rng = np.random.default_rng(0)
    per = (lambda a: d(a)) if batched else (lambda a: d(np.asarray(a).reshape(-1)[0]))
    kw = dict(H=d(H), f=d(1e-4), g=d(9.80665), alpha=d(2e-4), Fu=per(-5e-4 * (1 + rng.uniform(size=S))),
              Ftheta=per(1e-5 * (2 * rng.uniform(size=S) - 0.5)), dTdz_bottom=per(np.full(S, 0.01)),
              scalings=scalings, mpp=MPPParameters.default(dtype), Nz=NZ)
    kw.update(overrides)
    return jcm.HostColumnModel(**kw)


def _state(dtype=jnp.float64, batched=True, unstable=False, seed=1):
    rng = np.random.default_rng(seed)
    shape = (S, NZ) if batched else (NZ,)
    zc = (np.arange(NZ) + 0.5) * (H / NZ) - H
    slope = -0.01 if unstable else 0.01
    T = 19.0 + slope * (zc + H) + 0.01 * rng.standard_normal(shape)
    return jcm.HostColumnState(u=jnp.asarray(0.02 * rng.standard_normal(shape), dtype),
                               v=jnp.asarray(0.02 * rng.standard_normal(shape), dtype), T=jnp.asarray(T, dtype))


def _wind_nns(dtype):
    return FluxNNs(*[jax.tree.map(lambda a: a.astype(dtype), wind_mixing_mlp(k, NZ, scale=0.3))
                     for k in jax.random.split(jax.random.PRNGKey(0), 3)])


def _fc_nns(dtype):
    return FluxNNs(uw=None, vw=None,
                   wT=jax.tree.map(lambda a: a.astype(dtype), free_convection_mlp(jax.random.PRNGKey(5), NZ)))


# name -> (host overrides, batched, unstable initial profile, NNs)
CASES = {
    "mpp_linear_single_column": (dict(nn_dimensionalize="linear"), False, False, _wind_nns),
    "mpp_affine_batched": (dict(nn_dimensionalize="affine"), True, False, _wind_nns),
    "mpp_diurnal_mixed_amplitudes": (dict(diurnal=True, diurnal_amplitude=jnp.asarray([0.0, 2e-5, -1e-5]),
                                          nn_dimensionalize="linear"), True, False, _wind_nns),
    "mpp_diurnal_ftheta_amplitude": (dict(diurnal=True, nn_dimensionalize="affine"), True, False, _wind_nns),
    "mpp_conv_adjust": (dict(mpp_conv_adjust=True, kappa_conv=jnp.asarray(1.0), nn_dimensionalize="linear",
                             dTdz_bottom=jnp.asarray([0.01, -0.01, 0.0])), True, True, _wind_nns),
    "conv_adj_fc_nn": (dict(closure="conv_adj", nn_input="T", kappa_conv=jnp.asarray(10.0), Fu=jnp.asarray(0.0)),
                       True, True, _fc_nns),
}


def _case(name, dtype=jnp.float64):
    overrides, batched, unstable, make_nns = CASES[name]
    overrides = {k: (jnp.asarray(v, dtype) if isinstance(v, jax.Array) else v) for k, v in overrides.items()}
    return _host(dtype, batched, **overrides), _state(dtype, batched, unstable), make_nns(dtype)


def _close(got, want, rtol, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs {err:.3e} against {rtol} x {scale:.3e}"


def _port(obj, dtype=torch.float64):
    return from_reference(obj, "cpu", dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_paired_runs_and_flux_diagnostics_match_jax(name):
    model, state0, nns = _case(name)
    jb, jn = jcm.run_paired_columns(model, nns, state0, jnp.float64(DT), N_SAVE, SAVE_EVERY, t0=T0)
    tmodel, tnns = _port(model), _port(nns)
    tb, tn = tcm.run_paired_columns(tmodel, tnns, _port(state0), torch.tensor(DT, dtype=torch.float64), N_SAVE,
                                    SAVE_EVERY, t0=T0)
    for label, got, want in (("baseline", tb, jb), ("with_nn", tn, jn)):
        for f in ("u", "v", "T"):
            _close(getattr(got, f), getattr(want, f), RTOL, f"{name} {label} {f}")
    assert float(jnp.max(jnp.abs(jn.T[-1] - jb.T[-1]))) > 0.0  # the NN acts

    t = T0 + DT * SAVE_EVERY * np.arange(N_SAVE + 1)
    lead = (1,) * (tn.T.dim() - 2)
    for label, sol, jsol, run_nns, tnns_ in (("baseline", tb, jb, None, None), ("with_nn", tn, jn, nns, tnns)):
        want = jax.vmap(lambda st, ti: jcm.diagnose_host_fluxes(model, run_nns, st, ti))(jsol, jnp.asarray(t))
        got = tcm.diagnose_host_fluxes(tmodel, tnns_, sol, torch.tensor(t).reshape(-1, *lead))
        for flux, g, w in zip(("uw", "vw", "wT"), got, want):
            _close(g, w, RTOL, f"{name} {label} {flux}")
    if model.nn_input == "T":
        want = jcm.diagnose_nn_heat_flux(model, nns, jn.T)
        _close(tcm.diagnose_nn_heat_flux(tmodel, tnns, tn.T), want, RTOL, f"{name} nn heat flux")


def test_single_step_and_builders_match_jax():
    """One step at a diurnal time with (S,) fields; both builders from a JAX model, field by field."""
    from climateparameterizations_jl_tpu.models.free_convection import FreeConvectionModel
    from climateparameterizations_jl_tpu.models.wind_mixing import WindMixingModel

    model, state, nns = _case("mpp_diurnal_mixed_amplitudes")
    want = jcm.host_column_step(model, nns, state, jnp.float64(DT), t=jnp.float64(20000.0))
    got = tcm.host_column_step(_port(model), _port(nns), _port(state), torch.tensor(DT, dtype=torch.float64),
                               t=20000.0)
    for f in ("u", "v", "T"):
        _close(getattr(got, f), getattr(want, f), RTOL, f"step {f}")

    wm = WindMixingModel(H=model.H, tau=jnp.float64(1e5), f=model.f, g=model.g, alpha=model.alpha,
                         kappa=jnp.float64(10.0), scalings=model.scalings, mpp=model.mpp, Nz=NZ, use_mpp=False,
                         use_conv_adj=False, zero_weights=False, diurnal=True)
    args = (model.Fu, model.Ftheta, model.dTdz_bottom, model.diurnal_amplitude)
    want = jcm.host_for_wind_mixing(wm, *args)
    got = tcm.host_for_wind_mixing(_port(wm), *(_port(a) for a in args))
    assert (got.closure, got.nn_dimensionalize, got.diurnal) == (want.closure, want.nn_dimensionalize, want.diurnal)
    assert float(got.kappa_conv) == float(want.kappa_conv) == 0.0  # base-free: a zero-physics host
    sc = model.scalings
    fc = FreeConvectionModel(H=model.H, tau=jnp.float64(1e5), T_scaling=sc.T, wT_scaling=sc.wT,
                             bottom_flux=jnp.float64(0.0), top_flux=jnp.float64(0.1), kappa=jnp.float64(10.0), Nz=NZ)
    want = jcm.host_for_free_convection(fc, 1e-4, 9.81, 2e-4, model.Ftheta, model.dTdz_bottom)
    got = tcm.host_for_free_convection(_port(fc), 1e-4, 9.81, 2e-4, _port(model.Ftheta), _port(model.dTdz_bottom))
    assert (got.closure, got.nn_input, got.nn_dimensionalize) == ("conv_adj", "T", "auto")
    for f in ("Fu", "Ftheta", "dTdz_bottom", "kappa_conv", "f", "g", "alpha"):
        _close(getattr(got, f), getattr(want, f), RTOL, f"fc host {f}")


def test_float32_pair_matches_jax():
    model, state0, nns = _case("mpp_diurnal_mixed_amplitudes", jnp.float32)
    jb, jn = jcm.run_paired_columns(model, nns, state0, jnp.float32(DT), N_SAVE, SAVE_EVERY, t0=T0)
    tb, tn = tcm.run_paired_columns(_port(model, torch.float32), _port(nns, torch.float32),
                                    _port(state0, torch.float32), torch.tensor(DT), N_SAVE, SAVE_EVERY, t0=T0)
    for label, got, want in (("baseline", tb, jb), ("with_nn", tn, jn)):
        for f in ("u", "v", "T"):
            assert getattr(got, f).dtype == torch.float32
            _close(getattr(got, f), getattr(want, f), F32_RTOL, f"f32 {label} {f}")


def test_mixed_dtypes_are_kept_through_the_stacked_solve():
    """f64 momentum over an f32 temperature: the stacked solve runs in f64 and casts each field back, as JAX's."""
    model, state, _ = _case("mpp_affine_batched", jnp.float32)
    state = dataclasses.replace(state, u=state.u.astype(jnp.float64), v=state.v.astype(jnp.float64))
    want = jcm.host_column_step(model, None, state, jnp.float32(DT))
    tstate = tcm.HostColumnState(u=_port(state.u), v=_port(state.v), T=_port(state.T, torch.float32))
    got = tcm.host_column_step(_port(model, torch.float32), None, tstate, torch.tensor(DT))
    for f in ("u", "v", "T"):
        assert str(getattr(got, f).dtype).replace("torch.", "") == str(getattr(want, f).dtype), f
        _close(getattr(got, f), getattr(want, f), F32_RTOL, f"mixed {f}")


def test_heat_budget_closes():
    """Zero bottom gradient: the column's heat changes by the surface flux alone (the zeroed boundary faces conserve)."""
    model = _host(batched=False, dTdz_bottom=jnp.float64(0.0))
    state0 = _port(_state(batched=False))
    traj = tcm.run_embedded_column(_port(model), None, state0, 60.0, 10, 5)
    dz = H / NZ
    change = float(torch.sum(traj.T[-1]) * dz - torch.sum(traj.T[0]) * dz)
    expected = -float(model.Ftheta) * 60.0 * 50
    assert abs(change - expected) < 1e-6 * abs(expected)


def test_bottom_bc_kappa_uses_prescribed_gradient():
    """A transient instability at face 1 must not pair the conv-adj kappa with the stable prescribed gradient."""
    model = _port(_host(batched=False, closure="conv_adj", kappa_conv=jnp.float64(10.0), Fu=jnp.float64(0.0),
                        Ftheta=jnp.float64(0.0), dTdz_bottom=jnp.float64(0.01)))
    dz = H / NZ
    zc = (torch.arange(NZ, dtype=torch.float64) + 0.5) * dz - H
    T = 19.0 + 0.01 * (zc + H)
    T[1] = T[0] - 1e-4  # face 1 momentarily unstable
    zeros = torch.zeros(NZ, dtype=torch.float64)
    state = tcm.HostColumnState(u=zeros, v=zeros, T=T)
    out = tcm.host_column_step(model, None, state, 150.0)
    spurious = 10.0 * 0.01 * 150.0 / dz  # what kappa_conv x dTdz_bottom would cool cell 0 by
    assert abs(float(out.T[0] - state.T[0])) < 0.05 * spurious


def test_conv_adj_and_mpp_conv_adjust_remove_instability():
    """The conv-adj host and mPP's convective_adjustment=true branch (NDE_oceananigans.jl:49-54) homogenize an
    unstable column much faster than plain mPP."""
    state0 = _port(_state(batched=False, unstable=True))
    quiet = dict(Fu=jnp.float64(0.0), Ftheta=jnp.float64(0.0), dTdz_bottom=jnp.float64(0.0))
    spread = lambda m: float(np.ptp(tcm.run_embedded_column(_port(_host(batched=False, **quiet, **m)), None, state0,  # noqa: E731
                                                            600.0, 10, 6).T[-1].numpy()))
    plain = spread({})
    assert spread({"mpp_conv_adjust": True}) < 0.3 * plain
    assert spread({"closure": "conv_adj", "kappa_conv": jnp.float64(1.0)}) < 0.3 * plain


@pytest.mark.parametrize("entry", ["host_column_step", "run_embedded_column", "run_paired_columns"])
def test_auto_backend_is_the_scan_on_the_cpu(entry):
    """The entry points default to ``"auto"``: the Thomas kernel for CUDA state, the plain scan on the CPU."""
    model, state, nns = _case("mpp_affine_batched")
    model, state, nns = _port(model), _port(state), _port(nns)
    if entry == "host_column_step":
        run = lambda **kw: [tcm.host_column_step(model, nns, state, DT, t=T0, **kw)]  # noqa: E731
    elif entry == "run_embedded_column":
        run = lambda **kw: [tcm.run_embedded_column(model, nns, state, DT, 2, 2, t0=T0, **kw)]  # noqa: E731
    else:
        run = lambda **kw: list(tcm.run_paired_columns(model, nns, state, DT, 2, 2, t0=T0, **kw))  # noqa: E731
    for auto, scan in zip(run(), run(tridiag_backend="scan")):
        for f in ("u", "v", "T"):
            assert torch.equal(getattr(auto, f), getattr(scan, f)), f
