"""Port parity: the KPP and TKE column baselines (``physics/kpp.py``, ``physics/tke.py``) against the JAX package.

The same inputs, drawn from a numpy seed, go through each function of both
packages in float64 (JAX in x64 on the CPU, its ``scan`` solve; the port's
``"auto"`` backend is the plain scan on CPU tensors) in four forcing regimes:
cooling with wind, pure convection (``Fu = 0``), heating, and pure wind
(``Fb = 0``). Tolerance ``RTOL = 1e-10`` relative to each output's scale:
both packages run the same operations in float64, in other orders where
the libraries differ (``pow``, reductions), a few ulps per step.

The float32 case runs ``tests/test_kpp_tke.py``'s own inputs (the
three-layer profile, one day of cooling, 144 steps): the measured gap is
1.3e-5 K on T of about 19 K (7 f32 ulps; U and V equal), and its limit
``F32_ATOL`` is 5e-5 K; the boundary-layer crossing cell did not flip. The port's
own golden physics mirrors ``tests/test_kpp_tke.py``: the encroachment law,
the heat budget of the diagnosed fluxes, and the continuity of the velocity
scales across the regime switch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.physics import kpp as jk
from climateparameterizations_jl_tpu.physics import tke as jt
from climateparameterizations_jl_tpu_torch.physics import kpp as tk
from climateparameterizations_jl_tpu_torch.physics import tke as tt

RTOL = 1e-10
GRAD_RTOL = 1e-8
F32_ATOL = 5e-5
C, NZ, H = 8, 32, 256.0
DZ = H / NZ
G, ALPHA, F_COR = 9.81, 2e-4, 1e-4
REGIMES = {  # (Fu, Fb)
    "cooling_wind": (-5e-4, 3e-8),
    "convection": (0.0, 3e-8),
    "heating": (-5e-4, -3e-8),
    "wind": (-5e-4, 0.0),
}
PRIOR_NAMES = ("CSL", "CNL", "Cb_T", "CKE")

# The JAX side jitted once per shape (the regimes share shapes): eager JAX
# recompiles each step's scan on every call.
j_kpp_step = jax.jit(jk.kpp_step, static_argnames=("tridiag_backend",))
j_tke_step = jax.jit(jt.tke_step, static_argnames=("tridiag_backend",))
j_solve_kpp = jax.jit(jk.solve_kpp, static_argnames=("Nz", "n_substeps", "tridiag_backend", "diurnal"))
j_solve_tke = jax.jit(jt.solve_tke, static_argnames=("Nz", "n_substeps", "tridiag_backend"))
j_bulk_ri = jax.jit(jk.bulk_richardson_number)
j_bl_depth = jax.jit(jk.boundary_layer_depth)
j_velocity_scales = jax.jit(jk.turbulent_velocity_scales)
j_kpp_diffusivities = jax.jit(jk.kpp_diffusivities)
j_kpp_fluxes = jax.jit(jk.kpp_diagnostic_fluxes, static_argnames=("Nz",))
j_tke_diffusivities = jax.jit(jt.tke_diffusivities)
j_tke_heat_flux = jax.jit(jt.tke_diagnostic_heat_flux)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(float(np.abs(want).max()), 1e-30))


def _columns(seed, fu, fb):
    """Perturbed linearly stratified columns with a weakly mixed top, and per-column forcing."""
    rng = np.random.default_rng(seed)
    zc = (np.arange(NZ) + 0.5) * DZ - H
    T = 19.0 + 0.01 * (zc + H) + 0.02 * rng.normal(size=(C, NZ))
    T[:, -6:] = T[:, -6:].mean(axis=-1, keepdims=True) + 1e-4 * rng.normal(size=(C, 6))
    U, V = 0.05 * rng.normal(size=(C, NZ)), 0.05 * rng.normal(size=(C, NZ))
    scale = np.linspace(0.5, 1.5, C)
    return dict(U=U, V=V, T=T, e=1e-6 * (1.0 + rng.random((C, NZ))), Fu=fu * scale, Fb=fb * scale,
                dTdz=np.full(C, 0.01), zc=zc, zf=np.arange(NZ + 1) * DZ - H)


def _both(a):
    return jnp.asarray(a), torch.tensor(np.asarray(a))


@pytest.fixture(scope="module", params=list(REGIMES), ids=list(REGIMES))
def case(request):
    fu, fb = REGIMES[request.param]
    c = _columns(list(REGIMES).index(request.param), fu, fb)
    j, t = {}, {}
    for k, v in c.items():
        j[k], t[k] = _both(v)
    jp, tp = jk.KPPParameters.default(jnp.float64), tk.KPPParameters.default(torch.float64, device="cpu")
    j["forcing"], t["forcing"] = jk.KPPForcing(j["Fu"], j["Fb"], j["dTdz"]), tk.KPPForcing(t["Fu"], t["Fb"], t["dTdz"])
    j["params"], t["params"] = jp, tp
    j["tke"] = jt.TKEParameters.default(jnp.float64)
    t["tke"] = tt.TKEParameters.default(torch.float64, device="cpu")
    return j, t


def test_pointwise_helpers(case):
    j, t = case
    x = np.linspace(-1e-3, 1e-3, 41)
    for p in (0.5, 1.0 / 3.0, 0.25):
        _close(tk._pow_nonneg(torch.tensor(x), p), jk._pow_nonneg(jnp.asarray(x), p))
    s = np.linspace(-0.5, 1.5, 41)
    _close(tk._shape_fn(torch.tensor(s)), jk._shape_fn(jnp.asarray(s)))
    W_t, W_j = tk._surface_layer_weights(t["zc"], t["params"].CSL), jk._surface_layer_weights(j["zc"], j["params"].CSL)
    _close(W_t, W_j)
    _close(tk._surface_layer_anomaly(t["T"], W_t), jk._surface_layer_anomaly(j["T"], W_j))
    _close(tk._gradient(t["T"], DZ), jnp.gradient(j["T"], DZ, axis=-1))
    _close(t["params"].Ctau_b(t["params"].Cb_T, t["params"].Cd_T, t["params"].Cmb_T, t["params"].Cmtau_T),
           j["params"].Ctau_b(j["params"].Cb_T, j["params"].Cd_T, j["params"].Cmb_T, j["params"].Cmtau_T))


def test_richardson_and_boundary_layer_depth(case):
    j, t = case
    Bj, Bt = G * ALPHA * j["T"], G * ALPHA * t["T"]
    _close(tk.bulk_richardson_number(t["U"], t["V"], Bt, t["zc"], t["params"], t["Fb"]),
           j_bulk_ri(j["U"], j["V"], Bj, j["zc"], j["params"], j["Fb"]))
    h_t = tk.boundary_layer_depth(t["U"], t["V"], Bt, t["zc"], t["params"], t["Fb"], H)
    _close(h_t, j_bl_depth(j["U"], j["V"], Bj, j["zc"], j["params"], j["Fb"], H))
    assert h_t.shape == (C,) and bool(((h_t > 0) & (h_t <= H)).all())


def test_velocity_scales_diffusivities_and_fluxes(case):
    j, t = case
    sigma = np.linspace(0.0, 1.2, NZ + 1)
    h = np.linspace(20.0, 120.0, C)[:, None]
    for a, b in zip(tk.turbulent_velocity_scales(torch.tensor(h), t["params"], t["Fu"][:, None], t["Fb"][:, None],
                                                 torch.tensor(sigma)),
                    j_velocity_scales(jnp.asarray(h), j["params"], j["Fu"][:, None], j["Fb"][:, None],
                                                 jnp.asarray(sigma))):
        _close(a, b)
    args = lambda d: (d["U"], d["V"], d["T"], d["zf"], d["zc"], d["params"], d["forcing"], G, ALPHA, H)  # noqa: E731
    for a, b in zip(tk.kpp_diffusivities(*args(t)), j_kpp_diffusivities(*args(j))):
        _close(a, b)
    for a, b in zip(tk.kpp_diagnostic_fluxes(*args(t), NZ), j_kpp_fluxes(*args(j), Nz=NZ)):
        _close(a, b)


def test_kpp_step(case):
    j, t = case
    common = (600.0, DZ)
    out_t = tk.kpp_step(tk.KPPState(t["U"], t["V"], t["T"]), *common, t["zf"], t["zc"], t["params"], t["forcing"],
                        F_COR, G, ALPHA, H)
    out_j = j_kpp_step(jk.KPPState(j["U"], j["V"], j["T"]), *common, j["zf"], j["zc"], j["params"], j["forcing"],
                        F_COR, G, ALPHA, H)
    for k in ("U", "V", "T"):
        _close(getattr(out_t, k), getattr(out_j, k))


def test_tke_pieces(case):
    j, t = case
    st_t, st_j = tt.TKEState(t["U"], t["V"], t["T"], t["e"]), jt.TKEState(j["U"], j["V"], j["T"], j["e"])
    got, want = tt.tke_diffusivities(st_t, DZ, t["tke"], G, ALPHA), j_tke_diffusivities(st_j, DZ, j["tke"], G, ALPHA)
    for a, b in zip([*got[:3], *got[3]], [*want[:3], *want[3]]):
        _close(a, b)
    _close(tt.tke_diagnostic_heat_flux(st_t, DZ, t["tke"], t["Fb"], G, ALPHA),
           j_tke_heat_flux(st_j, DZ, j["tke"], j["Fb"], G, ALPHA))
    out_t = tt.tke_step(st_t, 600.0, DZ, t["tke"], t["Fu"], t["Fb"], F_COR, G, ALPHA, dTdz_bottom=t["dTdz"])
    out_j = j_tke_step(st_j, 600.0, DZ, j["tke"], j["Fu"], j["Fb"], F_COR, G, ALPHA, dTdz_bottom=j["dTdz"])
    for k in ("U", "V", "T", "e"):
        _close(getattr(out_t, k), getattr(out_j, k))


def _kpp_loss(mod, params, values, c):
    """A KPP loss of the four calibrated parameters: two steps of the columns, the squared change of state."""
    params = dataclasses.replace(params, **{n: values[i] for i, n in enumerate(PRIOR_NAMES)})
    state = mod.KPPState(c["U"], c["V"], c["T"])
    for _ in range(2):
        state = mod.kpp_step(state, 600.0, DZ, c["zf"], c["zc"], params, c["forcing"], F_COR, G, ALPHA, H)
    return ((state.T - c["T"]) ** 2).sum() + (state.U**2).sum() + (state.V**2).sum()


j_kpp_grad = jax.jit(jax.grad(lambda v, params, c: _kpp_loss(jk, params, v, c)))


def test_kpp_loss_gradient_wrt_calibrated_parameters(case):
    """The gradient through two steps (the IFT backward of the solve on the port's side), finite, at 1e-8.

    Relative to each entry, with an absolute floor of 1e-12 times the loss
    (the parameters are O(1)): under heating and pure wind the nonlocal and
    convective parameters do not act, and those entries are 0 or float64
    roundoff of order 1e-18.
    """
    j, t = case
    v0 = np.array([0.1, 6.33, 1.36, 4.32])
    g_j = j_kpp_grad(jnp.asarray(v0), j["params"], {k: j[k] for k in ("U", "V", "T", "zf", "zc", "forcing")})
    v = torch.tensor(v0, requires_grad=True)
    loss = _kpp_loss(tk, t["params"], v, t)
    loss.backward()
    assert bool(torch.isfinite(v.grad).all())
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_j), rtol=GRAD_RTOL, atol=1e-12 * float(loss.detach()))


@pytest.fixture(scope="module")
def mixed():
    """Eight columns across the four regimes, with ``dTdz_bottom = 0.01``."""
    cols = [_columns(10 + i, *REGIMES[r]) for i, r in enumerate(REGIMES)]
    pick = lambda k: np.concatenate([c[k][:2] for c in cols])  # noqa: E731
    out = {k: pick(k) for k in ("U", "V", "T", "e", "Fu", "Fb", "dTdz")}
    out["t"] = np.linspace(0.0, 24 * 1200.0, 25)
    return out


@pytest.mark.parametrize("diurnal", [False, True], ids=["constant", "diurnal"])
def test_solve_kpp_matches_jax(mixed, diurnal):
    jj = {k: jnp.asarray(v) for k, v in mixed.items()}
    tt_ = {k: torch.tensor(v) for k, v in mixed.items()}
    sol_j = j_solve_kpp(jk.KPPState(jj["U"], jj["V"], jj["T"]), jj["t"], jk.KPPParameters.default(jnp.float64),
                         jk.KPPForcing(jj["Fu"], jj["Fb"], jj["dTdz"]), H, NZ, F_COR, G, ALPHA, n_substeps=2,
                         diurnal=diurnal)
    sol_t = tk.solve_kpp(tk.KPPState(tt_["U"], tt_["V"], tt_["T"]), tt_["t"],
                         tk.KPPParameters.default(torch.float64, device="cpu"),
                         tk.KPPForcing(tt_["Fu"], tt_["Fb"], tt_["dTdz"]), H, NZ, F_COR, G, ALPHA, n_substeps=2,
                         diurnal=diurnal)
    for k in ("U", "V", "T"):
        assert getattr(sol_t, k).shape == (25, 2 * len(REGIMES), NZ)
        _close(getattr(sol_t, k), getattr(sol_j, k))


def test_solve_tke_matches_jax(mixed):
    jj = {k: jnp.asarray(v) for k, v in mixed.items()}
    tt_ = {k: torch.tensor(v) for k, v in mixed.items()}
    sol_j = j_solve_tke(jt.TKEState(jj["U"], jj["V"], jj["T"], jj["e"]), jj["t"], jt.TKEParameters.default(jnp.float64),
                         jj["Fu"], jj["Fb"], H, NZ, F_COR, G, ALPHA, n_substeps=2, dTdz_bottom=jj["dTdz"])
    sol_t = tt.solve_tke(tt.TKEState(tt_["U"], tt_["V"], tt_["T"], tt_["e"]), tt_["t"],
                         tt.TKEParameters.default(torch.float64, device="cpu"), tt_["Fu"], tt_["Fb"], H, NZ, F_COR, G,
                         ALPHA, n_substeps=2, dTdz_bottom=tt_["dTdz"])
    for k in ("U", "V", "T", "e"):
        _close(getattr(sol_t, k), getattr(sol_j, k))


def test_float32_cooling_run_on_the_reference_inputs():
    """``tests/test_kpp_tke.py::TestKPP::test_cooling_run_mixes_and_conserves_momentum``'s inputs, in f32."""
    from climateparameterizations_jl_tpu.data.synthetic import three_layer_profile as jprofile
    from climateparameterizations_jl_tpu_torch.data.synthetic import three_layer_profile as tprofile

    zc = (np.arange(NZ) + 0.5) * DZ - H
    f32 = jnp.float32
    T0j = jnp.asarray(np.array(jprofile(zc)), f32)
    zj = jnp.zeros(NZ, f32)
    tj = jnp.linspace(0.0, 86400.0, 25)
    sol_j = j_solve_kpp(jk.KPPState(zj, zj, T0j), tj, jk.KPPParameters.default(),
                         jk.KPPForcing(f32(0.0), f32(1e-7), f32(0.0)), f32(H), NZ, f32(F_COR), f32(9.80665),
                         f32(ALPHA), n_substeps=6)
    T0t = tprofile(torch.tensor(zc)).to(torch.float32)
    zt = torch.zeros(NZ)
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    sol_t = tk.solve_kpp(tk.KPPState(zt, zt, T0t), torch.tensor(np.asarray(tj)),
                         tk.KPPParameters.default(device="cpu"), tk.KPPForcing(f(0.0), f(1e-7), f(0.0)), f(H), NZ,
                         f(F_COR), f(9.80665), f(ALPHA), n_substeps=6)
    assert sol_t.T.dtype == torch.float32
    np.testing.assert_allclose(sol_t.T.numpy(), np.asarray(sol_j.T), rtol=0, atol=F32_ATOL)


def test_encroachment_law():
    """Golden physics (``tests/test_kpp_tke.py:220``): TKE mixed-layer deepening tracks ``sqrt(2 F t / Gamma)``."""
    Nz_, H_, Gamma, Fb_, t_end = 64, 128.0, 0.02, 5e-8, 86400.0
    dz_ = H_ / Nz_
    zc = (np.arange(Nz_) + 0.5) * dz_ - H_
    T0 = torch.tensor(20.0 + Gamma * (zc + H_), dtype=torch.float32)
    zeros = torch.zeros(Nz_)
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    traj = tt.solve_tke(tt.TKEState(zeros, zeros, T0, torch.full((Nz_,), 1e-9)), torch.linspace(0.0, t_end, 25),
                        tt.TKEParameters.default(device="cpu"), f(0.0), f(Fb_), H_, Nz_, f(1e-4), f(9.80665),
                        f(ALPHA), n_substeps=20)
    T = traj.T.numpy()
    F_theta = Fb_ / (9.80665 * ALPHA)
    for frac in (0.5, 1.0):
        k = int(frac * 24)
        h_theory = np.sqrt(2 * F_theta * (frac * t_end) / Gamma)
        dev = np.abs(T[k] - T0.numpy())
        h_measured = -zc[dev > 0.02 * np.max(dev)].min()
        assert 0.75 < h_measured / h_theory < 1.3, (frac, h_measured, h_theory)


def test_diagnostic_fluxes_close_heat_budget():
    """Golden physics (``tests/test_kpp_tke.py:104``): the diagnosed boundary fluxes carry the heat budget."""
    from climateparameterizations_jl_tpu_torch.data.synthetic import three_layer_profile

    zc = torch.tensor((np.arange(NZ) + 0.5) * DZ - H, dtype=torch.float32)
    zf = torch.tensor(np.arange(NZ + 1) * DZ - H, dtype=torch.float32)
    T0, zeros = three_layer_profile(zc).to(torch.float32), torch.zeros(NZ)
    params = tk.KPPParameters.default(device="cpu")
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    forcing = tk.KPPForcing(f(0.0), f(1e-7), f(0.01))
    dt, g = 60.0, 9.80665
    traj = tk.solve_kpp(tk.KPPState(zeros, zeros, T0), torch.linspace(0.0, 40 * dt, 41), params, forcing, f(H), NZ,
                        f(F_COR), f(g), f(ALPHA), n_substeps=1)
    uw, vw, wT = tk.kpp_diagnostic_fluxes(traj.U, traj.V, traj.T, zf, zc, params, forcing, f(g), f(ALPHA), f(H), NZ)
    assert wT.shape == (41, NZ + 1)
    np.testing.assert_allclose(uw[:, -1].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(wT[:, -1].numpy(), 1e-7 / (g * ALPHA), rtol=1e-5)
    wT_bot = -float(params.KT0) * 0.01
    np.testing.assert_allclose(wT[:, 0].numpy(), wT_bot, rtol=1e-5)
    dT_int = ((traj.T[1:] - traj.T[:-1]).sum(dim=-1) * DZ / dt).numpy()
    np.testing.assert_allclose(dT_int, wT_bot - 1e-7 / (g * ALPHA), rtol=5e-2)
    k = 20
    dTdt = ((traj.T[k + 1] - traj.T[k]) / dt).numpy()
    div = (-(wT[k + 1, 1:] - wT[k + 1, :-1]) / DZ).numpy()
    np.testing.assert_allclose(dTdt, div, atol=0.15 * np.abs(dTdt).max())


def test_velocity_scale_continuity():
    """Golden physics (``tests/test_kpp_tke.py:262``): W_U and W_T are continuous across the regime switch."""
    params = tk.KPPParameters.default(torch.float64, device="cpu")
    h, Fu = torch.tensor(100.0, dtype=torch.float64), torch.tensor(1e-4, dtype=torch.float64)
    checked = 0
    for Cd in (params.Cd_U, params.Cd_T):
        for Fb in (1e-7, 2e-6):
            Fb = torch.tensor(Fb, dtype=torch.float64)
            d3 = ((Fb * h) ** (1.0 / 3.0) / torch.sqrt(Fu)) ** 3
            sig_switch = float(Cd / d3)
            if not 0.0 < sig_switch < float(params.CSL):
                continue
            lo = tk.turbulent_velocity_scales(h, params, Fu, Fb, torch.tensor(sig_switch - 1e-9, dtype=torch.float64))
            hi = tk.turbulent_velocity_scales(h, params, Fu, Fb, torch.tensor(sig_switch + 1e-9, dtype=torch.float64))
            for a, b in zip(lo, hi):
                assert abs(float(a) - float(b)) < 1e-6 * abs(float(a)), (float(a), float(b))
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("fb,fu", [(3e-8, 0.0), (1e-8, 1e-4), (0.0, 1e-4), (-1e-7, 1e-4), (0.0, 0.0)])
def test_full_step_gradients_finite_across_regimes(fb, fu):
    """``tests/test_kpp_tke.py::test_full_step_grads_finite_across_regimes``: no NaN through any unselected branch.

    In float64 with float32 parameters, as the JAX test runs under the
    suite's x64 mode.
    """
    params = tk.KPPParameters.default(device="cpu")
    Nz_, H_ = 32, 100.0
    f64 = torch.float64
    zf = torch.linspace(-H_, 0.0, Nz_ + 1, dtype=f64)
    zc = 0.5 * (zf[:-1] + zf[1:])
    T0 = (19.0 + 0.01 * (zc + H_)).requires_grad_(True)
    fb_, fu_ = torch.tensor(fb, dtype=f64, requires_grad=True), torch.tensor(fu, dtype=f64, requires_grad=True)
    zeros = torch.zeros(Nz_, dtype=f64)
    out = tk.kpp_step(tk.KPPState(zeros, zeros, T0), 600.0, H_ / Nz_, zf, zc, params,
                      tk.KPPForcing(fu_, fb_, torch.tensor(0.01, dtype=f64)), 1e-4, 9.81, 2e-4, H_)
    ((out.T**2).sum() + (out.U**2).sum() + (out.V**2).sum()).backward()
    assert bool(torch.isfinite(fb_.grad)) and bool(torch.isfinite(fu_.grad)) and bool(torch.isfinite(T0.grad).all())
