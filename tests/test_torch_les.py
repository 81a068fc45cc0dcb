"""Port parity: the 3-D LES generator (``data/les.py``), its data sources and ``generate-les``.

The JAX package's ``data/les.py`` is the reference. Its cases of
``tests/test_les.py`` run here on the port at the same small boxes
(``Nx = Ny = 8``, ``Nz = 16``, float64 unless stated): the Poisson solve,
the physics budgets, the advection dispatch, the momentum schemes, the
output contract, the catalog source, RK3, the diurnal cycle and the
``.jld2`` round trip (where h5py is installed). The parity cases hand the
JAX package's state over through numpy (the two packages draw their noise
from different generators) and hold the port to it:

- ``_poisson_solve``, ``_tendencies`` (each tracer and momentum scheme) and
  ``les_step`` (Euler and RK3, with the diurnal cycle) in float64 to
  ``RTOL = 1e-10`` of each field's scale: the same operations, the FFTs and
  the tridiagonal solve summing in other orders (measured 5e-13);
- ``run_les`` over three saves to ``RUN_RTOL = 1e-8``;
- ``stable_dt`` exactly;
- the free-convection ``les3d`` source and ``generate-les`` in float32 from the
  JAX initial state: the fields to ``F32_RTOL = 1e-5`` of their scale, the
  covariance fluxes to ``F32_FLUX_RTOL = 1e-3`` of theirs (under the suite's
  x64 mode the JAX package runs part of its f32 LES in float64, its
  eigenvalues and its complex solve; the fluxes are differences of means of
  products of f32 fields), the mean velocities and momentum fluxes also to
  absolute floors (``F32_VELOCITY_FLOOR``, ``F32_MOMENTUM_FLUX_FLOOR``);
- the ``les3d`` cache: a file either package writes loads in the other.

Left out: the two animation cases (``eval/animations.py`` is ``ROADMAP.md``
queue 1, item 10), the two sharded cases (``parallel/les_sharding.py``, item
11) and the two dispatch-plan cases (the port steps eagerly and has no
dispatch plan). The CPU FFT of a small box is slow on many threads, so this
file runs torch on one.
"""

import dataclasses
import importlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.data import free_convection as jfcd
from climateparameterizations_jl_tpu.data import les as jles
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.data import free_convection as tfcd
from climateparameterizations_jl_tpu_torch.data import les as tles
from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries, coarsen_dataset

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
RTOL, RUN_RTOL, F32_RTOL, F32_FLUX_RTOL = 1e-10, 1e-8, 1e-5, 1e-3
# Where no stress drives them the mean velocities are zero but for the f32 roundoff they gather (flux-form advection
# and the projection conserve momentum): 2e-9 m/s after three RK3 steps of the free-convection source, where the
# packages differ by 5e-11; the momentum fluxes there (and v'w' under a zonal stress) are roundoff of size 4e-10
# m^2/s^2, differing by up to 2.3e-11. Both are held to absolute floors far below the runs' scales (velocities of
# 1e-2 m/s, a wind stress of 5e-4 m^2/s^2).
F32_VELOCITY_FLOOR, F32_MOMENTUM_FLUX_FLOOR = 1e-7, 1e-9
FIELDS = ("u", "v", "w", "T")
PROFILES = ("u", "v", "T", "uw", "vw", "wT", "t")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_config(**overrides):
    kw = dict(Nx=8, Ny=8, Nz=16, dtype=torch.float64, device="cpu")
    kw.update(overrides)
    return tles.LESConfig.default(**kw)


def jax_config(**overrides):
    kw = dict(Nx=8, Ny=8, Nz=16, dtype=jnp.float64)
    kw.update(overrides)
    return jles.LESConfig.default(**kw)


def to_port(state, dtype=torch.float64) -> tles.LESState:
    return from_reference(state, "cpu", dtype)


def _close(got, want, rtol, flux=False, floor=0.0):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=(F32_FLUX_RTOL if flux else rtol) * scale + floor)


def _same_profiles(got, want, f32: bool):
    for f in PROFILES:
        flux = f32 and f in ("uw", "vw", "wT")
        floors = {"u": F32_VELOCITY_FLOOR, "v": F32_VELOCITY_FLOOR, "uw": F32_MOMENTUM_FLUX_FLOOR,
                  "vw": F32_MOMENTUM_FLUX_FLOOR}
        floor = floors.get(f, 0.0) if f32 else 0.0
        _close(getattr(got, f), getattr(want, f), F32_RTOL if f32 else RUN_RTOL, flux=flux, floor=floor)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_steps():
    """One jitted JAX ``les_step`` per (momentum scheme, method), shared by the parity cases."""
    steps = {}
    for scheme, method in (("centered", "euler"), ("weno5", "rk3")):
        jc = jax_config(Qb=2e-7, momentum_advection=scheme, diurnal=True)
        steps[scheme, method] = (jc, jax.jit(lambda s, t, jc=jc, m=method: jles.les_step(jc, s, 20.0, m, t)))
    return steps


def test_bridge_converts_config_and_state():
    jc = jax_config(Qb=2e-7, diurnal=True, advection="centered")
    tc = from_reference(jc, "cpu", torch.float64)
    assert isinstance(tc, tles.LESConfig) and (tc.Nx, tc.Ny, tc.Nz) == (8, 8, 16)
    assert tc.diurnal and tc.advection == "centered" and tc.momentum_advection == "centered"
    for f in ("Lx", "H", "Qu", "Qb", "f", "dTdz", "nu", "Cs"):
        assert float(getattr(tc, f)) == float(getattr(jc, f))
    port = small_config(Qb=2e-7, diurnal=True, advection="centered")
    for f in dataclasses.fields(tles.LESConfig):
        a, b = getattr(tc, f.name), getattr(port, f.name)
        assert (float(a) == float(b)) if isinstance(a, torch.Tensor) else a == b, f.name
    s = to_port(jles.initial_state(jc, jax.random.PRNGKey(1), noise=1e-2))
    assert s.w.shape == (8, 8, 17) and s.T.dtype == torch.float64


def test_poisson_solve_matches_jax():
    rng = np.random.default_rng(0)
    rhs = rng.normal(size=(8, 8, 16))
    got = tles._poisson_solve(small_config(), torch.tensor(rhs))
    want = jles._poisson_solve(jax_config(), jnp.asarray(rhs))
    _close(got - got.mean(), np.asarray(want) - np.asarray(want).mean(), RTOL)


@pytest.mark.parametrize("advection", ["weno5", "centered"])
@pytest.mark.parametrize("momentum", ["centered", "weno5"])
def test_tendencies_match_jax(advection, momentum):
    kw = dict(Qb=2e-7, advection=advection, momentum_advection=momentum, diurnal=True)
    jc, tc = jax_config(**kw), small_config(**kw)
    key = jax.random.PRNGKey(4)
    js = jles.initial_state(jc, key, noise=1e-2)
    ks = jax.random.split(key, 3)
    js = jles.LESState(u=0.02 * jax.random.normal(ks[0], js.u.shape, jnp.float64),
                       v=0.02 * jax.random.normal(ks[1], js.v.shape, jnp.float64),
                       w=js.w.at[..., 1:-1].set(0.01 * jax.random.normal(ks[2], js.w[..., 1:-1].shape, jnp.float64)),
                       T=js.T)
    for coriolis in (True, False):
        want = jles._tendencies(jc, js, jnp.float64(5000.0), coriolis=coriolis)
        got = tles._tendencies(tc, to_port(js), torch.tensor(5000.0, dtype=torch.float64), coriolis=coriolis)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64
            _close(g, w, RTOL)


@pytest.mark.parametrize("scheme,method", [("centered", "euler"), ("weno5", "rk3")])
def test_les_step_matches_jax(jax_steps, scheme, method):
    jc, step = jax_steps[scheme, method]
    tc = from_reference(jc, "cpu", torch.float64)
    js = jles.initial_state(jc, jax.random.PRNGKey(3), noise=1e-2)
    ts = to_port(js)
    for k in range(4):  # from a quarter day on, so the diurnal flux is not zero
        t = 21600.0 + 20.0 * k
        js, ts = step(js, t), tles.les_step(tc, ts, 20.0, method, t=t)
    for f in FIELDS:
        _close(getattr(ts, f), getattr(js, f), RTOL)
    div = tles._divergence(tc, ts.u, ts.v, ts.w)
    assert float(div.abs().max()) < 1e-12


def test_run_les_matches_jax():
    kw = dict(Nz=16, Qu=-2e-4, Qb=1e-8, nu=1e-4)
    jc, tc = jax_config(**kw), small_config(**kw)
    js0 = jles.initial_state(jc, jax.random.PRNGKey(3))
    dt = tles.stable_dt(tc, u_max=0.05)
    want = jles.run_les(jc, js0, dt=dt, n_save=3, save_every=3, method="rk3")
    got = tles.run_les(tc, to_port(js0), dt=dt, n_save=3, save_every=3, method="rk3")
    _same_profiles(got, want, f32=False)
    for f in ("H", "f", "g", "alpha", "beta", "u_top", "theta_top", "theta_bottom", "diurnal_amplitude"):
        assert float(getattr(got, f)) == pytest.approx(float(getattr(want, f)), rel=1e-15, abs=0.0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(8, 8, 16), (32, 32, 32), (64, 64, 128), (12, 12, 12)])
def test_stable_dt_equals_jax(dtype, shape):
    Nx, Ny, Nz = shape
    jc = jles.LESConfig.default(Nx=Nx, Ny=Ny, Nz=Nz, dtype=getattr(jnp, dtype))
    tc = tles.LESConfig.default(Nx=Nx, Ny=Ny, Nz=Nz, dtype=getattr(torch, dtype), device="cpu")
    for u_max, cfl in ((0.1, 0.2), (0.05, 0.6), (0.2, 0.6)):
        assert tles.stable_dt(tc, u_max, cfl) == jles.stable_dt(jc, u_max, cfl)


def _handed_over(monkeypatch, jax_state):
    """Make the port's ``initial_state`` return the JAX package's state (f32)."""
    handed = to_port(jax_state, torch.float32)
    monkeypatch.setattr(tles, "initial_state", lambda config, generator=None, noise=1e-3: handed)


def test_free_convection_les3d_source_and_caches(monkeypatch, tmp_path):
    """The FC ``les3d`` source (RK3 at CFL 0.6, the id's stratification and seed) from the JAX state; then each
    package loads the other's cache file."""
    Nz_les, n_save, kw = 8, 1, dict(Nz=4, Nz_les=8, n_save=1, source="les3d")
    jc = jles.LESConfig.default(Nx=8, Ny=8, Nz=Nz_les, Qu=0.0, Qb=2.5e-8)
    jc = dataclasses.replace(jc, dTdz=jnp.asarray(2e-3, jnp.float32))
    _handed_over(monkeypatch, jles.initial_state(jc, jax.random.PRNGKey(2)))
    jcache, tcache = str(tmp_path / "jax_cache"), str(tmp_path / "port_cache")
    want = jfcd.load_free_convection_simulation(2, les_cache_dir=jcache, **kw)
    got = tfcd.load_free_convection_simulation(2, les_cache_dir=tcache, device="cpu", **kw)
    assert got.T.shape == (n_save + 1, 4) and got.T.device.type == "cpu"
    _same_profiles(got, want, f32=True)
    name = f"les3d_sim2_N{Nz_les}_n{n_save}_dt600.npz"
    assert sorted(os.listdir(jcache)) == sorted(os.listdir(tcache)) == [name]
    assert tfcd.les3d_cache_path(tcache, 2, Nz_les, n_save, 600.0) == os.path.join(tcache, name)
    # Each package reads the other's file (no LES runs: the port's initial state would raise).
    monkeypatch.setattr(tles, "initial_state", None)
    from_jax = tfcd.load_free_convection_simulation(2, les_cache_dir=jcache, device="cpu", **kw)
    from_port = jfcd.load_free_convection_simulation(2, les_cache_dir=tcache, **kw)
    for f in PROFILES:
        np.testing.assert_array_equal(getattr(from_jax, f).numpy(), np.asarray(getattr(want, f)))
        np.testing.assert_array_equal(np.asarray(getattr(from_port, f)), getattr(got, f).numpy())
    # An unreadable cache is regenerated, with a warning.
    with open(os.path.join(tcache, name), "wb") as f:
        f.write(b"not an npz")
    _handed_over(monkeypatch, jles.initial_state(jc, jax.random.PRNGKey(2)))
    again = tfcd.load_free_convection_simulation(2, les_cache_dir=tcache, device="cpu", **kw)
    np.testing.assert_array_equal(again.T.numpy(), got.T.numpy())
    assert tfcd.load_column_npz(os.path.join(tcache, name)).T.shape == (n_save + 1, Nz_les)


def test_generate_les_command_matches_jax(monkeypatch, tmp_path, capsys):
    """``generate-les`` in both packages from the JAX initial state: the npz, the JSON line and (with h5py) the
    ``.jld2`` under the catalog name, by value; then the command's refusals before any run."""
    have_h5py = importlib.util.find_spec("h5py") is not None
    name = "wind_-5e-4_diurnal_5e-8"
    argv = ["generate-les", "--n-horizontal", "8", "--nz-les", "8", "--n-save", "2", "--dt-save", "600"]
    argv += ["--jld2-name", name] if have_h5py else ["--diurnal", "--qu", "-5e-4", "--qb", "5e-8"]
    jc = jles.LESConfig.default(Nx=8, Ny=8, Nz=8, Qu=-5e-4, Qb=5e-8, f=1e-4, diurnal=True)
    _handed_over(monkeypatch, jles.initial_state(jc, jax.random.PRNGKey(0)))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main([*argv, "--output", jout]) == 0
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["--device", "cpu", *argv, "--output", tout]) == 0
    got_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got_line["dt"] == want_line["dt"] and got_line["save_every"] == want_line["save_every"]
    assert got_line["frames"] == want_line["frames"] == 3 and got_line["finite"]
    np.testing.assert_allclose(got_line["T_final_range"], want_line["T_final_range"], rtol=F32_RTOL)
    got, want = (tfcd.load_column_npz(os.path.join(d, "les_profiles.npz")) for d in (tout, jout))
    _same_profiles(got, want, f32=True)
    assert float(got.diurnal_amplitude) == float(want.diurnal_amplitude) != 0.0
    if have_h5py:
        from climateparameterizations_jl_tpu_torch.data.lesbrary import read_les_profiles

        assert os.path.relpath(got_line["jld2"], tout) == os.path.relpath(want_line["jld2"], jout)
        _same_profiles(read_les_profiles(got_line["jld2"]), read_les_profiles(want_line["jld2"]), f32=True)
    monkeypatch.setattr(tles, "initial_state", None)  # every refusal comes before the run
    for flags, message in ((["--jld2-name", "wind_fast"], None), (["--jld2-name=-5e-4", "--diurnal"], "--diurnal"),
                           (["--jld2-name=-5e-4", "--qu=-1e-4"], "contradicts")):
        with pytest.raises(KeyError if message is None else SystemExit, match=message):
            tcli.main(["--device", "cpu", "generate-les", *flags, "--output", str(tmp_path / "refused")])


# ---------------------------------------------------------------------------
# The JAX package's tests/test_les.py cases, on the port
# ---------------------------------------------------------------------------


class TestPoisson:
    def test_inverts_discrete_laplacian(self):
        """poisson(laplacian(p)) == p (up to the pinned constant)."""
        c = small_config()
        p = torch.tensor(np.random.default_rng(0).normal(size=(c.Ny, c.Nx, c.Nz)))
        p = p - p.mean()
        gx = (p - tles._xm(p)) / c.dx
        gy = (p - tles._ym(p)) / c.dy
        zeros = torch.zeros_like(p[..., :1])
        gz = torch.cat([zeros, (p[..., 1:] - p[..., :-1]) / c.dz, zeros], dim=-1)
        diff = tles._poisson_solve(c, tles._divergence(c, gx, gy, gz)) - p
        np.testing.assert_allclose((diff - diff.mean()).numpy(), 0.0, atol=1e-8)

    def test_projection_kills_divergence(self):
        c = small_config()
        gen = torch.Generator().manual_seed(1)
        state = tles.initial_state(c, gen, noise=1e-2)
        w = state.w.clone()
        w[..., 1:-1] = 0.01 * torch.randn(w[..., 1:-1].shape, generator=gen, dtype=torch.float64)
        state = tles.LESState(u=0.01 * torch.randn(state.u.shape, generator=gen, dtype=torch.float64),
                              v=0.01 * torch.randn(state.v.shape, generator=gen, dtype=torch.float64), w=w, T=state.T)
        new = tles.les_step(c, state, dt=1.0)
        assert float(tles._divergence(c, new.u, new.v, new.w).abs().max()) < 1e-10


class TestLESPhysics:
    def test_rest_state_stays_at_rest(self):
        """No forcing, no noise: the stratified rest state stays still; the top cell diffuses molecularly."""
        c = small_config(Qu=0.0, Qb=0.0)
        state = tles.initial_state(c, noise=0.0)
        out = state
        for _ in range(5):
            out = tles.les_step(c, out, dt=30.0)
        assert float(out.u.abs().max()) < 1e-10
        assert float(out.w.abs().max()) < 1e-10
        np.testing.assert_allclose(out.T[..., :-1].numpy(), state.T[..., :-1].numpy(), atol=1e-9)
        expected_drop = float(c.nu * c.dTdz / c.dz) * 5 * 30.0
        drop = float(torch.mean(state.T[..., -1] - out.T[..., -1]))
        np.testing.assert_allclose(drop, expected_drop, rtol=1e-4)

    def test_heat_budget(self):
        """Total heat change == surface-flux loss + bottom-gradient outflux."""
        c = small_config(Qu=0.0, Qb=3e-8)
        state = tles.initial_state(c, noise=0.0)
        n, dt = 20, 30.0
        out = state
        for _ in range(n):
            out = tles.les_step(c, out, dt=dt)
        dz = float(c.dz)
        heat0 = float(state.T.sum(-1).mean()) * dz
        heat1 = float(out.T.sum(-1).mean()) * dz
        expected = -(float(c.theta_top) + float(c.nu * c.dTdz)) * n * dt
        assert abs((heat1 - heat0) - expected) < 5e-3 * abs(expected) + 1e-12

    def test_momentum_budget(self):
        """f = 0, Cs = 0: total u-momentum change == -Qu t exactly (flux form conserves momentum)."""
        c = small_config(Qu=-3e-4, Qb=0.0, f=0.0, Cs=0.0)
        state = tles.initial_state(c, torch.Generator().manual_seed(5), noise=1e-3)
        n, dt = 15, 20.0
        out = state
        for _ in range(n):
            out = tles.les_step(c, out, dt=dt)
        dz = float(c.dz)
        mom0 = float(state.u.sum(-1).mean()) * dz
        mom1 = float(out.u.sum(-1).mean()) * dz
        np.testing.assert_allclose(mom1 - mom0, -float(c.Qu) * n * dt, rtol=1e-10)

    def test_convection_mixes_surface(self):
        """Surface cooling: a mixed layer forms."""
        c = small_config(Nz=16, Qu=0.0, Qb=2e-7, nu=1e-4)
        dt = tles.stable_dt(c, u_max=0.05)
        ds = tles.run_les(c, dt=dt, n_save=4, save_every=40, generator=torch.Generator().manual_seed(2))
        T0, T1 = ds.T[0].numpy(), ds.T[-1].numpy()
        assert np.all(np.isfinite(T1))
        assert T1.sum() < T0.sum()
        assert (T0 - T1)[-4:].mean() > (T0 - T1)[:4].mean()


class TestAdvectionDispatch:
    def test_unknown_scheme_raises(self):
        c = small_config(advection="weno")  # a typo for "weno5"
        with pytest.raises(ValueError, match="advection"):
            tles.les_step(c, tles.initial_state(c, noise=0.0), 1.0)

    def test_gyre_unknown_scheme_raises(self):
        from climateparameterizations_jl_tpu_torch.embed.double_gyre import (
            DoubleGyreModel,
            DoubleGyreState,
            double_gyre_step,
        )

        model = DoubleGyreModel.default(Nx=8, Ny=8, Nz=4, advection="WENO5", device="cpu")  # case slip
        with pytest.raises(ValueError, match="advection"):
            double_gyre_step(model, DoubleGyreState.rest(model), 1800.0)


class TestMomentumAdvection:
    """WENO5 flux-form momentum against the 2nd-order centered scheme."""

    def _smooth_state(self, c, amp=0.05):
        """A divergence-free streamfunction flow, z-independent (w = 0), and stratified T."""
        kx, ky = 2 * np.pi / float(c.Lx), 2 * np.pi / float(c.Ly)
        xf = np.arange(c.Nx) * float(c.dx)
        xc = xf + 0.5 * float(c.dx)
        yf = np.arange(c.Ny) * float(c.dy)
        yc = yf + 0.5 * float(c.dy)
        zc = (np.arange(c.Nz) + 0.5) * float(c.dz)
        u = amp * np.sin(kx * xf)[None, :, None] * np.cos(ky * yc)[:, None, None] * np.ones_like(zc)
        v = -amp * np.cos(kx * xc)[None, :, None] * np.sin(ky * yf)[:, None, None] * np.ones_like(zc)
        w = np.zeros((c.Ny, c.Nx, c.Nz + 1))
        T = np.asarray(19.0 + 0.01 * (zc - float(c.H)))[None, None, :] * np.ones((c.Ny, c.Nx, 1))
        return tles.LESState(*(torch.tensor(a, dtype=c.H.dtype) for a in (u, v, w, T)))

    def _tendency_diff(self, N):
        outs = []
        for scheme in ("centered", "weno5"):
            c = small_config(Nx=N, Ny=N, Nz=8, momentum_advection=scheme)
            outs.append(tles._tendencies(c, self._smooth_state(c), 0.0))
        return max(float((outs[0][0] - outs[1][0]).abs().max()), float((outs[0][1] - outs[1][1]).abs().max()))

    def test_uniform_flow_identical_tendencies(self):
        outs = []
        for scheme in ("centered", "weno5"):
            c = small_config(momentum_advection=scheme)
            z = (torch.arange(16, dtype=torch.float64) + 0.5) * c.dz
            state = tles.LESState(u=torch.full((8, 8, 16), 0.05, dtype=torch.float64),
                                  v=torch.full((8, 8, 16), -0.03, dtype=torch.float64),
                                  w=torch.zeros((8, 8, 17), dtype=torch.float64),
                                  T=torch.broadcast_to(19.0 + 0.01 * z, (8, 8, 16)))
            outs.append(tles._tendencies(c, state, 0.0))
        for a, b in zip(outs[0][:3], outs[1][:3]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)

    def test_smooth_field_schemes_converge_together(self):
        d8, d16 = self._tendency_diff(8), self._tendency_diff(16)
        assert d16 < d8 / 3.0, (d8, d16)

    def test_weno5_momentum_step_runs_finite(self):
        c = small_config(momentum_advection="weno5", Qu=-5e-4, Qb=3e-8)
        state = tles.initial_state(c)
        dt = tles.stable_dt(c)
        for _ in range(4):
            state = tles.les_step(c, state, dt)
        assert bool(torch.isfinite(state.T).all() and torch.isfinite(state.u).all())

    def test_unknown_momentum_scheme_raises(self):
        c = small_config(momentum_advection="weno")
        with pytest.raises(ValueError, match="momentum advection"):
            tles.les_step(c, tles.initial_state(c, noise=0.0), 1.0)


class TestLESOutput:
    @pytest.fixture(scope="class")
    def dataset(self):
        c = small_config(Nz=32, Qu=-2e-4, Qb=1e-8, nu=1e-4)
        dt = tles.stable_dt(c, u_max=0.05)
        return tles.run_les(c, dt=dt, n_save=6, save_every=25, generator=torch.Generator().manual_seed(3))

    def test_column_time_series_contract(self, dataset):
        ds = dataset
        assert isinstance(ds, ColumnTimeSeries)
        assert ds.T.shape == (7, 32) and ds.wT.shape == (7, 33) and ds.t.shape == (7,)
        for name in ("u", "v", "T", "uw", "vw", "wT"):
            assert bool(torch.isfinite(getattr(ds, name)).all()), name

    def test_boundary_fluxes_imposed(self, dataset):
        ds = dataset
        np.testing.assert_allclose(ds.uw[:, -1].numpy(), float(ds.u_top), rtol=1e-6)
        np.testing.assert_allclose(ds.wT[:, -1].numpy(), float(ds.theta_top), rtol=1e-6)
        np.testing.assert_allclose(ds.uw[:, 0].numpy(), 0.0, atol=1e-12)

    def test_wind_accelerates_surface_current(self, dataset):
        assert float(dataset.u[-1, -1]) > 0.0  # Qu < 0: an eastward surface current spins up

    def test_coarsens_into_pipeline(self, dataset):
        coarse = coarsen_dataset(dataset, 16)
        assert coarse.T.shape == (7, 16) and coarse.wT.shape == (7, 17)
        np.testing.assert_allclose(coarse.T.mean(-1).numpy(), dataset.T.mean(-1).numpy(), rtol=1e-6)


class TestRegistryLESSource:
    def test_catalog_entry_generates_via_les3d(self):
        from climateparameterizations_jl_tpu_torch.data.registry import load_simulation

        ds = load_simulation("strong_wind", Nz_les=12, n_save=2, dt_save=60.0, source="les3d", device="cpu")
        assert ds.T.shape == (3, 12)
        assert bool(torch.isfinite(ds.T).all())
        assert float(ds.u_top) < 0.0  # the signed kinematic momentum flux


class TestRK3:
    def test_rk3_divergence_free_and_consistent(self):
        """RK3 keeps the field divergence-free and agrees with Euler to O(dt^2) as dt -> 0."""
        c = small_config()
        state = tles.initial_state(c, torch.Generator().manual_seed(9), noise=1e-2)
        out3 = tles.les_step(c, state, dt=10.0, method="rk3")
        assert float(tles._divergence(c, out3.u, out3.v, out3.w).abs().max()) < 1e-10
        e = tles.les_step(c, state, dt=0.5, method="euler")
        r = tles.les_step(c, state, dt=0.5, method="rk3")
        assert float((e.T - r.T).abs().max()) < 1e-6

    def test_rk3_stable_at_higher_cfl(self):
        c = small_config(Nz=16, Qu=-5e-4, Qb=2e-7, nu=1e-5)
        dt = tles.stable_dt(c, u_max=0.05, cfl=0.6)
        ds = tles.run_les(c, dt=dt, n_save=3, save_every=30, generator=torch.Generator().manual_seed(10),
                          method="rk3")
        assert bool(torch.isfinite(ds.T).all()) and bool(torch.isfinite(ds.wT).all())


class TestDiurnalLES:
    def test_diurnal_flux_cycles(self):
        c = small_config(Qb=5e-8, diurnal=True)
        t = lambda s: torch.tensor(s, dtype=torch.float64)  # noqa: E731
        q0 = float(tles.surface_theta_flux(c, t(0.0)))
        q_quarter = float(tles.surface_theta_flux(c, t(86400.0 / 4)))
        q_half = float(tles.surface_theta_flux(c, t(86400.0 / 2)))
        assert abs(q0) < 1e-18
        np.testing.assert_allclose(q_quarter, float(c.theta_top), rtol=1e-6)
        assert abs(q_half) < 1e-12 * abs(q_quarter) + 1e-18

    def test_diurnal_catalog_entry_via_les3d(self):
        from climateparameterizations_jl_tpu_torch.data.registry import load_simulation

        ds = load_simulation("wind_-5e-4_diurnal_5e-8", Nz_les=10, n_save=2, dt_save=60.0, source="les3d",
                             device="cpu")
        assert bool(torch.isfinite(ds.T).all())
        wt_top = ds.wT[:, -1].numpy()
        assert abs(wt_top[0]) < 1e-12
        assert not np.allclose(wt_top[1:], wt_top[0])


class TestJLD2RoundTrip:
    def test_write_then_read(self, tmp_path):
        from climateparameterizations_jl_tpu_torch.data.lesbrary import HAVE_H5PY, read_les_profiles, write_les_profiles

        if not HAVE_H5PY:
            pytest.skip("h5py not available")
        c = small_config(Nz=12)
        ds = tles.run_les(c, dt=20.0, n_save=3, save_every=5, generator=torch.Generator().manual_seed(11))
        path = str(tmp_path / "gen.jld2")
        write_les_profiles(path, ds)
        back = read_les_profiles(path)
        np.testing.assert_allclose(back.T.numpy(), ds.T.numpy(), rtol=1e-6)
        np.testing.assert_allclose(back.wT.numpy(), ds.wT.numpy(), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(back.t.numpy(), ds.t.numpy(), rtol=1e-6)
        np.testing.assert_allclose(float(back.theta_top), float(ds.theta_top), rtol=1e-5)
        np.testing.assert_allclose(float(back.u_top), float(ds.u_top), rtol=1e-6)
        np.testing.assert_allclose(float(back.H), float(ds.H), rtol=1e-12)


def test_poisson_diagonals_are_built_once_and_pinned():
    """One contiguous (2, Ny, Nx // 2 + 1, Nz) batch per config, kept on the config; the (0, 0) mode pinned."""
    c = small_config()
    dl, d, du = c.poisson_diagonals
    assert c.poisson_diagonals[1] is d
    assert all(a.shape == (2, 8, 5, 16) and a.is_contiguous() and a.dtype == torch.float64 for a in (dl, d, du))
    assert float(d[0, 0, 0, 0]) == 1.0 and float(du[0, 0, 0, 0]) == 0.0 and float(dl[0, 0, 0, 1]) == 0.0
    assert bool((dl[..., 0] == 0).all()) and bool((du[..., -1] == 0).all())
    assert torch.equal(dl[0], dl[1]) and torch.equal(d[0], d[1])
    assert dataclasses.replace(c, Nz=8).poisson_diagonals[0].shape == (2, 8, 5, 8)


def test_pressure_solve_is_one_batched_solve(monkeypatch):
    """Each projection is one solve of the stacked real and imaginary parts: one per Euler step, three per RK3 step;
    f64 state with the kernel backend raises and names the scan."""
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    shapes = []
    original = tri._thomas_cuda
    monkeypatch.setattr(tri, "_thomas_cuda", lambda *a: shapes.append(tuple(a[3].shape)) or original(*a))
    c32 = small_config(dtype=torch.float32)
    s = tles.initial_state(c32)
    tles.les_step(c32, s, 10.0, "euler", tridiag_backend="cuda")
    assert shapes == [(2, 8, 5, 16)]
    tles.les_step(c32, s, 10.0, "rk3", tridiag_backend="cuda")
    assert shapes == [(2, 8, 5, 16)] * 4
    with pytest.raises(ValueError, match="backend='scan'"):
        tles.les_step(small_config(), tles.initial_state(small_config()), 10.0, tridiag_backend="cuda")
    # On the CPU "cuda" runs the kernel's plain version, _thomas_scan: the same numbers as "scan".
    a = tles.les_step(c32, s, 10.0, "rk3", tridiag_backend="cuda")
    b = tles.les_step(c32, s, 10.0, "rk3", tridiag_backend="auto")
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)
