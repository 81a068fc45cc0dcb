"""Port parity: the y-decomposed 3-D LES and double gyre (``parallel/les_sharding.py``, ``parallel/gyre_sharding.py``)
and the 2-D ``(sim, ens)`` mesh, on gloo worlds of 2 and 4 ranks.

Two spawned worlds (2 and 4 ranks) run every case through
``tests/torch_parallel_worker.py`` (no JAX), on the setups of the JAX
package's ``tests/test_les.py::TestShardedLES`` (Nx = 8, Ny = 16, Nz = 12,
three RK3 steps of 20 s from its ``initial_state``, handed over through
numpy), ``tests/test_gyre_sharding.py`` (Nx = 16, Ny = 24, Nz = 8, 12 steps
of 1,800 s from rest; with the NN closure, its remap and its stability
gate) and ``tests/test_parallel.py``'s 2-D mesh block (S = 4, E = 6). The
JAX references run here on ``make_mesh(N)`` of the 8-virtual-device CPU
mesh, in float64. Tolerances:

- the port's world-N result against its own world-1 run (float32), at the
  JAX tests' tolerances: the LES ``rtol=2e-5`` with ``atol=1e-6`` on T and
  ``1e-7`` on the velocities; the gyre ``rtol=2e-4, atol=1e-6``; the 2-D
  mesh ``rtol=1e-5, atol=1e-7``;
- the port's world-N result against the JAX package's mesh-N result
  (float64), at the port's parity tolerance for the unsharded functions:
  ``RTOL = 1e-10`` of each field's scale (``test_torch_les.py``,
  ``test_torch_double_gyre.py``); ``1e-9`` for the 2-D mesh's solve
  (``test_torch_parallel.py``).

Each rank holds ``Ny / N`` rows of every LES field and of u, T and eta, and
the ``Ny / N + 1`` v-faces around them; an Ny that does not divide raises
``ValueError``.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from helpers import make_wind_model_nns
from test_torch_parallel import _close, _f64, _suite_inputs, _t

from climateparameterizations_jl_tpu.closures.mlp import mlp_init
from climateparameterizations_jl_tpu.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu.data import les as jles
from climateparameterizations_jl_tpu.embed import double_gyre as jdg
from climateparameterizations_jl_tpu.models.wind_mixing import BoundaryConditions as JBCs
from climateparameterizations_jl_tpu.parallel import gyre_sharding as jgs
from climateparameterizations_jl_tpu.parallel import les_sharding as jls
from climateparameterizations_jl_tpu.parallel import sharding as jsh
from climateparameterizations_jl_tpu.train.nde import NDETrainConfig as JConfig
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.models.wind_mixing import BoundaryConditions
from climateparameterizations_jl_tpu_torch.parallel import world
from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

WORLDS = (2, 4)
RTOL = 1e-10
SUITE_RTOL = 1e-9
LES_STEPS, LES_DT = 3, 20.0
GYRE_STEPS, GYRE_DT = 12, 1800.0
NN_KNOBS = dict(T_remap=(18.6, 85.0), nn_stability_gate=0.02)
f32, f64 = jnp.float32, jnp.float64


def _jax_inputs():
    les_c = jles.LESConfig.default(Nx=8, Ny=16, Nz=12, dtype=f32)
    gyre = jdg.DoubleGyreModel.default(Nx=16, Ny=24, Nz=8)
    nn = mlp_init(jax.random.PRNGKey(3), [gyre.Nz, 8, gyre.Nz - 1])
    scalings = dict(T_scaling=ZeroMeanUnitVarianceScaling(mu=f32(19.7), sigma=f32(0.02)),
                    wT_scaling=ZeroMeanUnitVarianceScaling(mu=f32(0.0), sigma=f32(1e-5)))
    return dict(les_c=les_c, les_c64=jles.LESConfig.default(Nx=8, Ny=16, Nz=12, dtype=f64),
                les_s=jles.initial_state(les_c, jax.random.PRNGKey(12), noise=1e-2), gyre=gyre,
                gyre_s=jdg.DoubleGyreState.rest(gyre), nn=nn, scalings=scalings, wind=make_wind_model_nns())


def _port_setups(ji: dict, dtype, tag: str, suite: bool) -> dict:
    conv = lambda o: from_reference(o, "cpu", dtype)  # noqa: E731
    gyre = dict(model=conv(ji["gyre"]), state=conv(ji["gyre_s"]), dt=GYRE_DT, n_steps=GYRE_STEPS)
    les_c = ji["les_c64"] if dtype == torch.float64 else ji["les_c"]
    out = {f"les:{tag}": dict(config=conv(les_c), state=conv(ji["les_s"]), dt=LES_DT, method="rk3",
                              n_steps=LES_STEPS),
           f"gyre:{tag}": gyre}
    if tag == "f32":
        nn_kw = dict(nn=conv(ji["nn"]), **{k: conv(v) for k, v in ji["scalings"].items()}, n_steps=8)
        out["gyre:nn"] = dict(gyre, **nn_kw, **NN_KNOBS)
        out["gyre:nn_gate_off"] = dict(gyre, **nn_kw, T_remap=NN_KNOBS["T_remap"])
    if suite:
        model, nns = (conv(o) for o in ji["wind"])
        sx0, sbcs = _suite_inputs(None)
        out[f"suite_ensemble_solver:{tag}"] = dict(
            model=model, nns=nns, x0=_t(sx0, dtype), config=NDETrainConfig(n_substeps=2, method="split"), t0=0.0,
            dt_save=1e-3, n_save=3, bcs=BoundaryConditions(**{k: _t(v, dtype) for k, v in sbcs.items()}))
    return out


def _jax_references(ji: dict) -> dict:
    """The JAX package's results on ``make_mesh(N)``, float64: the LES at N = 2, the gyre at 2 and 4, the 2-D mesh
    at (2, 2)."""
    ji = {k: _f64(v) for k, v in ji.items()}
    les_c = ji["les_c64"]
    out = {}
    mesh = jls.make_les_mesh(2)
    step = jls.make_sharded_les_stepper(les_c, mesh, LES_DT, method="rk3", n_substeps=LES_STEPS)
    with mesh:
        s = step(jls.shard_les_state(ji["les_s"], mesh), f64(0.0))
    out["les", 2] = {f: np.asarray(getattr(s, f)) for f in ("u", "v", "w", "T")}
    for n in WORLDS:
        traj = jgs.run_double_gyre_sharded(ji["gyre"], ji["gyre_s"], dt=GYRE_DT, n_save=2, save_every=GYRE_STEPS // 2,
                                           mesh=jgs.make_gyre_mesh(n))
        out["gyre_run", n] = {f: np.asarray(getattr(traj, f)) for f in ("u", "v", "T", "eta")}
        out["gyre", n] = {f: a[-1] for f, a in out["gyre_run", n].items()}
    model, nns = ji["wind"]
    sx0, sbcs = _suite_inputs(None)
    mesh2 = jsh.make_mesh_2d(2, 2)
    solver = jsh.make_sharded_suite_ensemble_solver(model, JConfig(n_substeps=2, method="split"), mesh2)
    with mesh2:
        traj = solver(nns, JBCs(**{k: jnp.asarray(v, f64) for k, v in sbcs.items()}), jnp.asarray(sx0, f64),
                      f64(0.0), f64(1e-3), 3)
    out["suite_ensemble_solver", 4] = {"trajectory": np.asarray(traj)}
    return out


@pytest.fixture(scope="module")
def run():
    ji = _jax_inputs()
    setups = {n: {**_port_setups(ji, torch.float32, "f32", n == 4), **_port_setups(ji, torch.float64, "f64", n == 4)}
              for n in WORLDS}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(lambda: {n: world.spawn_world(worker.field_cases, n, (setups[n],)) for n in WORLDS})
        jax_refs = _jax_references(ji)
        ranks = spawned.result()
    return dict(ranks=ranks, jax=jax_refs)


def _rec(run, n, name):
    return run["ranks"][n][0]["paths"][name]


@pytest.mark.parametrize("n", WORLDS)
def test_les_matches_world_one(run, n):
    """The y-decomposed LES (ring halos, distributed FFT) against one device: ``rtol=2e-5``, ``atol`` 1e-6 on T and
    1e-7 on the velocities (float32)."""
    rec = _rec(run, n, "les:f32")
    for f, atol in (("T", 1e-6), ("u", 1e-7), ("v", 1e-7), ("w", 1e-7)):
        np.testing.assert_allclose(rec["sharded"][f], rec["unsharded"][f], rtol=2e-5, atol=atol, err_msg=f)
    assert rec["local"]["T"] == (16 // n, 8, 12)


def test_les_matches_jax_mesh(run):
    """World 2 against the JAX package's ``make_les_mesh(2)`` stepper (float64): ``RTOL = 1e-10`` of each field's
    scale."""
    got = _rec(run, 2, "les:f64")["sharded"]
    for f in ("u", "v", "w", "T"):
        _close(got[f], run["jax"]["les", 2][f], RTOL, f)


@pytest.mark.parametrize("n", WORLDS)
def test_gyre_matches_world_one(run, n):
    """The y-decomposed gyre (wall padding at the global walls only, halos between ranks, the free-surface solve's
    all_reduce) against one device: ``rtol=2e-4, atol=1e-6`` (float32)."""
    rec = _rec(run, n, "gyre:f32")
    for f in ("u", "v", "T", "eta"):
        np.testing.assert_allclose(rec["sharded"][f], rec["unsharded"][f], rtol=2e-4, atol=1e-6, err_msg=f)
    assert rec["local"] == {"T": (24 // n, 16, 8), "v": (24 // n + 1, 16, 8)}


@pytest.mark.parametrize("n", WORLDS)
def test_gyre_matches_jax_mesh(run, n):
    """World N against the JAX package's ``make_gyre_mesh(N)`` run (float64): ``RTOL = 1e-10`` of each field's
    scale."""
    got = _rec(run, n, "gyre:f64")["sharded"]
    for f in ("u", "v", "T", "eta"):
        _close(got[f], run["jax"]["gyre", n][f], RTOL, f)


@pytest.mark.parametrize("n", WORLDS)
def test_run_double_gyre_sharded_matches_jax_mesh(run, n):
    """``run_double_gyre_sharded``, every rank's frames of its own rows assembled along y, against the JAX package's
    on ``make_gyre_mesh(N)`` (float64, 2 saves of 6 steps): every frame at ``RTOL = 1e-10`` of each field's scale."""
    blocks = [r["gyre_run"] for r in run["ranks"][n]]
    got = {f: np.concatenate([b[f] for b in blocks], axis=1) for f in ("u", "T", "eta")}
    got["v"] = np.concatenate([b["v"][:, :-1] for b in blocks] + [blocks[-1]["v"][:, -1:]], axis=1)
    assert blocks[0]["T"].shape == (3, 24 // n, 16, 8) and blocks[0]["v"].shape == (3, 24 // n + 1, 16, 8)
    for f in ("u", "v", "T", "eta"):
        _close(got[f], run["jax"]["gyre_run", n][f], RTOL, f)


@pytest.mark.parametrize("n", WORLDS)
def test_gyre_nn_knobs_match_world_one(run, n):
    """The NN closure with ``T_remap`` and ``nn_stability_gate`` runs on the sharded path as on one device, and the
    gate changes the result (the knob is not dropped)."""
    rec = _rec(run, n, "gyre:nn")
    for f in ("u", "v", "T", "eta"):
        assert np.all(np.isfinite(rec["sharded"][f]))
        np.testing.assert_allclose(rec["sharded"][f], rec["unsharded"][f], rtol=2e-4, atol=1e-6, err_msg=f)
    assert not np.allclose(rec["sharded"]["T"], _rec(run, n, "gyre:nn_gate_off")["sharded"]["T"])


def test_suite_ensemble_on_2d_mesh(run):
    """Sims over "sim" and members over "ens" on a (2, 2) mesh: each rank one (2, 3) tile, no collective;
    ``rtol=1e-5, atol=1e-7`` against one device, ``1e-9`` against the JAX (2, 2) mesh."""
    rec = _rec(run, 4, "suite_ensemble_solver:f32")
    np.testing.assert_allclose(rec["sharded"]["trajectory"], rec["unsharded"]["trajectory"], rtol=1e-5, atol=1e-7)
    assert rec["collectives"] == [] and rec["local"]["mesh"] == (2, 2)
    _close(_rec(run, 4, "suite_ensemble_solver:f64")["sharded"]["trajectory"],
           run["jax"]["suite_ensemble_solver", 4]["trajectory"], SUITE_RTOL, "suite")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["les_ny_indivisible", "gyre_ny_indivisible"])
def test_indivisible_ny_raises(run, n, case):
    msg = run["ranks"][n][0]["raises"][case]
    assert msg is not None and msg.startswith("ValueError") and "not divisible" in msg, msg


@pytest.mark.parametrize("n", WORLDS)
def test_2d_mesh_needs_its_world(run, n):
    """A 2-D mesh of more ranks than the world raises and says how to start one."""
    msg = run["ranks"][n][0]["raises"]["suite_indivisible"]
    assert msg is not None and msg.startswith("RuntimeError") and "torchrun" in msg, msg
