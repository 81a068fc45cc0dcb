"""Port parity: multiple shooting, the curriculum, resume and checkpoints of NDE training.

A tiny suite (synthetic sims at 16 LES levels, 12 saves, coarsened to
Nz = 8) is generated by the JAX package in float64 and handed over through
numpy; flux MLPs cross through ``bridge.from_reference``. Both packages then
build their batches, solve and train in float64 (the JAX tests run with x64):
the same operations in the same order, so trajectories, losses and weights
agree to ``rtol=1e-9`` (adam's ``sqrt(nu) + eps`` division can amplify a
gradient's last-digit difference; see ``tests/test_torch_training.py``).
Checkpoints written by one package are read by the other.
"""

import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.data import synthetic as js
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.physics.mpp import MPPParameters as JMPP
from climateparameterizations_jl_tpu.train import checkpoint as jck
from climateparameterizations_jl_tpu.train import nde as jnde
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm
from climateparameterizations_jl_tpu_torch.train import checkpoint as tck
from climateparameterizations_jl_tpu_torch.train import nde as tnde

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
CHANNELS = ("u", "v", "T", "dudz", "dvdz", "dTdz")
FRACTIONS = {"T": 0.8, "dTdz": 0.8, "profile": 0.5}
BC_FIELDS = ("uw_bot", "uw_top", "vw_bot", "vw_top", "wT_bot", "wT_top", "diurnal_amplitude")
RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * max(float(np.abs(want).max()), 1e-30))


def _leaf_paths(tree, prefix):
    """``(key, tensor)`` of each leaf, keyed as in a ``state.npz`` under ``prefix``."""
    out = []
    tck._map_leaves(tree, lambda key, leaf: out.append((key, leaf)) or leaf, (prefix,))
    return out


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    })


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _make_suite(diurnal: bool, specs=((-5e-4, 3e-8), (-2e-4, -1e-8))):
    kw = dict(Nz=16, n_save=12, dtype=jnp.float64, mpp=JMPP.default(jnp.float64), diurnal=diurnal)
    sims = [jc.coarsen_dataset(js.synthetic_wind_mixing_les(Qu=qu, Qb=qb, **kw), 8) for qu, qb in specs]
    if not diurnal:
        sims = [jc.enforce_surface_fluxes(d) for d in sims]
    ds = jc.stack_datasets(sims)
    model = _f64(jcli._wind_model(ds, 8, diurnal=diurnal))
    return ds, model, _to_torch(ds), from_reference(model, "cpu", torch.float64)


@pytest.fixture(scope="module")
def suite():
    return _make_suite(False)


@pytest.fixture(scope="module")
def diurnal_suite():
    return _make_suite(True, specs=((-5e-4, 5e-8), (-3.5e-4, 3e-8)))


def _nns(seed=4, scale=0.3):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    jn = _f64(jwm.FluxNNs(*[jmlp.wind_mixing_mlp(k, 8, scale=scale) for k in keys]))
    return jn, from_reference(jn, "cpu", torch.float64)


def _batches_close(tb, jb, exact=True):
    rtol = 0 if exact else 1e-12
    for name in ("x0", "targets", "t", "tau"):
        _close(getattr(tb, name), getattr(jb, name), rtol)
    assert (tb.t0 is None) == (jb.t0 is None)
    if jb.t0 is not None:
        _close(tb.t0, jb.t0, rtol)
    for name in BC_FIELDS:
        _close(getattr(tb.bcs, name), getattr(jb.bcs, name), rtol)


# ---------------------------------------------------------------------------
# multiple shooting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixture,K,stride", [("suite", 1, 2), ("suite", 3, 2), ("suite", 4, 3),
                                              ("diurnal_suite", 3, 2), ("diurnal_suite", 2, 3)])
def test_multiple_shooting_tensors_match_jax(fixture, K, stride, request):
    jds, jmodel, tds, tmodel = request.getfixturevalue(fixture)
    tsteps = np.arange(0, 13, stride)
    jb = jc.multiple_shooting_tensors(jds, jmodel.scalings, tsteps, K, tau=jmodel.tau)
    tb = tc.multiple_shooting_tensors(tds, tmodel.scalings, tsteps, K, tau=tmodel.tau)
    _batches_close(tb, jb)
    S, W = 2, (len(tsteps) - 1) // K + 1
    assert tb.x0.shape == (S * K, 24) and tb.targets.shape == (S * K, W, 24) and tb.t0.shape == (S * K,)
    # Sims-major rows; adjacent windows share their boundary frame.
    for s in range(S):
        for k in range(K - 1):
            assert torch.equal(tb.targets[s * K + k, -1], tb.targets[s * K + k + 1, 0])
    if fixture == "diurnal_suite":
        assert float(tb.bcs.diurnal_amplitude.abs().min()) > 0.0


def test_single_window_equals_plain_batch(suite):
    jds, jmodel, tds, tmodel = suite
    tsteps = np.arange(0, 13, 2)
    tb = tc.multiple_shooting_tensors(tds, tmodel.scalings, tsteps, 1, tau=tmodel.tau)
    plain = tc.training_tensors(tds, tmodel.scalings, tsteps, tau=tmodel.tau)
    for name in ("x0", "targets", "t"):
        assert torch.equal(getattr(tb, name), getattr(plain, name))
    for name in BC_FIELDS:
        assert torch.equal(getattr(tb.bcs, name), getattr(plain.bcs, name))
    assert torch.equal(tb.t0, plain.t[0].expand(2))


def test_single_sim_dataset_matches_jax(suite):
    jds, jmodel, tds, tmodel = suite
    one_j = jax.tree.map(lambda a: a[0], jds)
    one_t = tc.ColumnTimeSeries(**{f.name: getattr(tds, f.name)[0] if getattr(tds, f.name) is not None else None
                                   for f in dataclasses.fields(tds)})
    tsteps = np.arange(0, 13, 2)
    _batches_close(tc.multiple_shooting_tensors(one_t, tmodel.scalings, tsteps, 3, tau=tmodel.tau),
                   jc.multiple_shooting_tensors(one_j, jmodel.scalings, tsteps, 3, tau=jmodel.tau))


@pytest.mark.parametrize("tsteps,K,match", [
    (np.arange(0, 15, 2), 7, "out of range"),
    (np.array([0, 1, 2, 4]), 1, "strided"),
    (np.arange(0, 13, 2), 4, "divide"),
    (np.arange(0, 13, 2), 0, "divide"),
])
def test_multiple_shooting_errors_match_jax(suite, tsteps, K, match):
    jds, jmodel, tds, tmodel = suite
    with pytest.raises(ValueError, match=match) as jerr:
        jc.multiple_shooting_tensors(jds, jmodel.scalings, tsteps, K, tau=jmodel.tau)
    with pytest.raises(ValueError, match=match) as terr:
        tc.multiple_shooting_tensors(tds, tmodel.scalings, tsteps, K, tau=tmodel.tau)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("method", ["split", "rk4"])
@pytest.mark.parametrize("fixture", ["suite", "diurnal_suite"])
def test_shooting_solve_matches_jax(fixture, method, request):
    jds, jmodel, tds, tmodel = request.getfixturevalue(fixture)
    jn, tn = _nns()
    tsteps = np.arange(0, 13, 2)
    jb = jc.multiple_shooting_tensors(jds, jmodel.scalings, tsteps, 3, tau=jmodel.tau)
    tb = tc.multiple_shooting_tensors(tds, tmodel.scalings, tsteps, 3, tau=tmodel.tau)
    kw = dict(n_substeps=2, method=method)
    got = tnde._solve(tmodel, tn, tb, tnde.NDETrainConfig(**kw))
    _close(got, jnde._solve(jmodel, jn, jb, jnde.NDETrainConfig(**kw)))
    # Window k of the batched solve is the scalar-t0 solve of that window alone.
    for k in range(3):
        wb = tc.training_tensors(tds, tmodel.scalings, tsteps[2 * k: 2 * k + 3], tau=tmodel.tau)
        _close(got[np.arange(2) * 3 + k], tnde._solve(tmodel, tn, wb, tnde.NDETrainConfig(**kw)), 1e-12)
    if fixture == "diurnal_suite":
        # The per-row start times reach the diurnal top BC: a zero t0 changes the later windows.
        zero = tnde._solve(tmodel, tn, dataclasses.replace(tb, t0=torch.zeros_like(tb.t0)), tnde.NDETrainConfig(**kw))
        assert not torch.allclose(zero[1:], got[1:], atol=1e-7)


# ---------------------------------------------------------------------------
# curriculum
# ---------------------------------------------------------------------------


def _stages(mod):
    return [mod.CurriculumStage(tsteps=np.arange(0, 7), maxiters=2, learning_rate=1e-2, n_substeps=2),
            mod.CurriculumStage(tsteps=np.arange(0, 13, 3), maxiters=3, learning_rate=4e-3, n_substeps=6)]


def _history_close(t_hist, j_hist):
    assert len(t_hist) == len(j_hist)
    for th, jh in zip(t_hist, j_hist):
        _close(np.array([th[c] for c in CHANNELS]), np.array([float(getattr(jh, c)) for c in CHANNELS]))


def test_two_stage_curriculum_matches_jax(suite, tmp_path):
    """Stage 1 a plain 6-interval window at lr 1e-2; stage 2 strided by 3, with
    its n_substeps override, on a 2-window shooting batch at lr 4e-3. The adam
    moments and step count carry across the stages in both packages: a fresh
    adam for stage 2 restarts the bias correction and moves every stage-2 step."""
    jds, jmodel, tds, tmodel = suite
    jn, tn = _nns()

    def jbatch(tsteps):
        if len(tsteps) == 5:
            return jc.multiple_shooting_tensors(jds, jmodel.scalings, tsteps, 2, tau=jmodel.tau)
        return jc.training_tensors(jds, jmodel.scalings, tsteps, tau=jmodel.tau)

    def tbatch(tsteps):
        if len(tsteps) == 5:
            return tc.multiple_shooting_tensors(tds, tmodel.scalings, tsteps, 2, tau=tmodel.tau)
        return tc.training_tensors(tds, tmodel.scalings, tsteps, tau=tmodel.tau)

    kw = dict(method="split", n_substeps=2, training_fractions=FRACTIONS)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jout, jhist = jnde.train_wind_mixing_nde(jmodel, jn, jbatch(np.arange(0, 7)), jnde.NDETrainConfig(**kw),
                                             stages=_stages(jnde), full_batch_fn=jbatch, checkpoint_dir=jdir)
    tout, thist = tnde.train_wind_mixing_nde(tmodel, tn, tbatch(np.arange(0, 7)), tnde.NDETrainConfig(**kw),
                                             stages=_stages(tnde), full_batch_fn=tbatch, checkpoint_dir=tdir)
    _history_close(thist, jhist)
    for p, q in zip(tnde.nn_parameters(tout), jax.tree.leaves(jout)):
        _close(p, q)
    # The two train states hold the same leaves under the same keys.
    with np.load(os.path.join(jdir, "state.npz")) as j, np.load(os.path.join(tdir, "state.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        assert int(t["['opt_state']/[0]/.count"]) == int(j["['opt_state']/[0]/.count"]) == 5
        assert t["['opt_state']/[0]/.count"].dtype == np.int32
        for key in j.files:
            _close(t[key], j[key])
    with open(os.path.join(tdir, "meta.json")) as f, open(os.path.join(jdir, "meta.json")) as g:
        assert json.load(f) == json.load(g)

    # A fresh adam for stage 2 (the trap) gives other stage-2 losses.
    _, tn2 = _nns()
    tnde.train_wind_mixing_nde(tmodel, tn2, tbatch(np.arange(0, 7)), tnde.NDETrainConfig(**kw),
                               stages=_stages(tnde)[:1], full_batch_fn=tbatch)
    _, reset = tnde.train_wind_mixing_nde(tmodel, tn2, tbatch(np.arange(0, 13, 3)),
                                          tnde.NDETrainConfig(**dict(kw, n_substeps=6)),
                                          stages=_stages(tnde)[1:], full_batch_fn=tbatch)
    assert abs(sum(reset[1].values()) / sum(thist[3].values()) - 1.0) > 1e-6


# ---------------------------------------------------------------------------
# resume, both directions
# ---------------------------------------------------------------------------

# Fixed loss weights: with auto-balanced fractions a resumed run would
# re-balance from its own starting weights, and 3 + 3 would not be 6.
RESUME_CONFIG = dict(method="split", n_substeps=2, learning_rate=1e-2, training_fractions=None)


def _resume_batches(suite):
    jds, jmodel, tds, tmodel = suite
    tsteps = np.arange(0, 13, 2)
    return (jc.multiple_shooting_tensors(jds, jmodel.scalings, tsteps, 3, tau=jmodel.tau),
            tc.multiple_shooting_tensors(tds, tmodel.scalings, tsteps, 3, tau=tmodel.tau))


@pytest.fixture(scope="module")
def jax_runs(suite, tmp_path_factory):
    """JAX's 3 iterations with their train state written, and its uninterrupted 6 (seed 9)."""
    jds, jmodel, tds, tmodel = suite
    jb, _ = _resume_batches(suite)
    jn, _ = _nns(seed=9)
    j3 = str(tmp_path_factory.mktemp("j3"))
    jnde.train_wind_mixing_nde(jmodel, jn, jb, jnde.NDETrainConfig(maxiters=3, **RESUME_CONFIG), checkpoint_dir=j3)
    six, jhist = jnde.train_wind_mixing_nde(jmodel, jn, jb, jnde.NDETrainConfig(maxiters=6, **RESUME_CONFIG))
    return j3, six, jhist


def test_port_resumes_a_jax_train_state(suite, jax_runs, tmp_path):
    jds, jmodel, tds, tmodel = suite
    _, tb = _resume_batches(suite)
    _, tn = _nns(seed=9)
    j3, six, jhist = jax_runs
    out, thist = tnde.train_wind_mixing_nde(tmodel, tn, tb, tnde.NDETrainConfig(maxiters=3, **RESUME_CONFIG),
                                            checkpoint_dir=str(tmp_path / "t6"), resume_from=j3)
    _history_close(thist, jhist[3:])
    for p, q in zip(tnde.nn_parameters(out), jax.tree.leaves(six)):
        _close(p, q)
    _, opt_state = tnde.resume_train_state(str(tmp_path / "t6"), tn)
    assert int(opt_state[0].count) == 6


def test_jax_resumes_a_port_train_state(suite, tmp_path):
    jds, jmodel, tds, tmodel = suite
    jb, tb = _resume_batches(suite)
    jn, tn = _nns(seed=9)
    _, tn6 = _nns(seed=9)
    tnde.train_wind_mixing_nde(tmodel, tn, tb, tnde.NDETrainConfig(maxiters=3, **RESUME_CONFIG),
                               checkpoint_dir=str(tmp_path / "t3"))
    six, thist = tnde.train_wind_mixing_nde(tmodel, tn6, tb, tnde.NDETrainConfig(maxiters=6, **RESUME_CONFIG))
    config = jnde.NDETrainConfig(maxiters=3, **RESUME_CONFIG)
    params, opt_state = jnde.resume_train_state(str(tmp_path / "t3"), jn, jnde._make_optimizer(config))
    assert int(opt_state[0].count) == 3
    out, jhist = jnde.train_wind_mixing_nde(jmodel, jn, jb, config, resume_from=str(tmp_path / "t3"))
    _history_close(thist[3:], jhist)
    for p, q in zip(tnde.nn_parameters(six), jax.tree.leaves(out)):
        _close(p, q)


def test_train_loop_project_matches_jax(suite):
    """``project`` runs after every update: a hard spatial-causality mask on each
    first-layer weight (in place here, functional in JAX) holds through training."""
    from climateparameterizations_jl_tpu.closures.mlp import spatial_causality_mask

    jds, jmodel, tds, tmodel = suite
    jb, tb = _resume_batches(suite)
    jn, tn = _nns(seed=8)
    mask = np.array(spatial_causality_mask(jn.uw.weights[0].shape))

    def jproject(nns):
        return jwm.FluxNNs(*(dataclasses.replace(m, weights=(jnp.where(mask, 0.0, m.weights[0]), *m.weights[1:]))
                             for m in nns))

    def tproject(nns):
        for m in nns:
            m.weights[0][torch.from_numpy(mask)] = 0.0

    jconfig, tconfig = jnde.NDETrainConfig(**RESUME_CONFIG), tnde.NDETrainConfig(**RESUME_CONFIG)
    jfn = jnde.make_wind_mixing_loss_fn(jmodel, jb, jnde.determine_loss_scalings(jmodel, jn, jb, jconfig), jconfig)
    tfn = tnde.make_wind_mixing_loss_fn(tmodel, tb, tnde.determine_loss_scalings(tmodel, tn, tb, tconfig), tconfig)
    jout, jhist, _ = jnde._train_loop(jfn, jn, jnde._make_optimizer(jconfig), 3, project=jproject)
    tout, thist, _ = tnde._train_loop(tfn, tn, tnde._make_optimizer(tconfig, tn), 3, project=tproject)
    _history_close(thist, jhist)
    for p, q in zip(tnde.nn_parameters(tout), jax.tree.leaves(jout)):
        _close(p, q)
    assert all(float(m.weights[0].detach()[torch.from_numpy(mask)].abs().max()) == 0.0 for m in tout)


def test_sgd_train_state_roundtrip(suite, tmp_path):
    """sgd keeps no optimizer state: the train state holds the params alone, in both packages."""
    jds, jmodel, tds, tmodel = suite
    jb, tb = _resume_batches(suite)
    jn, tn = _nns(seed=2)
    config = dict(RESUME_CONFIG, optimizer="sgd", maxiters=2)
    tout, _ = tnde.train_wind_mixing_nde(tmodel, tn, tb, tnde.NDETrainConfig(**config), checkpoint_dir=str(tmp_path))
    jout, _ = jnde.train_wind_mixing_nde(jmodel, jn, jb, jnde.NDETrainConfig(**config))
    for p, q in zip(tnde.nn_parameters(tout), jax.tree.leaves(jout)):
        _close(p, q)
    with np.load(tmp_path / "state.npz") as data:
        assert all(k.startswith("['params']") for k in data.files)
    params, opt_state = jnde.resume_train_state(str(tmp_path), jn, jnde._make_optimizer(jnde.NDETrainConfig(**config)))
    assert opt_state == jnde._make_optimizer(jnde.NDETrainConfig(**config)).init(jn)
    for p, q in zip(tnde.nn_parameters(tout), jax.tree.leaves(params)):
        _close(p, q, 0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoints_cross_both_ways(tmp_path):
    jn, tn = _nns(seed=5)
    meta = {"command": "test", "nested": {"a": 1}}
    tck.save_checkpoint(str(tmp_path / "t"), tn, meta)
    back, jmeta = jck.load_checkpoint(str(tmp_path / "t"), jax.tree.map(jnp.zeros_like, jn))
    assert jmeta == meta
    for p, q in zip(tnde.nn_parameters(tn), jax.tree.leaves(back)):
        _close(p, q, 0)
    jck.save_checkpoint(str(tmp_path / "j"), jn, meta)
    skeleton = twm.FluxNNs(*(tck.mlp_skeleton({"sizes": [24, 50, 20, 7], "activation": "mish"}, "cpu",
                                              torch.float64) for _ in range(3)))
    back, tmeta = tck.load_checkpoint(str(tmp_path / "j"), skeleton)
    assert tmeta == meta
    for p, q in zip(tnde.nn_parameters(back), jax.tree.leaves(jn)):
        _close(p, q, 0)
        assert p.dtype == torch.float64


def test_adam_state_maps_onto_optax(suite, jax_runs):
    """The optax layout of a torch Adam, leaf by leaf, against optax's own state after the same 3 steps
    (JAX's train state, read as plain arrays)."""
    jds, jmodel, tds, tmodel = suite
    _, tb = _resume_batches(suite)
    _, tn = _nns(seed=9)
    config = tnde.NDETrainConfig(maxiters=3, **RESUME_CONFIG)
    ones = tnde.determine_loss_scalings(tmodel, tn, tb, config)
    optimizer = tnde._make_optimizer(config, tn)
    _, _, tstate = tnde._train_loop(tnde.make_wind_mixing_loss_fn(tmodel, tb, ones, config), tn, optimizer, 3)
    assert int(tstate[0].count) == 3 and tstate[0].count.dtype == torch.int32
    with np.load(os.path.join(jax_runs[0], "state.npz")) as j:
        assert int(j["['opt_state']/[0]/.count"]) == 3
        for field in ("mu", "nu"):
            keys = sorted(k for k in j.files if k.startswith(f"['opt_state']/[0]/.{field}/"))
            got = dict(_leaf_paths(getattr(tstate[0], field), f"['opt_state']/[0]/.{field}"))
            assert sorted(got) == keys
            for k in keys:
                _close(got[k], j[k])
    # Back into a fresh Adam: the state, copied.
    fresh = tnde._make_optimizer(config, tn)
    tck.load_optax_state(fresh, tn, tstate)
    for p in tnde.nn_parameters(tn):
        assert int(fresh.state[p]["step"]) == 3
        assert torch.equal(fresh.state[p]["exp_avg"], optimizer.state[p]["exp_avg"])
        assert fresh.state[p]["exp_avg"] is not optimizer.state[p]["exp_avg"]
    # Before any step: count 0 and zero moments, as optax.adam's init.
    _, untrained = _nns()
    (init,) = tck.optax_state(tnde._make_optimizer(config, untrained), untrained)
    assert int(init.count) == 0 and all(float(m.abs().max()) == 0.0 for m in tnde.nn_parameters(init.mu))


def test_extract_matches_jax(tmp_path):
    """Heterogeneous history records (a bool, a missing channel, an int): the
    dense channels line up by iteration with NaN gaps, as the JAX package writes them."""
    run = tmp_path / "run"
    hist = tck.history_path(str(run))
    for rec in ({"iter": 0, "loss": 1.5, "u": 0.5, "converged": False},
                {"iter": 1, "loss": 1.25, "T": 2},
                {"iter": 2, "loss": 1.0, "u": 0.25, "T": 0.75, "note": "x"}):
        hist.append(rec)
    jn, tn = _nns(seed=1)
    tck.save_checkpoint(str(run), tn, {"command": "train-nde"})
    tck.save_checkpoint(str(run / "train_state"), {"params": tn, "opt_state": ()}, {"stage": 0})
    jck.extract_checkpoint(str(run), str(tmp_path / "j"))
    tck.extract_checkpoint(str(run), str(tmp_path / "t"))
    jl, tl = jck.load_extracted_losses(str(tmp_path / "j")), tck.load_extracted_losses(str(tmp_path / "t"))
    assert sorted(tl) == sorted(jl) == ["T", "iter", "loss", "u"]
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])
    np.testing.assert_array_equal(tl["u"], [0.5, np.nan, 0.25])
    for name in ("meta.json",):
        with open(tmp_path / "t" / name) as f, open(tmp_path / "j" / name) as g:
            assert json.load(f) == json.load(g)
    for name in ("state.npz", "train_state.npz"):
        with np.load(tmp_path / "t" / name) as t, np.load(tmp_path / "j" / name) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in j.files:
                np.testing.assert_array_equal(t[k], j[k])
    assert hist.read()[1] == {"iter": 1, "loss": 1.25, "T": 2}
