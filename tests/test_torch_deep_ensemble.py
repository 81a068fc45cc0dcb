"""Port parity: deep ensembles (stacking, training, the member fold, flux regression, bands).

The counterparts of ``tests/test_deep_ensemble.py`` (its sharded cases wait
for the parallel port, ``ROADMAP.md`` queue 1 item 11; the plot case for
item 10). A tiny suite (synthetic sims at 16 LES levels, 12 saves, coarsened
to Nz = 8) is generated by the JAX package in float64 and handed over
through numpy; stacked closures cross through ``bridge.from_reference``.

Tolerances:

- ``RTOL = 1e-9`` (float64) wherever both packages run the same operations
  in the same order: stacked training, per-member loss scalings, the
  member-loop loss and gradient against JAX's vmapped ones, the curriculum
  with checkpoints read across the packages, ``train_flux_nn_ensemble``,
  the free-convection ensemble and both uncertainty bands. adam's
  ``sqrt(nu) + eps`` division amplifies a gradient's last-digit difference
  (``tests/test_torch_training.py``), hence not 1e-12.
- The member fold at S = M = 2, where a right-aligned BC broadcast would
  pass silently, on a plain and on a 2-window shooting batch: in float64
  against JAX's folded loss and gradient and against the member loop, both
  at ``RTOL``; in float32 against the member loop at JAX's own limits
  (loss 1e-5, gradients 5e-4 and 1e-7). The block-diagonal chain against
  each member's own: float64 at ``RTOL``, float32 at JAX's 2e-5 and 2e-6.
  One earlier float32 run of the chain case reported a 1.8e-5 gap on these
  inputs. It did not recur in 2,400 runs (six concurrent workers, 1 to 8
  threads each) or over 16 input alignments, where the worst gap was
  1.5e-7; and 300 random summation orders of every layer move the float32
  output by at most 1.05e-6 from float64, so thread count, alignment and
  reduction order, the CPU GEMM's freedoms, cannot produce it. Its cause
  is not known (``ROADMAP.md`` queue 3).

The commands' ensemble runs are in ``tests/test_torch_cli.py`` and
``tests/test_torch_fc_cli.py``; the flagship-size check and the trained
ensembles in ``tests/test_torch_ensemble_flagship.py``.
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
from climateparameterizations_jl_tpu.eval import ensemble_uq as juq
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.physics.mpp import MPPParameters as JMPP
from climateparameterizations_jl_tpu.train import deep_ensemble as jde
from climateparameterizations_jl_tpu.train import nde as jnde
from climateparameterizations_jl_tpu.train import nn as jnn
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.closures import mlp as tmlp
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.eval import ensemble_uq as tuq
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm
from climateparameterizations_jl_tpu_torch.train import checkpoint as tck
from climateparameterizations_jl_tpu_torch.train import deep_ensemble as tde
from climateparameterizations_jl_tpu_torch.train import nde as tnde
from climateparameterizations_jl_tpu_torch.train import nn as tnn

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
CHANNELS = ("u", "v", "T", "dudz", "dvdz", "dTdz")
FRACTIONS = {"T": 0.8, "dTdz": 0.8, "profile": 0.5}
RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * max(float(np.abs(want).max()), 1e-30))


def _leaves_close(tree_t, tree_j, rtol=RTOL):
    t, j = tck._tensors(tree_t), jax.tree.leaves(tree_j)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        _close(a, b, rtol)


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    })


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def suite():
    kw = dict(Nz=16, n_save=12, dtype=jnp.float64, mpp=JMPP.default(jnp.float64))
    sims = [jc.enforce_surface_fluxes(jc.coarsen_dataset(js.synthetic_wind_mixing_les(Qu=qu, Qb=qb, **kw), 8))
            for qu, qb in ((-5e-4, 3e-8), (-2e-4, -1e-8))]
    ds = jc.stack_datasets(sims)
    model = _f64(jcli._wind_model(ds, 8))
    tds, tmodel = _to_torch(ds), from_reference(model, "cpu", torch.float64)
    tsteps = np.arange(0, 7)
    jb = jc.training_tensors(ds, model.scalings, tsteps, tau=model.tau)
    tb = tc.training_tensors(tds, tmodel.scalings, tsteps, tau=tmodel.tau)
    return ds, model, tds, tmodel, jb, tb


def _member(seed, scale=0.3, Nz=8):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    return jwm.FluxNNs(*[jmlp.wind_mixing_mlp(k, Nz, scale=scale) for k in keys])


def _stacked(seeds, dtype=torch.float64, **kw):
    js_ = jde.stack_members([_member(s, **kw) for s in seeds])
    if dtype == torch.float64:
        js_ = _f64(js_)
    return js_, from_reference(js_, "cpu", dtype)


# ---------------------------------------------------------------------------
# stacking
# ---------------------------------------------------------------------------


def test_stack_unstack_roundtrip_and_init():
    members = [from_reference(_member(s), "cpu") for s in (0, 1, 2)]
    stacked = tde.stack_members(members)
    assert tde.ensemble_size(stacked) == 3 and stacked.uw.weights[0].shape == (3, 50, 24)
    for a, b in zip(tnde.nn_parameters(members[1]), tnde.nn_parameters(tde.unstack_members(stacked)[1])):
        assert torch.equal(a, b)
    # init_ensemble: successive draws of one generator, so the members differ.
    init = tde.init_ensemble(torch.Generator().manual_seed(0), 3, lambda g: twm.FluxNNs(
        *(tmlp.wind_mixing_mlp(g, 8, device="cpu") for _ in range(3))))
    w = tde.unstack_members(init)
    assert not torch.allclose(w[0].uw.weights[0], w[1].uw.weights[0])
    with pytest.raises(ValueError):
        tde.stack_members([])
    with pytest.raises(ValueError):
        tde.init_ensemble(torch.Generator(), 0, None)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_member_packed_call_matches_per_member(dtype):
    """The block-diagonal chain gives each member its own chain's output (float64 ``RTOL``; float32 2e-5 / 2e-6)."""
    members = [from_reference(_member(s, scale=1.0, Nz=32), "cpu", dtype) for s in (80, 81, 82)]
    mp = twm.pack_member_flux_nns(tde.stack_members(members))
    assert mp.n_members == 3
    x = torch.tensor(np.random.default_rng(0).normal(size=(5, 3, 96)), dtype=dtype)
    y = mp(x)
    assert y.shape == (5, 3, 93)
    for m, mem in enumerate(members):
        own = twm.pack_flux_nns(mem)(x[:, m]).detach().numpy()
        if dtype == torch.float64:
            _close(y[:, m], own)
        else:
            np.testing.assert_allclose(y[:, m].detach().numpy(), own, rtol=2e-5, atol=2e-6)


def test_member_chain_refused_by_the_rk4_fused_assembly(suite):
    _, _, _, tmodel, _, tb = suite
    _, ts = _stacked((1, 2))
    packed = twm.pack_member_flux_nns(ts)
    assert twm.resolve_fast_assembly(tmodel, packed, "rk4", "auto") is False
    assert twm.resolve_fast_assembly(tmodel, packed, "split", "auto") == "fold"
    x0 = tb.x0[:, None, :].expand(2, 2, 24)
    with pytest.raises(ValueError, match="3-flux layout"):
        twm.solve_wind_mixing_nde(tmodel, packed, tb.bcs, x0, 0.0, 1e-3, 1, fast_assembly="fold")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_ensemble_matches_solo_training(suite):
    """Adam on the stacked member-sum is K solo runs, in both packages; the port's stacked run equals JAX's."""
    _, jmodel, _, tmodel, jb, tb = suite
    kw = dict(n_substeps=2, method="split", maxiters=3, learning_rate=1e-2)
    js_, ts = _stacked((10, 11))
    jout, jhist = jde.train_wind_mixing_deep_ensemble(jmodel, js_, jb, jnde.NDETrainConfig(**kw))
    tout, thist = tde.train_wind_mixing_deep_ensemble(tmodel, ts, tb, tnde.NDETrainConfig(**kw))
    _leaves_close(tout, jout)
    assert len(thist) == 3
    for th, jh in zip(thist, jhist):
        _close(np.array([th[c] for c in CHANNELS]), np.array([float(getattr(jh, c)) for c in CHANNELS]))
    _, fresh = _stacked((10, 11))  # training updates the stacked tensors in place
    for m, solo_init in enumerate(tde.unstack_members(fresh)):
        solo_init = tck._map_leaves(solo_init, lambda _k, x: x.clone())
        solo, _ = tnde.train_wind_mixing_nde(tmodel, solo_init, tb, tnde.NDETrainConfig(**kw))
        for a, b in zip(tnde.nn_parameters(solo), tnde.nn_parameters(tde.member(tout, m))):
            _close(a, b.detach().numpy())


def test_callback_loss_matches_channel_sum(suite):
    _, _, _, tmodel, _, tb = suite
    _, ts = _stacked((15, 16))
    seen = []
    tde.train_wind_mixing_deep_ensemble(tmodel, ts, tb, tnde.NDETrainConfig(n_substeps=2, method="split",
                                                                            maxiters=2),
                                        callback=lambda i, total, channels, *r: seen.append((total, channels)))
    assert len(seen) == 2
    for total, channels in seen:
        assert total == pytest.approx(float(channels.total()), rel=1e-12)


def test_lbfgs_raises(suite):
    _, _, _, tmodel, _, tb = suite
    _, ts = _stacked((0, 1))
    with pytest.raises(ValueError, match="elementwise"):
        tde.train_wind_mixing_deep_ensemble(tmodel, ts, tb, tnde.NDETrainConfig(optimizer="lbfgs", maxiters=1))


def test_per_member_auto_balance_scalings(suite):
    _, jmodel, _, tmodel, jb, tb = suite
    config = dict(n_substeps=2, method="split", training_fractions=FRACTIONS)
    js_, ts = _stacked((20, 21))
    got = tde.ensemble_loss_scalings(tmodel, ts, tb, tnde.NDETrainConfig(**config))
    want = jde.ensemble_loss_scalings(jmodel, js_, jb, jnde.NDETrainConfig(**config))
    folded = tde.ensemble_loss_scalings(tmodel, ts, tb, tnde.NDETrainConfig(**config), member_fold=True)
    for c in CHANNELS:
        assert getattr(got, c).shape == (2,)
        _close(getattr(got, c), getattr(want, c))
        _close(getattr(folded, c), getattr(want, c))  # the K pre-solves as one folded solve
    ones = tde.ensemble_loss_scalings(tmodel, ts, tb, tnde.NDETrainConfig(method="split"))
    assert ones.T.shape == (2,) and float(ones.dTdz[1]) == pytest.approx(5e-3)


@pytest.mark.parametrize("method", ["split", "rk4"])
def test_member_loop_loss_and_grad_match_jax(suite, method):
    """The port's one-solve-per-member loss against JAX's vmapped one, float64."""
    _, jmodel, _, tmodel, jb, tb = suite
    config = dict(n_substeps=2, method=method, training_fractions=FRACTIONS)
    js_, ts = _stacked((30, 31))
    jconf, tconf = jnde.NDETrainConfig(**config), tnde.NDETrainConfig(**config)
    jfn = jde.make_ensemble_loss_fn(jmodel, jb, jde.ensemble_loss_scalings(jmodel, js_, jb, jconf), jconf)
    tfn = tde.make_ensemble_loss_fn(tmodel, tb, tde.ensemble_loss_scalings(tmodel, ts, tb, tconf), tconf)
    (jt, jch), jg = jax.value_and_grad(jfn, has_aux=True)(js_)
    params = [p.requires_grad_(True) for p in tnde.nn_parameters(ts)]
    tt, tch = tfn(ts)
    grads = torch.autograd.grad(tt, params)
    _close(tt, jt)
    _close(tch.total(), jch.total())
    for g, q in zip(grads, jax.tree.leaves(jg)):
        _close(g, q)


def _shooting_batch(batch):
    """A 2-window shooting-style batch from a plain one: rows (sim, window), per-row absolute t0."""
    S, Nt = batch.targets.shape[0], batch.t.shape[0]
    half = Nt // 2
    full = lambda v: torch.full((S,), float(v), dtype=batch.t.dtype)  # noqa: E731
    bcs = dataclasses.replace(batch.bcs, **{f.name: torch.cat([getattr(batch.bcs, f.name)] * 2)
                                            for f in dataclasses.fields(batch.bcs)})
    return dataclasses.replace(
        batch, x0=torch.cat([batch.targets[:, 0, :], batch.targets[:, half, :]]),
        targets=torch.cat([batch.targets[:, : half + 1, :], batch.targets[:, half:, :]]), t=batch.t[: half + 1],
        t0=torch.cat([full(batch.t[0]), full(batch.t[half])]), bcs=bcs)


def _shooting_batch_jax(batch):
    """:func:`_shooting_batch` for the JAX package's batch (``tests/test_deep_ensemble.py``'s construction)."""
    S, Nt = batch.targets.shape[0], batch.t.shape[0]
    half = Nt // 2
    return dataclasses.replace(
        batch, x0=jnp.concatenate([batch.targets[:, 0, :], batch.targets[:, half, :]]),
        targets=jnp.concatenate([batch.targets[:, : half + 1, :], batch.targets[:, half:, :]]), t=batch.t[: half + 1],
        t0=jnp.concatenate([jnp.full((S,), batch.t[0]), jnp.full((S,), batch.t[half])]),
        bcs=jax.tree.map(lambda a: jnp.concatenate([a, a]) if getattr(a, "ndim", 0) else a, batch.bcs))


@pytest.fixture(scope="module")
def suite32(suite):
    """The suite's model and batch in float32, for the float32 fold case."""
    _, model, tds, _, _, _ = suite
    tmodel = from_reference(model, "cpu", torch.float32)
    tds = tc.ColumnTimeSeries(**{f.name: None if getattr(tds, f.name) is None else getattr(tds, f.name).float()
                                 for f in dataclasses.fields(tc.ColumnTimeSeries)})
    return tmodel, tc.training_tensors(tds, tmodel.scalings, np.arange(0, 7), tau=tmodel.tau)


FOLD_CASES = [("split", "auto", False), ("split", False, False), ("rk4", False, False), ("split", "auto", True)]
FOLD_IDS = ["split-fold", "split-stencil", "rk4-stencil", "split-fold-shooting"]


def _fold_and_loop(tmodel, tb, ts, config):
    """``(total, channel total, grads)`` of the member loop and of the member fold, on the loop's loss weights."""
    scalings = tde.ensemble_loss_scalings(tmodel, ts, tb, config)
    params = [p.requires_grad_(True) for p in tnde.nn_parameters(ts)]
    results = []
    for make in (tde.make_ensemble_loss_fn, tde.make_folded_ensemble_loss_fn):
        total, channels = make(tmodel, tb, scalings, config)(ts)
        results.append((float(total.detach()), float(channels.total().detach()),
                        torch.autograd.grad(total, params)))
    return results


@pytest.mark.parametrize("method,fast,shooting", FOLD_CASES, ids=FOLD_IDS)
def test_folded_loss_and_grad_match_vmapped(suite, method, fast, shooting):
    """The member fold at S = M = 2, float64: against JAX's folded loss and gradient, and against the member loop.

    Both at ``RTOL``, on a plain batch and on a 2-window shooting batch.
    """
    _, jmodel, _, tmodel, jb, tb = suite
    if shooting:
        tb, jb = _shooting_batch(tb), _shooting_batch_jax(jb)
    assert tb.x0.shape[0] == 2 * (1 + shooting)
    config = dict(n_substeps=2, method=method, fast_assembly=fast, training_fractions=FRACTIONS)
    js_, ts = _stacked((85, 86))
    (t_ref, ch_ref, g_ref), (t_f, ch_f, g_f) = _fold_and_loop(tmodel, tb, ts, tnde.NDETrainConfig(**config))
    jconf = jnde.NDETrainConfig(**config)
    jfn = jde.make_folded_ensemble_loss_fn(jmodel, jb, jde.ensemble_loss_scalings(jmodel, js_, jb, jconf), jconf)
    (jt, jch), jg = jax.value_and_grad(jfn, has_aux=True)(js_)
    _close(t_f, jt)
    _close(ch_f, jch.total())
    _close(t_f, t_ref)
    _close(ch_f, ch_ref)
    for a, b, q in zip(g_f, g_ref, jax.tree.leaves(jg)):
        _close(a, q)
        _close(a, b.numpy())


@pytest.mark.parametrize("method,fast,shooting", FOLD_CASES, ids=FOLD_IDS)
def test_folded_loss_and_grad_match_vmapped_f32(suite32, method, fast, shooting):
    """The member fold against the member loop in float32 at JAX's own limits: loss 1e-5, gradients 5e-4 / 1e-7."""
    tmodel, tb = suite32
    if shooting:
        tb = _shooting_batch(tb)
    config = tnde.NDETrainConfig(n_substeps=2, method=method, fast_assembly=fast, training_fractions=FRACTIONS)
    _, ts = _stacked((85, 86), dtype=torch.float32)
    assert ts.uw.weights[0].dtype == torch.float32 and tb.x0.dtype == torch.float32
    (t_ref, ch_ref, g_ref), (t_f, ch_f, g_f) = _fold_and_loop(tmodel, tb, ts, config)
    np.testing.assert_allclose(t_f, t_ref, rtol=1e-5)
    np.testing.assert_allclose(ch_f, ch_ref, rtol=1e-5)
    for a, b in zip(g_f, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=1e-7)


def test_folded_training_runs_and_saves(suite, tmp_path):
    """member_fold=True trains through the curriculum and checkpoints like the member loop."""
    _, _, _, tmodel, _, tb = suite
    _, ts = _stacked((40, 41))
    _, ts2 = _stacked((40, 41))
    kw = dict(n_substeps=2, method="split", maxiters=2, learning_rate=1e-2)
    folded, fh = tde.train_wind_mixing_deep_ensemble(tmodel, ts, tb, tnde.NDETrainConfig(**kw), member_fold=True,
                                                     checkpoint_dir=str(tmp_path))
    looped, lh = tde.train_wind_mixing_deep_ensemble(tmodel, ts2, tb, tnde.NDETrainConfig(**kw))
    for a, b in zip(tnde.nn_parameters(folded), tnde.nn_parameters(looped)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-9, atol=1e-12)
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["ensemble"] == 2


def test_curriculum_checkpoint_resume_cross_packages(suite, tmp_path):
    """Two curriculum stages with checkpoints in both packages; each resumes the other's stacked train state."""
    _, jmodel, _, tmodel, jb, tb = suite
    js_, ts = _stacked((50, 51))
    config = dict(n_substeps=2, method="split", learning_rate=1e-2)

    def stages(mod):
        return [mod.CurriculumStage(tsteps=np.arange(4), maxiters=2), mod.CurriculumStage(tsteps=np.arange(7),
                                                                                          maxiters=2)]

    def jbatch(tsteps):
        return dataclasses.replace(jb, targets=jb.targets[:, np.asarray(tsteps)], t=jb.t[np.asarray(tsteps)])

    def tbatch(tsteps):
        idx = torch.as_tensor(np.asarray(tsteps))
        return dataclasses.replace(tb, targets=tb.targets[:, idx], t=tb.t[idx])

    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jout, jhist = jde.train_wind_mixing_deep_ensemble(jmodel, js_, jb, jnde.NDETrainConfig(**config),
                                                      stages=stages(jnde), full_batch_fn=jbatch, checkpoint_dir=jdir)
    tout, thist = tde.train_wind_mixing_deep_ensemble(tmodel, ts, tb, tnde.NDETrainConfig(**config),
                                                      stages=stages(tnde), full_batch_fn=tbatch, checkpoint_dir=tdir)
    assert len(thist) == 4
    _leaves_close(tout, jout)
    with np.load(os.path.join(jdir, "state.npz")) as j, np.load(os.path.join(tdir, "state.npz")) as t:
        assert sorted(j.files) == sorted(t.files)
        assert int(t["['opt_state']/[0]/.count"]) == 4
        for key in j.files:
            _close(t[key], j[key])
    # Each package resumes the other's stacked train state and takes the same steps.
    more = dict(config, maxiters=2)
    jres, _ = jde.train_wind_mixing_deep_ensemble(jmodel, js_, jb, jnde.NDETrainConfig(**more), resume_from=tdir)
    tres, _ = tde.train_wind_mixing_deep_ensemble(tmodel, ts, tb, tnde.NDETrainConfig(**more), resume_from=jdir)
    assert tde.ensemble_size(tres) == 2
    _leaves_close(tres, jres)


# ---------------------------------------------------------------------------
# flux regression and free convection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causality", ["none", "soft", "hard"])
def test_train_flux_nn_ensemble_matches_jax(causality):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 8))
    ys = rng.normal(size=(3, 40, 9)) * 0.1
    members = [jmlp.free_convection_mlp(jax.random.PRNGKey(s), 8) for s in (1, 2, 3)]
    js_ = _f64(jde.stack_members(members))
    ts = from_reference(js_, "cpu", torch.float64)
    kw = dict(learning_rate=1e-2, epochs=4, gradient_scaling=0.1, dz_hat=1.0 / 8, causality=causality)
    jout, jh = jnn.train_flux_nn_ensemble(js_, jnp.asarray(x), jnp.asarray(ys), **kw)
    tout, th = tnn.train_flux_nn_ensemble(ts, torch.tensor(x), torch.tensor(ys), **kw)
    _close(np.array(th), np.asarray(jh))
    _leaves_close(tout, jout)
    # Member 1 of the stack is its solo run.
    solo, sh = tnn.train_flux_nn(tde.member(ts, 1), torch.tensor(x), torch.tensor(ys[1]), **kw)
    _close(np.array(sh), np.array(th[1]))
    if causality == "hard":
        for W in tout.weights:
            assert not bool(W[:, tmlp.spatial_causality_mask(W.shape[1:])].any())


@pytest.fixture(scope="module")
def fc_setup():
    from climateparameterizations_jl_tpu.core.scalings import ZeroMeanUnitVarianceScaling
    from climateparameterizations_jl_tpu.models.free_convection import FreeConvectionModel

    les = js.synthetic_free_convection_les(Nz=16, n_save=8, dt_save=600.0, dtype=jnp.float64)
    coarse = jc.coarsen_dataset(les, 8)
    T_scaling = ZeroMeanUnitVarianceScaling.fit(coarse.T)
    wT_scaling = ZeroMeanUnitVarianceScaling.fit(coarse.wT)
    model = _f64(FreeConvectionModel(
        H=coarse.H, tau=jnp.abs(coarse.t[-1] - coarse.t[0]), T_scaling=T_scaling, wT_scaling=wT_scaling,
        bottom_flux=wT_scaling.scale(jnp.float64(0.0)), top_flux=wT_scaling.scale(coarse.theta_top), Nz=8))
    tsteps = np.arange(0, 6)
    targets = T_scaling.scale(coarse.T)[None, tsteps]
    t = (coarse.t[tsteps] - coarse.t[0]) / model.tau
    return model, coarse, targets[:, 0], targets, t


def test_fc_ensemble_hard_projection_matches_jax(fc_setup):
    model, _, T0, targets, t = fc_setup
    members = [jmlp.apply_spatial_causality_mask(jmlp.free_convection_mlp(jax.random.PRNGKey(s), 8))
               for s in (72, 73)]
    js_ = _f64(jde.stack_members(members))
    ts = from_reference(js_, "cpu", torch.float64)
    tmodel = from_reference(model, "cpu", torch.float64)
    kw = dict(learning_rate=1e-2, maxiters=3, n_substeps=2, method="split")
    jout, jhist = jde.train_free_convection_deep_ensemble(model, js_, T0, targets, t, jnde.NDETrainConfig(**kw),
                                                          project=jmlp.apply_spatial_causality_mask)
    tout, thist = tde.train_free_convection_deep_ensemble(
        tmodel, ts, torch.tensor(np.asarray(T0)), torch.tensor(np.asarray(targets)), torch.tensor(np.asarray(t)),
        tnde.NDETrainConfig(**kw), project=tmlp.apply_spatial_causality_mask_)
    _leaves_close(tout, jout)
    _close(np.array([h["T"] for h in thist]), np.array([float(h.T) for h in jhist]))
    for m in tde.unstack_members(tout):
        for W in m.weights:
            assert not bool(W[tmlp.spatial_causality_mask(W.shape)].any())


def test_fc_ensemble_uq_matches_jax(fc_setup):
    model, coarse, _, _, _ = fc_setup
    js_ = _f64(jde.stack_members([jmlp.free_convection_mlp(jax.random.PRNGKey(s), 8) for s in (74, 75, 76)]))
    want = juq.fc_ensemble_uq(model, js_, coarse, np.arange(0, 6), n_substeps=2)
    got = tuq.fc_ensemble_uq(from_reference(model, "cpu", torch.float64), from_reference(js_, "cpu", torch.float64),
                             _to_torch(coarse), np.arange(0, 6), n_substeps=2)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    assert float(got["ensemble_T_std"].max()) > 0
    assert np.all(got["losses_ensemble_mean_T"] <= got["losses_member_T"].mean(axis=0) * (1 + 1e-5) + 1e-10)


def test_nde_ensemble_uq_matches_jax(suite):
    """One member-folded solve against JAX's vmapped solves; Jensen; identical members have zero spread."""
    ds, jmodel, tds, tmodel, _, _ = suite
    one_j = jax.tree.map(lambda a: a[1:2], ds)  # a stacked suite of one
    one_t = _to_torch(one_j)
    js_, ts = _stacked((60, 61, 62), scale=1.0)
    for solver in ("split", "rk4"):
        want = juq.nde_ensemble_uq(jmodel, js_, one_j, np.arange(0, 12, 2), solver=solver, n_substeps=4)
        got = tuq.nde_ensemble_uq(tmodel, ts, one_t, np.arange(0, 12, 2), solver=solver, n_substeps=4)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    assert got["ensemble_T_mean"].shape == (6, 8) and got["losses_member_T"].shape == (3, 6)
    assert int(got["n_members"]) == 3 and float(got["ensemble_T_std"].max()) > 0
    assert np.all(got["losses_ensemble_mean_T"] <= got["losses_member_T"].mean(axis=0) * (1 + 1e-5) + 1e-10)
    same = tde.stack_members([tde.member(ts, 0)] * 2)
    uq = tuq.nde_ensemble_uq(tmodel, same, one_t, np.arange(0, 12, 2), n_substeps=4)
    np.testing.assert_allclose(uq["ensemble_T_std"], 0.0, atol=1e-12)
    np.testing.assert_allclose(uq["losses_ensemble_mean_T"], uq["losses_member_T"][0], rtol=1e-12)
    with pytest.raises(ValueError, match="ONE held-out"):
        tuq.nde_ensemble_uq(tmodel, ts, tds, np.arange(0, 12, 2))
