"""Port parity: the rk4 fast assembly (``solve_wind_mixing_nde(fast_assembly=True/"fold")``).

Mirrors ``tests/test_fused_rhs.py::TestFastRK4``, the rk4 cases of
``::TestFoldDivergence`` and ``::TestAutoFastAssembly``: each case runs the
port and its JAX twin on the same inputs (the JAX package's flagship model
with the trained ``runs/wm_flagship_fold`` MLPs, carried over through numpy;
states from a numpy seed), on the CPU.

Tolerances are the JAX tests' own, for both comparisons a case makes: the
port's fast path against the port's default path, and the port against JAX
(the same f32 operations summed in other orders): trajectories
``rtol=1e-5, atol=1e-7``; gradients ``rtol=1e-4, atol=1e-6 max(1, max|g|)``;
f64 trajectories ``rtol=1e-12, atol=1e-14`` (the fold is exact linear
algebra there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.models import timestepper as jts
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.train import nde as jnde
from climateparameterizations_jl_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.models import timestepper as tts
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm
from climateparameterizations_jl_tpu_torch.train import nde as tnde

RUN = (0.0, 1e-4, 3)  # t0, dt_save, n_save; 4 substeps per save
TRAJ = dict(rtol=1e-5, atol=1e-7)


def _setup(n_columns=4, dtype=np.float32):
    model, _, bcs, _ = graft._make_setup(Nz=32, n_columns=1)
    skeleton = jwm.FluxNNs(*[jmlp.wind_mixing_mlp(k, 32) for k in jax.random.split(jax.random.PRNGKey(0), 3)])
    nns, _ = j_load_checkpoint("runs/wm_flagship_fold", skeleton)
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)  # noqa: E731
    model, nns, bcs = cast(model), cast(nns), cast(bcs)
    x0 = (np.random.default_rng(n_columns).normal(size=(n_columns, 96)) * 0.1).astype(dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    port = tuple(from_reference(o, "cpu", tdtype) for o in (model, nns, bcs)) + (torch.tensor(x0),)
    return (model, nns, bcs, jnp.asarray(x0)), port


def _with(pair, **model_changes):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = pair
    return (dataclasses.replace(jm, **model_changes), jn, jb, jx), (dataclasses.replace(tm, **model_changes), tn, tb, tx)


def _with_bcs(pair, **fields):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = pair
    jb = dataclasses.replace(jb, **{k: jnp.asarray(v, jx.dtype) for k, v in fields.items()})
    tb = dataclasses.replace(tb, **{k: torch.tensor(v, dtype=tx.dtype) for k, v in fields.items()})
    return (jm, jn, jb, jx), (tm, tn, tb, tx)


def _solve_both(pair, fast, run=RUN, n_substeps=4):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = pair
    j = np.asarray(jwm.solve_wind_mixing_nde(jm, jn, jb, jx, *run, n_substeps=n_substeps, fast_assembly=fast))
    with torch.no_grad():
        t = twm.solve_wind_mixing_nde(tm, tn, tb, tx, *run, n_substeps=n_substeps, fast_assembly=fast).numpy()
    return j, t


def _batched_diurnal(n_columns=5):
    rng = np.random.default_rng(7)
    pair = _with(_setup(n_columns), diurnal=True)
    return _with_bcs(pair, uw_top=rng.normal(size=n_columns) * 0.3, wT_bot=rng.normal(size=n_columns) * 0.1,
                     diurnal_amplitude=np.abs(rng.normal(size=n_columns)) * 2e-5)


@pytest.mark.parametrize("fast", [True, "fold"])
@pytest.mark.parametrize("case", ["default", "batched_bcs_and_diurnal"])
def test_matches_default_path(case, fast):
    """``TestFastRK4::test_matches_default_path`` / ``::test_batched_bcs_and_diurnal`` and
    ``TestFoldDivergence::test_rk4_fold_matches_default`` / ``::test_rk4_fold_batched_bcs_and_diurnal``."""
    pair = _setup(6) if case == "default" else _batched_diurnal(5)
    j_fast, t_fast = _solve_both(pair, fast)
    _, t_default = _solve_both(pair, False)
    np.testing.assert_allclose(t_fast, t_default, **TRAJ)
    np.testing.assert_allclose(t_fast, j_fast, **TRAJ)
    assert float(np.abs(t_fast[-1] - t_fast[0]).max()) > 1e-4


@pytest.mark.parametrize("fast", [True, "fold"])
def test_gradients_match(fast):
    """``TestFastRK4::test_gradients_match`` and the rk4 half of
    ``TestFoldDivergence::test_gradients_match_both_solvers``, against JAX's gradients too."""
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup(4)

    def jloss(nns, fa):
        return jnp.sum(jwm.solve_wind_mixing_nde(jm, nns, jb, jx, 0.0, 1e-4, 2, n_substeps=3, fast_assembly=fa)[-1] ** 2)

    j_grads = [p for m in jax.grad(lambda p: jloss(p, fast))(jn) for p in (*m.weights, *m.biases)]
    port = {}
    for fa in (fast, False):
        nns = twm.FluxNNs(*[dataclasses.replace(m, weights=tuple(w.clone().requires_grad_(True) for w in m.weights),
                                                biases=tuple(b.clone().requires_grad_(True) for b in m.biases))
                            for m in tn])
        leaves = [p for m in nns for p in (*m.weights, *m.biases)]
        loss = torch.sum(twm.solve_wind_mixing_nde(tm, nns, tb, tx, 0.0, 1e-4, 2, n_substeps=3, fast_assembly=fa)[-1] ** 2)
        port[fa] = torch.autograd.grad(loss, leaves)
    for gf, gd, gj in zip(port[fast], port[False], j_grads):
        gd, gj = gd.numpy(), np.asarray(gj)
        np.testing.assert_allclose(gf.numpy(), gd, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(gd).max())))
        np.testing.assert_allclose(gf.numpy(), gj, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(gj).max())))


@pytest.mark.parametrize("fast", [True, "fold"])
def test_f64_full_precision(fast):
    """``TestFastRK4::test_f64_full_precision`` / ``TestFoldDivergence::test_f64_full_precision``."""
    pair = _setup(4, dtype=np.float64)
    j_fast, t_fast = _solve_both(pair, fast)
    j_default, t_default = _solve_both(pair, False)
    assert t_fast.dtype == np.float64 and j_fast.dtype == np.float64
    np.testing.assert_allclose(t_fast, t_default, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(t_fast, j_fast, rtol=1e-12, atol=1e-14)


def _two_layer_pair(seed=0, **kw):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    j = jwm.FluxNNs(*(jmlp.wind_mixing_mlp(k, Nz=32, **kw) for k in keys))
    return j, from_reference(j, "cpu")


@pytest.mark.parametrize("case", ["euler", "heun", "wrong_depth", "non_mpp", "unknown_value"])
def test_rejected_like_jax(case):
    """``TestFastRK4::test_non_rk4_methods_rejected``, ``::test_wrong_depth_rejected``,
    ``::test_non_mpp_rejected`` and ``::test_fold_rejects_unknown_value``: the same error, same message."""
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup(2)
    kw, match = dict(fast_assembly=True), "fast_assembly"
    if case in ("euler", "heun"):
        kw["method"] = case
    elif case == "wrong_depth":
        jn, tn = _two_layer_pair(hidden=(16,))
        match = "3-layer"
    elif case == "non_mpp":
        (jm, jn, jb, jx), (tm, tn, tb, tx) = _with(((jm, jn, jb, jx), (tm, tn, tb, tx)),
                                                   use_mpp=False, use_conv_adj=True)
        match = "mPP"
    else:
        kw["fast_assembly"] = "folded"
    with pytest.raises(ValueError, match=match):
        jwm.solve_wind_mixing_nde(jm, jn, jb, jx, 0.0, 1e-4, 1, **kw)
    with pytest.raises(ValueError, match=match):
        twm.solve_wind_mixing_nde(tm, tn, tb, tx, 0.0, 1e-4, 1, **kw)
    if case == "unknown_value":
        with pytest.raises(ValueError, match="fast_assembly"):
            twm.solve_wind_mixing_split(tm, tn, tb, tx, 0.0, 1e-3, 1, fast_assembly="folded")


def test_smoothing_rejected_like_jax():
    pair = _setup(2)
    for change in (dict(smooth_NN=True), dict(smooth_Ri=True)):
        (jm, jn, jb, jx), (tm, tn, tb, tx) = _with(pair, **change)
        with pytest.raises(ValueError, match="smoothing"):
            jwm.solve_wind_mixing_nde(jm, jn, jb, jx, 0.0, 1e-4, 1, fast_assembly=True)
        with pytest.raises(ValueError, match="smoothing"):
            twm.solve_wind_mixing_nde(tm, tn, tb, tx, 0.0, 1e-4, 1, fast_assembly=True)


def test_checkpointed_solve_matches_plain_solve():
    """The port's stand-in for ``TestFastRK4::test_builds_inside_jit``: the solve that training runs
    (autograd on, each save interval recomputed in the backward pass) gives the forward solve's values."""
    (_, _, _, _), (tm, tn, tb, tx) = _setup(3)
    x = tx.clone().requires_grad_(True)
    out = twm.solve_wind_mixing_nde(tm, tn, tb, x, 0.0, 1e-4, 2, n_substeps=2, fast_assembly=True)
    out.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    with torch.no_grad():
        ref = twm.solve_wind_mixing_nde(tm, tn, tb, tx, 0.0, 1e-4, 2, n_substeps=2, fast_assembly=False)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), **TRAJ)


# --- TestAutoFastAssembly ----------------------------------------------------


def _resolved(model_pair, nns_pair, method):
    (jm, tm), (jn, tn) = model_pair, nns_pair
    j = jwm.resolve_fast_assembly(jm, jn, method, "auto")
    t = twm.resolve_fast_assembly(tm, tn, method, "auto")
    assert t == j
    return t


@pytest.mark.parametrize("case,method,expected", [
    ("base", "split", "fold"), ("base", "rk4", "fold"), ("base", "euler", False),
    ("smooth_NN", "split", False), ("smooth_NN", "rk4", False),
    ("conv_adj", "rk4", False), ("conv_adj", "split", "fold"),
    ("smooth_Ri", "rk4", False), ("smooth_Ri", "split", "fold"),
    ("tanh", "rk4", False), ("tanh", "split", "fold"),
    ("two_layer", "rk4", False), ("two_layer", "split", "fold"),
])
def test_auto_resolution_matches_jax(case, method, expected):
    """``TestAutoFastAssembly::test_resolves_to_fold_when_supported`` and
    ``::test_falls_back_on_unsupported_configs``, each case against JAX's answer."""
    (jm, jn, _, _), (tm, tn, _, _) = _setup(2)
    changes = dict(smooth_NN=dict(smooth_NN=True), conv_adj=dict(use_mpp=False, use_conv_adj=True),
                   smooth_Ri=dict(smooth_Ri=True)).get(case, {})
    jm, tm = dataclasses.replace(jm, **changes), dataclasses.replace(tm, **changes)
    if case == "tanh":
        jn, tn = _two_layer_pair(seed=1, activation="tanh")
    elif case == "two_layer":
        jn, tn = _two_layer_pair(hidden=(16,))
    got = _resolved((jm, tm), (jn, tn), method)
    assert got == expected and type(got) is type(expected)


def test_explicit_values_pass_through():
    (jm, jn, _, _), (tm, tn, _, _) = _setup(2)
    for method in ("split", "rk4"):
        for v in (False, True, "fold"):
            assert twm.resolve_fast_assembly(tm, tn, method, v) == v == jwm.resolve_fast_assembly(jm, jn, method, v)


@pytest.mark.parametrize("method", ["split", "rk4"])
def test_train_config_auto_runs_everywhere(method):
    """``TestAutoFastAssembly::test_train_config_auto_runs_everywhere`` (and its rk4 twin): the
    config default solves supported and unsupported configurations, and the fold matches the
    default path and JAX."""
    pair = _setup(3)
    (jm, jn, jb, jx), (tm, tn, tb, tx) = pair
    run = (0.0, 1e-3 if method == "split" else 1e-4, 2)
    tcfg, jcfg = tnde.NDETrainConfig(method=method, n_substeps=2), jnde.NDETrainConfig(method=method, n_substeps=2)
    assert tcfg.fast_assembly == "auto"
    with torch.no_grad():
        t_fold = tnde.solve_with_config(tm, tn, tb, tx, *run, tcfg).numpy()
        t_ref = tnde.solve_with_config(tm, tn, tb, tx, *run, dataclasses.replace(tcfg, fast_assembly=False)).numpy()
        smooth = dataclasses.replace(tm, smooth_NN=True)
        assert np.all(np.isfinite(tnde.solve_with_config(smooth, tn, tb, tx, *run, tcfg).numpy()))
    np.testing.assert_allclose(t_fold, t_ref, **TRAJ)
    np.testing.assert_allclose(t_fold, np.asarray(jnde.solve_with_config(jm, jn, jb, jx, *run, jcfg)), **TRAJ)


def test_auto_default_trains_unsupported_rk4_configs():
    """``TestAutoFastAssembly::test_auto_default_trains_unsupported_rk4_configs``."""
    (jm, _, jb, jx), (tm, _, tb, tx) = _setup(3)
    jtanh, ttanh = _two_layer_pair(seed=2, activation="tanh")
    cfg = dict(method="rk4", n_substeps=2)
    with torch.no_grad():
        out = tnde.solve_with_config(tm, ttanh, tb, tx, 0.0, 1e-4, 2, tnde.NDETrainConfig(**cfg))
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jnde.solve_with_config(jm, jtanh, jb, jx, 0.0, 1e-4, 2, jnde.NDETrainConfig(**cfg))),
        **TRAJ)
    j2, t2 = _two_layer_pair(seed=2, hidden=(16,))
    split = dict(method="split", n_substeps=2)
    with torch.no_grad():
        fold = tnde.solve_with_config(tm, t2, tb, tx, 0.0, 1e-3, 2, tnde.NDETrainConfig(**split)).numpy()
        ref = tnde.solve_with_config(tm, t2, tb, tx, 0.0, 1e-3, 2,
                                     tnde.NDETrainConfig(**split, fast_assembly=False)).numpy()
    np.testing.assert_allclose(fold, ref, **TRAJ)


@pytest.mark.parametrize("method,fast", [("rk4", "fold"), ("rk4", False)])
def test_nde_train_step_matches_jax(method, fast):
    """The training entry point of the slice (``benchmarks.nde_train_step_setup``, the inputs of
    ``bench_nde_train_step``) at 2 sims x 3 saves: one step's loss and gradient against the JAX
    benchmark's ``loss_fn`` on the same inputs, with JAX's random MLPs carried over."""
    from climateparameterizations_jl_tpu.data.containers import TrainingBatch
    from climateparameterizations_jl_tpu.train.loss import LossChannels
    from climateparameterizations_jl_tpu_torch import benchmarks

    n_sims, n_window = 2, 3
    model, nns, _, _ = graft._make_setup(Nz=32, n_columns=1)
    x0 = jnp.asarray(np.random.default_rng(0).normal(size=(n_sims, 96)) * 0.1, jnp.float32)
    zeros = jnp.zeros((n_sims,), jnp.float32)
    bcs = jwm.BoundaryConditions(uw_bot=zeros, uw_top=zeros - 0.5, vw_bot=zeros, vw_top=zeros, wT_bot=zeros,
                                 wT_top=zeros + 0.3, diurnal_amplitude=zeros)
    batch = TrainingBatch(x0=x0, targets=jnp.repeat(x0[:, None, :], n_window, axis=1), bcs=bcs,
                          t=jnp.linspace(0.0, 1e-3 * (n_window - 1), n_window, dtype=jnp.float32),
                          tau=jnp.float32(691200.0))
    config = jnde.NDETrainConfig(n_substeps=4, method=method, fast_assembly=fast)
    loss_fn = jnde.make_wind_mixing_loss_fn(model, batch, LossChannels.ones(config.gradient_scaling), config)
    (j_loss, _), j_grad = jax.value_and_grad(loss_fn, has_aux=True)(nns)
    setup = benchmarks.nde_train_step_setup(n_sims, 32, n_window, method, fast, nns=from_reference(nns, "cpu"),
                                            device="cpu")
    t_loss, t_grad = benchmarks.train_step_loss_and_grad(setup)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    j_flat = np.concatenate([np.asarray(p).reshape(-1) for m in j_grad for p in (*m.weights, *m.biases)])
    np.testing.assert_allclose(t_grad.numpy(), j_flat, rtol=1e-4, atol=1e-6 * max(1.0, float(np.abs(j_flat).max())))


@pytest.mark.parametrize("args", [(1e-2, 1e-3, 1 / 32), (0.0, 1e-3, 1 / 32), (3e-4, 0.5, 1 / 16), (5.0, 1e-7, 1.0)])
def test_stable_substeps_matches_jax(args):
    assert tts.stable_substeps(*args) == jts.stable_substeps(*args)
    assert tts.stable_substeps(*args, safety=0.25) == jts.stable_substeps(*args, safety=0.25)
