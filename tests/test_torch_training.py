"""Port parity: the NDE loss, the loss-scaling pre-solve and adam steps.

A tiny split problem (3 synthetic sims at 16 LES levels, coarsened to
Nz = 8, 4 save intervals of 3 substeps) goes through the JAX package's
``train/`` with optax and the port's ``train/`` with ``torch.optim``, in
float64 on both sides (the JAX tests run with x64): the same operations in
the same order, so losses, gradients and parameters agree to ``rtol=1e-9``
(the adam update divides by ``sqrt(nu) + eps``, which can amplify a
gradient's last-digit difference; measured agreement is ~1e-12).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.data import synthetic as js
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.physics.mpp import MPPParameters as JMPP
from climateparameterizations_jl_tpu.train import loss as jloss
from climateparameterizations_jl_tpu.train import nde as jnde
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.ops import tridiagonal as ttri
from climateparameterizations_jl_tpu_torch.train import loss as tloss
from climateparameterizations_jl_tpu_torch.train import nde as tnde

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
CHANNELS = ("u", "v", "T", "dudz", "dvdz", "dTdz")
FRACTIONS = {"T": 0.8, "dTdz": 0.8, "profile": 0.5}


def _close(got, want, rtol=1e-9):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * max(float(np.abs(want).max()), 1e-30))


def _channels_close(t, j, rtol=1e-12):
    for c in CHANNELS:
        _close(getattr(t, c), getattr(j, c), rtol)


@pytest.mark.parametrize("train_gradient", [True, False])
def test_loss_channels_and_scalings_match_jax(train_gradient):
    rng = np.random.default_rng(0)
    pred, target = rng.normal(size=(2, 3, 5, 24)), rng.normal(size=(3, 5, 24))
    pred[0][..., :16] = target[..., :16]  # u = v = 0 signal: the safe-division branch
    for p in pred:
        jch = jloss.nde_loss_channels(jnp.asarray(p), jnp.asarray(target), 8, train_gradient)
        tch = tloss.nde_loss_channels(torch.tensor(p), torch.tensor(target), 8, train_gradient)
        _channels_close(tch, jch)
        jsc = jloss.calculate_loss_scalings(jch, FRACTIONS, train_gradient)
        tsc = tloss.calculate_loss_scalings(tch, FRACTIONS, train_gradient)
        _channels_close(tsc, jsc)
        _channels_close(tloss.apply_loss_scalings(tch, tsc), jloss.apply_loss_scalings(jch, jsc))
        _close(tloss.apply_loss_scalings(tch, tsc).total(), jloss.apply_loss_scalings(jch, jsc).total(), 1e-12)
    _close(tloss.loss_per_timestep(torch.tensor(pred[1]), torch.tensor(target)),
           jloss.loss_per_timestep(jnp.asarray(pred[1]), jnp.asarray(target)), 1e-12)
    ones = tloss.LossChannels.ones(5e-3)
    assert ones.as_floats() == pytest.approx(dict(u=1, v=1, T=1, dudz=5e-3, dvdz=5e-3, dTdz=5e-3))


def _problem():
    """(JAX (model, nns, batch), port (model, nns, batch)) for the tiny split problem, f64."""
    kw = dict(Nz=16, n_save=12, dtype=jnp.float64, mpp=JMPP.default(jnp.float64))
    sims = [js.synthetic_wind_mixing_les(Qu=Qu, Qb=Qb, **kw) for Qu, Qb in ((-5e-4, 3e-8), (-2e-4, -1e-8), (-3.5e-4, 2e-8))]
    ds = jc.stack_datasets([jc.enforce_surface_fluxes(jc.coarsen_dataset(d, 8)) for d in sims])
    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
    model = f64(jcli._wind_model(ds, 8))
    nns = f64(jwm.FluxNNs(*[jmlp.wind_mixing_mlp(k, 8, scale=0.3) for k in jax.random.split(jax.random.PRNGKey(4), 3)]))
    batch = jc.training_tensors(ds, model.scalings, np.arange(0, 13, 3), tau=model.tau)
    tbatch = tc.TrainingBatch(
        x0=torch.tensor(np.asarray(batch.x0)), targets=torch.tensor(np.asarray(batch.targets)),
        bcs=from_reference(batch.bcs, "cpu", torch.float64), t=torch.tensor(np.asarray(batch.t)),
        tau=torch.tensor(np.asarray(batch.tau)),
    )
    port = (from_reference(model, "cpu", torch.float64), from_reference(nns, "cpu", torch.float64), tbatch)
    return (model, nns, batch), port


CONFIG = dict(learning_rate=1e-2, n_substeps=3, method="split", training_fractions=FRACTIONS)


def test_determine_loss_scalings_matches_jax():
    (jm, jn, jb), (tm, tn, tb) = _problem()
    for fractions in (FRACTIONS, None):
        kw = dict(CONFIG, training_fractions=fractions)
        _channels_close(tnde.determine_loss_scalings(tm, tn, tb, tnde.NDETrainConfig(**kw)),
                        jnde.determine_loss_scalings(jm, jn, jb, jnde.NDETrainConfig(**kw)), rtol=1e-9)


def test_two_adam_steps_match_optax():
    (jm, jn, jb), (tm, tn, tb) = _problem()
    jconfig, tconfig = jnde.NDETrainConfig(**CONFIG), tnde.NDETrainConfig(**CONFIG)
    jscal = jnde.determine_loss_scalings(jm, jn, jb, jconfig)
    tscal = tnde.determine_loss_scalings(tm, tn, tb, tconfig)
    jfn = jnde.make_wind_mixing_loss_fn(jm, jb, jscal, jconfig)
    tfn = tnde.make_wind_mixing_loss_fn(tm, tb, tscal, tconfig)

    opt = optax.adam(CONFIG["learning_rate"])
    state = opt.init(jn)
    jparams, jlosses, jgrads = jn, [], []
    for _ in range(2):
        (total, _), g = jax.value_and_grad(jfn, has_aux=True)(jparams)
        updates, state = opt.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jlosses.append(float(total))
        jgrads.append(g)

    # The first step's gradient, then two steps of the port's loop.
    optimizer = tnde._make_optimizer(tconfig, tn)
    total, _ = tfn(tn)
    total.backward()
    leaves = tnde.nn_parameters(tn)
    for p, g in zip(leaves, tnde.nn_parameters(jgrads[0])):
        _close(p.grad, g)
    optimizer.zero_grad()
    _, history, _ = tnde._train_loop(tfn, tn, optimizer, 2)
    np.testing.assert_allclose([sum(h.values()) for h in history], jlosses, rtol=1e-9)
    assert jlosses[1] != jlosses[0]
    for p, q in zip(leaves, tnde.nn_parameters(jparams)):
        _close(p, q)


def test_solves_per_step():
    """Per substep: one solve forward, one in the checkpoint recompute, one
    transposed solve in the backward pass; the loss-scaling pre-solve adds
    one per substep. This is the count ``chip_smoke.py`` expects of the kernel."""
    _, (tm, tn, tb) = _problem()
    config = tnde.NDETrainConfig(**CONFIG)
    calls = []
    raw = ttri._raw_solve

    def counting(*args, **kw):
        calls.append(1)
        return raw(*args, **kw)

    substeps = (tb.t.shape[0] - 1) * config.n_substeps
    try:
        ttri._raw_solve = counting
        scalings = tnde.determine_loss_scalings(tm, tn, tb, config)
        assert len(calls) == substeps
        optimizer = tnde._make_optimizer(config, tn)
        tnde._train_loop(tnde.make_wind_mixing_loss_fn(tm, tb, scalings, config), tn, optimizer, 2)
    finally:
        ttri._raw_solve = raw
    assert len(calls) == substeps * (1 + 3 * 2)


def test_resolve_tridiag_backend():
    assert tnde.resolve_tridiag_backend("auto", 1152, torch.device("cpu")) == "scan"
    assert tnde.resolve_tridiag_backend("auto", 1152, "cuda") == "cuda"
    assert tnde.resolve_tridiag_backend("auto", 8, None) == "scan"
    for backend in ("scan", "pcr", "cuda"):
        assert tnde.resolve_tridiag_backend(backend, 8, "cpu") == backend


def test_optimizers():
    _, (_, tn, _) = _problem()
    assert isinstance(tnde._make_optimizer(tnde.NDETrainConfig(optimizer="sgd"), tn), torch.optim.SGD)
    with pytest.raises(NotImplementedError, match="lbfgs"):
        tnde._make_optimizer(tnde.NDETrainConfig(optimizer="lbfgs"), tn)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tnde._make_optimizer(tnde.NDETrainConfig(optimizer="rmsprop"), tn)


def test_require_uniform():
    tnde._require_uniform(torch.tensor([0.0, 0.5, 1.0]), "ok")
    with pytest.raises(ValueError, match="uniformly spaced"):
        tnde._require_uniform(torch.tensor([0.0, 0.5, 2.0]), "bad")


def test_config_fields_match_jax():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(tnde.NDETrainConfig) == names(jnde.NDETrainConfig)
