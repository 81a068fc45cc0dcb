"""Port parity: mPP calibration (gradient, L-BFGS, EKI), the EKI library and the ``optimise-mpp`` command.

The counterparts of the mPP and EKI cases of ``tests/test_training.py`` and
``tests/test_calibration_utils.py`` (the sharded EKI case waits for the
parallel port, ``ROADMAP.md`` queue 1 item 11). A tiny suite (two synthetic
sims at 16 LES levels, 12 saves, coarsened to Nz = 8) is generated by the
JAX package in float64 and handed over through numpy.

Tolerances:

- ``RTOL = 1e-9`` (float64) where both packages run the same operations:
  projected adam (every iterate and the best loss) and one Kalman step on
  the same noise (the port draws its noise from a ``torch.Generator``, so the
  test hands JAX's ``eta`` to the port's ``kalman_step``).
- L-BFGS: ``torch.optim.LBFGS`` (strong Wolfe) and ``optax.lbfgs`` (zoom)
  are different line searches, so the port is held to the same minimum, not
  the same iterates: its best loss at most ``LBFGS_FACTOR`` times JAX's and
  times the port's own adam (the reference test's criterion).
- EKI runs draw their own noise: held to the reference tests' outcomes
  (truth recovered within 0.05, misfit falls).
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

from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.data import synthetic as js
from climateparameterizations_jl_tpu.physics.mpp import MPPParameters as JMPP
from climateparameterizations_jl_tpu.train import eki as jeki
from climateparameterizations_jl_tpu.train import mpp_calibration as jmc
from climateparameterizations_jl_tpu.train import nde as jnde
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.cli import main as tcli
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters as TMPP
from climateparameterizations_jl_tpu_torch.train import eki as teki
from climateparameterizations_jl_tpu_torch.train import mpp_calibration as tmc
from climateparameterizations_jl_tpu_torch.train import nde as tnde

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
RTOL = 1e-9
LBFGS_FACTOR = 1.05
FIELDS = ("nu_0", "nu_minus", "Ri_c", "delta_Ri", "Pr")
WRONG = dict(nu_0=3e-4, nu_minus=3e-2, Ri_c=0.4, delta_Ri=2.0, Pr=1.5)
TINY = ["--nz", "16", "--n-save", "12", "--dt-save", "600"]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * max(float(np.abs(want).max()), 1e-30))


@pytest.fixture(scope="module")
def problem():
    """(JAX model, batch, port model, batch), float64, both over the mis-set mPP parameters ``WRONG``."""
    kw = dict(Nz=16, n_save=12, dtype=jnp.float64, mpp=JMPP.default(jnp.float64))
    sims = [jc.enforce_surface_fluxes(jc.coarsen_dataset(js.synthetic_wind_mixing_les(Qu=qu, Qb=qb, **kw), 8))
            for qu, qb in ((-5e-4, 3e-8), (-2e-4, -1e-8))]
    ds = jc.stack_datasets(sims)
    wrong = JMPP(**{k: jnp.float64(v) for k, v in WRONG.items()})
    model = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jcli._wind_model(ds, 8))
    model = dataclasses.replace(model, mpp=wrong)
    tds = tc.ColumnTimeSeries(**{f.name: None if getattr(ds, f.name) is None else
                                 torch.tensor(np.asarray(getattr(ds, f.name)))
                                 for f in dataclasses.fields(tc.ColumnTimeSeries)})
    tmodel = from_reference(model, "cpu", torch.float64)
    tsteps = np.arange(0, 9)
    return (model, jc.training_tensors(ds, model.scalings, tsteps, tau=model.tau),
            tmodel, tc.training_tensors(tds, tmodel.scalings, tsteps, tau=tmodel.tau))


BASE = dict(learning_rate=0.05, maxiters=4, n_substeps=2, train_gradient=False, method="split")


def test_optimise_mpp_adam_matches_jax(problem):
    jmodel, jb, tmodel, tb = problem
    jfit, jhist = jmc.optimise_mpp_parameters(jmodel, jb, jnde.NDETrainConfig(**BASE), initial=jmodel.mpp)
    tfit, thist = tmc.optimise_mpp_parameters(tmodel, tb, tnde.NDETrainConfig(**BASE), initial=tmodel.mpp)
    assert len(thist) == len(jhist) == 4
    for (tl, tp), (jl, jp) in zip(thist, jhist):
        _close(tl, jl)
        _close([getattr(tp, k) for k in FIELDS], [getattr(jp, k) for k in FIELDS])
    _close(torch.stack([getattr(tfit, k) for k in FIELDS]), [float(getattr(jfit, k)) for k in FIELDS])
    assert min(h[0] for h in thist) < thist[0][0]  # calibration reduces the trajectory loss
    # The callback sees each pre-update iterate, and the box holds.
    seen = []
    tmc.optimise_mpp_parameters(tmodel, tb, tnde.NDETrainConfig(**dict(BASE, maxiters=2)), initial=tmodel.mpp,
                                callback=lambda i, loss, p: seen.append((i, loss, p)), ub=1.2)
    assert [s[0] for s in seen] == [0, 1] and seen[0][1] == pytest.approx(thist[0][0], rel=1e-12)
    assert all(float(getattr(seen[1][2], k)) <= 1.2 * WRONG[k] * (1 + 1e-12) for k in FIELDS)


def test_optimise_mpp_lbfgs_reaches_the_jax_minimum(problem):
    jmodel, jb, tmodel, tb = problem
    conf = dict(BASE, maxiters=8)
    _, jhist = jmc.optimise_mpp_parameters(jmodel, jb, jnde.NDETrainConfig(**dict(conf, optimizer="lbfgs")),
                                           initial=jmodel.mpp)
    _, thist = tmc.optimise_mpp_parameters(tmodel, tb, tnde.NDETrainConfig(**dict(conf, optimizer="lbfgs")),
                                           initial=tmodel.mpp)
    _, tadam = tmc.optimise_mpp_parameters(tmodel, tb, tnde.NDETrainConfig(**conf), initial=tmodel.mpp)
    best_j, best_t, best_adam = (min(h[0] for h in hist) for hist in (jhist, thist, tadam))
    assert np.isfinite(best_t)
    assert best_t <= LBFGS_FACTOR * best_j, (best_t, best_j)
    assert best_t <= LBFGS_FACTOR * best_adam, (best_t, best_adam)


def test_kalman_step_matches_jax_on_its_noise():
    rng = np.random.default_rng(0)
    J, p, d = 12, 3, 40
    u, g, y = rng.normal(size=(J, p)), rng.normal(size=(J, d)), rng.normal(size=d)
    noise_std, key = 0.3, jax.random.PRNGKey(4)
    want = jeki.eki_update(jnp.asarray(u), jnp.asarray(g), jnp.asarray(y), jnp.asarray(noise_std), key)
    eta = noise_std * jax.random.normal(key, g.shape, jnp.float64)  # the noise eki_update draws
    got = teki.kalman_step(torch.tensor(u), torch.tensor(g), torch.tensor(y), torch.tensor(np.asarray(eta)),
                           noise_std)
    _close(got, want)
    # The port's own draw: same shapes, a step that moves every member.
    moved = teki.eki_update(torch.tensor(u), torch.tensor(g), torch.tensor(y), noise_std,
                            torch.Generator().manual_seed(0))
    assert moved.shape == (J, p) and bool((moved != torch.tensor(u)).all())


def test_constraint_maps_match_jax():
    theta = np.array([[0.05, 1.0], [0.999999999, 4.9], [0.5, 2.5]])
    lo, hi = np.array([0.0, 0.0]), np.array([1.0, 5.0])
    u_t = teki._to_unconstrained(torch.tensor(theta), torch.tensor(lo), torch.tensor(hi))
    _close(u_t, jeki._to_unconstrained(jnp.asarray(theta), jnp.asarray(lo), jnp.asarray(hi)))
    _close(teki._to_constrained(u_t, torch.tensor(lo), torch.tensor(hi)),
           jeki._to_constrained(jnp.asarray(u_t.numpy()), jnp.asarray(lo), jnp.asarray(hi)))


def _linear_problem(n_obs, truth, dtype=torch.float64):
    A = torch.tensor(np.random.default_rng(0).normal(size=(n_obs, 2)), dtype=dtype)
    return A, A @ torch.tensor(truth, dtype=dtype), (lambda v: v @ A.T)


def test_eki_linear_gaussian_recovers_truth():
    A, y, forward = _linear_problem(12, [0.7, 2.5])
    priors = {"a": (0.0, 1.0), "b": (0.0, 5.0)}
    result = teki.eki_calibrate(forward, y, priors, generator=torch.Generator().manual_seed(1), n_ensemble=64,
                                n_iterations=12, noise_std=1e-3)
    np.testing.assert_allclose(result.theta_mean.numpy(), [0.7, 2.5], atol=0.05)
    assert result.misfit_history[-1] < 0.01 * result.misfit_history[0]
    ens = result.ensemble.numpy()
    assert ens[:, 0].min() >= 0.0 and ens[:, 0].max() <= 1.0 and ens[:, 1].min() >= 0.0 and ens[:, 1].max() <= 5.0
    assert bool((result.theta_std >= 0).all()) and result.names == ("a", "b")
    # batch_size evaluates the population in chunks: the same result.
    chunked = teki.eki_calibrate(forward, y, priors, generator=torch.Generator().manual_seed(1), n_ensemble=64,
                                 n_iterations=12, noise_std=1e-3, batch_size=10)
    assert torch.equal(chunked.ensemble, result.ensemble)


def test_eki_tempering_prevents_saturation_collapse():
    A, y, forward = _linear_problem(20, [2.0, 8.0], torch.float32)
    priors = {"a": (0.0, 1.0), "b": (0.0, 5.0)}
    kw = dict(n_ensemble=32, n_iterations=10, noise_std=1e-3)
    bad = teki.eki_calibrate(forward, y, priors, generator=torch.Generator().manual_seed(1), tempered=False, **kw)
    good = teki.eki_calibrate(forward, y, priors, generator=torch.Generator().manual_seed(1), **kw)
    # Untempered: the first updates drive every member into the sigmoid's saturated tails, where the f32
    # ensemble collapses to zero spread and freezes (which corner it freezes at depends on the draws).
    assert float(bad.theta_std.max()) == 0.0 and len(set(bad.misfit_history[3:])) == 1
    assert good.misfit_history[-1] < 0.5 * good.misfit_history[0]
    np.testing.assert_allclose(good.theta_mean.numpy(), [1.0, 5.0], atol=0.05)


def test_eki_mesh_names_its_roadmap_item(monkeypatch):
    """``mesh=`` is accepted: on a one-device mesh the run is the mesh-less one; an ``n_ensemble`` that does not
    divide over the mesh raises ``ValueError`` (worlds of 2 ranks: ``test_torch_parallel.py``)."""
    from climateparameterizations_jl_tpu_torch.parallel import sharding, world

    A, y, forward = _linear_problem(12, [0.7, 2.5])
    priors = {"a": (0.0, 1.0), "b": (0.0, 5.0)}
    kw = dict(n_ensemble=16, n_iterations=3, noise_std=1e-3)
    plain = teki.eki_calibrate(forward, y, priors, generator=torch.Generator().manual_seed(1), **kw)
    meshed = teki.eki_calibrate(forward, y, priors, generator=torch.Generator().manual_seed(1),
                                mesh=sharding.make_mesh(device="cpu"), **kw)
    assert torch.equal(plain.ensemble, meshed.ensemble) and plain.misfit_history == meshed.misfit_history
    monkeypatch.setattr(world, "axis_of", lambda mesh, name=None: world.Axis(None, 0, 3))
    with pytest.raises(ValueError, match="n_ensemble=16 must divide over the 3-rank mesh"):
        teki.eki_calibrate(forward, y, priors, mesh=sharding.make_mesh(device="cpu"), **kw)


def test_calibrate_mpp_eki_reduces_misfit(problem):
    """The J parameter sets on the solve's batch axis: the first forward evaluation equals J solves one by one."""
    _, _, tmodel, tb = problem
    config = tnde.NDETrainConfig(n_substeps=2, train_gradient=False, method="split")
    calls = []
    real = tmc._solve

    def recording(model, nns, batch, config):
        out = real(model, nns, batch, config)
        calls.append((model.mpp, batch.x0.shape, out))
        return out

    tmc._solve = recording
    try:
        fitted, result = tmc.calibrate_mpp_eki(tmodel, tb, config, generator=torch.Generator().manual_seed(0),
                                               n_ensemble=8, n_iterations=3)
    finally:
        tmc._solve = real
    assert result.misfit_history[-1] <= result.misfit_history[0]
    assert bool(torch.isfinite(result.theta_mean).all()) and float(fitted.nu_0) > 0.0
    assert result.names == ("nu_0", "nu_minus", "delta_Ri", "Ri_c", "Pr") and len(calls) == 4
    mpp, shape, out = calls[0]
    assert shape == (2, 8, 24) and out.shape == (2, 8, 9, 24)
    for j in (0, 5):
        one = TMPP(**{k: getattr(mpp, k)[j, 0] for k in FIELDS})
        solo = real(dataclasses.replace(tmodel, mpp=one), tmc.NO_NNS, tb, config)
        _close(out[:, j], solo.numpy(), 1e-12)


def test_calibrate_mpp_eki_zero_parameter_prior_raises(problem):
    _, _, tmodel, tb = problem
    m = dataclasses.replace(tmodel, mpp=dataclasses.replace(tmodel.mpp, nu_minus=torch.tensor(0.0)))
    with pytest.raises(ValueError, match="nu_minus"):
        tmc.calibrate_mpp_eki(m, tb, tnde.NDETrainConfig(n_substeps=2, method="split"), n_ensemble=4,
                              n_iterations=1)


@pytest.mark.parametrize("extra", [["--maxiters", "2"], ["--maxiters", "2", "--optimizer", "lbfgs"],
                                   ["--calibration-method", "eki", "--n-ensemble", "6", "--n-eki-iters", "2"]],
                         ids=["adam", "lbfgs", "eki"])
def test_optimise_mpp_command_writes_the_jax_keys(tmp_path, extra, capsys):
    argv = ["optimise-mpp", "--sims", "strong_wind", *TINY, "--n-train-steps", "6", "--n-substeps", "2", *extra]
    assert tcli.main(["--device", "cpu", *argv, "--output", str(tmp_path / "t")]) == 0
    assert jcli.main([*argv, "--output", str(tmp_path / "j")]) == 0
    capsys.readouterr()
    got = json.loads((tmp_path / "t" / "mpp_parameters.json").read_text())
    want = json.loads((tmp_path / "j" / "mpp_parameters.json").read_text())
    assert list(got) == list(want)
    assert all(np.isfinite(v) for v in got.values() if isinstance(v, float))
    if "eki" in extra:
        assert list(got["posterior_std"]) == list(want["posterior_std"])
        assert got["misfit_final"] <= got["misfit_initial"]
    else:
        assert got["loss_final"] <= got["loss_initial"]
    # The json feeds train-nde --mpp-params in the port, as in the JAX package.
    mpp = tcli._restore_mpp({}, str(tmp_path / "t" / "mpp_parameters.json"), "cpu")["mpp"]
    assert float(mpp.nu_0) == pytest.approx(got["nu_0"], rel=1e-6)
    assert os.path.exists(tmp_path / "t" / "mpp_parameters.json")
