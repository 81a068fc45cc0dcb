"""Port parity: KPP calibration (``train/kpp_calibration.py``, ``train/eki.py::calibrate_kpp_eki``).

The counterparts of ``tests/test_calibration_utils.py::TestKPPCalibration``.
The datasets are made with numpy from a seed (two simulations, Nz = 8, nine
600 s frames) and handed to both packages; the JAX side gets the suite's
constants as scalars, the port the stacked ``(S,)`` constants its
``_load_suite`` gives (the JAX forward map broadcasts ``(S,)`` constants
against the level axis and fails; the port reduces equal ones to a scalar).

Tolerances, float64: a population of P parameter sets is one solve, held to
the P single evaluations at ``POP_RTOL = 1e-12`` (the same elementwise
operations; only the final mean sums in another order) and to JAX's
``jax.vmap`` of the single loss at ``RTOL = 1e-10`` (another library's
``pow`` and reductions through the solve). Projected adam from the same
start follows JAX's iterates at ``ADAM_RTOL = 1e-8`` over five iterations.
The random searches draw from a ``torch.Generator``: they are held to the
reference tests' outcomes, not to JAX's draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.train import kpp_calibration as jkc
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.physics.kpp import KPPParameters
from climateparameterizations_jl_tpu_torch.train import eki as teki
from climateparameterizations_jl_tpu_torch.train import kpp_calibration as tkc

POP_RTOL, RTOL, ADAM_RTOL = 1e-12, 1e-10, 1e-8
S, NZ, NT, H = 2, 8, 9, 100.0
TSTEPS = np.arange(0, NT)
CONSTANTS = ("H", "f", "g", "alpha", "beta")


def _fields(seed=0, diurnal=(0.0, 0.0)):
    """A two-simulation suite: cooling columns that mix from the top, with noise; ``(S,)`` constants."""
    rng = np.random.default_rng(seed)
    zc = (np.arange(NZ) + 0.5) * H / NZ - H
    t = np.arange(NT) * 600.0
    mix = np.clip(1.0 - (-zc[None, None, :]) / (20.0 + 3.0 * np.arange(NT)[None, :, None]), 0.0, 1.0)
    T = 19.0 + 0.01 * (zc + H) - 0.05 * mix * np.array([1.0, 0.6])[:, None, None]
    T = T + 1e-3 * rng.normal(size=(S, NT, NZ))
    u = 0.02 * rng.normal(size=(S, NT, NZ))
    flux = np.zeros((S, NT, NZ + 1))
    full = lambda v: np.full(S, v)  # noqa: E731
    return dict(u=u, v=0.5 * u, T=T, uw=flux, vw=flux, wT=flux, t=np.broadcast_to(t, (S, NT)).copy(), H=full(H),
                f=full(1e-4), g=full(9.81), alpha=full(2e-4), beta=full(8e-4), u_top=np.array([-4e-4, -1e-4]),
                theta_top=np.array([1.2e-5, 4e-6]), theta_bottom=full(0.01), diurnal_amplitude=np.array(diurnal))


def _jax_ds(f):
    return jc.ColumnTimeSeries(**{k: jnp.asarray(v[0] if k in CONSTANTS else v) for k, v in f.items()})


def _port_ds(f):
    return tc.ColumnTimeSeries(**{k: torch.tensor(v) for k, v in f.items()})


@pytest.fixture(scope="module")
def suite():
    f = _fields()
    return _jax_ds(f), _port_ds(f)


@pytest.fixture(scope="module")
def candidates():
    """Five parameter sets inside the default priors, drawn by ``jax.random.uniform`` and handed over."""
    lo = np.array([tkc.DEFAULT_PRIORS[n][0] for n in tkc.DEFAULT_PRIORS])
    hi = np.array([tkc.DEFAULT_PRIORS[n][1] for n in tkc.DEFAULT_PRIORS])
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (5, len(lo)), jnp.float64))
    return lo + (hi - lo) * u


def test_population_loss_is_one_solve_equal_to_single_evaluations_and_jax(suite, candidates):
    jds, tds = suite
    loss_t = tkc.make_kpp_loss_fn(tds, TSTEPS, NZ, base_params=KPPParameters.default(device="cpu"))
    pop = loss_t(torch.tensor(candidates))
    assert pop.shape == (5,) and pop.dtype == torch.float64
    singles = torch.stack([loss_t(torch.tensor(c)) for c in candidates])
    np.testing.assert_allclose(pop.numpy(), singles.numpy(), rtol=POP_RTOL, atol=0)
    loss_j = jkc.make_kpp_loss_fn(jds, TSTEPS, NZ)
    want = np.asarray(jax.jit(jax.vmap(loss_j))(jnp.asarray(candidates)))
    np.testing.assert_allclose(pop.numpy(), want, rtol=RTOL, atol=0)
    # The forward map of the population is the P single maps.
    fwd, y = tkc.make_kpp_forward_fn(tds, TSTEPS, NZ)
    out = fwd(torch.tensor(candidates))
    assert out.shape == (5, y.numel()) == (5, S * NT * NZ)
    np.testing.assert_allclose(out[2].numpy(), fwd(torch.tensor(candidates[2])).numpy(), rtol=POP_RTOL, atol=0)


@pytest.mark.parametrize("P", [1, 3, S])
def test_population_result_has_one_loss_per_set(suite, candidates, P):
    """Each overridden field is ``(P, 1)`` against ``(P, S, Nz)`` states: ``(P,)`` losses, never ``(P, P, S)``."""
    _, tds = suite
    loss_t = tkc.make_kpp_loss_fn(tds, TSTEPS, NZ)
    assert loss_t(torch.tensor(candidates[:P])).shape == (P,)
    assert loss_t(torch.tensor(candidates[0])).shape == ()


def test_gradient_refine_follows_jax_adam(suite, candidates):
    jds, tds = suite
    lo = [tkc.DEFAULT_PRIORS[n][0] for n in tkc.DEFAULT_PRIORS]
    hi = [tkc.DEFAULT_PRIORS[n][1] for n in tkc.DEFAULT_PRIORS]
    v_t, h_t = tkc.gradient_refine_kpp(tkc.make_kpp_loss_fn(tds, TSTEPS, NZ), candidates[0], (lo, hi), n_iters=5)
    v_j, h_j = jkc.gradient_refine_kpp(jkc.make_kpp_loss_fn(jds, TSTEPS, NZ), jnp.asarray(candidates[0]), (lo, hi),
                                       n_iters=5)
    np.testing.assert_allclose(h_t, h_j, rtol=ADAM_RTOL, atol=0)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=ADAM_RTOL, atol=0)
    assert min(h_t) < h_t[0] and all(np.isfinite(h_t))
    # Zero iterations report the loss of the returned start.
    v0, h0 = tkc.gradient_refine_kpp(tkc.make_kpp_loss_fn(tds, TSTEPS, NZ), candidates[0], (lo, hi), n_iters=0)
    np.testing.assert_allclose(h0, h_t[:1], rtol=POP_RTOL)


def test_line_search_is_monotone_and_pipeline_improves_on_the_plugin(suite):
    _, tds = suite
    loss_t = tkc.make_kpp_loss_fn(tds, TSTEPS, NZ)
    _, history = tkc.random_line_search(loss_t, [0.5, 4.0, 2.0, 2.0], torch.Generator().manual_seed(1), n_iters=5)
    assert np.all(np.diff(history) <= 1e-12) and history[-1] < history[0]
    params, info = tkc.calibrate_kpp(tds, TSTEPS, NZ, generator=torch.Generator().manual_seed(2), n_plugin=8,
                                     n_line_search=3)
    assert isinstance(params, KPPParameters)
    assert info["final_loss"] <= info["plugin_best_loss"] + 1e-12
    assert 0.0 < float(params.CSL) < 1.0
    best, best_loss, losses = tkc.random_plugin(loss_t, tkc.DEFAULT_PRIORS, 8, torch.Generator().manual_seed(3))
    assert float(best_loss) == float(losses[torch.isfinite(losses)].min()) and best.shape == (4,)
    _, info_g = tkc.calibrate_kpp(tds, TSTEPS, NZ, generator=torch.Generator().manual_seed(2), n_plugin=8,
                                  n_line_search=3, refine="gradient")
    assert info_g["final_loss"] == min(info_g["history"]) and info_g["plugin_best_loss"] == info["plugin_best_loss"]
    with pytest.raises(ValueError, match="unknown refine"):
        tkc.calibrate_kpp(tds, TSTEPS, NZ, n_plugin=2, refine="newton")


def test_guards_mixed_suites_grids_and_constants():
    diurnal = _port_ds(_fields(diurnal=(2e-5, 2e-5)))
    with pytest.raises(ValueError, match="mixed"):
        tkc.make_kpp_forward_fn(_port_ds(_fields(diurnal=(0.0, 2e-5))), TSTEPS, NZ)
    with pytest.raises(ValueError, match="uniformly spaced"):
        tkc.make_kpp_forward_fn(diurnal, np.array([0, 1, 3, 4]), NZ)
    f = _fields()
    f["H"] = np.array([H, 2 * H])
    with pytest.raises(ValueError, match="differ in H"):
        tkc.make_kpp_forward_fn(_port_ds(f), TSTEPS, NZ)
    # A diurnal suite threads its cycle into the solve: the constant-flux twin differs.
    v = torch.tensor([0.1, 6.33, 1.36, 4.32])
    fwd, _ = tkc.make_kpp_forward_fn(diurnal, TSTEPS, NZ)
    const, _ = tkc.make_kpp_forward_fn(dataclasses.replace(diurnal, diurnal_amplitude=torch.zeros(S)), TSTEPS, NZ)
    out = fwd(v)
    assert bool(torch.isfinite(out).all()) and not torch.allclose(out, const(v))


def test_diurnal_forward_matches_jax():
    f = _fields(diurnal=(2e-5, 1e-5))
    v = np.array([0.2, 5.0, 1.0, 3.0])
    fwd_j, _ = jkc.make_kpp_forward_fn(_jax_ds(f), TSTEPS, NZ)
    fwd_t, _ = tkc.make_kpp_forward_fn(_port_ds(f), TSTEPS, NZ)
    want = np.asarray(jax.jit(fwd_j)(jnp.asarray(v)))
    np.testing.assert_allclose(fwd_t(torch.tensor(v)).numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_calibrate_kpp_eki_reduces_misfit(suite):
    _, tds = suite
    params, result = teki.calibrate_kpp_eki(tds, TSTEPS, NZ, generator=torch.Generator().manual_seed(0),
                                            n_ensemble=16, n_iterations=4)
    assert result.ensemble.shape == (16, 4) and result.names == tuple(tkc.DEFAULT_PRIORS)
    assert result.misfit_history[-1] < result.misfit_history[0]
    assert bool(torch.isfinite(result.theta_std).all()) and float(params.CSL) == float(result.theta_mean[0])
    # mesh= is accepted: a one-device mesh gives the mesh-less run; an n_ensemble that does not divide raises.
    from climateparameterizations_jl_tpu_torch.parallel import sharding, world

    mesh = sharding.make_mesh(device="cpu")
    _, meshed = teki.calibrate_kpp_eki(tds, TSTEPS, NZ, generator=torch.Generator().manual_seed(0), n_ensemble=16,
                                       n_iterations=4, mesh=mesh)
    assert torch.equal(meshed.ensemble, result.ensemble)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(world, "axis_of", lambda mesh, name=None: world.Axis(None, 0, 3))
        with pytest.raises(ValueError, match="must divide over the 3-rank mesh"):
            teki.calibrate_kpp_eki(tds, TSTEPS, NZ, n_ensemble=16, n_iterations=1, mesh=mesh)
