"""Port parity: MLP closures, packing and the wind-mixing forward path.

The JAX package's ``__graft_entry__._make_setup`` (f32) builds the model;
``bridge.from_reference`` carries it into the port as numbers. States come
from a numpy seed. Both sides run on the CPU.

Tolerances: an MLP or a packed chain agrees to a few f32 ulps (the two
frameworks sum the matmuls in different orders). The tendencies multiply
face fluxes by ``tau/H * sigma_flux/sigma_var / dz`` (~1e2 to 1e4 for the
flagship scalings), so a one-ulp flux difference shows as ~1e-5 absolute
there; trajectories add the time step on top of that.
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
from climateparameterizations_jl_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.closures import mlp as tmlp
from climateparameterizations_jl_tpu_torch.models import timestepper as tts
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm

FLAGSHIP = "runs/wm_flagship_fold"


def _flagship_jax_nns():
    skeleton = jwm.FluxNNs(*[jmlp.wind_mixing_mlp(k, 32) for k in jax.random.split(jax.random.PRNGKey(0), 3)])
    nns, _ = j_load_checkpoint(FLAGSHIP, skeleton)
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), nns)


def _setup(n_columns=8, trained=True, seed=0):
    """(JAX objects, port objects, x0 pair) for the flagship configuration."""
    model, nns, bcs, _ = graft._make_setup(Nz=32, n_columns=1)
    if trained:
        nns = _flagship_jax_nns()
    x0 = np.random.default_rng(seed).normal(size=(n_columns, 96)).astype(np.float32) * 0.1
    j = (model, nns, bcs, jnp.asarray(x0, jnp.float32))
    t = (from_reference(model, "cpu"), from_reference(nns, "cpu"), from_reference(bcs, "cpu"), torch.tensor(x0))
    return j, t


def _close(t, j, rtol, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def _close_to_scale(t, j, ulps=16):
    """Agree to ``ulps`` f32 ulps of the largest entry (a field's roundoff
    scales with its largest terms, not with each entry)."""
    j = np.asarray(j)
    _close(t, j, rtol=1e-5, atol=ulps * np.finfo(np.float32).eps * float(np.abs(j).max()))


@pytest.mark.parametrize("activation", ["relu", "tanh", "mish", "gelu", "swish", "linear"])
def test_mlp_apply(activation):
    rng = np.random.default_rng(1)
    sizes = (96, 50, 20, 31)
    Ws = [rng.normal(size=(o, i)).astype(np.float32) / np.sqrt(i) for i, o in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(size=(o,)).astype(np.float32) * 0.1 for o in sizes[1:]]
    x = rng.normal(size=(7, 96)).astype(np.float32)
    jn = jmlp.MLP(tuple(map(jnp.asarray, Ws)), tuple(map(jnp.asarray, bs)), activation)
    tn = from_reference(jn, "cpu")
    assert tn.sizes == jn.sizes
    _close(tmlp.mlp_apply(tn, torch.tensor(x)), jmlp.mlp_apply(jn, jnp.asarray(x)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("x", [-30.0, -3.0, -1e-3, 0.0, 2.0, 25.0, 90.0])
def test_mish_matches_jax_softplus(x):
    got = float(tmlp.mish(torch.tensor(x, dtype=torch.float32)))
    want = float(jmlp._ACTIVATIONS["mish"](jnp.float32(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


def test_wind_mixing_mlp_init():
    gen = torch.Generator().manual_seed(3)
    nn = tmlp.wind_mixing_mlp(gen, 32, scale=1e-5, device="cpu")
    assert nn.sizes == (96, 50, 20, 31) and nn.activation == "mish"
    bound = np.sqrt(6.0 / (96 + 50)) * 1e-5
    assert float(nn.weights[0].abs().max()) <= bound and float(nn.weights[0].abs().max()) > 0.5 * bound
    assert all(float(b.abs().max()) == 0.0 for b in nn.biases)
    again = tmlp.wind_mixing_mlp(torch.Generator().manual_seed(3), 32, scale=1e-5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(nn.weights, again.weights))
    with pytest.raises(ValueError):
        tmlp.mlp_init(gen, (4, 4), activation="elu", device="cpu")


def test_pack_flux_nns():
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup()
    jp, tp = jwm.pack_flux_nns(jn), twm.pack_flux_nns(tn)
    for a, b in zip(tp.matrices + tp.biases, jp.matrices + jp.biases):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(tp(tx), jp(jx), rtol=1e-5, atol=1e-6)
    assert twm.pack_flux_nns(tp) is tp
    assert twm.pack_flux_nns(twm.FluxNNs(tn.uw, None, tn.wT)) is None


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("variant", ["default", "non_zero_weights", "conv_adj", "smooth", "diurnal"])
def test_predict_flux_and_rhs(variant, packed):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup(n_columns=6)
    if variant == "non_zero_weights":
        jm, tm = dataclasses.replace(jm, zero_weights=False), dataclasses.replace(tm, zero_weights=False)
    elif variant == "conv_adj":
        jm = dataclasses.replace(jm, use_mpp=False, use_conv_adj=True)
        tm = dataclasses.replace(tm, use_mpp=False, use_conv_adj=True)
    elif variant == "smooth":
        jm = dataclasses.replace(jm, smooth_NN=True, smooth_Ri=True)
        tm = dataclasses.replace(tm, smooth_NN=True, smooth_Ri=True)
    elif variant == "diurnal":
        amp = np.linspace(0.0, 3e-5, 6).astype(np.float32)  # per-sim; member 0 keeps its frozen BC
        jm, tm = dataclasses.replace(jm, diurnal=True), dataclasses.replace(tm, diurnal=True)
        jb = dataclasses.replace(jb, diurnal_amplitude=jnp.asarray(amp))
        tb = dataclasses.replace(tb, diurnal_amplitude=torch.tensor(amp))
    if packed:
        jn, tn = jwm.pack_flux_nns(jn), twm.pack_flux_nns(tn)
    t_hat = 0.3
    for a, b in zip(twm.predict_flux(tm, tn, tb, tx, t_hat), jwm.predict_flux(jm, jn, jb, jx, t_hat)):
        assert a.shape == (6, 33)
        _close_to_scale(a, b)
    _close_to_scale(twm.wind_mixing_rhs(tm, tn, tb, tx, t_hat), jwm.wind_mixing_rhs(jm, jn, jb, jx, t_hat))


def test_split_join_roundtrip():
    x = torch.arange(2 * 96, dtype=torch.float32).reshape(2, 96)
    u, v, T = twm.split_uvT(x, 32)
    assert torch.equal(twm.join_uvT(u, v, T), x)


@pytest.mark.parametrize("method", ["rk4", "euler", "heun"])
def test_solve_wind_mixing_nde(method):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup(n_columns=8)
    args = (0.0, 4e-5, 2)
    j = jwm.solve_wind_mixing_nde(jm, jn, jb, jx, *args, n_substeps=4, method=method)
    t = twm.solve_wind_mixing_nde(tm, tn, tb, tx, *args, n_substeps=4, method=method)
    assert t.shape == (3, 8, 96)
    # 8 steps of dt 1e-5 on tendencies ~1e2: the ~1e-5 tendency roundoff
    # moves the state by ~1e-10 per step; f32 state ulps (~3e-8) dominate.
    _close(t, j, rtol=1e-5, atol=1e-6)
    assert float((t[-1] - t[0]).abs().max()) > 1e-4


def test_solve_rejects_fast_assembly():
    # The name dates from before the rk4 fast assembly was ported: it now
    # runs, and matches JAX's (tolerance as test_solve_wind_mixing_nde).
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup(n_columns=2)
    for value in (True, "fold"):
        j = jwm.solve_wind_mixing_nde(jm, jn, jb, jx, 0.0, 4e-5, 2, n_substeps=4, fast_assembly=value)
        t = twm.solve_wind_mixing_nde(tm, tn, tb, tx, 0.0, 4e-5, 2, n_substeps=4, fast_assembly=value)
        _close(t, j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stepper", ["euler_step", "heun_step", "rk4_step"])
def test_steppers_linear_ode(stepper):
    A = np.random.default_rng(2).normal(size=(5, 5)).astype(np.float32)
    x = np.random.default_rng(3).normal(size=(4, 5)).astype(np.float32)
    j = getattr(jts, stepper)(lambda x, t: x @ jnp.asarray(A) * (1 + t), jnp.asarray(x), 0.1, 0.05)
    t = getattr(tts, stepper)(lambda x, t: x @ torch.tensor(A) * (1 + t), torch.tensor(x), 0.1, 0.05)
    _close(t, j, rtol=1e-6, atol=1e-6)


def test_solve_fixed_step_and_times():
    x0 = np.ones((3, 2), np.float32)
    j = jts.solve_fixed_step(lambda x, t: -x, jnp.asarray(x0), 0.0, 0.1, 3, n_substeps=2)
    t = tts.solve_fixed_step(lambda x, t: -x, torch.tensor(x0), 0.0, 0.1, 3, n_substeps=2)
    _close(t, j, rtol=1e-6, atol=0)
    _close(tts.trajectory_times(0.5, 0.1, 3), jts.trajectory_times(0.5, 0.1, 3), rtol=1e-6, atol=0)
