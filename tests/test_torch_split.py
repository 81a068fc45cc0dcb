"""Port parity: the operator-split stepper ``solve_wind_mixing_split``.

The JAX package's flagship setup (``__graft_entry__._make_setup``) with the
trained ``runs/wm_flagship_fold`` flux MLPs goes to both packages through
numpy (``bridge.from_reference``); states come from a numpy seed. Both
sides run on the CPU in float64 (the JAX tests run with x64), where the
point is the algorithm: the same operations in the same order, so
trajectories and gradients agree to ``rtol=1e-9`` (a few hundred f64 ulps
after 12 stiff substeps). One f32 case holds the port at the working
precision against JAX at ``rtol=1e-5, atol=1e-6``, the tolerance of the JAX
suite's own f32 assembly-variant comparisons (``TestFastSplit``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

FLAGSHIP = "runs/wm_flagship_fold"
RUN = dict(t0=0.0, dt_save=1e-3, n_save=3, n_substeps=4)


def _setup(n_columns=4, dtype=np.float64, seed=0):
    model, _, bcs, _ = graft._make_setup(Nz=32, n_columns=1)
    skeleton = jwm.FluxNNs(*[jmlp.wind_mixing_mlp(k, 32) for k in jax.random.split(jax.random.PRNGKey(0), 3)])
    nns, _ = j_load_checkpoint(FLAGSHIP, skeleton)
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)  # noqa: E731
    model, nns, bcs = cast(model), cast(nns), cast(bcs)
    x0 = (np.random.default_rng(seed).normal(size=(n_columns, 96)) * 0.1).astype(dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    port = tuple(from_reference(o, "cpu", tdtype) for o in (model, nns, bcs)) + (torch.tensor(x0),)
    return (model, nns, bcs, jnp.asarray(x0)), port


def _run_jax(j, **kw):
    model, nns, bcs, x0 = j
    return np.asarray(jwm.solve_wind_mixing_split(model, nns, bcs, x0, RUN["t0"], RUN["dt_save"], RUN["n_save"],
                                                  RUN["n_substeps"], **kw))


def _run_port(t, **kw):
    model, nns, bcs, x0 = t
    with torch.no_grad():
        return twm.solve_wind_mixing_split(model, nns, bcs, x0, RUN["t0"], RUN["dt_save"], RUN["n_save"],
                                           RUN["n_substeps"], **kw).numpy()


def _replace(pair, model=None, bcs=None):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = pair
    jm2 = dataclasses.replace(jm, **model) if model else jm
    tm2 = dataclasses.replace(tm, **model) if model else tm
    jb2 = dataclasses.replace(jb, **{k: jnp.asarray(v) for k, v in bcs.items()}) if bcs else jb
    tb2 = dataclasses.replace(tb, **{k: torch.tensor(v) for k, v in bcs.items()}) if bcs else tb
    return (jm2, jn, jb2, jx), (tm2, tn, tb2, tx)


VARIANTS = {
    "mpp": {},
    "per_sim_bcs": dict(bcs=dict(uw_top=np.linspace(-0.5, 0.2, 4), wT_top=np.linspace(0.1, 0.4, 4),
                                 vw_bot=np.linspace(-0.1, 0.1, 4))),
    "diurnal": dict(model=dict(diurnal=True), bcs=dict(diurnal_amplitude=np.linspace(1e-5, 3e-5, 4))),
    "non_zero_weights": dict(model=dict(zero_weights=False)),
    "conv_adj": dict(model=dict(use_mpp=False, use_conv_adj=True)),
    "no_base": dict(model=dict(use_mpp=False, use_conv_adj=False)),
}


@pytest.mark.parametrize("fast_assembly", [False, True, "fold"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_split_matches_jax(variant, fast_assembly):
    j, t = _replace(_setup(), **VARIANTS[variant])
    got = _run_port(t, fast_assembly=fast_assembly)
    want = _run_jax(j, fast_assembly=fast_assembly)
    assert got.shape == want.shape == (RUN["n_save"] + 1, 4, 96)
    assert np.abs(want[-1] - want[0]).max() > 1e-3  # the state moved
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("backend", ["scan", "pcr", "cuda"])
def test_split_f32_matches_jax(backend):
    # The "cuda" backend takes the kernel's plain version for CPU tensors.
    j, t = _setup(dtype=np.float32)
    got = _run_port(t, fast_assembly="fold", tridiag_backend=backend)
    want = _run_jax(j, fast_assembly="fold", tridiag_backend="scan")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fast_assembly", [False, "fold"])
@pytest.mark.parametrize("implicit_solve_grad", [True, False])
def test_split_gradients_match_jax(fast_assembly, implicit_solve_grad):
    """d(loss)/d(weights) through the split solve, with checkpointed intervals."""
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup()
    target = np.random.default_rng(1).normal(size=(RUN["n_save"] + 1, 4, 96)) * 0.1
    kw = dict(fast_assembly=fast_assembly, implicit_solve_grad=implicit_solve_grad, checkpoint=True)

    def jloss(nns):
        traj = jwm.solve_wind_mixing_split(jm, nns, jb, jx, 0.0, RUN["dt_save"], RUN["n_save"], RUN["n_substeps"], **kw)
        return jnp.mean((traj - target) ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(jn)
    leaves = [p.requires_grad_(True) for m in tn for p in (*m.weights, *m.biases)]
    traj = twm.solve_wind_mixing_split(tm, tn, tb, tx, 0.0, RUN["dt_save"], RUN["n_save"], RUN["n_substeps"], **kw)
    tval = torch.mean((traj - torch.tensor(target)) ** 2)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-11)
    jleaves = [p for m in jgrad for p in (*m.weights, *m.biases)]
    for gt, gj in zip([p.grad for p in leaves], jleaves):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-8, atol=1e-12 * float(np.abs(gj).max()))


def test_resolve_fast_assembly():
    _, (model, nns, _, _) = _setup()
    assert twm.resolve_fast_assembly(model, nns, "split", "auto") == "fold"
    assert twm.resolve_fast_assembly(model, nns, "rk4", "auto") == "fold"
    assert twm.resolve_fast_assembly(dataclasses.replace(model, smooth_NN=True), nns, "split", "auto") is False
    assert twm.resolve_fast_assembly(model, twm.FluxNNs(None, None, None), "split", "auto") is False
    assert twm.resolve_fast_assembly(model, nns, "split", True) is True


def test_fast_assembly_refusals():
    _, (model, nns, bcs, x0) = _setup()
    with pytest.raises(ValueError, match="fast_assembly must be"):
        twm.solve_wind_mixing_split(model, nns, bcs, x0, 0.0, 1e-3, 1, fast_assembly="yes")
    with pytest.raises(ValueError, match="packable"):
        twm.solve_wind_mixing_split(model, twm.FluxNNs(None, None, None), bcs, x0, 0.0, 1e-3, 1, fast_assembly=True)


class TestEkmanTransport:
    def test_steady_transport_matches_theory(self):
        """Port of ``tests/test_models.py::TestEkmanTransport`` (golden physics):
        the steady depth-integrated Ekman transport is ``int v dz = Fu / f``
        and ``int u dz = 0`` for constant-viscosity wind-driven flow; the
        forward-backward Coriolis keeps the split stepper on the inertial
        circle. The same 400 saves x 20 substeps (40 days) as the JAX test;
        the solve uses ``"pcr"`` (the plain scan costs about twice as long on
        the CPU in eager PyTorch), which gives the same trajectory to roundoff.
        """
        f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
        sc = lambda m, s: ZeroMeanUnitVarianceScaling(f(m), f(s))  # noqa: E731
        scalings = twm.WindMixingScalings(u=sc(0.0, 0.1), v=sc(0.0, 0.1), T=sc(19.0, 0.5),
                                          uw=sc(0.0, 1e-4), vw=sc(0.0, 1e-4), wT=sc(0.0, 1e-5))
        mpp = MPPParameters(nu_0=f(1e-2), nu_minus=f(0.0), Ri_c=f(0.25), delta_Ri=f(0.1), Pr=f(1.0))
        model = twm.WindMixingModel(H=f(256.0), tau=f(691200.0), f=f(1e-4), g=f(9.80665), alpha=f(2e-4),
                                    kappa=f(10.0), scalings=scalings, mpp=mpp, Nz=32)
        Fu = -5e-4
        z = f(0.0)
        bcs = twm.BoundaryConditions(uw_bot=z, uw_top=f(Fu / 1e-4), vw_bot=z, vw_top=z, wT_bot=z, wT_top=z)
        Nz, H = 32, 256.0
        zc = (np.arange(Nz) + 0.5) * (H / Nz) - H
        T0 = torch.tensor(19.0 + 0.02 * (zc + H), dtype=torch.float32)
        x0 = torch.cat([torch.zeros(Nz), torch.zeros(Nz), scalings.T.scale(T0)])
        n_save, substeps = 400, 20
        with torch.no_grad():
            traj = twm.solve_wind_mixing_split(model, twm.FluxNNs(None, None, None), bcs, x0, 0.0, 5.0 / n_save,
                                               n_save, substeps, tridiag_backend="pcr")
        u, v, _ = twm.split_uvT(traj, Nz)
        dz = H / Nz
        U = scalings.u.unscale(u).sum(dim=-1).numpy() * dz
        V = scalings.v.unscale(v).sum(dim=-1).numpy() * dz
        U_ss, V_ss = U[-8:].mean(), V[-8:].mean()
        theory = Fu / 1e-4
        np.testing.assert_allclose(V_ss, theory, rtol=0.15)
        assert abs(U_ss) < 0.15 * abs(theory)
