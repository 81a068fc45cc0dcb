"""Port parity: a-posteriori training through the host column (``train/embedded.py``).

Two simulations made with numpy from seeds (Nz = 16, 9 saves of 600 s;
``test_torch_eval_profile._column``) are handed to both packages in
float64, with flux MLPs drawn by ``jax.random`` and carried over by
``bridge.from_reference``. The loss over a 4-save window and its gradient
in every weight agree with ``jax.grad`` within ``RTOL = 1e-9`` of each
leaf's scale (the same float64 operations; the port's backward pass runs
the checkpoint recompute and the transposed Thomas solve where JAX
differentiates its scan), in both workloads, with fixed and with
auto-balanced loss scalings. A two-stage curriculum with checkpoints gives
JAX's losses and weights (adam carries its moments across the stages), and
each package resumes the other's train state. The trainer's trajectory is
the evaluator's (``eval/profile.py`` with ``include_embedded``) in both
workloads, and checkpointed save intervals give the same loss and gradient
as stored ones.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.data import containers as jc
from climateparameterizations_jl_tpu.data import free_convection as jfcd
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.train import embedded as jemb
from climateparameterizations_jl_tpu.train import nde as jnde
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling as TScaling
from climateparameterizations_jl_tpu_torch.data import free_convection as tfcd
from climateparameterizations_jl_tpu_torch.embed import column_model as tcm
from climateparameterizations_jl_tpu_torch.eval import profile as tprof
from climateparameterizations_jl_tpu_torch.train import embedded as temb
from climateparameterizations_jl_tpu_torch.train import nde as tnde
from test_torch_eval_profile import _column, _f64, _to_torch

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
RTOL = 1e-9
NZ, NT = 16, 9
CHANNELS = ("u", "v", "T", "dudz", "dvdz", "dTdz")
FRACTIONS = {"T": 0.8, "dTdz": 0.8, "profile": 0.5}


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max abs {err:.3e} against {rtol} x {scale:.3e}"


def _port(obj):
    return from_reference(obj, "cpu", torch.float64)


@pytest.fixture(scope="module")
def wind():
    ds = jc.stack_datasets([_column(0, NT=NT, NZ=NZ), _column(1, NT=NT, NZ=NZ)])
    model = _f64(jcli._wind_model(ds, NZ))
    nns = _f64(jwm.FluxNNs(*[jmlp.wind_mixing_mlp(k, NZ, scale=0.3) for k in jax.random.split(jax.random.PRNGKey(5), 3)]))
    return ds, model, nns, _to_torch(ds), _port(model), _port(nns)


def _fc_column(seed):
    ds = _column(seed, NT=NT, NZ=NZ)
    zeros = jnp.zeros_like(ds.u)
    return dataclasses.replace(ds, u=zeros, v=zeros, uw=jnp.zeros_like(ds.uw), vw=jnp.zeros_like(ds.vw),
                               u_top=jnp.float64(0.0))


@pytest.fixture(scope="module")
def fc():
    ds = jc.stack_datasets([_fc_column(2), _fc_column(3)])
    T_scaling, wT_scaling = jmlp_scaling(ds.T), jmlp_scaling(ds.wT)
    model = _f64(jfcd.build_free_convection_model(ds, T_scaling, wT_scaling))
    nn = _f64(jmlp.free_convection_mlp(jax.random.PRNGKey(11), NZ))
    tds = _to_torch(ds)
    tmodel = tfcd.build_free_convection_model(tds, _port(T_scaling), _port(wT_scaling))
    return ds, model, nn, tds, tmodel, _port(nn)


def jmlp_scaling(x):
    from climateparameterizations_jl_tpu.core.scalings import ZeroMeanUnitVarianceScaling

    return ZeroMeanUnitVarianceScaling.fit(x.reshape(-1))


def _leaves(tree):
    return tnde.nn_parameters(tree)


def _wind_loss(wind, config_kw, tsteps=np.arange(0, 5)):
    ds, model, nns, tds, tmodel, tnns = wind
    jconf, tconf = jnde.NDETrainConfig(**config_kw), tnde.NDETrainConfig(**config_kw)
    jhost, thost = jemb.host_from_suite(model, ds), temb.host_from_suite(tmodel, tds)
    jb, tb = jemb.embedded_training_tensors(ds, model.scalings, tsteps), temb.embedded_training_tensors(
        tds, tmodel.scalings, tsteps)
    _close(tb.targets, jb.targets, 0, "targets")
    _close(tb.t, jb.t, 0, "t")
    jscal = jemb.determine_embedded_loss_scalings(jhost, nns, jb, jconf)
    tscal = temb.determine_embedded_loss_scalings(thost, tnns, tb, tconf)
    for c in CHANNELS:
        _close(getattr(tscal, c), getattr(jscal, c), RTOL, f"loss scaling {c}")
    jfn = jemb.make_embedded_loss_fn(jhost, jb, jscal, jconf)
    tfn = temb.make_embedded_loss_fn(thost, tb, tscal, tconf)
    return jfn, tfn, nns, tnns


@pytest.mark.parametrize("fractions", [None, FRACTIONS], ids=["fixed", "auto_balance"])
def test_wind_mixing_loss_and_gradient_match_jax(wind, fractions):
    jfn, tfn, nns, tnns = _wind_loss(wind, dict(n_substeps=2, tridiag_backend="scan", training_fractions=fractions))
    (jloss, jch), jgrad = jax.value_and_grad(jfn, has_aux=True)(nns)
    tnns = _port(nns)  # fresh leaves, so the fixture's stay without gradients
    leaves = [p.requires_grad_(True) for p in _leaves(tnns)]
    tloss, tch = tfn(tnns)
    tloss.backward()
    _close(tloss, jloss, RTOL, "loss")
    for c in CHANNELS:
        _close(getattr(tch, c), getattr(jch, c), RTOL, f"channel {c}")
    for i, (p, g) in enumerate(zip(leaves, jax.tree.leaves(jgrad))):
        assert float(np.abs(np.asarray(g)).max()) > 0.0
        _close(p.grad, g, RTOL, f"gradient leaf {i}")


def test_free_convection_loss_and_gradient_match_jax(fc):
    ds, model, nn, tds, tmodel, tnn = fc
    conf = dict(n_substeps=2, tridiag_backend="scan")
    jhost, thost = jemb.host_from_fc_suite(model, ds), temb.host_from_fc_suite(tmodel, tds)
    tsteps = np.arange(0, 5)
    jb = jemb.embedded_fc_training_tensors(ds, model.T_scaling, tsteps)
    tb = temb.embedded_fc_training_tensors(tds, tmodel.T_scaling, tsteps)
    jfn = jemb.make_embedded_fc_loss_fn(jhost, jb, jnde.NDETrainConfig(**conf))
    tfn = temb.make_embedded_fc_loss_fn(thost, tb, tnde.NDETrainConfig(**conf))
    (jloss, _), jgrad = jax.value_and_grad(jfn, has_aux=True)(nn)
    tnn = _port(nn)
    leaves = [p.requires_grad_(True) for p in _leaves(tnn)]
    tloss, _ = tfn(tnn)
    tloss.backward()
    _close(tloss, jloss, RTOL, "fc loss")
    for i, (p, g) in enumerate(zip(leaves, jax.tree.leaves(jgrad))):
        _close(p.grad, g, RTOL, f"fc gradient leaf {i}")


def test_remat_equals_no_remat(wind):
    """Checkpointed save intervals (recomputed in the backward pass) give the stored run's loss and gradient."""
    _, _, jnns, tds, tmodel, _ = wind
    host = temb.host_from_suite(tmodel, tds)
    batch = temb.embedded_training_tensors(tds, tmodel.scalings, np.arange(0, 5))
    out = []
    for remat in (True, False):
        nns = _port(jnns)
        leaves = [p.requires_grad_(True) for p in _leaves(nns)]
        traj = tcm.run_embedded_column(host, nns, batch.state0, 60.0, 4, 3, t0=batch.t[0], remat=remat)
        loss = torch.sum(traj.T ** 2) + torch.sum(traj.u * traj.v)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in leaves]))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_trainer_trajectory_is_the_evaluators(wind, fc):
    """One simulation: the trainer's scaled host trajectory equals ``evaluate --embedded``'s, in both workloads."""
    _, _, _, tds, tmodel, tnns = wind
    one = dataclasses.replace(tds, **{f.name: getattr(tds, f.name)[:1] for f in dataclasses.fields(tds)
                                      if getattr(tds, f.name) is not None})
    tsteps = np.arange(0, NT)
    with torch.no_grad():
        batch = temb.embedded_training_tensors(one, tmodel.scalings, tsteps)
        pred = temb._solve_embedded(temb.host_from_suite(tmodel, one), tnns, batch,
                                    tnde.NDETrainConfig(n_substeps=10, tridiag_backend="scan"))[0]
    ev = tprof.nde_profile(tmodel, tnns, one, tsteps, include_embedded=True, include_kpp=False)
    s = tmodel.scalings
    want = torch.cat([s.u.scale(torch.tensor(ev["embedded_u"])), s.v.scale(torch.tensor(ev["embedded_v"])),
                      s.T.scale(torch.tensor(ev["embedded_T"]))], dim=-1)
    _close(pred, want, 1e-12, "wind-mixing trainer vs evaluator")

    _, _, _, fds, fmodel, fnn = fc
    one = dataclasses.replace(fds, **{f.name: getattr(fds, f.name)[:1] for f in dataclasses.fields(fds)
                                      if getattr(fds, f.name) is not None})
    with torch.no_grad():
        batch = temb.embedded_fc_training_tensors(one, fmodel.T_scaling, tsteps)
        pred = temb._solve_embedded_fc(temb.host_from_fc_suite(fmodel, one), fnn, batch,
                                       tnde.NDETrainConfig(n_substeps=10, tridiag_backend="scan"))[0]
    # The evaluator's model is built on the one simulation (evaluate-fc builds one per id).
    ds0 = dataclasses.replace(one, **{f.name: getattr(one, f.name)[0] for f in dataclasses.fields(one)
                                      if getattr(one, f.name) is not None})
    ev_model = tfcd.build_free_convection_model(ds0, fmodel.T_scaling, fmodel.wT_scaling)
    ev = tprof.free_convection_profile(ev_model, fnn, ds0, tsteps, include_embedded=True, include_kpp=False,
                                       include_tke=False)
    _close(pred, fmodel.T_scaling.scale(torch.tensor(ev["embedded_T"])), 1e-12, "FC trainer vs evaluator")


def _stages(mod):
    return [mod.CurriculumStage(tsteps=np.arange(0, 3), maxiters=2, learning_rate=1e-2, n_substeps=2),
            mod.CurriculumStage(tsteps=np.arange(0, 7, 2), maxiters=2, learning_rate=4e-3, n_substeps=4)]


def _history_close(t_hist, j_hist):
    assert len(t_hist) == len(j_hist)
    for th, jh in zip(t_hist, j_hist):
        _close(np.array([th[c] for c in CHANNELS]), np.array([float(getattr(jh, c)) for c in CHANNELS]), RTOL,
               "history")


def test_curriculum_checkpoints_and_resume_match_jax(wind, fc, tmp_path):
    """A two-stage curriculum (the second strided, with its own substeps) with a checkpoint after each stage,
    in both workloads; then each package resumes the other's train state for one more stage."""
    ds, model, nns, tds, tmodel, tnns = wind
    conf = dict(n_substeps=2, tridiag_backend="scan", training_fractions=FRACTIONS)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jout, jhist = jemb.train_embedded_wind_mixing(model, nns, ds, jnde.NDETrainConfig(**conf), stages=_stages(jnde),
                                                  checkpoint_dir=jdir)
    tout, thist = temb.train_embedded_wind_mixing(tmodel, tnns, tds, tnde.NDETrainConfig(**conf),
                                                  stages=_stages(tnde), checkpoint_dir=tdir)
    _history_close(thist, jhist)
    for p, q in zip(_leaves(tout), jax.tree.leaves(jout)):
        _close(p, q, RTOL, "weights")
    more = lambda mod: [mod.CurriculumStage(tsteps=np.arange(0, 5), maxiters=1, learning_rate=1e-2,  # noqa: E731
                                            n_substeps=2)]
    j2, jh2 = jemb.train_embedded_wind_mixing(model, nns, ds, jnde.NDETrainConfig(**conf), stages=more(jnde),
                                              resume_from=tdir)
    t2, th2 = temb.train_embedded_wind_mixing(tmodel, _port(nns), tds, tnde.NDETrainConfig(**conf),
                                              stages=more(tnde), resume_from=jdir)
    _history_close(th2, jh2)
    for p, q in zip(_leaves(t2), jax.tree.leaves(j2)):
        _close(p, q, RTOL, "resumed weights")

    ds, model, nn, fds, fmodel, fnn = fc
    conf = dict(n_substeps=2, tridiag_backend="scan")
    jdir, tdir = str(tmp_path / "fc_jax"), str(tmp_path / "fc_port")
    jout, jhist = jemb.train_embedded_free_convection(model, nn, ds, jnde.NDETrainConfig(**conf), stages=_stages(jnde),
                                                      checkpoint_dir=jdir)
    tout, thist = temb.train_embedded_free_convection(fmodel, fnn, fds, tnde.NDETrainConfig(**conf),
                                                      stages=_stages(tnde), checkpoint_dir=tdir)
    _history_close(thist, jhist)
    for p, q in zip(_leaves(tout), jax.tree.leaves(jout)):
        _close(p, q, RTOL, "fc weights")
    j2, jh2 = jemb.train_embedded_free_convection(model, nn, ds, jnde.NDETrainConfig(**conf), stages=more(jnde),
                                                  resume_from=tdir)
    t2, th2 = temb.train_embedded_free_convection(fmodel, _port(nn), fds, tnde.NDETrainConfig(**conf),
                                                  stages=more(tnde), resume_from=jdir)
    _history_close(th2, jh2)


def test_guards_match_jax(wind, fc):
    ds, model, _, tds, tmodel, _ = wind
    with pytest.raises(ValueError, match="out of range"):
        temb.embedded_training_tensors(tds, tmodel.scalings, np.arange(0, NT + 1))
    with pytest.raises(ValueError, match="pass tsteps or stages"):
        temb.train_embedded_wind_mixing(tmodel, None, tds, tnde.NDETrainConfig())
    _, _, _, fds, fmodel, _ = fc
    mixed = dataclasses.replace(fds, f=torch.tensor([1e-4, 2e-4], dtype=torch.float64))
    with pytest.raises(ValueError, match="disagree on f"):
        temb.host_from_fc_suite(fmodel, mixed)
    assert isinstance(fmodel.T_scaling, TScaling)
