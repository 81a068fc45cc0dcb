"""Port parity: the adjoint-parity study (``studies/adjoint_parity.py``) against its port.

The JAX study's stiff column (8 saves) is built by the JAX package, cast to
float64 and handed over (model, batch and MLPs through numpy), so both
studies differentiate the same problem:

- the port's counterparts of ``tests/test_adjoint_parity.py``'s three
  properties (split gradients converge with dt; rk4 is converged at coarse
  dt; the two stepper families agree at fine dt), with that test's limits;
- ``dt_refinement``'s rows and ``training_ab`` against the JAX study's, at
  ``RTOL = 1e-8`` (the same operations in the same order).

Then the f32 roundings of the tridiagonal solves (``ROADMAP.md`` queue 3,
item 3): on 2 flagship sims over the flagship window's first ``GAP_FRAMES``
frames (stride 9, 9 split substeps per save, IFT gradients, the MLPs of
``runs/wm_flagship_fold``; the suite generated by the JAX package and handed
over), the loss and gradient of the port's ``scan`` and ``pcr`` in f32 and of
JAX's ``pcr`` in f32, each against the port's ``scan`` in f64. The measured
distances are pinned; ``PYTHONPATH=. python tests/test_torch_adjoint_parity.py --frames
1153`` prints them over the whole window.
"""

import argparse
import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.data import containers as tc
from climateparameterizations_jl_tpu_torch.studies import adjoint_parity as tap
from climateparameterizations_jl_tpu_torch.studies import flagship_training as tft
from studies import adjoint_parity as jap

jcli = importlib.import_module("climateparameterizations_jl_tpu.cli.main")
jc = importlib.import_module("climateparameterizations_jl_tpu.data.containers")
jnde = importlib.import_module("climateparameterizations_jl_tpu.train.nde")
REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-8
GAP_FRAMES = 73  # 8 saves x 9 substeps: 72 split substeps of the flagship window


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * max(float(np.abs(want).max()), 1e-30))


def _to_torch(ds_jax) -> tc.ColumnTimeSeries:
    return tc.ColumnTimeSeries(**{
        f.name: None if getattr(ds_jax, f.name) is None else torch.tensor(np.asarray(getattr(ds_jax, f.name)))
        for f in dataclasses.fields(tc.ColumnTimeSeries)
    })


def _batch(jb, dtype) -> tc.TrainingBatch:
    """A JAX ``TrainingBatch`` as the port's, through numpy."""
    t = lambda a: None if a is None else torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    return tc.TrainingBatch(x0=t(jb.x0), targets=t(jb.targets), bcs=from_reference(jb.bcs, "cpu", dtype),
                            t=t(jb.t), tau=t(jb.tau), t0=t(jb.t0))


def _handed_over(jproblem, dtype):
    jmodel, jbatch, jnns = jproblem
    return from_reference(jmodel, "cpu", dtype), _batch(jbatch, dtype), from_reference(jnns, "cpu", dtype)


@pytest.fixture(scope="module")
def problem():
    """The JAX study's stiff column in float64: ``(jax (model, batch, nns), port (model, batch, nns))``."""
    jproblem = jap.to_f64(jap.build_problem(stiff=True, Nz=32, n_frames=8))
    return jproblem, _handed_over(jproblem, torch.float64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the column's small products lose more to thread hand-offs on a loaded CPU than they gain."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_split_gradient_converges_with_dt(problem):
    _, tproblem = problem
    rows, _ = tap.dt_refinement(*tproblem, substeps=(1, 4, 16), fine=64)  # the JAX test's ladder
    split = {r["n_substeps"]: r for r in rows if r["method"] == "split"}
    errs = [split[n]["grad_rel_err"] for n in (1, 4, 16)]
    assert all(np.isfinite(errs)), errs
    assert errs[0] > errs[1] > errs[2], errs  # monotone refinement
    assert errs[2] < 0.05, errs  # near the continuous-adjoint limit
    assert split[16]["grad_cosine"] > 0.999
    assert split[16]["loss_rel_err"] < 0.05


def test_rk4_gradient_converged_at_coarse_dt(problem):
    _, tproblem = problem
    L1, g1 = tap.loss_and_grad(*tproblem, "rk4", 1)
    L8, g8 = tap.loss_and_grad(*tproblem, "rk4", 8)
    a, b = tap.flat(g1), tap.flat(g8)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 0.03
    assert abs(L1 - L8) / abs(L8) < 0.01


def test_stepper_families_agree_at_fine_dt(problem):
    _, tproblem = problem
    _, g_rk4 = tap.loss_and_grad(*tproblem, "rk4", 64)
    _, g_split = tap.loss_and_grad(*tproblem, "split", 64)
    a, b = tap.flat(g_rk4), tap.flat(g_split)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.999, cos


def test_dt_refinement_matches_jax(problem):
    jproblem, tproblem = problem
    (rows, meta), (jrows, jmeta) = (study.dt_refinement(*p, substeps=(2,), fine=8)
                                    for study, p in ((tap, tproblem), (jap, jproblem)))
    assert [(r["method"], r["n_substeps"], r["dt_s"]) for r in rows] == [
        (r["method"], r["n_substeps"], r["dt_s"]) for r in jrows]
    assert all(r.keys() == j.keys() for r, j in zip(rows, jrows))
    for r, j in zip(rows, jrows):
        _close([r[k] for k in ("loss", "loss_rel_err", "grad_rel_err", "grad_cosine")],
               [j[k] for k in ("loss", "loss_rel_err", "grad_rel_err", "grad_cosine")])
        assert r["finite"] == j["finite"] is True
    _close(meta["L_star"], jmeta["L_star"])
    _close([meta["solver_agreement_at_fine"][k] for k in ("loss_rel", "grad_rel")],
           [jmeta["solver_agreement_at_fine"][k] for k in ("loss_rel", "grad_rel")])


def test_training_ab_matches_jax(problem):
    jproblem, tproblem = problem
    mine, theirs = tap.training_ab(*tproblem, maxiters=3), jap.training_ab(*jproblem, maxiters=3)
    assert mine.keys() == theirs.keys() == {"split", "rk4"}
    for method in theirs:
        assert mine[method].keys() == theirs[method].keys()
        for key in ("loss_initial", "loss_final", "loss_curve", "loss_under_fine_solver"):
            _close(mine[method][key], theirs[method][key])


def test_build_problem_and_f64_cast():
    """The port's own problem (its stand-in generated by the port, f32) against the JAX study's, and ``to_f64``."""
    jmodel, jbatch, _ = jap.build_problem(stiff=True, Nz=32, n_frames=8)
    model, batch, nns = tap.build_problem(stiff=True, Nz=32, n_frames=8, device="cpu")
    for name in ("x0", "targets", "t"):
        want = np.asarray(getattr(jbatch, name), np.float64)
        # tests/test_torch_data.py's limit for the two f32 generators: 2e-3 of the field's scale.
        np.testing.assert_allclose(getattr(batch, name).double().numpy(), want, rtol=0,
                                   atol=2e-3 * np.abs(want).max())
    for field in ("nu_0", "nu_minus", "Ri_c", "delta_Ri", "Pr"):
        assert float(getattr(model.mpp, field)) == float(getattr(jmodel.mpp, field))
    assert tuple(nns.uw.weights[0].shape) == (50, 96) and float(nns.uw.weights[0].abs().max()) < 1e-3
    m64, b64, n64 = tap.to_f64((model, batch, nns))
    assert m64.H.dtype == b64.targets.dtype == n64.wT.weights[-1].dtype == torch.float64
    assert m64.Nz == 32 and m64.zero_weights and batch.targets.dtype == torch.float32


# ---------------------------------------------------------------------------
# the f32 roundings of the tridiagonal solves (ROADMAP.md queue 3, item 3)
# ---------------------------------------------------------------------------


def precision_rows(frames: int) -> dict:
    """Each f32 solve's loss and gradient distance from the port's f64 scan, on JAX's batch of 2 flagship sims."""
    names = tft.TRAIN_FILES_STANDARD[:2]
    ds = jcli._load_suite(list(names), 32, None, frames - 1, 600.0)
    jmodel = jcli._wind_model(ds, 32)
    jnns, _ = jcli._load_nns(str(REPO / "runs" / "wm_flagship_fold"))
    jbatch = jc.training_tensors(ds, jmodel.scalings, np.arange(0, frames, 9), tau=jmodel.tau)
    model, batch, nns = _handed_over((jmodel, jbatch, jnns), torch.float32)
    rows = {r["backend"] + "_" + r["dtype"]: r for r in tap.precision_gap(model, batch, nns, 9, ("scan", "pcr"))}
    ref = rows["scan_float64"]
    _, g_ref = tap.loss_and_grad(*tap.to_f64((model, batch, nns)), "split", 9, "scan")
    g_ref = tap.flat(g_ref)

    def jax_row(backend, dtype):
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)  # noqa: E731
        jm, jb, jn = cast(jmodel), cast(jbatch), cast(jnns)
        config = jnde.NDETrainConfig(method="split", n_substeps=9, train_gradient=False, tridiag_backend=backend)
        loss, grad = jax.jit(jax.value_and_grad(
            lambda n: jnp.mean((jnde._solve(jm, n, jb, config) - jb.targets) ** 2)))(jn)
        g = jap.flat(grad)
        return dict(loss=float(loss), loss_rel_err=abs(float(loss) - ref["loss"]) / abs(ref["loss"]),
                    grad_rel_err=float(np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)))

    rows["jax_pcr_float32"] = jax_row("pcr", jnp.float32)
    return rows


def test_flagship_problem_on_the_jax_suite(monkeypatch):
    """``flagship_problem`` on the JAX package's suite (f32): the batch JAX builds, and the checkpoint's MLPs."""
    ds = jcli._load_suite(list(tft.TRAIN_FILES_STANDARD[:2]), 32, None, GAP_FRAMES - 1, 600.0)
    monkeypatch.setattr(tft, "load_suite", lambda names, Nz=32, device=None: _to_torch(ds))
    model, batch, nns = tap.flagship_problem(str(REPO / "runs" / "wm_flagship_fold"), window=GAP_FRAMES, device="cpu")
    jmodel = jcli._wind_model(ds, 32)
    jbatch = jc.training_tensors(ds, jmodel.scalings, np.arange(0, GAP_FRAMES, 9), tau=jmodel.tau)
    for name in ("x0", "targets", "t"):
        # The two packages' f32 means of T (about 19 K) differ by an ulp or two, 4e-6 in scaled units (sigma 0.39 K).
        np.testing.assert_allclose(getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)), rtol=0,
                                   atol=1e-5)
    jnns, _ = jcli._load_nns(str(REPO / "runs" / "wm_flagship_fold"))
    np.testing.assert_array_equal(tap.flat(nns), jap.flat(jnns))


def test_f32_solves_against_f64_pinned():
    """The measured distances from f64 (loss; gradient, relative to its 2-norm), pinned within a factor of 2 either
    way; the verdict of queue 3 item 3: neither pcr (port or JAX) lies further from f64 than the f32 scan does by more
    than phase 9's 1e-3."""
    rows = precision_rows(GAP_FRAMES)
    measured = {"scan_float32": (6.46e-6, 1.52e-5), "pcr_float32": (6.10e-6, 2.45e-5),
                "jax_pcr_float32": (5.29e-6, 2.33e-5)}
    for key, (loss_rel, grad_rel) in measured.items():
        row = rows[key]
        print(f"{key}: loss {row['loss']!r} rel {row['loss_rel_err']:.3e}, gradient rel {row['grad_rel_err']:.3e}")
        assert loss_rel / 2 <= row["loss_rel_err"] <= 2 * loss_rel, (key, row)
        assert grad_rel / 2 <= row["grad_rel_err"] <= 2 * grad_rel, (key, row)
    for key in ("pcr_float32", "jax_pcr_float32"):
        assert rows[key]["grad_rel_err"] <= rows["scan_float32"]["grad_rel_err"] + 1e-3


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    parser = argparse.ArgumentParser(description="print the f32 solves' distances from f64 on 2 flagship sims")
    parser.add_argument("--frames", type=int, default=GAP_FRAMES)
    for key, row in precision_rows(parser.parse_args().frames).items():
        print(key, {k: v for k, v in row.items() if k in ("loss", "loss_rel_err", "grad_rel_err", "grad_cosine")})
