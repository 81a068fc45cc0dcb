"""Adjoint-parity study on the port: fixed-step discrete gradients against the fine-step limit.

Port of ``studies/adjoint_parity.py``. The reference trains its NDEs with
adaptive solvers and a continuous interpolating adjoint; this repo trains
through fixed-step solves with gradients through the steps (the split
stepper's implicit solves by the implicit function theorem). The study
measures that substitution:

1. **dt refinement**: on a stiff mPP case (nu jumps about 300x across a
   narrow Ri transition) the loss and its gradient, for the explicit rk4 and
   the operator-split steppers, converge to the fine-step limit as dt -> 0.
   Both adjoints differentiate the same ODE, so a discrete gradient that
   converges with dt converges to the continuous adjoint's.
2. **training A/B**: train with split and with rk4 at a practical dt, then
   evaluate both under a 16x finer split solve.

Three options have no JAX counterpart. ``--dtype`` runs the study in f32 or f64
(the JAX script's ``--f32`` is ``--dtype f32``), and ``--tridiag-backend``
picks the split stepper's solve: on the card ``auto`` in f32 is the Thomas
kernel (``csrc/thomas.cu``), and f64 runs on ``scan`` (the kernel is
f32-only). ``--problem flagship`` measures, on two flagship sims over the
flagship window, each f32 backend's loss and gradient against the f64 scan
solve of the same problem (:func:`precision_gap`): how far an f32 solve lies
from f64, apart from the method error.

    python -m climateparameterizations_jl_tpu_torch.studies.adjoint_parity --device cpu --out adjoint_parity.json
    python -m climateparameterizations_jl_tpu_torch.studies.adjoint_parity --problem flagship --out precision.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device

FLAGSHIP_RUN = Path(__file__).resolve().parents[2] / "runs" / "wm_flagship_fold"


def build_problem(stiff: bool = True, Nz: int = 32, n_frames: int = 12, nns=None, device=None):
    """``(model, batch, nns)``: one synthetic wind+cooling column, ``n_frames`` saves 600 s apart, f32.

    The MLPs are drawn at the 1e-4 scale from a ``torch.Generator`` seeded
    with 7 unless ``nns`` is given (the JAX package draws other numbers).
    """
    from climateparameterizations_jl_tpu_torch.closures.mlp import wind_mixing_mlp
    from climateparameterizations_jl_tpu_torch.data.containers import (
        coarsen_dataset,
        fit_wind_mixing_scalings,
        stack_datasets,
        training_tensors,
    )
    from climateparameterizations_jl_tpu_torch.data.synthetic import synthetic_wind_mixing_les
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs, WindMixingModel
    from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

    device = resolve_device(device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    les = synthetic_wind_mixing_les(Qu=-5e-4, Qb=3e-8, Nz=64, n_save=n_frames, dt_save=600.0, n_substeps=2)
    coarse = [coarsen_dataset(les, Nz).to(device)]
    scalings = fit_wind_mixing_scalings(coarse)
    suite = stack_datasets(coarse)
    tau = torch.abs(coarse[0].t[-1] - coarse[0].t[0])
    mpp = MPPParameters.default(torch.float32, device)
    if stiff:
        # nu_minus / nu_0 ~ 300x across a narrow Ri transition: the regime the reference handles with a
        # stiff-capable adaptive solver.
        mpp = dataclasses.replace(mpp, nu_minus=f32(3e-2), nu_0=f32(1e-4), delta_Ri=f32(0.02), Ri_c=f32(0.25))
    model = WindMixingModel(
        H=coarse[0].H, tau=tau, f=coarse[0].f, g=coarse[0].g, alpha=coarse[0].alpha,
        kappa=f32(10.0), scalings=scalings, mpp=mpp, Nz=Nz, zero_weights=True,
    )
    batch = training_tensors(suite, scalings, tsteps=np.arange(0, n_frames), tau=tau)
    if nns is None:
        gen = torch.Generator().manual_seed(7)
        nns = FluxNNs(*(wind_mixing_mlp(gen, Nz, scale=1e-4, device=device) for _ in range(3)))
    return model, batch, nns


def flagship_problem(checkpoint: str, window: int = 1153, device=None):
    """``(model, batch, nns)``: the first two flagship training sims over ``arange(0, window, 9)``.

    The suite is the flagship study's (``N_FRAMES`` frames, its synthetic
    stand-ins), the model is fitted on it over the default mPP base, and the
    MLPs are ``checkpoint``'s. Solved at 9 substeps per save, this is the
    flagship step's window (``1:9:1153``), where the f32 solves' distance
    from f64 matters.
    """
    from climateparameterizations_jl_tpu_torch.cli.main import _wind_model
    from climateparameterizations_jl_tpu_torch.data.containers import training_tensors
    from climateparameterizations_jl_tpu_torch.studies import flagship_training as fst
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_flux_nns

    device = resolve_device(device)
    ds = fst.load_suite(fst.TRAIN_FILES[:2], device=device)
    model = _wind_model(ds, ds.Nz)
    batch = training_tensors(ds, model.scalings, np.arange(0, window, 9), tau=model.tau)
    return model, batch, load_flux_nns(checkpoint, device=device)


def _with_leaves(tree, fn):
    """``tree`` (a model, batch or closure) with each floating tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_with_leaves(x, fn) for x in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _with_leaves(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_leaves(x, fn) for x in tree)
    return tree


def loss_and_grad(model, batch, nns, method: str, n_substeps: int, tridiag_backend: str = "auto", weights=None):
    """``(loss, gradient)``: the plain trajectory MSE and its gradient in every MLP tensor (a list, in
    ``nn_parameters`` order), through the ``method`` solve at ``n_substeps`` per save.

    With ``weights`` (a ``LossChannels`` of channel weights) the loss is the
    training loss instead: the six channels (profiles and their vertical
    gradients) weighted by ``weights``.
    """
    from climateparameterizations_jl_tpu_torch.train.loss import apply_loss_scalings, nde_loss_channels
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, _solve, nn_parameters

    config = NDETrainConfig(method=method, n_substeps=n_substeps, train_gradient=False,
                            tridiag_backend=tridiag_backend)
    nns = _with_leaves(nns, lambda x: x.detach().clone().requires_grad_(True))
    params = nn_parameters(nns)
    pred = _solve(model, nns, batch, config)
    if weights is None:
        loss = torch.mean((pred - batch.targets) ** 2)
    else:
        loss = apply_loss_scalings(nde_loss_channels(pred, batch.targets, model.Nz), weights).total()
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), list(grads)


def flat(tree):
    """Every leaf of a gradient list or a closure, raveled into one f64 vector."""
    from climateparameterizations_jl_tpu_torch.train.nde import nn_parameters

    leaves = tree if isinstance(tree, list) else nn_parameters(tree)
    return np.concatenate([x.detach().cpu().double().numpy().ravel() for x in leaves if x is not None])


def _errors(L, g, L_ref, g_ref) -> dict:
    finite = bool(np.isfinite(L) and np.isfinite(g).all())
    return dict(
        loss_rel_err=abs(L - L_ref) / abs(L_ref) if finite else float("inf"),
        grad_rel_err=float(np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)) if finite else float("inf"),
        grad_cosine=float(g @ g_ref / (np.linalg.norm(g) * np.linalg.norm(g_ref))) if finite else float("nan"),
        finite=finite,
    )


def dt_refinement(model, batch, nns, substeps=(1, 2, 4, 8, 16, 32), fine: int = 256, tridiag_backend: str = "auto"):
    """Loss and gradient error against the fine-step limit, for rk4 and split, at each ``substeps`` count.

    The limit is the split stepper at ``fine`` substeps (A-stable on the stiff
    diffusion); rk4 at that dt is recorded beside it. ``tridiag_backend`` is
    the split stepper's solve.
    """
    rows = []
    L_star, g_star = loss_and_grad(model, batch, nns, "split", fine, tridiag_backend)
    g_star = flat(g_star)
    L_rk4_fine, g_rk4_fine = loss_and_grad(model, batch, nns, "rk4", fine)
    agree = dict(
        loss_rel=abs(L_rk4_fine - L_star) / abs(L_star),
        grad_rel=float(np.linalg.norm(flat(g_rk4_fine) - g_star) / np.linalg.norm(g_star)),
    )
    for n in substeps:
        for method in ("rk4", "split"):
            L, g = loss_and_grad(model, batch, nns, method, n, tridiag_backend)
            errs = _errors(L, flat(g), L_star, g_star)
            rows.append(dict(method=method, n_substeps=n, dt_s=600.0 / n, loss=L, **errs))
    return rows, dict(L_star=L_star, solver_agreement_at_fine=agree)


FLAGSHIP_FRACTIONS = {"T": 0.8, "dTdz": 0.8, "profile": 0.5}


def precision_gap(model, batch, nns, n_substeps: int, backends=("scan", "pcr"), method: str = "split",
                  loss: str = "trajectory") -> list:
    """Each f32 backend's loss and gradient against the f64 scan solve of the same problem.

    ``model``, ``batch`` and ``nns`` are given in f32; the reference casts
    them to f64 and solves on ``scan``. One row per backend (``"cuda"``: the
    Thomas kernel, on the card), then the f64 reference row. ``loss``:
    ``"trajectory"`` (the study's plain MSE) or ``"flagship"`` (the training
    loss of the flagship step: six channels, auto-balanced to the flagship
    fractions by one f64 pre-solve, the same weights for every backend).
    """
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, determine_loss_scalings

    ref = to_f64((model, batch, nns))
    weights64 = weights32 = None
    if loss == "flagship":
        config = NDETrainConfig(method=method, n_substeps=n_substeps, training_fractions=FLAGSHIP_FRACTIONS,
                                tridiag_backend="scan")
        weights64 = determine_loss_scalings(ref[0], ref[2], ref[1], config)
        weights32 = _with_leaves(weights64, lambda x: x.float())
    elif loss != "trajectory":
        raise ValueError(f"unknown loss {loss!r} (expected 'trajectory' or 'flagship')")
    L_ref, g_ref = loss_and_grad(*ref, method, n_substeps, "scan", weights64)
    g_ref = flat(g_ref)
    rows = []
    for backend in backends:
        L, g = loss_and_grad(model, batch, nns, method, n_substeps, backend, weights32)
        rows.append(dict(backend=backend, dtype="float32", n_substeps=n_substeps, loss_kind=loss, loss=L,
                         **_errors(L, flat(g), L_ref, g_ref)))
    rows.append(dict(backend="scan", dtype="float64", n_substeps=n_substeps, loss_kind=loss, loss=L_ref))
    return rows


def training_ab(model, batch, nns, maxiters: int = 150, lr: float = 3e-3, tridiag_backend: str = "auto"):
    """Train with split and with rk4 at 4 substeps; evaluate both under a 64-substep split solve."""
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, _solve, train_wind_mixing_nde

    out, trained = {}, {}
    for method, n_sub in (("split", 4), ("rk4", 4)):
        config = NDETrainConfig(learning_rate=lr, maxiters=maxiters, n_substeps=n_sub, method=method,
                                train_gradient=False, tridiag_backend=tridiag_backend)
        nns_t, hist = train_wind_mixing_nde(model, _with_leaves(nns, lambda x: x.detach().clone()), batch, config)
        trained[method] = nns_t
        totals = [sum(h.values()) for h in hist]
        out[method] = dict(loss_initial=totals[0], loss_final=totals[-1],
                           loss_curve=totals[:: max(1, maxiters // 30)])
    fine = NDETrainConfig(method="split", n_substeps=64, train_gradient=False, tridiag_backend=tridiag_backend)
    with torch.no_grad():
        for method, nns_t in trained.items():
            pred = _solve(model, nns_t, batch, fine)
            out[method]["loss_under_fine_solver"] = float(torch.mean((pred - batch.targets) ** 2))
    return out


def to_f64(tree):
    """Every floating tensor of ``tree`` cast to f64: isolates the method error from f32 rounding."""
    return _with_leaves(tree, lambda x: x.double())


def _sanitize(o):
    """Non-finite floats as null: bare Infinity / NaN tokens are not valid JSON."""
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_sanitize(v) for v in o]
    return None if isinstance(o, float) and not np.isfinite(o) else o


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' runs on the CPU)")
    ap.add_argument("--out", default="adjoint_parity.json")
    ap.add_argument("--maxiters", type=int, default=150)
    ap.add_argument("--dtype", default="f64", choices=["f32", "f64"],
                    help="f64 (default) isolates the method error; f32 is the production precision")
    ap.add_argument("--f32", action="store_true", help="the JAX script's spelling of --dtype f32")
    ap.add_argument("--tridiag-backend", default="auto", choices=["auto", "scan", "pcr", "cuda"],
                    help="the split stepper's solve; auto: the Thomas kernel for f32 on the card, scan otherwise")
    ap.add_argument("--problem", default="stiff", choices=["stiff", "flagship"],
                    help="stiff: the study's column (refinement, training A/B; --maxiters 0 skips the A/B); "
                         "flagship: the first two flagship sims over 1:9:1153 with the MLPs of runs/wm_flagship_fold, "
                         "each f32 solve against the f64 scan (precision_gap) in the study's and the training loss")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = "f32" if args.f32 else args.dtype
    backend = args.tridiag_backend
    if backend == "auto" and dtype == "f64":
        backend = "scan"  # the Thomas kernel is f32-only

    if args.problem == "flagship":
        backends = ("scan", "pcr") + (("cuda",) if device.type == "cuda" else ())
        problem = flagship_problem(str(FLAGSHIP_RUN), device=device)
        report = dict(problem="flagship", window=1153, checkpoint=str(FLAGSHIP_RUN),
                      precision_gap=[row for loss in ("trajectory", "flagship")
                                     for row in precision_gap(*problem, 9, backends, loss=loss)])
        with open(args.out, "w") as f:
            json.dump(_sanitize(report), f, indent=2)
        _print_gap(report["precision_gap"])
        return report
    model, batch, nns = build_problem(stiff=True, device=device)
    if dtype == "f64":
        model, batch, nns = to_f64((model, batch, nns))
    rows, meta = dt_refinement(model, batch, nns, tridiag_backend=backend)
    meta.update(dtype=dtype, tridiag_backend=backend, device=str(device))
    ab = training_ab(model, batch, nns, maxiters=args.maxiters, tridiag_backend=backend) if args.maxiters else {}
    report = dict(refinement=rows, meta=meta, training_ab=ab)
    with open(args.out, "w") as f:
        json.dump(_sanitize(report), f, indent=2)

    print(f"fine-limit loss {meta['L_star']:.6e}; rk4/split agreement at fine dt: {meta['solver_agreement_at_fine']}")
    print(f"{'method':>6} {'n_sub':>5} {'dt[s]':>7} {'|dL|/L*':>10} {'|dg|/|g*|':>10} {'cos':>7}")
    for r in rows:
        print(f"{r['method']:>6} {r['n_substeps']:>5} {r['dt_s']:>7.1f} {r['loss_rel_err']:>10.2e} "
              f"{r['grad_rel_err']:>10.2e} {r['grad_cosine']:>7.4f}")
    for m, d in ab.items():
        print(f"train[{m}]: {d['loss_initial']:.4e} -> {d['loss_final']:.4e} "
              f"(under fine solver: {d['loss_under_fine_solver']:.4e})")
    _print_gap(report.get("precision_gap", []))
    return report


def _print_gap(rows):
    for r in rows:
        if r["dtype"] == "float32":
            print(f"precision[{r['backend']} f32 vs scan f64 at {r['n_substeps']} substeps, {r['loss_kind']} loss]: "
                  f"loss {r['loss']!r} rel "
                  f"{r['loss_rel_err']:.3e}, gradient rel {r['grad_rel_err']:.3e}, cosine {r['grad_cosine']!r}")


if __name__ == "__main__":
    main()
