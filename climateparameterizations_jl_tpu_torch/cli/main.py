"""Command-line interface, partial port of ``climateparameterizations_jl_tpu/cli/main.py``.

The subcommand ported so far is ``train-gp`` (:func:`cmd_train_gp`):

    python -m climateparameterizations_jl_tpu_torch.cli train-gp --sims strong_wind \
        --test-sims strong_wind_weak_cooling --fluxes wT --output runs/gp

It runs on the card unless ``--device cpu`` is given (the JAX package's
``--platform`` flag). The helpers of the training path
(:func:`_suite_diurnal_flags`, :func:`_load_suite`, :func:`_wind_model`)
live here too; the other subcommands are later work (``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device


def _sims(arg: str) -> list[str]:
    return [s.strip() for s in arg.split(",") if s.strip()]


def _suite_diurnal_flags(names) -> list:
    from climateparameterizations_jl_tpu_torch.data.registry import simulation_parameters

    flags = []
    for n in names:
        try:
            flags.append(bool(simulation_parameters(n).diurnal))
        except KeyError:
            flags.append(False)
    return flags


def _load_suite(names, Nz: int, data_dir=None, n_save=288, dt_save=600.0, Nz_les=128, device=None):
    """The coarse suite of catalog ``names``, stacked on a leading axis, on ``device``.

    The synthetic stand-ins are generated on the CPU (``data/synthetic.py``)
    and moved to ``device`` (``cuda`` unless the caller asks for the CPU) at
    the end. Members that share the generator's column (``f``, ``H``,
    ``alpha``, ``g``, grid and diurnal flag) run as one batched split solve
    instead of one solve each. Diurnal members keep their time-varying top
    ``wT`` face; the others have their surface fluxes pinned.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import (
        coarsen_dataset,
        enforce_surface_fluxes,
        stack_datasets,
    )
    from climateparameterizations_jl_tpu_torch.data.registry import (
        require_synthetic,
        signed_momentum_flux,
        simulation_parameters,
    )
    from climateparameterizations_jl_tpu_torch.data.synthetic import _synthetic_wind_mixing_les_batch

    device = resolve_device(device)
    require_synthetic(data_dir)
    specs = [simulation_parameters(n) for n in names]
    groups: dict = {}
    for i, spec in enumerate(specs):
        groups.setdefault((spec.f, spec.diurnal), []).append(i)
    raw = [None] * len(names)
    for (f, diurnal), members in groups.items():
        generated = _synthetic_wind_mixing_les_batch(
            [signed_momentum_flux(specs[i]) for i in members], [specs[i].Qb for i in members],
            f=f, diurnal=diurnal, Nz=Nz_les, n_save=n_save, dt_save=dt_save,
        )
        for i, ds in zip(members, generated):
            raw[i] = ds
    datasets = []
    for ds, spec in zip(raw, specs):
        ds = coarsen_dataset(ds, Nz)
        datasets.append(ds if spec.diurnal else enforce_surface_fluxes(ds))
    suite = stack_datasets(datasets) if len(datasets) > 1 else datasets[0]
    return suite.to(device)


def _wind_model(ds, Nz: int, **overrides):
    """The wind-mixing model of a (stacked) suite, on the suite's device.

    Scalings are fitted on the suite; ``tau`` is its time span; the mPP
    parameters are the defaults. ``overrides`` replace any field.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import fit_wind_mixing_scalings
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import WindMixingModel
    from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

    device = ds.T.device
    scalings = fit_wind_mixing_scalings(ds)
    first = lambda x: x.reshape(-1)[0]  # noqa: E731 - suite-stacked constants are identical
    t_row = ds.t.reshape(-1, ds.t.shape[-1])[0]
    kw = dict(
        H=first(ds.H), tau=torch.abs(t_row[-1] - t_row[0]), f=first(ds.f), g=first(ds.g),
        alpha=first(ds.alpha), kappa=torch.tensor(10.0, dtype=torch.float32, device=device), scalings=scalings,
        mpp=MPPParameters.default(torch.float32, device), Nz=Nz,
    )
    kw.update(overrides)
    return WindMixingModel(**kw)


def _select_sims(ds, keep):
    """The members ``keep`` (an index array or an int) of a suite stacked on its leading axis."""
    return dataclasses.replace(ds, **{
        f.name: getattr(ds, f.name)[keep] for f in dataclasses.fields(ds) if getattr(ds, f.name) is not None
    })


def cmd_train_gp(args) -> int:
    """GP kernel grid search, optional ML-II refinement, fused fit, test MSE and posterior variance.

    The JAX package's ``train-gp``: kernel selection never sees the test
    set (``--val-sims``, else leave-one-out over ``--sims``, else a tail
    split of the training pairs); ``--optimize-hyperparams`` refines the
    grid winner by ML-II with ``--gram-backend`` (``cuda``: the fused Gram
    kernel, f32); the final fits share predictors (``gp_fit_multi``);
    ``--integrate`` also runs the GP-closure DE on the test sim. Writes
    ``gp_report.json`` with the JAX command's keys; the uncertainty plots
    (``gp_uncertainty_<flux>.png``) are not drawn (``ROADMAP.md``).
    """
    from climateparameterizations_jl_tpu_torch.closures.gp import (
        GPKernel,
        error_per_gamma,
        gp_fit_multi,
        gp_predict,
        gp_uncertainty,
        optimize_kernel_hyperparameters,
        select_best_kernel,
    )
    from climateparameterizations_jl_tpu_torch.data.containers import (
        direct_regression_pairs,
        fit_wind_mixing_scalings,
        scaled_state_array,
    )

    device = resolve_device(args.device)
    train_names = _sims(args.sims)
    train_ds = _load_suite(train_names, args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
    test_ds = _load_suite(_sims(args.test_sims), args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
    scalings = fit_wind_mixing_scalings(train_ds)
    z = torch.linspace(0.0, 1.0, 3 * args.nz, dtype=torch.float64, device=device)
    kernel_ids = tuple(int(k) for k in _sims(args.kernel_ids))
    log_gammas = np.linspace(-1.5, 1.5, 10)
    os.makedirs(args.output, exist_ok=True)
    report = {}
    fluxes = list(_sims(args.fluxes))
    # --integrate needs all three flux GPs; fit the union once.
    fit_fluxes = sorted(set(fluxes) | ({"uw", "vw", "wT"} if args.integrate else set()))

    def _sub(x, y):
        return (x[:: args.subsample], y[:: args.subsample]) if args.subsample > 1 else (x, y)

    if args.val_sims:
        val_ds = _load_suite(_sims(args.val_sims), args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
        splits = [(train_ds, scalings, val_ds)]
    elif len(train_names) > 1:
        splits = []
        for i in range(len(train_names)):
            sub_ds = _select_sims(train_ds, torch.tensor([j for j in range(len(train_names)) if j != i]))
            splits.append((sub_ds, fit_wind_mixing_scalings(sub_ds), _select_sims(train_ds, i)))
    else:
        splits = None

    selected, x_by_flux, y_by_flux, test_pairs = {}, {}, {}, {}
    for flux in fit_fluxes:
        x_tr, y_tr = _sub(*direct_regression_pairs(train_ds, scalings, flux))
        test_pairs[flux] = direct_regression_pairs(test_ds, scalings, flux)
        errors = {kid: np.zeros(len(log_gammas)) for kid in kernel_ids}
        if splits is None:
            n_val = max(1, int(0.2 * x_tr.shape[0]))
            sel_sets = [(x_tr[:-n_val], y_tr[:-n_val], x_tr[-n_val:], y_tr[-n_val:])]
        else:
            sel_sets = [
                (*_sub(*direct_regression_pairs(sub_ds, sub_scl, flux)), *direct_regression_pairs(held_ds, sub_scl, flux))
                for sub_ds, sub_scl, held_ds in splits
            ]
        for xs, ys, xv, yv in sel_sets:
            for kid in kernel_ids:
                errors[kid] += np.asarray(error_per_gamma(xs, ys, xv, yv, z, kid, log_gammas, args.metric))
        kernel, _ = select_best_kernel(errors, log_gammas, args.metric, 0.0, x_tr.dtype, device=device)
        if args.optimize_hyperparams:
            # ML-II refinement of the grid winner through the Cholesky; only a
            # GPKernel has a Gram backend (the spectral mixture stays plain).
            if isinstance(kernel, GPKernel):
                kernel = dataclasses.replace(kernel, backend=args.gram_backend)
            kernel, ml_losses = optimize_kernel_hyperparameters(x_tr, y_tr, kernel, z, iters=args.hyperopt_iters)
            if isinstance(kernel, GPKernel):
                kernel = dataclasses.replace(kernel, backend="plain")
            print(f"train-gp[{flux}]: ML-II {ml_losses[0]:.4e} -> {ml_losses[-1]:.4e} ({args.hyperopt_iters} iters)")
        selected[flux] = kernel
        x_by_flux[flux], y_by_flux[flux] = x_tr, y_tr
    models = gp_fit_multi(
        x_by_flux[fit_fluxes[0]], [y_by_flux[f] for f in fit_fluxes], [selected[f] for f in fit_fluxes], z,
    ) if fit_fluxes else []
    fitted = dict(zip(fit_fluxes, models))
    for flux, model in fitted.items():
        if flux not in fluxes:
            continue
        kernel = selected[flux]
        x_te, y_te = test_pairs[flux]
        mse = float(torch.mean((gp_predict(model, x_te) - y_te) ** 2))
        unc = gp_uncertainty(model, x_te)
        name = kernel.family if isinstance(kernel, GPKernel) else "spectral_mixture"
        report[flux] = {"kernel": name, "mse": mse, "mean_posterior_variance": float(torch.mean(unc)),
                        "max_posterior_variance": float(torch.max(unc))}
        if isinstance(kernel, GPKernel):
            report[flux]["log_gamma"] = float(torch.log10(kernel.gamma))
        print(f"train-gp[{flux}]: kernel {name}, mse {mse:.4e}, "
              f"mean posterior var {report[flux]['mean_posterior_variance']:.3e}")

    if args.integrate:
        # The GP-closure DE on the held-out sim (run_GP_DE.jl:181-192).
        from climateparameterizations_jl_tpu_torch.models.gp_closure import FluxGPs, solve_gp_closure

        model = _wind_model(train_ds, args.nz)
        x_true = scaled_state_array(test_ds, scalings)
        x_true = x_true.reshape(-1, x_true.shape[-2], x_true.shape[-1])[0]
        n_frames = min(args.n_integrate_steps, x_true.shape[0] - 1)
        t_row = test_ds.t.reshape(-1, test_ds.t.shape[-1])[0]
        dt_hat = float((t_row[1] - t_row[0]) / model.tau)
        gps = FluxGPs(**{flux: fitted[flux] for flux in ("uw", "vw", "wT")})
        traj = solve_gp_closure(model, gps, x_true[0], 0.0, dt_hat, n_frames, n_substeps=args.n_substeps)
        de_mse = float(torch.mean((traj - x_true[: n_frames + 1]) ** 2))
        report["gp_de"] = {"trajectory_mse": de_mse, "frames": int(n_frames + 1)}
        print(f"train-gp[DE]: trajectory mse {de_mse:.4e}")

    with open(os.path.join(args.output, "gp_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return 0


def _add_common(p):
    p.add_argument("--sims", default="strong_wind", help="comma-separated catalog names")
    p.add_argument("--data-dir", default=None, help="root of local LESbrary .jld2 files (not ported: must be unset)")
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--n-save", type=int, default=96, help="LES frames to generate")
    p.add_argument("--dt-save", type=float, default=600.0)
    p.add_argument("--output", default="runs/latest")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="climateparameterizations_jl_tpu_torch", description=__doc__)
    parser.add_argument("--device", default=None, help="torch device (default: cuda; pass cpu to run on the CPU)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train-gp", help="GP kernel grid search + fit + test MSE")
    _add_common(p)
    p.add_argument("--test-sims", default="strong_wind_weak_cooling")
    p.add_argument("--val-sims", default=None,
                   help="sims for kernel selection; default: leave-one-out over --sims (never the test set)")
    p.add_argument("--kernel-ids", default="1,2,3,4", help="kernel families to sweep (1-5 stationary, 6 spectral-mixture)")
    p.add_argument("--fluxes", default="wT")
    p.add_argument("--metric", default="euclidean", choices=["euclidean", "derivative", "antiderivative"])
    p.add_argument("--subsample", type=int, default=4)
    p.add_argument("--integrate", action="store_true", help="also integrate the GP-closure DE on the test sim")
    p.add_argument("--optimize-hyperparams", action="store_true",
                   help="ML-II refine the grid-selected kernel (gradient through the Cholesky)")
    p.add_argument("--hyperopt-iters", type=int, default=80)
    p.add_argument("--gram-backend", default="plain", choices=["plain", "cuda"],
                   help="Gram backend for the ML-II loop (cuda = the fused Gram kernel with its analytic backward, f32)")
    p.add_argument("--n-integrate-steps", type=int, default=32)
    p.add_argument("--n-substeps", type=int, default=4)
    p.set_defaults(fn=cmd_train_gp)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
