"""Reference-scale flagship NDE training on the port.

Port of ``studies/flagship_training.py``. It reproduces the reference's
flagship wind-mixing run at full problem scale
(``wind_mixing/train_NDE_args.jl``): the 18-simulation wind+cooling /
wind+heating suite, 8-day simulations saved every 600 s (1,153 frames),
trained through the coupled triple-MLP NDE over the mPP base closure with
the auto-balanced 6-channel loss (T = 0.8, dT/dz = 0.8, profile = 0.5),
zero-weights BCs and curriculum staging to the full ``1:9:1153`` window.
Each stage keeps the inner step at 600 s (stride-s saves, s substeps), so
the final stages integrate all 1,152 inner steps per iteration and
simulation. On the card every implicit solve is one launch of the Thomas
kernel (``csrc/thomas.cu``), forward and in the IFT backward pass.

Modes (those of the JAX script):

- ``--mode train``: pretraining, optional mPP calibration (``--calibrate-mpp``),
  the curriculum (solo, or ``--ensemble K``), the held-out evaluation against
  mPP and KPP, optionally the a-posteriori stage (``--finish-aposteriori``);
  ``--eval-checkpoint DIR`` evaluates a saved run instead;
- ``--mode step-bench``: one final-stage training step timed on the card
  (``benchmarks.bench_train_step``);
- ``--mode aposteriori``: fine-tune a checkpoint through the embedded host
  column, with the held-out embedded evaluation before and after;
- ``--mode embedded-eval``: that evaluation alone, at any host substep count.

``--device`` takes the place of the JAX ``--platform``: the card unless
``--device cpu`` is given. ``--out`` writes JSON with the JAX script's keys.
Two flags have no JAX counterpart: ``--stages`` runs a subset of the
curriculum and ``--init-from`` starts it from a saved solo checkpoint, so one
curriculum can be split over several processes at stage boundaries (each
stage starts a fresh optimizer, so a split run equals an unsplit one)::

    python -m climateparameterizations_jl_tpu_torch.studies.flagship_training --mode train \\
        --out flagship.json --save-nns runs/wm_flagship_port
    python -m climateparameterizations_jl_tpu_torch.studies.flagship_training --device cpu \\
        --eval-checkpoint runs/wm_flagship_fold --out eval.json

The suite lists, ``N_FRAMES``, ``STAGES`` and ``DATA_DIR`` are module globals,
read when a function runs, as in the JAX script (``main`` sets them from its
flags). Unlike the JAX script, ``nde_train`` and ``nde_train_ensemble`` read
``STAGES`` when called, so ``--smoke`` shortens the stages it names.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device

TRAIN_FILES = [  # train_NDE_args.jl:39-59
    "wind_-5e-4_cooling_3e-8_new", "wind_-5e-4_cooling_1e-8_new",
    "wind_-2e-4_cooling_3e-8_new", "wind_-2e-4_cooling_1e-8_new",
    "wind_-5e-4_heating_-3e-8_new", "wind_-2e-4_heating_-1e-8_new",
    "wind_-2e-4_heating_-3e-8_new", "wind_-5e-4_heating_-1e-8_new",
    "wind_-3.5e-4_cooling_2e-8_new", "wind_-3.5e-4_heating_-2e-8_new",
    "wind_-5e-4_cooling_2e-8_new", "wind_-3.5e-4_cooling_3e-8_new",
    "wind_-3.5e-4_cooling_1e-8_new", "wind_-2e-4_cooling_2e-8_new",
    "wind_-3.5e-4_heating_-3e-8_new", "wind_-3.5e-4_heating_-1e-8_new",
    "wind_-2e-4_heating_-2e-8_new", "wind_-5e-4_heating_-2e-8_new",
]
# Held-out: interpolation members of the same forcing grids.
TEST_FILES = ["wind_-4.5e-4_cooling_2.5e-8", "wind_-2.5e-4_cooling_1.5e-8", "wind_-4.5e-4_heating_-2.5e-8"]

# --suite diurnal: the 8-day wind x diurnal-amplitude grid; held-out interpolation members of both axes.
TRAIN_FILES_DIURNAL = [
    f"wind_{w}_diurnal_{c}"
    for w in ("-5e-4", "-3.5e-4", "-2e-4")
    for c in ("1e-8", "2e-8", "3e-8", "3.5e-8", "5e-8")
]
TEST_FILES_DIURNAL = ["wind_-4.5e-4_diurnal_4e-8", "wind_-3e-4_diurnal_2e-8", "wind_-2e-4_diurnal_4e-8"]

# Frozen copies of the standard suite: main() resolves --suite / --extra-train from them on every call.
# --suite mixed trains both families as one run (per-sim diurnal amplitudes).
TRAIN_FILES_STANDARD = tuple(TRAIN_FILES)
TEST_FILES_STANDARD = tuple(TEST_FILES)

N_FRAMES = 1153  # 8 days at 600 s saves
# (window, stride, maxiters, lr), dt = stride * 600 / n_substeps = 600 s. The final stage is the reference's
# 1:9:1153 x 130 iterations (train_NDE_args.jl:196-198) followed by a decayed-lr burn-in on the same window.
STAGES = [(200, 20, 150, 1e-2), (577, 12, 100, 3e-3), (1153, 9, 130, 1e-3), (1153, 9, 200, 2e-4)]
FRACTIONS = {"T": 0.8, "dTdz": 0.8, "profile": 0.5}

# --data-dir: reference-layout .jld2 files instead of the synthetic stand-ins.
DATA_DIR = None


def load_suite(names, Nz=32, device=None):
    """The coarse suite of ``names`` at ``N_FRAMES`` frames, on ``device`` (``cli/main.py::_load_suite``).

    With ``DATA_DIR`` set, every member must have its file there: falling
    back to a synthetic stand-in would fake the provenance.
    """
    from climateparameterizations_jl_tpu_torch.cli.main import _load_suite

    if DATA_DIR is not None:
        from climateparameterizations_jl_tpu_torch.data.registry import lesbrary_relative_path

        missing = [n for n in names if not os.path.exists(os.path.join(DATA_DIR, lesbrary_relative_path(n)))]
        if missing:
            raise SystemExit(
                f"--data-dir {DATA_DIR}: {len(missing)} suite members missing "
                f"(e.g. {missing[0]}); generate them with studies/generate_wm_les.sh "
                "— silently falling back to synthetic stand-ins would fake the provenance"
            )
    return _load_suite(names, Nz, DATA_DIR, N_FRAMES - 1, 600.0, device=device)


def _draw_nns(generator: torch.Generator, Nz: int, device):
    from climateparameterizations_jl_tpu_torch.closures.mlp import wind_mixing_mlp
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs

    return FluxNNs(*(wind_mixing_mlp(generator, Nz, scale=1e-5, device=device) for _ in range(3)))


def build(Nz=32, seed=0, diurnal=False, nns=None, device=None):
    """``(suite, model, nns)`` of the training suite.

    The MLPs are drawn at the reference's 1e-5 scale from a
    ``torch.Generator`` seeded with ``seed``, unless ``nns`` is given (e.g.
    weights carried over from the JAX package by ``bridge.from_reference``:
    the two packages' generators draw different numbers).
    """
    from climateparameterizations_jl_tpu_torch.cli.main import _wind_model

    ds = load_suite(TRAIN_FILES, Nz, resolve_device(device))
    model = _wind_model(ds, Nz, diurnal=diurnal)
    if nns is None:
        nns = _draw_nns(torch.Generator().manual_seed(seed), Nz, ds.T.device)
    return ds, model, nns


def pretrain(ds, model, nns, epochs=150, lr=1e-3):
    """Full-batch flux pre-training on (state -> flux) pairs, per flux MLP."""
    from climateparameterizations_jl_tpu_torch.data.containers import direct_regression_pairs
    from climateparameterizations_jl_tpu_torch.train.nn import train_flux_nn

    out = {}
    t0 = time.perf_counter()
    for flux in ("uw", "vw", "wT"):
        x, y = direct_regression_pairs(ds, model.scalings, flux)
        nn, hist = train_flux_nn(getattr(nns, flux), x, y, learning_rate=lr, epochs=epochs)
        nns = nns._replace(**{flux: nn})
        out[flux] = (float(hist[0]), float(hist[-1]))
    return nns, out, time.perf_counter() - t0


def calibrate_mpp(ds, model, optimizer="lbfgs", maxiters=60, window=200, stride=20):
    """Calibrate the 5 mPP parameters on the training suite (the reference's pipeline order).

    The window is cut to ``N_FRAMES`` where the suite is shorter.
    ``torch.optim.LBFGS`` takes the place of ``optax.lbfgs``: another line
    search, so other iterates toward the same minimum.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import training_tensors
    from climateparameterizations_jl_tpu_torch.train.mpp_calibration import optimise_mpp_parameters
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    t0 = time.perf_counter()
    config = NDETrainConfig(
        learning_rate=0.05, maxiters=maxiters, n_substeps=stride, method="split",
        train_gradient=False, optimizer=optimizer,
    )
    batch = training_tensors(ds, model.scalings, np.arange(0, min(window, N_FRAMES), stride), tau=model.tau)
    fitted, history = optimise_mpp_parameters(model, batch, config)
    info = dict(
        optimizer=optimizer, loss_initial=history[0][0], loss_final=min(h[0] for h in history),
        wall_s=time.perf_counter() - t0,
        params={k: float(getattr(fitted, k)) for k in ("nu_0", "nu_minus", "delta_Ri", "Ri_c", "Pr")},
    )
    return dataclasses.replace(model, mpp=fitted), info


def _stage_batch(ds, model, i, n_stages, window, stride, shooting, shooting_hybrid):
    """``(batch, K)`` of one stage: K windows (multiple shooting) where K divides a full-window stage's intervals."""
    from climateparameterizations_jl_tpu_torch.data.containers import multiple_shooting_tensors, training_tensors

    tsteps = np.arange(0, window, stride)
    K = shooting if (shooting and window == N_FRAMES and (len(tsteps) - 1) % shooting == 0) else 0
    if shooting_hybrid and i == n_stages - 1:
        K = 0  # a sequential final burn-in restores the rollout objective
    if K:
        return multiple_shooting_tensors(ds, model.scalings, tsteps, K, tau=model.tau), tsteps, K
    return training_tensors(ds, model.scalings, tsteps, tau=model.tau), tsteps, K


def _totals(history) -> list:
    return [sum(h.values()) for h in history]


def nde_train(ds, model, nns, stages=None, fractions=FRACTIONS, tridiag_backend="auto", fast_assembly="auto",
              shooting=0, shooting_hybrid=False, host_matched_substeps=False):
    """The curriculum, one ``train_wind_mixing_nde`` call per stage (``stages``: ``STAGES`` when None).

    The optimizer starts fresh at each stage, as the reference's flagship
    scripts build one per stage. ``host_matched_substeps`` trains at the
    embedded host's dt (about 540 s: 10 substeps per stride-9 save);
    ``shooting`` K splits each full-window stage into K truth-anchored
    windows on the batch axis (``shooting_hybrid``: not the last stage).
    """
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, train_wind_mixing_nde

    stages = STAGES if stages is None else stages
    report = []
    for i, (window, stride, maxiters, lr) in enumerate(stages):
        n_sub = max(stride + 1, round(stride * 10 / 9)) if host_matched_substeps else stride
        config = NDETrainConfig(
            learning_rate=lr, maxiters=maxiters, n_substeps=n_sub, method="split",
            training_fractions=fractions, tridiag_backend=tridiag_backend, fast_assembly=fast_assembly,
        )
        batch, tsteps, K = _stage_batch(ds, model, i, len(stages), window, stride, shooting, shooting_hybrid)
        t0 = time.perf_counter()
        nns, hist = train_wind_mixing_nde(model, nns, batch, config)
        wall = time.perf_counter() - t0
        totals = _totals(hist)
        inner = int((len(tsteps) - 1) * stride)
        report.append(dict(
            window=window, stride=stride, maxiters=maxiters, lr=lr, shooting=K,
            n_saveat=len(tsteps), inner_steps=inner // K if K else inner,
            loss_initial=totals[0], loss_final=totals[-1],
            wall_s=wall, s_per_iter=wall / maxiters,
            loss_curve=totals[:: max(1, maxiters // 25)],
        ))
        print(f"stage window={window} stride={stride}{f' shooting={K}' if K else ''}: "
              f"{report[-1]['loss_initial']:.4e} -> "
              f"{report[-1]['loss_final']:.4e} in {wall:.1f} s ({wall / maxiters * 1e3:.0f} ms/iter)", flush=True)
    return nns, report


def build_ensemble_members(n_members, Nz=32, seed=0, device=None):
    """``n_members`` flux-MLP triples at the 1e-5 scale, drawn one after another from one generator."""
    gen = torch.Generator().manual_seed(seed)
    device = resolve_device(device)
    return [_draw_nns(gen, Nz, device) for _ in range(n_members)]


def pretrain_ensemble(ds, model, members, epochs=150, lr=1e-3):
    """All K members x 3 fluxes pre-trained as one stacked full-batch adam (each net as its solo run)."""
    from climateparameterizations_jl_tpu_torch.data.containers import direct_regression_pairs
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import stack_members, unstack_members
    from climateparameterizations_jl_tpu_torch.train.nn import train_flux_nn_ensemble

    t0 = time.perf_counter()
    fluxes = ("uw", "vw", "wT")
    ys = {}
    for i, f in enumerate(fluxes):
        xf, ys[f] = direct_regression_pairs(ds, model.scalings, f)
        if i == 0:
            x = xf  # the predictor block is flux-independent
    nets = [getattr(m, f) for m in members for f in fluxes]
    targets = torch.stack([ys[f] for _ in members for f in fluxes])
    stacked, hist = train_flux_nn_ensemble(stack_members(nets), x, targets, learning_rate=lr, epochs=epochs)
    flat = unstack_members(stacked)
    out_members = [FluxNNs(*flat[i * 3: (i + 1) * 3]) for i in range(len(members))]
    info = {
        f"m{i}": {f: (float(hist[i * 3 + j][0]), float(hist[i * 3 + j][-1])) for j, f in enumerate(fluxes)}
        for i in range(len(members))
    }
    return out_members, info, time.perf_counter() - t0


def nde_train_ensemble(ds, model, members, stages=None, fractions=FRACTIONS, tridiag_backend="auto",
                       fast_assembly="auto", shooting=0, shooting_hybrid=False, member_fold=False):
    """Deep-ensemble curriculum: one step advances all K members; the report carries member-mean losses.

    ``member_fold`` puts the members on the solve's batch axis (one Thomas
    launch per solve for all of them) instead of one solve per member.
    """
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import (
        stack_members,
        train_wind_mixing_deep_ensemble,
    )
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    stages = STAGES if stages is None else stages
    stacked = stack_members(members)
    report = []
    for i, (window, stride, maxiters, lr) in enumerate(stages):
        config = NDETrainConfig(
            learning_rate=lr, maxiters=maxiters, n_substeps=stride, method="split",
            training_fractions=fractions, tridiag_backend=tridiag_backend, fast_assembly=fast_assembly,
        )
        batch, tsteps, K = _stage_batch(ds, model, i, len(stages), window, stride, shooting, shooting_hybrid)
        t0 = time.perf_counter()
        stacked, hist = train_wind_mixing_deep_ensemble(model, stacked, batch, config, member_fold=member_fold)
        wall = time.perf_counter() - t0
        totals = _totals(hist)
        inner = int((len(tsteps) - 1) * stride)
        report.append(dict(
            window=window, stride=stride, maxiters=maxiters, lr=lr, shooting=K,
            n_saveat=len(tsteps), inner_steps=inner // K if K else inner,
            loss_initial=totals[0], loss_final=totals[-1],
            wall_s=wall, s_per_iter=wall / maxiters,
        ))
        print(f"[ensemble] stage window={window} stride={stride}{f' shooting={K}' if K else ''}: "
              f"member-mean {report[-1]['loss_initial']:.4e} -> {report[-1]['loss_final']:.4e} "
              f"in {wall:.1f} s ({wall / maxiters * 1e3:.0f} ms/iter)", flush=True)
    return stacked, report


def evaluate_ensemble(model, stacked, Nz=32):
    """Held-out deep-ensemble evaluation: predictive bands and the ensemble mean's wins.

    Per held-out sim, member 0 runs the full ``nde_profile`` harness (the mPP
    and KPP baselines come from it) and one member-folded solve gives every
    member's loss, the ensemble mean's loss and the 2-sigma coverage. The
    first held-out sim is the validation member: a scalar variance inflation
    is fit on its T bands and applied unchanged to the others.
    """
    from climateparameterizations_jl_tpu_torch.eval.ensemble_uq import nde_ensemble_uq
    from climateparameterizations_jl_tpu_torch.eval.profile import nde_profile
    from climateparameterizations_jl_tpu_torch.eval.uq_calibration import band_report, fit_band_calibration
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import member

    member0 = member(stacked, 0)
    tsteps = np.arange(0, N_FRAMES, 9)
    out = {}
    calibration = None
    for name in TEST_FILES:
        ds = load_suite([name], Nz, model.H.device)
        ev = nde_profile(model, member0, ds, tsteps, solver="split", n_substeps=9,
                         include_kpp=True, include_embedded=False, kpp_n_substeps=9)
        uq = nde_ensemble_uq(model, stacked, ds, tsteps, solver="split", n_substeps=9)
        truth = np.asarray(ev["truth_T"]).reshape(uq["ensemble_T_mean"].shape)
        band = 2.0 * uq["ensemble_T_std"]
        abs_err = np.abs(truth - uq["ensemble_T_mean"])
        # Spread-skill: Pearson r of the band width against the error over all frames x levels (null when either
        # is constant, e.g. K = 1).
        sd_flat = uq["ensemble_T_std"].ravel()
        degenerate = float(sd_flat.std()) == 0.0 or float(abs_err.std()) == 0.0
        spread_skill = None if degenerate else float(np.corrcoef(sd_flat, abs_err.ravel())[0, 1])
        row = dict(
            nde_member0=float(np.mean(ev["losses_nde_T"])),
            nde_members=[float(v) for v in uq["losses_member_T"].mean(axis=1)],
            nde_ensemble_mean=float(np.mean(uq["losses_ensemble_mean_T"])),
            mpp=float(np.mean(ev["losses_mpp_T"])),
            kpp=float(np.mean(ev["losses_kpp_T"])),
            coverage_2sigma=float(np.mean(abs_err <= band)),
            mean_band_K=float(np.mean(band)),
            spread_skill_r=spread_skill,
        )
        row["win_vs_mpp"] = row["mpp"] / row["nde_ensemble_mean"]
        row["win_vs_kpp"] = row["kpp"] / row["nde_ensemble_mean"]
        row["win_vs_best_member"] = min(row["nde_members"]) / row["nde_ensemble_mean"]
        if calibration is None:
            calibration = fit_band_calibration(truth, uq["ensemble_T_mean"], uq["ensemble_T_std"])
            row["calibration_role"] = "validation (inflation fit here)"
            row["lam_nll"] = calibration.lam_nll
            row["lam_coverage"] = calibration.lam_coverage
        else:
            row["calibration_role"] = "test"
        row["calibrated"] = band_report(truth, uq["ensemble_T_mean"], uq["ensemble_T_std"], lam=calibration.lam)
        out[name] = row
        print(f"eval[{name}]: ens-mean {row['nde_ensemble_mean']:.4e} "
              f"(members {min(row['nde_members']):.3e}..{max(row['nde_members']):.3e}, "
              f"{row['win_vs_best_member']:.2f}x vs best) | mPP {row['win_vs_mpp']:.1f}x, "
              f"KPP@600s {row['win_vs_kpp']:.1f}x | 2-sigma coverage {row['coverage_2sigma']:.2f} "
              f"-> {row['calibrated']['coverage']:.2f} calibrated (lam={calibration.lam:.2f}, "
              f"{row['calibration_role'].split(' ')[0]}; mean band {row['mean_band_K']:.3f} K, spread-skill r="
              f"{'n/a' if row['spread_skill_r'] is None else format(row['spread_skill_r'], '.2f')})", flush=True)
    return out


def evaluate_embedded(model, nns, Nz=32, embedded_substeps=10):
    """Held-out embedded evaluation: the host column with the MLPs against its physics-only twin.

    ``evaluate --embedded``'s harness (dimensional host, implicit mPP, dt =
    save spacing / ``embedded_substeps``) on the held-out sims; ``nde`` is
    recorded beside it.
    """
    from climateparameterizations_jl_tpu_torch.eval.profile import nde_profile

    tsteps = np.arange(0, N_FRAMES, 9)
    out = {}
    for name in TEST_FILES:
        ds = load_suite([name], Nz, model.H.device)
        ev = nde_profile(model, nns, ds, tsteps, solver="split", n_substeps=9,
                         include_kpp=False, include_embedded=True, embedded_substeps=embedded_substeps)
        row = dict(
            embedded=float(np.mean(ev["losses_embedded_T"])),
            embedded_twin=float(np.mean(ev["losses_embedded_baseline_T"])),
            nde=float(np.mean(ev["losses_nde_T"])),
            mpp=float(np.mean(ev["losses_mpp_T"])),
        )
        row["win_vs_twin"] = row["embedded_twin"] / row["embedded"]
        out[name] = row
        print(f"embedded[{name}]: +NN {row['embedded']:.4e} vs twin {row['embedded_twin']:.4e} "
              f"({row['win_vs_twin']:.1f}x) | NDE {row['nde']:.4e}", flush=True)
    return out


def aposteriori_finetune(ds, model, nns, maxiters=60, lr=3e-4, window=None, stride=9, substeps=10,
                         tridiag_backend="auto"):
    """Fine-tune the flux MLPs through the embedded host column over ``window`` frames (``N_FRAMES`` when None):
    the same auto-balanced 6-channel loss, the host discretization of the evaluation (10 substeps: dt = 540 s)."""
    from climateparameterizations_jl_tpu_torch.train.embedded import train_embedded_wind_mixing
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    window = N_FRAMES if window is None else window
    config = NDETrainConfig(
        learning_rate=lr, maxiters=maxiters, n_substeps=substeps, training_fractions=FRACTIONS,
        tridiag_backend=tridiag_backend,
    )
    tsteps = np.arange(0, window, stride)
    t0 = time.perf_counter()
    nns, hist = train_embedded_wind_mixing(model, nns, ds, config, tsteps=tsteps)
    wall = time.perf_counter() - t0
    totals = _totals(hist)
    info = dict(
        maxiters=maxiters, lr=lr, window=window, stride=stride, substeps=substeps,
        n_saveat=len(tsteps), inner_steps=int((len(tsteps) - 1) * substeps),
        loss_initial=totals[0], loss_final=totals[-1],
        wall_s=wall, s_per_iter=wall / maxiters,
        loss_curve=totals[:: max(1, maxiters // 25)],
    )
    print(f"a-posteriori: {info['loss_initial']:.4e} -> {info['loss_final']:.4e} "
          f"in {wall:.1f} s ({wall / maxiters * 1e3:.0f} ms/iter)", flush=True)
    return nns, info


def _kpp_loss_at(model, ds, tsteps, kpp_n_substeps):
    """Mean scaled-T MSE of the KPP baseline at ``kpp_n_substeps`` steps per save, without re-solving the NDE and
    mPP trajectories (``nde_profile``'s KPP block alone)."""
    from climateparameterizations_jl_tpu_torch.physics.kpp import KPPForcing, KPPParameters, KPPState, solve_kpp

    if ds.T.dim() > 2:  # a singleton stacked suite
        ds = dataclasses.replace(ds, **{f.name: getattr(ds, f.name)[0] for f in dataclasses.fields(ds)
                                        if getattr(ds, f.name) is not None})
    idx = torch.as_tensor(np.asarray(tsteps), dtype=torch.long, device=ds.T.device)
    i0 = int(np.asarray(tsteps)[0])
    kpp = solve_kpp(
        KPPState(U=ds.u[..., i0, :], V=ds.v[..., i0, :], T=ds.T[..., i0, :]),
        ds.t.index_select(-1, idx), KPPParameters.default(device=ds.T.device),
        KPPForcing(Fu=ds.u_top, Fb=ds.theta_top * ds.g * ds.alpha, dTdz_bottom=ds.theta_bottom),
        model.H, model.Nz, ds.f, ds.g, ds.alpha, n_substeps=kpp_n_substeps, diurnal=model.diurnal,
    )
    s = model.scalings.T
    truth = ds.T.index_select(-2, idx)
    return float(torch.mean((s.scale(kpp.T) - s.scale(truth)) ** 2))


def evaluate(model, nns, Nz=32, include_kpp=True):
    """Held-out NDE against mPP alone and KPP over the whole window (``nde_profile``).

    KPP steps at its native 600 s (9 steps per stride-9 save);
    ``kpp_ref_dt`` records it at the save spacing, as the reference's own
    harness steps it.
    """
    from climateparameterizations_jl_tpu_torch.eval.profile import nde_profile

    tsteps = np.arange(0, N_FRAMES, 9)
    out = {}
    for name in TEST_FILES:
        ds = load_suite([name], Nz, model.H.device)
        ev = nde_profile(model, nns, ds, tsteps, solver="split", n_substeps=9,
                         include_kpp=include_kpp, include_embedded=False, kpp_n_substeps=9)
        row = {}
        for member in ("nde", "mpp") + (("kpp",) if include_kpp else ()):
            row[member] = float(np.mean(ev[f"losses_{member}_T"]))  # mean over time of the T channel
        row["win_vs_mpp"] = row["mpp"] / row["nde"]
        if include_kpp:
            row["win_vs_kpp"] = row["kpp"] / row["nde"]
            row["kpp_ref_dt"] = _kpp_loss_at(model, ds, tsteps, kpp_n_substeps=1)
            row["win_vs_kpp_ref_dt"] = row["kpp_ref_dt"] / row["nde"]
        out[name] = row
        msg = f"eval[{name}]: NDE {row['nde']:.4e} vs mPP {row['mpp']:.4e} ({row['win_vs_mpp']:.1f}x)"
        if include_kpp:
            msg += (f" vs KPP@600s {row['kpp']:.4e} ({row['win_vs_kpp']:.1f}x)"
                    f" [KPP@save-spacing {row['kpp_ref_dt']:.4e}, {row['win_vs_kpp_ref_dt']:.1f}x]")
        print(msg, flush=True)
    return out


def save_nns(nns, out_dir, ensemble=0, model=None):
    """A run directory that both packages' ``evaluate`` / ``ensemble`` / ``_load_nns`` read.

    With ``model``, ``meta["mpp"]`` records its mPP parameters: MLPs trained
    over a calibrated base form another closure over the default one.
    """
    from climateparameterizations_jl_tpu_torch.cli.main import _mpp_meta, _save_nns, _suite_diurnal_flags

    meta = {"command": "climateparameterizations_jl_tpu_torch/studies/flagship_training.py",
            "sims": ",".join(TRAIN_FILES), "nz": 32, "diurnal": any(_suite_diurnal_flags(TRAIN_FILES)),
            "ensemble": int(ensemble)}
    if model is not None:
        meta["mpp"] = _mpp_meta(model)
    _save_nns(out_dir, nns, meta)
    return out_dir


def step_bench(n_timed=10, tridiag_backend="auto", split_unroll=1, fast_assembly=False, implicit_solve_grad=True,
               diurnal=False, shooting=0, n_repeats=1, ensemble=0, member_fold=False, device=None):
    """One final-stage training step timed on the card by ``benchmarks.bench_train_step``.

    ``n_repeats`` blocks of ``n_timed`` steps after one warm-up; each
    block's mean gives one per-iteration sample, reported as
    min / median / max. ``compile_s`` is the wall time of the warm-up step
    with the loss-scaling pre-solve (the eager port compiles nothing but the
    kernels, built once per process). ``ensemble=M`` times M stacked
    members (seed 0), ``shooting=K`` the K-window batch.
    """
    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.data.containers import training_tensors
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import stack_members
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, resolve_tridiag_backend

    device = resolve_device(device)
    ds, model, nns = build(diurnal=diurnal, device=device)
    window, stride, _, lr = STAGES[-1]
    config = NDETrainConfig(learning_rate=lr, n_substeps=stride, method="split", training_fractions=FRACTIONS,
                            tridiag_backend=tridiag_backend, split_unroll=split_unroll,
                            fast_assembly=fast_assembly, implicit_solve_grad=implicit_solve_grad)
    tsteps = np.arange(0, window, stride)
    setup = dict(ds=ds, model=model, nns=nns, config=config, tsteps=tsteps, substeps=(len(tsteps) - 1) * stride,
                 batch=training_tensors(ds, model.scalings, tsteps, tau=model.tau))
    stacked = stack_members(build_ensemble_members(ensemble, device=device)) if ensemble else None
    n_timed, n_repeats = max(1, n_timed), max(1, n_repeats)
    t0 = time.perf_counter()
    r = benchmarks.bench_train_step(setup, n_timed=n_timed * n_repeats, device=device, shooting=shooting,
                                    ensemble=ensemble, member_fold=member_fold, stacked_nns=stacked)
    wall = time.perf_counter() - t0
    ms = r["ms"]
    samples = [sum(ms[b * n_timed: (b + 1) * n_timed]) / n_timed * 1e-3 for b in range(n_repeats)]
    per_iter = float(np.median(samples))
    sims, inner = len(TRAIN_FILES), (len(tsteps) - 1) * stride
    return dict(
        backend=device.type, compile_s=wall - sum(ms) * 1e-3, s_per_iter=per_iter,
        tridiag_backend_resolved=resolve_tridiag_backend(tridiag_backend, inner // max(1, shooting), device),
        s_per_iter_min=float(min(samples)), s_per_iter_max=float(max(samples)),
        n_repeats=len(samples),
        sims=sims, inner_steps=inner, shooting=shooting, ensemble=ensemble,
        batch_columns=sims * max(1, shooting) * max(1, ensemble),
        column_timesteps_per_s=sims * inner * max(1, ensemble) / per_iter,
    )


def resolve_suite(suite, extra_train=None):
    """``(train_files, test_files, diurnal)`` from the frozen base lists.

    Idempotent: a second in-process ``main()`` does not compound the first
    call's suite. ``diurnal`` follows suite membership, not the ``--suite``
    name: an ``--extra-train`` diurnal member on the standard suite still
    resolves the daily cycle.
    """
    from climateparameterizations_jl_tpu_torch.cli.main import _sims, _suite_diurnal_flags

    if suite == "diurnal":
        train, test = list(TRAIN_FILES_DIURNAL), list(TEST_FILES_DIURNAL)
    elif suite == "mixed":
        train = list(TRAIN_FILES_STANDARD) + TRAIN_FILES_DIURNAL
        test = list(TEST_FILES_STANDARD) + TEST_FILES_DIURNAL
    else:
        train, test = list(TRAIN_FILES_STANDARD), list(TEST_FILES_STANDARD)
    if extra_train:
        train = train + _sims(extra_train)
    return train, test, any(_suite_diurnal_flags(train))


def _load_checkpoint(path, model, device):
    """``(nns, meta, model)``: a saved run and the model over its training-time mPP base."""
    from climateparameterizations_jl_tpu_torch.cli.main import _load_nns, _restore_mpp

    nns, meta = _load_nns(path, device)
    if meta.get("mpp"):
        model = dataclasses.replace(model, **_restore_mpp(meta, device=device))
        print(f"restored TRAINING-time mPP parameters from checkpoint meta: {meta['mpp']}", flush=True)
    return nns, meta, model


def _improvement(before, after, with_nde: bool):
    out = {}
    for name in after:
        row = dict(embedded_before=before[name]["embedded"], embedded_after=after[name]["embedded"],
                   improvement=before[name]["embedded"] / after[name]["embedded"],
                   win_vs_twin_after=after[name]["win_vs_twin"])
        if with_nde:
            row.update(nde_before=before[name]["nde"], nde_after=after[name]["nde"])
        out[name] = row
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="train", choices=["train", "step-bench", "aposteriori", "embedded-eval"])
    ap.add_argument("--pretrain-epochs", type=int, default=150,
                    help="flux pre-training epochs per NN (0 skips the phase — the zero-init NDE A/B)")
    ap.add_argument("--suite", default="standard", choices=["standard", "diurnal", "mixed"],
                    help="standard = the 18-sim wind+cooling/heating '_new' suite; "
                         "diurnal = the 15-sim 8-day diurnal grid (held-out interpolation members); "
                         "mixed = both families as ONE 33-sim run (per-sim diurnal amplitudes)")
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' runs on the CPU)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true", help="3-iteration stages (correctness flush before the real run)")
    ap.add_argument("--tridiag-backend", default="auto", choices=["auto", "scan", "pcr", "cuda"])
    ap.add_argument("--split-unroll", type=int, default=1)
    ap.add_argument("--fast-assembly", nargs="?", const="on", default="off", choices=["on", "off", "fold"],
                    help="matmul-assembled explicit split tendencies (A/B vs default); "
                         "pass 'fold' to also precompose the divergence matrix into the last NN layer")
    ap.add_argument("--no-ift", action="store_true",
                    help="direct autodiff through the implicit solves instead of the IFT default (A/B)")
    ap.add_argument("--calibrate-mpp", action="store_true",
                    help="pre-calibrate the 5 mPP parameters (the reference's pipeline order)")
    ap.add_argument("--shooting-hybrid", action="store_true",
                    help="with --shooting K: keep the FINAL burn-in stage sequential")
    ap.add_argument("--shooting", type=int, default=0,
                    help="window-parallel (multiple-shooting) FINAL stages: split the 1:9:1153 window into K "
                         "truth-anchored segments batched with the sims (K must divide 128). 0 = sequential")
    ap.add_argument("--data-dir", default=None,
                    help="read the suite from reference-layout .jld2 files under this dir instead of synthetic "
                         "stand-ins; missing members are an error")
    ap.add_argument("--extra-train", default=None,
                    help="comma-separated catalog names APPENDED to the training suite")
    ap.add_argument("--save-nns", default=None, help="save the trained NNs as a CLI-compatible checkpoint dir")
    ap.add_argument("--ensemble", type=int, default=0,
                    help="train a K-member deep ensemble at flagship scale (one step advances all members; "
                         "eval adds predictive bands + coverage)")
    ap.add_argument("--member-fold", action="store_true",
                    help="put the ensemble's members on the solve's batch axis (MemberPackedFluxNNs): one solve "
                         "for all members instead of one per member")
    ap.add_argument("--eval-checkpoint", default=None,
                    help="skip training: evaluate a saved (solo or ensemble) checkpoint dir against the suite's "
                         "held-out sims")
    ap.add_argument("--ft-maxiters", type=int, default=60, help="a-posteriori fine-tune iterations")
    ap.add_argument("--ft-lr", type=float, default=3e-4)
    ap.add_argument("--ft-substeps", type=int, default=10,
                    help="host steps per save interval (match evaluate --embedded's 10; 9 = the NDE's own "
                         "dt = 600 s)")
    ap.add_argument("--bench-repeats", type=int, default=3, help="step-bench timing blocks (min/median/max reported)")
    ap.add_argument("--host-matched-substeps", action="store_true",
                    help="train the NDE at the embedded host's dt (~540 s, 10 substeps per stride-9 save) instead "
                         "of the reference's 600 s")
    ap.add_argument("--finish-aposteriori", action="store_true",
                    help="end the training pipeline with the a-posteriori (through-the-host) fine-tune; the "
                         "NDE-stage checkpoint is kept as <save-nns>_nde_stage")
    ap.add_argument("--stages", default=None,
                    help="comma-separated indices of STAGES to run (default: all); with --init-from, one "
                         "curriculum split over several processes")
    ap.add_argument("--init-from", default=None,
                    help="start the stages from this saved solo run (its mPP meta restored) instead of a fresh "
                         "draw; pretraining still runs unless --pretrain-epochs 0")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.finish_aposteriori and args.ensemble:
        ap.error("--finish-aposteriori takes a solo run (extract an ensemble member first)")
    if args.init_from and (args.ensemble or args.eval_checkpoint or args.mode != "train"):
        ap.error("--init-from starts a solo --mode train curriculum")
    args.fast_assembly = {"on": True, "off": False}.get(args.fast_assembly, args.fast_assembly)
    global TRAIN_FILES, TEST_FILES, DATA_DIR, STAGES
    DATA_DIR = args.data_dir
    TRAIN_FILES, TEST_FILES, suite_diurnal = resolve_suite(args.suite, args.extra_train)
    if args.smoke:
        STAGES = [(w, s, 3, lr) for w, s, _, lr in STAGES]
    stages = STAGES if args.stages is None else [STAGES[int(i)] for i in args.stages.split(",")]
    device = resolve_device(args.device)

    if args.mode == "step-bench":
        result = step_bench(tridiag_backend=args.tridiag_backend, split_unroll=args.split_unroll,
                            fast_assembly=args.fast_assembly, implicit_solve_grad=not args.no_ift,
                            diurnal=suite_diurnal, shooting=args.shooting, ensemble=args.ensemble,
                            n_repeats=args.bench_repeats, member_fold=args.member_fold, device=device)
        result["tridiag_backend"] = args.tridiag_backend
        result["fast_assembly"] = args.fast_assembly
        result["implicit_solve_grad"] = not args.no_ift
        result["split_unroll"] = args.split_unroll
        result["member_fold"] = args.member_fold
        print(json.dumps(result))
    elif args.mode == "embedded-eval":
        # Eval-only ablation arm: a checkpoint in the embedded host at any host substep count, no fine-tune.
        if not args.eval_checkpoint:
            raise SystemExit("--mode embedded-eval needs --eval-checkpoint")
        _, model, _ = build(diurnal=suite_diurnal, device=device)
        nns, _, model = _load_checkpoint(args.eval_checkpoint, model, device)
        print(f"held-out embedded eval at substeps={args.ft_substeps} "
              f"(dt={9 * 600 / args.ft_substeps:.0f} s):", flush=True)
        held_out = evaluate_embedded(model, nns, embedded_substeps=args.ft_substeps)
        result = dict(eval_checkpoint=args.eval_checkpoint, embedded_substeps=args.ft_substeps, held_out=held_out)
    elif args.mode == "aposteriori":
        # Fine-tune a checkpoint through the embedded host column; held-out embedded eval before and after.
        if not args.eval_checkpoint:
            raise SystemExit("--mode aposteriori needs --eval-checkpoint (the flagship init)")
        wall0 = time.perf_counter()
        ds, model, _ = build(diurnal=suite_diurnal, device=device)
        nns, ckpt_meta, model = _load_checkpoint(args.eval_checkpoint, model, device)
        if int(ckpt_meta.get("ensemble", 0) or 0):
            raise SystemExit("--mode aposteriori takes a solo checkpoint; extract a member first")
        print("held-out embedded eval BEFORE fine-tune:", flush=True)
        before = evaluate_embedded(model, nns, embedded_substeps=args.ft_substeps)
        nns, ft = aposteriori_finetune(ds, model, nns, maxiters=3 if args.smoke else args.ft_maxiters,
                                       lr=args.ft_lr, substeps=args.ft_substeps,
                                       tridiag_backend=args.tridiag_backend)
        if args.save_nns:
            save_nns(nns, args.save_nns, model=model)
            print(f"a-posteriori checkpoint saved to {args.save_nns}", flush=True)
        print("held-out embedded eval AFTER fine-tune:", flush=True)
        after = evaluate_embedded(model, nns, embedded_substeps=args.ft_substeps)
        improvement = _improvement(before, after, with_nde=True)
        for name, row in improvement.items():
            print(f"a-posteriori[{name}]: embedded {row['embedded_before']:.4e} -> "
                  f"{row['embedded_after']:.4e} ({row['improvement']:.2f}x better); "
                  f"NDE {row['nde_before']:.4e} -> {row['nde_after']:.4e}", flush=True)
        result = dict(init_checkpoint=args.eval_checkpoint, finetune=ft, held_out_before=before,
                      held_out_after=after, improvement=improvement, total_wall_s=time.perf_counter() - wall0)
    elif args.eval_checkpoint:
        _, model, _ = build(diurnal=suite_diurnal, device=device)
        loaded, ckpt_meta, model = _load_checkpoint(args.eval_checkpoint, model, device)
        held_out = evaluate_ensemble(model, loaded) if ckpt_meta.get("ensemble") else evaluate(model, loaded)
        result = dict(eval_checkpoint=args.eval_checkpoint, ensemble=int(ckpt_meta.get("ensemble", 0) or 0),
                      held_out=held_out)
    else:
        wall0 = time.perf_counter()
        t0 = time.perf_counter()
        ds, model, nns = build(diurnal=suite_diurnal, device=device)
        data_s = time.perf_counter() - t0
        if args.init_from:
            nns, _, model = _load_checkpoint(args.init_from, model, device)
        mpp_info = None
        if args.calibrate_mpp:
            model, mpp_info = calibrate_mpp(ds, model, maxiters=5 if args.smoke else 60)
            print(f"mPP calibration ({mpp_info['wall_s']:.1f} s, {mpp_info['optimizer']}): "
                  f"{mpp_info['loss_initial']:.4e} -> {mpp_info['loss_final']:.4e}; {mpp_info['params']}", flush=True)
        pre, pre_s = {}, 0.0
        epochs = 5 if args.smoke else args.pretrain_epochs
        if args.ensemble:
            members = build_ensemble_members(args.ensemble, device=device)
            if args.pretrain_epochs:
                members, pre, pre_s = pretrain_ensemble(ds, model, members, epochs=epochs)
                print(f"pretrain x{args.ensemble} ({pre_s:.1f} s, one stacked adam)", flush=True)
            stacked, stage_report = nde_train_ensemble(ds, model, members, stages=stages,
                                                       tridiag_backend=args.tridiag_backend,
                                                       fast_assembly=args.fast_assembly or "auto",
                                                       shooting=args.shooting, shooting_hybrid=args.shooting_hybrid,
                                                       member_fold=args.member_fold)
            if args.save_nns:
                save_nns(stacked, args.save_nns, ensemble=args.ensemble, model=model)
                print(f"ensemble checkpoint saved to {args.save_nns}", flush=True)
            held_out = evaluate_ensemble(model, stacked)
        else:
            if args.pretrain_epochs:
                nns, pre, pre_s = pretrain(ds, model, nns, epochs=epochs)
                print(f"pretrain ({pre_s:.1f} s): " + ", ".join(f"{k} {a:.3e}->{b:.3e}" for k, (a, b) in pre.items()),
                      flush=True)
            nns, stage_report = nde_train(ds, model, nns, stages=stages, tridiag_backend=args.tridiag_backend,
                                          fast_assembly=args.fast_assembly or "auto", shooting=args.shooting,
                                          shooting_hybrid=args.shooting_hybrid,
                                          host_matched_substeps=args.host_matched_substeps)
            if args.save_nns:
                nde_dir = args.save_nns + ("_nde_stage" if args.finish_aposteriori else "")
                save_nns(nns, nde_dir, model=model)
                print(f"{'NDE-stage ' if args.finish_aposteriori else ''}checkpoint saved to {nde_dir}", flush=True)
            held_out = evaluate(model, nns)
        result = dict(
            sims=len(TRAIN_FILES), frames=N_FRAMES, data_s=data_s, mpp_calibration=mpp_info,
            ensemble=args.ensemble, shooting=args.shooting, data_dir=DATA_DIR,
            host_matched_substeps=args.host_matched_substeps,
            pretrain=pre, pretrain_s=pre_s, stages=stage_report, held_out=held_out,
            total_wall_s=time.perf_counter() - wall0,
        )
        if args.finish_aposteriori:
            # The shipped checkpoint is the one fine-tuned through its deployment host.
            print("held-out embedded eval BEFORE the a-posteriori stage:", flush=True)
            before = evaluate_embedded(model, nns, embedded_substeps=args.ft_substeps)
            nns, ft = aposteriori_finetune(ds, model, nns, maxiters=3 if args.smoke else args.ft_maxiters,
                                           lr=args.ft_lr, substeps=args.ft_substeps,
                                           tridiag_backend=args.tridiag_backend)
            if args.save_nns:
                save_nns(nns, args.save_nns, model=model)
                print(f"deployment (a-posteriori) checkpoint saved to {args.save_nns}", flush=True)
            print("held-out embedded eval AFTER the a-posteriori stage:", flush=True)
            after = evaluate_embedded(model, nns, embedded_substeps=args.ft_substeps)
            result["aposteriori"] = dict(finetune=ft, held_out_before=before, held_out_after=after,
                                         improvement=_improvement(before, after, with_nde=False))
            result["total_wall_s"] = time.perf_counter() - wall0
        print(f"TOTAL wall: {result['total_wall_s']:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
