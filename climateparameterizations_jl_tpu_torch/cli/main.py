"""Command-line interface, partial port of ``climateparameterizations_jl_tpu/cli/main.py``.

The subcommands ported so far are ``catalog``, ``train-nn`` (direct flux
regression), ``train-nde`` (wind-mixing NDE training: curriculum, multiple
shooting, checkpoints, resume, calibrated mPP base, deep ensembles),
``extract``, ``train-gp``, ``train-fc-nde`` (free-convection NDE training:
flux pre-training, spatial causality, curriculum, deep ensembles),
``optimise-mpp`` (mPP calibration by gradient or EKI), ``calibrate-kpp``
(KPP calibration: random search, gradient or EKI), the evaluation
harnesses ``evaluate`` and ``evaluate-fc`` (a trained closure against the
KPP, TKE and base-closure baselines, and with ``--embedded`` inside the
host column model), the a-posteriori trainers ``train-embedded`` and
``train-embedded-fc`` (gradients through the host column),
``double-gyre`` (the 3-D basin with the free-convection closure),
``generate-les`` (the 3-D LES data generator) and ``ensemble`` (the
perturbed-IC column ensemble):

    python -m climateparameterizations_jl_tpu_torch.cli train-nde --sims strong_wind \
        --curriculum 6,13:2 --shooting 3 --output runs/nde
    python -m climateparameterizations_jl_tpu_torch.cli extract runs/nde runs/nde_extracted
    python -m climateparameterizations_jl_tpu_torch.cli train-gp --sims strong_wind \
        --test-sims strong_wind_weak_cooling --fluxes wT --output runs/gp
    python -m climateparameterizations_jl_tpu_torch.cli train-nn --sims strong_wind --output runs/nn
    python -m climateparameterizations_jl_tpu_torch.cli train-fc-nde --sim-ids 1,2,3 \
        --pretrain-epochs 50 --curriculum 9,25:2 --output runs/fc
    python -m climateparameterizations_jl_tpu_torch.cli optimise-mpp --sims strong_wind \
        --calibration-method eki --output runs/mpp
    python -m climateparameterizations_jl_tpu_torch.cli calibrate-kpp --sims strong_wind --output runs/kpp
    python -m climateparameterizations_jl_tpu_torch.cli evaluate --checkpoint runs/nde \
        --test-sims strong_wind_weak_cooling --output runs/eval
    python -m climateparameterizations_jl_tpu_torch.cli evaluate-fc --checkpoint runs/fc --sim-ids 8,9 \
        --embedded --output runs/eval_fc
    python -m climateparameterizations_jl_tpu_torch.cli train-embedded --init-from runs/nde \
        --curriculum 8,16 --output runs/emb
    python -m climateparameterizations_jl_tpu_torch.cli train-embedded-fc --init-from runs/fc --output runs/emb_fc
    python -m climateparameterizations_jl_tpu_torch.cli double-gyre --checkpoint runs/fc --days 10 --output runs/gyre
    python -m climateparameterizations_jl_tpu_torch.cli generate-les --n-save 48 --output runs/les
    python -m climateparameterizations_jl_tpu_torch.cli ensemble --checkpoint runs/nde --n-members 1024 --output runs/ens

They run on the card unless ``--device cpu`` is given (the JAX package's
``--platform`` flag). ``--config FILE`` (JSON, or YAML where PyYAML is
installed) supplies flag values; flags typed on the command line win. Run
directories use the JAX package's format and load in either package.
``--data-dir`` reads LESbrary ``.jld2`` files where they exist (h5py needed)
and falls back to the synthetic stand-ins; the free-convection commands'
``--source les3d`` generates their data with the 3-D LES instead. The other
subcommands are later work (``ROADMAP.md``); the commands write the JAX
commands' files but no figures (``eval/animations.py`` is not ported, so
``--animate`` raises).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.device import resolve_device


def _load_config(path: str | None) -> dict:
    """A ``--config`` file as a dict: JSON, or YAML for a ``.yaml``/``.yml`` path (PyYAML imported only then)."""
    if not path:
        return {}
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            return yaml.safe_load(f) or {}
        return json.load(f)


def _apply_config(args: argparse.Namespace, config: dict, parser_defaults: dict, explicit: set | None = None):
    """Config values override defaults; flags typed on the command line override the config.

    ``explicit`` names the dests typed on the command line: comparing values
    with the parser defaults alone cannot tell ``--nz 32`` (typed, equal to
    the default) from an omitted flag.
    """
    explicit = explicit or set()
    for key, value in config.items():
        attr = key.replace("-", "_")
        if attr in explicit:
            continue
        if hasattr(args, attr) and getattr(args, attr) == parser_defaults.get(attr):
            setattr(args, attr, value)
    return args


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

    A name whose LESbrary file exists under ``data_dir`` is read from it
    (``data/registry.py::load_simulation``); the others get their synthetic
    stand-ins, generated on the CPU (``data/synthetic.py``), where members
    that share the generator's column (``f``, ``H``, ``alpha``, ``g``, grid
    and diurnal flag) run as one batched split solve instead of one solve
    each. The suite moves to ``device`` (``cuda`` unless the caller asks for
    the CPU) at the end. Diurnal members keep their time-varying top ``wT``
    face; the others have their surface fluxes pinned.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import (
        coarsen_dataset,
        enforce_surface_fluxes,
        stack_datasets,
    )
    from climateparameterizations_jl_tpu_torch.data.registry import (
        lesbrary_file,
        load_simulation,
        signed_momentum_flux,
        simulation_parameters,
    )
    from climateparameterizations_jl_tpu_torch.data.synthetic import _synthetic_wind_mixing_les_batch

    device = resolve_device(device)
    specs = [simulation_parameters(n) for n in names]
    raw = [None] * len(names)
    groups: dict = {}
    for i, (name, spec) in enumerate(zip(names, specs)):
        if lesbrary_file(name, data_dir) is not None:
            raw[i] = load_simulation(name, data_dir=data_dir, Nz_les=Nz_les, n_save=n_save, dt_save=dt_save)
        else:
            groups.setdefault((spec.f, spec.diurnal), []).append(i)
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


def _load_fc_suite(ids, Nz: int, data_dir=None, n_save=96, dt_save=600.0, source="auto", device=None,
                   les_cache_dir=None):
    """The coarse free-convection suite of ``ids``, stacked on a leading axis (one id: unstacked), on ``device``.

    Files under ``data_dir`` where they exist, else the synthetic stand-ins
    in one batched solve on the CPU (``data/free_convection.py``);
    ``source="les3d"``: each id's 3-D LES run on ``device``, through
    ``les_cache_dir`` where given.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import stack_datasets
    from climateparameterizations_jl_tpu_torch.data.free_convection import load_free_convection_suite

    device = resolve_device(device)
    datasets = load_free_convection_suite(ids, data_dir, Nz, n_save=n_save, dt_save=dt_save, source=source,
                                          les_cache_dir=les_cache_dir, device=device)
    suite = stack_datasets(datasets) if len(datasets) > 1 else datasets[0]
    return suite.to(device)


def _wind_model(ds, Nz: int, **overrides):
    """The wind-mixing model of a (stacked) suite, on the suite's device.

    Scalings are fitted on the suite; ``tau`` is its time span; the mPP
    parameters are the defaults. ``overrides`` replace any field: a model
    for a checkpoint takes ``**_restore_mpp(meta)``, its training-time base.
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


def _base_closure_overrides(name: str) -> dict:
    """``WindMixingModel`` flags for a ``--base-closure`` name (also read back from checkpoint meta).

    Parity: the reference's base closures: mPP (``train_NDE.jl``),
    convective adjustment (``train_NDE_2DaySuite_SWNH_convective_adjustment.jl``)
    and bare NNs (``NDE_training.jl`` with both toggles off).
    """
    table = {
        "mpp": dict(use_mpp=True, use_conv_adj=False),
        "conv-adj": dict(use_mpp=False, use_conv_adj=True),
        "none": dict(use_mpp=False, use_conv_adj=False),
    }
    try:
        return table[name]
    except KeyError:
        raise SystemExit(f"unknown base closure {name!r} (expected one of {sorted(table)})") from None


_MPP_FIELDS = ("nu_0", "nu_minus", "Ri_c", "delta_Ri", "Pr")


def _mpp_meta(model) -> dict:
    """The model's mPP parameters as floats, for checkpoint meta.

    Always recorded: NNs trained over calibrated mPP parameters form a
    different closure than the same NNs over the defaults (the JAX
    package's calibrated-base checkpoint scored 500x worse when evaluated
    over the default base).
    """
    return {k: float(getattr(model.mpp, k)) for k in _MPP_FIELDS}


def _restore_mpp(meta: dict, override_path: str | None = None, device=None) -> dict:
    """``_wind_model`` overrides restoring the training-time mPP parameters (f32, on ``device``).

    ``override_path`` (an ``optimise-mpp`` ``mpp_parameters.json``) wins
    over ``meta["mpp"]``; with neither, returns ``{}`` (the defaults).
    """
    from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

    params = None
    if override_path:
        with open(override_path) as f:
            params = json.load(f)
    elif meta.get("mpp"):
        params = meta["mpp"]
    if params is None:
        return {}
    device = resolve_device(device)
    return {"mpp": MPPParameters(**{k: torch.tensor(params[k], dtype=torch.float32, device=device)
                                    for k in _MPP_FIELDS})}


def _save_nns(output: str, nns, meta: dict):
    """Save flux MLPs with their ``arch`` (sizes and activation per member) in ``meta.json``.

    A stacked ensemble (``meta["ensemble"] = K``) is saved whole; its arch
    is read from member 0.
    """
    from climateparameterizations_jl_tpu_torch.train.checkpoint import save_checkpoint

    arch_src = nns
    if meta.get("ensemble"):
        from climateparameterizations_jl_tpu_torch.train.deep_ensemble import member

        arch_src = member(nns, 0)
    arch = {}
    for name in ("uw", "vw", "wT"):
        nn = getattr(arch_src, name, None)
        if nn is not None:
            arch[name] = {"sizes": list(nn.sizes), "activation": nn.activation}
    save_checkpoint(output, nns, {**meta, "arch": arch})


def _load_nns(directory: str, device=None):
    """``(nns, meta)`` of a run directory written by either package's ``_save_nns``."""
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_run

    return load_run(directory, device)


def _load_fc_nn(directory: str, device=None):
    """``(nn, meta)`` of a ``train-fc-nde`` run directory written by either package (``MLP`` or ``ConvMLP``)."""
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_fc_run

    return load_fc_run(directory, device)


def _resolve_train_state(directory: str | None) -> str | None:
    """``--resume-from`` accepts a run directory (holding ``train_state/``) or the train-state directory."""
    if directory is None:
        return None
    nested = os.path.join(directory, "train_state")
    return nested if os.path.isdir(nested) else directory


def _parse_curriculum(spec, n_frames: int, n_substeps: int, maxiters: int, lr: float, default_window: int):
    """Parse ``"w[:s],w[:s],..."`` into :class:`CurriculumStage` objects.

    Windows clamp to the available frames, and each stage's ``n_substeps``
    scales by its stride so the inner step stays ``dt_save / n_substeps``
    (the reference's ``1:9:1153`` tranges are strided save ranges,
    ``train_NDE_args.jl:197``).
    """
    from climateparameterizations_jl_tpu_torch.train.nde import CurriculumStage

    def parse_stage(x: str):
        w, _, s = x.partition(":")
        return int(w), int(s) if s else 1

    windows = [parse_stage(x) for x in spec.split(",")] if spec else [(default_window, 1)]
    if any(w > n_frames for w, _ in windows):
        print(f"warning: clamping training windows {windows} to {n_frames} available frames")
        windows = [(min(w, n_frames), s) for w, s in windows]
    return [
        CurriculumStage(tsteps=np.arange(0, w, s), maxiters=maxiters, learning_rate=lr, n_substeps=n_substeps * s)
        for w, s in windows
    ]


def _history_writer(output: str, print_every: int = 10):
    """A train-loop callback appending ``{"iter", "loss", <channels>}`` to ``output/history.jsonl``.

    Every ``print_every`` iterations it prints the channels' shares of the
    loss (the reference's training callback, ``NDE_training.jl:343-369``).
    """
    from climateparameterizations_jl_tpu_torch.train.checkpoint import history_path

    hist = history_path(output)

    def callback(i, total, channels=None, *_rest):
        rec = {"iter": int(i), "loss": float(total)}
        if channels is not None:
            rec.update(channels.as_floats())
        hist.append(rec)
        if print_every and i % print_every == 0 and channels is not None:
            parts = {k: v for k, v in rec.items() if k not in ("iter", "loss")}
            s = sum(parts.values())
            if s > 0:
                pct = " ".join(f"{k} {100.0 * v / s:.1f}%" for k, v in parts.items())
                print(f"  iter {i}: loss {total:.4e} | {pct}", flush=True)

    return callback


@contextlib.contextmanager
def _profiler_trace(directory: str, device: torch.device):
    """``torch.profiler`` over the block, written to ``directory/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def _select_sims(ds, keep):
    """The members ``keep`` (an index array or an int) of a suite stacked on its leading axis."""
    return dataclasses.replace(ds, **{
        f.name: getattr(ds, f.name)[keep] for f in dataclasses.fields(ds) if getattr(ds, f.name) is not None
    })


def cmd_catalog(args) -> int:
    from climateparameterizations_jl_tpu_torch.data.registry import FREE_CONVECTION_IDS, WIND_MIXING_CATALOG

    print("# wind_mixing catalog (%d simulations)" % len(WIND_MIXING_CATALOG))
    for name in WIND_MIXING_CATALOG:
        print(name)
    print("# free_convection ids:", ", ".join(str(i) for i in FREE_CONVECTION_IDS))
    return 0


def cmd_extract(args) -> int:
    from climateparameterizations_jl_tpu_torch.train.checkpoint import extract_checkpoint

    extract_checkpoint(args.run_dir, args.out_dir)
    print(f"extracted {args.run_dir} -> {args.out_dir}")
    return 0


def cmd_train_nn(args) -> int:
    """Direct flux regression: one MLP per flux of ``--fluxes`` on the suite's (state, flux) pairs.

    The JAX package's ``train-nn``: ``3 Nz -> hidden -> Nz - 1`` MLPs, drawn
    one after another from one ``torch.Generator`` seeded with ``--seed``,
    trained full batch by adam; saved with ``meta["arch"]`` per flux.
    """
    from climateparameterizations_jl_tpu_torch.closures import mlp
    from climateparameterizations_jl_tpu_torch.data.containers import direct_regression_pairs, fit_wind_mixing_scalings
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs
    from climateparameterizations_jl_tpu_torch.train.nn import train_flux_nn

    device = resolve_device(args.device)
    ds = _load_suite(_sims(args.sims), args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
    scalings = fit_wind_mixing_scalings(ds)
    gen = torch.Generator().manual_seed(args.seed)
    trained = {}
    for flux in _sims(args.fluxes):
        x, y = direct_regression_pairs(ds, scalings, flux)
        nn = mlp.mlp_init(gen, [3 * args.nz, args.hidden, args.nz - 1], args.activation, device=device)
        nn, history = train_flux_nn(nn, x, y, learning_rate=args.lr, epochs=args.epochs,
                                    gradient_scaling=args.gradient_scaling, dz_hat=1.0 / args.nz,
                                    causality=args.spatial_causality)
        trained[flux] = nn
        print(f"train-nn[{flux}]: loss {history[0]:.4e} -> {history[-1]:.4e}")
    nns = FluxNNs(uw=trained.get("uw"), vw=trained.get("vw"), wT=trained.get("wT"))
    _save_nns(args.output, nns, {"command": "train-nn", "sims": args.sims, "nz": args.nz})
    print(f"saved checkpoint to {args.output}")
    return 0


def cmd_train_nde(args) -> int:
    """Wind-mixing NDE training: curriculum stages, optional multiple shooting, checkpoints.

    The JAX package's ``train-nde``. ``--shooting K`` trains each stage
    whose save-interval count K divides on a multiple-shooting batch (every
    (sim, window) pair on the batch axis). ``--mpp-params`` trains over a
    calibrated mPP base; without it the base is the default one, also after
    ``--init-from`` a checkpoint trained over another base (as in the JAX
    command: pass that checkpoint's ``meta["mpp"]`` as ``--mpp-params`` to
    keep it). The output directory holds the MLPs (``state.npz``, ``meta.json`` with the
    ``mpp`` used), ``history.jsonl`` and ``train_state/`` (params and
    optimizer state after every stage, for ``--resume-from``). ``--ensemble
    K`` trains K stacked members (``train/deep_ensemble.py``; adam or sgd
    only), all on the solve's batch axis where their MLPs pack into one
    chain (else one solve per member); ``--init-from`` then needs a K-member
    run.
    """
    if args.fast_assembly in ("off", False):
        args.fast_assembly = False
    elif args.fast_assembly in ("on", True):
        args.fast_assembly = True
    # Fail fast on an explicit --fast-assembly misconfiguration, before any data loads.
    if args.fast_assembly and args.fast_assembly != "auto":
        if args.smooth_nn:
            raise SystemExit("train-nde: --fast-assembly does not apply the NN smoothing filter; drop --smooth-nn")
        if args.method not in ("split", "rk4"):
            raise SystemExit(f"train-nde: --fast-assembly supports --method split or rk4 (got {args.method!r})")
        if args.method == "rk4" and args.smooth_ri:
            raise SystemExit("train-nde: --fast-assembly with --method rk4 does not apply the Ri smoothing filter; "
                             "drop --smooth-ri")
    if args.ensemble and args.optimizer not in ("adam", "sgd"):
        raise SystemExit(f"train-nde: --ensemble requires an elementwise optimizer (adam/sgd); {args.optimizer} "
                         f"couples members through its shared linesearch")

    from climateparameterizations_jl_tpu_torch.closures.mlp import wind_mixing_mlp
    from climateparameterizations_jl_tpu_torch.data.containers import multiple_shooting_tensors, training_tensors
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, train_wind_mixing_nde

    device = resolve_device(args.device)
    names = _sims(args.sims)
    ds = _load_suite(names, args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
    # Mixed suites are fine: the amplitude is per sim (constant-flux members
    # carry 0 and keep their frozen BC).
    diurnal = any(_suite_diurnal_flags(names))
    ensemble = int(args.ensemble or 0)

    def init_member(gen):
        return FluxNNs(*(wind_mixing_mlp(gen, args.nz, scale=args.init_scale, device=device) for _ in range(3)))

    if args.init_from:
        nns, init_meta = _load_nns(args.init_from, device)
        if int(init_meta.get("ensemble", 0) or 0) != ensemble:
            raise SystemExit(f"train-nde: --init-from checkpoint ensemble size {init_meta.get('ensemble', 0) or 0} "
                             f"does not match --ensemble {ensemble}")
    elif ensemble:
        from climateparameterizations_jl_tpu_torch.train.deep_ensemble import init_ensemble

        nns = init_ensemble(torch.Generator().manual_seed(args.seed), ensemble, init_member)
    else:
        nns = init_member(torch.Generator().manual_seed(args.seed))
    model = _wind_model(
        ds, args.nz, diurnal=diurnal, smooth_NN=args.smooth_nn, smooth_Ri=args.smooth_ri,
        **_base_closure_overrides(args.base_closure),
        **_restore_mpp({}, args.mpp_params, device),
    )
    config = NDETrainConfig(
        learning_rate=args.lr, maxiters=args.maxiters, n_substeps=args.n_substeps,
        method=args.method, gradient_scaling=args.gradient_scaling,
        optimizer=args.optimizer, tridiag_backend=args.tridiag_backend,
        fast_assembly=args.fast_assembly,
        training_fractions=(
            {"T": args.fraction_T, "dTdz": args.fraction_dTdz, "profile": args.fraction_profile}
            if args.auto_balance
            else None
        ),
    )
    stages = _parse_curriculum(args.curriculum, ds.t.shape[-1], args.n_substeps, args.maxiters, args.lr,
                               default_window=args.n_train_steps)
    if len(stages) == 1:
        # One stage runs with stages=None below, which bypasses the per-stage
        # override: carry its stride-scaled n_substeps in the config.
        config = dataclasses.replace(config, n_substeps=stages[0].n_substeps)

    def batch_fn(tsteps):
        # --shooting K: a multiple-shooting batch where K divides the stage's
        # save intervals; short stages keep the plain batch.
        t_arr = np.asarray(tsteps)
        K = args.shooting
        if K and len(t_arr) > K and (len(t_arr) - 1) % K == 0:
            return multiple_shooting_tensors(ds, model.scalings, t_arr, K, tau=model.tau, diurnal=diurnal)
        return training_tensors(ds, model.scalings, tsteps, tau=model.tau, diurnal=diurnal)

    batch = batch_fn(stages[0].tsteps)
    if ensemble:
        from climateparameterizations_jl_tpu_torch.models.wind_mixing import pack_member_flux_nns
        from climateparameterizations_jl_tpu_torch.train.deep_ensemble import train_wind_mixing_deep_ensemble

        # Packable members ride the solve's batch axis: one Thomas launch per solve for all of them.
        train = functools.partial(train_wind_mixing_deep_ensemble, member_fold=pack_member_flux_nns(nns) is not None)
    else:
        train = train_wind_mixing_nde
    with _profiler_trace(args.trace, device) if args.trace else contextlib.nullcontext():
        nns, history = train(
            model, nns, batch, config,
            stages=stages if len(stages) > 1 else None,
            full_batch_fn=batch_fn if len(stages) > 1 else None,
            callback=_history_writer(args.output),
            checkpoint_dir=os.path.join(args.output, "train_state"),
            resume_from=_resolve_train_state(args.resume_from),
        )
    _save_nns(args.output, nns, {
        "command": "train-nde", "sims": args.sims, "nz": args.nz,
        "smooth_NN": bool(args.smooth_nn), "smooth_Ri": bool(args.smooth_ri),
        "diurnal": bool(diurnal), "base_closure": args.base_closure,
        "ensemble": ensemble, "mpp": _mpp_meta(model),
    })
    first, last = sum(history[0].values()), sum(history[-1].values())
    print(f"train-nde: loss {first:.4e} -> {last:.4e}; saved to {args.output}")
    return 0


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


def cmd_train_fc_nde(args) -> int:
    """Free-convection NDE training: optional flux pre-training, spatial causality, a curriculum.

    The JAX package's ``train-fc-nde``. The suite of ``--sim-ids`` (files
    under ``--data-dir`` where they exist, else the synthetic stand-ins)
    gets one T and one wT scaling and per-simulation boundary fluxes; the
    closure (``--conv w > 1``: a ``ConvMLP``) is drawn from a
    ``torch.Generator`` seeded with ``--seed``, optionally pre-trained on
    (T, wT) pairs, then trained through the NDE solve stage by stage (a
    fresh adam per stage; the last of several stages at ``--lr`` times
    ``--burn-in-lr-decay``). ``--spatial-causality hard`` masks the weights
    and re-masks after every update; ``soft`` acts in pre-training only.
    ``--ensemble K`` draws K closures one after another from the generator,
    pre-trains each on its own and trains them stacked
    (``train_free_convection_deep_ensemble``); the arch is read from member 0.
    The split solver's implicit solves run on ``--tridiag-backend`` (auto:
    the Thomas kernel on the card). Writes ``state.npz``, ``meta.json``
    (scalings, ``base_closure``, ``arch`` with ``conv_width``) and
    ``history.jsonl``, in the JAX command's format.
    """
    from climateparameterizations_jl_tpu_torch.closures import mlp
    from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
    from climateparameterizations_jl_tpu_torch.data.free_convection import (
        FREE_CONVECTION_IDS,
        build_free_convection_model,
        free_convection_regression_pairs,
    )
    from climateparameterizations_jl_tpu_torch.train.checkpoint import save_checkpoint
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, train_free_convection_nde
    from climateparameterizations_jl_tpu_torch.train.nn import train_flux_nn

    device = resolve_device(args.device)
    ids = [int(s) for s in _sims(args.sim_ids)]
    # Held-out ids are the complement by convention, so only out-of-range ids are worth a warning.
    bad = sorted(set(ids) - set(FREE_CONVECTION_IDS))
    if bad:
        print(f"warning: unknown simulation ids {bad} (valid: {sorted(FREE_CONVECTION_IDS)})")
    ds = _load_fc_suite(ids, args.nz, args.data_dir, args.n_save, args.dt_save, args.source, device,
                        args.les_cache_dir)
    T_scaling = ZeroMeanUnitVarianceScaling.fit(ds.T.reshape(-1))
    wT_scaling = ZeroMeanUnitVarianceScaling.fit(ds.wT.reshape(-1))
    t_row = ds.t.reshape(-1, ds.t.shape[-1])[0]
    tau = torch.abs(t_row[-1] - t_row[0])
    # Per-sim BC fluxes on the suite axis: each member trains against its own surface forcing.
    model = build_free_convection_model(ds, T_scaling, wT_scaling, base_closure=args.base_closure)

    ensemble = int(args.ensemble or 0)
    gen = torch.Generator().manual_seed(args.seed)

    def init_fc():
        if args.conv > 1:
            return mlp.free_convection_conv_mlp(gen, args.nz, conv_width=args.conv, device=device)
        return mlp.free_convection_mlp(gen, args.nz, device=device)

    # Ensemble members are drawn one after another from the one generator.
    members = [init_fc() for _ in range(max(ensemble, 1))]
    if args.pretrain_epochs > 0:
        # Flux pre-training: T -> wT regression (train_free_convection_nde.jl:210-216), each member on its own.
        x, y = free_convection_regression_pairs(ds, T_scaling, wT_scaling)
        for mi in range(len(members)):
            members[mi], pre_hist = train_flux_nn(members[mi], x, y, learning_rate=args.lr,
                                                  epochs=args.pretrain_epochs, causality=args.spatial_causality)
            tag = f"[pretrain m{mi}]" if ensemble else "[pretrain]"
            print(f"train-fc-nde{tag}: loss {pre_hist[0]:.4e} -> {pre_hist[-1]:.4e}")

    project = None
    if args.spatial_causality == "hard":
        # Masked now and after every optimizer update, which repopulates masked entries otherwise.
        with torch.no_grad():
            members = [mlp.apply_spatial_causality_mask(m) for m in members]
        project = mlp.apply_spatial_causality_mask_
    elif args.spatial_causality == "soft" and args.pretrain_epochs == 0:
        print("warning: --spatial-causality soft only acts during flux pretraining; set --pretrain-epochs > 0 or "
              "it is a no-op")

    n_frames = int(ds.t.shape[-1])
    stages = _parse_curriculum(args.curriculum, n_frames, args.n_substeps, args.maxiters, args.lr,
                               default_window=min(args.n_train_steps, n_frames))

    def stage_tensors(tsteps):
        idx = torch.as_tensor(np.asarray(tsteps), dtype=torch.long, device=device)
        T_sel = ds.T.index_select(-2, idx)
        T0, targets = T_scaling.scale(T_sel[..., 0, :]), T_scaling.scale(T_sel)
        if T0.dim() == 1:
            T0, targets = T0[None], targets[None]
        return T0, targets, t_row.index_select(0, idx) / tau

    if ensemble:
        from climateparameterizations_jl_tpu_torch.train.deep_ensemble import (
            member,
            stack_members,
            train_free_convection_deep_ensemble,
        )

        nn, fc_train = stack_members(members), train_free_convection_deep_ensemble
    else:
        nn, fc_train = members[0], train_free_convection_nde
    history = []
    for stage_i, stage in enumerate(stages):
        lr = args.lr * (args.burn_in_lr_decay if stage_i == len(stages) - 1 and len(stages) > 1 else 1.0)
        config = NDETrainConfig(learning_rate=lr, maxiters=args.maxiters, n_substeps=stage.n_substeps,
                                method=args.method, tridiag_backend=args.tridiag_backend)
        T0, targets, t = stage_tensors(stage.tsteps)
        nn, h = fc_train(model, nn, T0, targets, t, config, callback=_history_writer(args.output), project=project)
        history.extend(h)
    meta = {
        "command": "train-fc-nde", "sim_ids": ids, "conv": args.conv, "ensemble": ensemble,
        # What evaluation needs to rebuild the training-time model: the
        # closure only makes sense under its scalings and base closure.
        "base_closure": args.base_closure,
        "scalings": {
            "T": {"mu": float(T_scaling.mu), "sigma": float(T_scaling.sigma)},
            "wT": {"mu": float(wT_scaling.mu), "sigma": float(wT_scaling.sigma)},
        },
    }
    arch_src = member(nn, 0) if ensemble else nn
    if isinstance(arch_src, mlp.ConvMLP):
        meta["arch"] = {"sizes": list(arch_src.mlp.sizes), "activation": arch_src.mlp.activation,
                        "conv_width": arch_src.width}
    else:
        meta["arch"] = {"sizes": list(arch_src.sizes), "activation": arch_src.activation}
    save_checkpoint(args.output, nn, meta)
    first, last = sum(history[0].values()), sum(history[-1].values())
    print(f"train-fc-nde: loss {first:.4e} -> {last:.4e}; saved to {args.output}")
    return 0


def cmd_optimise_mpp(args) -> int:
    """mPP parameter calibration on the suite's first ``--n-train-steps`` frames; writes ``mpp_parameters.json``.

    The JAX package's ``optimise-mpp``: ``--calibration-method gradient``
    (projected ``--optimizer`` adam, sgd or lbfgs through the solve; the
    json holds the five parameters of the best evaluated iterate,
    ``loss_initial`` and ``loss_final``) or ``eki`` (``--n-ensemble``
    parameter sets on the solve's batch axis for ``--n-eki-iters``
    iterations, the EKI noise seeded with ``--seed``; the json holds the
    ensemble-mean parameters, ``posterior_std`` and the first and last
    misfits). Diurnal members set the model's diurnal flag: without it the
    cycling surface flux freezes at its frame-0 value.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import training_tensors
    from climateparameterizations_jl_tpu_torch.train.mpp_calibration import calibrate_mpp_eki, optimise_mpp_parameters
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    device = resolve_device(args.device)
    names = _sims(args.sims)
    ds = _load_suite(names, args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
    model = _wind_model(ds, args.nz, diurnal=any(_suite_diurnal_flags(names)))
    batch = training_tensors(ds, model.scalings, np.arange(0, args.n_train_steps), tau=model.tau)
    config = NDETrainConfig(learning_rate=args.lr, maxiters=args.maxiters, n_substeps=args.n_substeps,
                            method=args.method, optimizer=args.optimizer)
    if args.calibration_method == "eki":
        params, eki = calibrate_mpp_eki(model, batch, config, generator=torch.Generator().manual_seed(args.seed),
                                        n_ensemble=args.n_ensemble, n_iterations=args.n_eki_iters,
                                        inflation=args.eki_inflation)
        result = {name: float(getattr(params, name)) for name in eki.names}
        result["posterior_std"] = {name: float(s) for name, s in zip(eki.names, eki.theta_std.tolist())}
        result["misfit_initial"] = eki.misfit_history[0]
        result["misfit_final"] = eki.misfit_history[-1]
    else:
        params, history = optimise_mpp_parameters(model, batch, config)
        result = {name: float(getattr(params, name)) for name in ("nu_0", "nu_minus", "Ri_c", "delta_Ri", "Pr")}
        # loss_final: the best evaluated loss, the one the returned (best) iterate achieved.
        result.update(loss_initial=float(history[0][0]), loss_final=float(min(h[0] for h in history)))
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "mpp_parameters.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return 0


def cmd_calibrate_kpp(args) -> int:
    """KPP parameter calibration on the suite's first ``--n-train-steps`` frames; writes ``kpp_parameters.json``.

    The JAX package's ``calibrate-kpp``: ``--calibration-method random`` (the
    reference's recipe: ``--n-plugin`` uniform draws, then ``--n-line-search``
    finite-difference line-search iterations), ``gradient`` (the same draws,
    then projected adam through the solve) or ``eki`` (``--n-ensemble``
    parameter sets for ``--n-eki-iters`` iterations). Every population of
    parameter sets is one KPP solve whose steps each run one Thomas launch
    on the card. The draws come from a generator seeded with ``--seed``. The
    json holds the calibrated values and ``loss`` (random, gradient), or each
    parameter's posterior ``mean`` and ``std`` and the last ``misfit`` (eki).
    """
    device = resolve_device(args.device)
    ds = _load_suite(_sims(args.sims), args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
    tsteps = np.arange(0, min(args.n_train_steps, ds.t.shape[-1]))
    generator = torch.Generator().manual_seed(args.seed)
    if args.calibration_method == "eki":
        from climateparameterizations_jl_tpu_torch.train.eki import calibrate_kpp_eki

        _, eki = calibrate_kpp_eki(ds, tsteps, args.nz, generator=generator, n_ensemble=args.n_ensemble,
                                   n_iterations=args.n_eki_iters, inflation=args.eki_inflation)
        result = {name: {"mean": float(m), "std": float(sd)}
                  for name, m, sd in zip(eki.names, eki.theta_mean.tolist(), eki.theta_std.tolist())}
        result["misfit"] = eki.misfit_history[-1]
    else:
        from climateparameterizations_jl_tpu_torch.train.kpp_calibration import calibrate_kpp

        _, info = calibrate_kpp(ds, tsteps, args.nz, generator=generator, n_plugin=args.n_plugin,
                                n_line_search=args.n_line_search,
                                refine="gradient" if args.calibration_method == "gradient" else "line-search")
        result = {name: float(v) for name, v in zip(info["names"], info["values"].tolist())}
        result["loss"] = info["final_loss"]
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "kpp_parameters.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return 0


# Flags of the JAX commands that need modules still to be ported (ROADMAP.md, queue 1).
_FIGURES = "queue 1, item 10 (eval/animations.py)"


def _refuse(flag: str, what: str, item: str):
    raise SystemExit(f"{flag} {what}, which waits for the port of ROADMAP.md {item}")


def _write_embedded_jld2(sim_dir: str, ev, ds, Nz: int) -> None:
    """The embedded pair of one evaluation as LESbrary-layout ``baseline.jld2`` / ``neural_network.jld2``.

    The reference's JLD2OutputWriter files (``NDE_oceananigans.jl:421-454``),
    read back by ``eval/profile.py::nde_profile_from_saved``; the sim's
    constants come from its suite ``ds``.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import ColumnTimeSeries
    from climateparameterizations_jl_tpu_torch.data.lesbrary import write_les_profiles

    os.makedirs(sim_dir, exist_ok=True)
    Nt = ev["t"].shape[0]
    first = lambda a: float(a.reshape(-1)[0])  # noqa: E731
    for tag, m in (("baseline", "embedded_baseline"), ("neural_network", "embedded")):
        cts = ColumnTimeSeries(
            u=np.reshape(ev[f"{m}_u"], (Nt, Nz)), v=np.reshape(ev[f"{m}_v"], (Nt, Nz)),
            T=np.reshape(ev[f"{m}_T"], (Nt, Nz)), uw=np.reshape(ev[f"{m}_uw"], (Nt, Nz + 1)),
            vw=np.reshape(ev[f"{m}_vw"], (Nt, Nz + 1)), wT=np.reshape(ev[f"{m}_wT"], (Nt, Nz + 1)),
            t=np.asarray(ev["t"]), H=first(ds.H), f=first(ds.f), g=first(ds.g), alpha=first(ds.alpha),
            beta=first(ds.beta), u_top=first(ds.u_top), theta_top=first(ds.theta_top),
            theta_bottom=first(ds.theta_bottom),
        )
        write_les_profiles(os.path.join(sim_dir, f"{tag}.jld2"), cts)


def cmd_evaluate(args) -> int:
    """NDE-profile comparison of a trained closure against mPP alone and KPP on held-out sims.

    The JAX package's ``evaluate``: the checkpoint's closure over its
    training-time base, with the training suite's scalings (``--sims``, else
    the sims the checkpoint records), on each of ``--test-sims`` over
    ``arange(0, --n-train-steps, --eval-stride)``. Writes
    ``evaluation_<sim>.npz`` (``eval/profile.py::nde_profile``),
    ``uncertainty_<sim>.npz`` for an ensemble checkpoint (whose member 0
    fills the ``nde`` channels) and ``summary.json`` (``per_sim`` and
    ``mean`` of each member's T loss). ``--embedded`` adds the host-column
    pair (``embedded``, ``embedded_baseline``; 10 host steps per save
    interval) and ``--write-jld2`` writes it as LESbrary-layout
    ``<sim>/baseline.jld2`` and ``<sim>/neural_network.jld2`` (h5py). The
    JAX command's figures are not drawn; ``--animate`` and ``--gif-stride`` raise.
    """
    from climateparameterizations_jl_tpu_torch.eval.profile import nde_profile

    if args.animate:
        _refuse("--animate", "draws the comparison animation", _FIGURES)
    if args.gif_stride is not None:
        _refuse("--gif-stride", "sets the comparison animation's frame stride", _FIGURES)
    if args.write_jld2 and not args.embedded:
        raise SystemExit("--write-jld2 requires --embedded (it writes the embedded pair)")
    device = resolve_device(args.device)
    test_sims = _sims(args.test_sims)
    nns, ckpt_meta = _load_nns(args.checkpoint, device)
    ensemble_nns = None
    if ckpt_meta.get("ensemble"):
        from climateparameterizations_jl_tpu_torch.train.deep_ensemble import member

        ensemble_nns, nns = nns, member(nns, 0)
        print(f"deep-ensemble checkpoint (K={int(ckpt_meta['ensemble'])}): 'nde' channels show member 0; "
              f"uncertainty_*.npz / 'nde_ensemble_mean' carry the ensemble", flush=True)
    # Evaluation uses the TRAINING suite's scalings: --sims, else the checkpoint's recorded sims.
    if args.sims:
        train_names, sims_src = _sims(args.sims), "--sims"
    elif ckpt_meta.get("sims"):
        train_names, sims_src = _sims(ckpt_meta["sims"]), "checkpoint meta"
    else:
        train_names, sims_src = test_sims, "test sims (checkpoint records none)"
    train_ds = _load_suite(train_names, args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
    diurnal = bool(ckpt_meta.get("diurnal", any(_suite_diurnal_flags(train_names))))
    model = _wind_model(
        train_ds, args.nz, diurnal=diurnal, smooth_NN=bool(ckpt_meta.get("smooth_NN", False)),
        smooth_Ri=bool(ckpt_meta.get("smooth_Ri", False)),
        **_base_closure_overrides(ckpt_meta.get("base_closure", "mpp")),
        **_restore_mpp(ckpt_meta, args.mpp_params, device),
    )
    tsteps = np.arange(0, args.n_train_steps, args.eval_stride)
    os.makedirs(args.output, exist_ok=True)
    print(f"evaluating {len(test_sims)} sim(s) over {len(tsteps)} frames (window {args.n_train_steps}, stride "
          f"{args.eval_stride}): {', '.join(test_sims)}", flush=True)
    print(f"scaling context from {sims_src}: {len(train_names)} sim(s)", flush=True)

    matrix: dict = {}
    for name in test_sims:
        ds = _load_suite([name], args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
        ev = nde_profile(model, nns, ds, tsteps, solver=args.method, n_substeps=args.n_substeps,
                         include_embedded=args.embedded, kpp_n_substeps=args.kpp_n_substeps)
        np.savez(os.path.join(args.output, f"evaluation_{name}.npz"), **ev.to_dict())
        if args.write_jld2:
            _write_embedded_jld2(os.path.join(args.output, name), ev, ds, args.nz)
        if ensemble_nns is not None:
            from climateparameterizations_jl_tpu_torch.eval.ensemble_uq import nde_ensemble_uq

            uq = nde_ensemble_uq(model, ensemble_nns, ds, tsteps, solver=args.method, n_substeps=args.n_substeps)
            np.savez(os.path.join(args.output, f"uncertainty_{name}.npz"), **uq)
            matrix.setdefault("nde_ensemble_mean", []).append(float(np.mean(uq["losses_ensemble_mean_T"])))
        for m in ("nde", "mpp", "kpp", "embedded", "embedded_baseline"):
            if f"losses_{m}_T" in ev.keys():
                matrix.setdefault(m, []).append(float(np.mean(ev[f"losses_{m}_T"])))

    summary = {m: float(np.mean(v)) for m, v in matrix.items()}
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump({"per_sim": matrix, "mean": summary}, f, indent=2)
    print(json.dumps(summary))
    return 0


def cmd_evaluate_fc(args) -> int:
    """Free-convection comparison (truth, NDE, conv-adj or base, KPP, TKE) across simulation ids.

    The JAX package's ``evaluate-fc`` (``free_convection/test_free_convection_nde.jl:110-165``):
    the checkpoint's training scalings and base closure where its meta
    records them (else refitted per sim, with a warning), each of
    ``--sim-ids`` over ``arange(0, min(--n-eval-steps, frames), --eval-stride)``.
    Writes ``sim<i>.npz`` (``eval/profile.py::free_convection_profile``),
    ``uncertainty_sim<i>.npz`` for an ensemble checkpoint and
    ``summary.json`` (each member's mean T loss over the ids). ``--embedded``
    adds the conv-adj host-column pair and ``--netcdf`` writes it as the
    reference's ``sim<i>/oceananigans_*.nc`` pair (h5py). The loss-matrix
    figure is not drawn.
    """
    from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
    from climateparameterizations_jl_tpu_torch.data.free_convection import build_free_convection_model
    from climateparameterizations_jl_tpu_torch.eval.profile import free_convection_profile

    if args.netcdf and not args.embedded:
        raise SystemExit("--netcdf requires --embedded (it writes the embedded pair)")
    device = resolve_device(args.device)
    nn, meta = _load_fc_nn(args.checkpoint, device)
    ensemble_nn = None
    if meta.get("ensemble"):
        from climateparameterizations_jl_tpu_torch.train.deep_ensemble import member

        ensemble_nn, nn = nn, member(nn, 0)
        print(f"deep-ensemble checkpoint (K={int(meta['ensemble'])}): 'nde' channels show member 0; "
              f"uncertainty_sim*.npz / 'nde_ensemble_mean' carry the ensemble", flush=True)
    ids = [int(s) for s in _sims(args.sim_ids)]
    os.makedirs(args.output, exist_ok=True)
    saved = meta.get("scalings")
    base_closure = meta.get("base_closure", "convective_adjustment")
    if saved is None:
        print("warning: checkpoint has no recorded training scalings; refitting per sim (results not comparable "
              "to training)")
    # The ids' stand-ins come from one batched generation (each id's result is the single-id generator's).
    suite = _load_fc_suite(ids, args.nz, args.data_dir, args.n_save, args.dt_save, args.source, device,
                           args.les_cache_dir)
    matrix: dict = {}
    for k, i in enumerate(ids):
        ds = _select_sims(suite, k) if len(ids) > 1 else suite
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
        if saved is not None:
            T_scaling = ZeroMeanUnitVarianceScaling(f32(saved["T"]["mu"]), f32(saved["T"]["sigma"]))
            wT_scaling = ZeroMeanUnitVarianceScaling(f32(saved["wT"]["mu"]), f32(saved["wT"]["sigma"]))
        else:
            T_scaling = ZeroMeanUnitVarianceScaling.fit(ds.T.reshape(-1))
            wT_scaling = ZeroMeanUnitVarianceScaling.fit(ds.wT.reshape(-1))
        model = build_free_convection_model(ds, T_scaling, wT_scaling, base_closure=base_closure)
        tsteps = np.arange(0, min(args.n_eval_steps, int(ds.t.shape[-1])), args.eval_stride)
        ev = free_convection_profile(model, nn, ds, tsteps, n_substeps=args.n_substeps,
                                     include_embedded=args.embedded, kpp_n_substeps=args.kpp_n_substeps)
        np.savez(os.path.join(args.output, f"sim{i}.npz"), **ev.to_dict())
        if args.netcdf:
            # The reference-layout NetCDF pair (oceananigans_nn.jl:174-192), one directory per simulation.
            from climateparameterizations_jl_tpu_torch.data.netcdf import write_paired_column_netcdf

            sim_dir = os.path.join(args.output, f"sim{i}")
            os.makedirs(sim_dir, exist_ok=True)
            write_paired_column_netcdf(sim_dir, ev["zc"], ev["zf"], ev["t"], ev["embedded_baseline_T"],
                                       ev["embedded_T"], ev["embedded_wT"], attrs={"simulation_id": i})
        if ensemble_nn is not None:
            from climateparameterizations_jl_tpu_torch.eval.ensemble_uq import fc_ensemble_uq

            uq = fc_ensemble_uq(model, ensemble_nn, ds, tsteps, n_substeps=args.n_substeps)
            np.savez(os.path.join(args.output, f"uncertainty_sim{i}.npz"), **uq)
            matrix.setdefault("nde_ensemble_mean", []).append(float(np.mean(uq["losses_ensemble_mean_T"])))
        for m in ("nde", "conv_adj", "base", "kpp", "tke", "embedded", "embedded_baseline"):
            if f"losses_{m}_T" in ev.keys():
                matrix.setdefault(m, []).append(float(np.mean(ev[f"losses_{m}_T"])))

    summary = {m: float(np.mean(v)) for m, v in matrix.items()}
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


def cmd_train_embedded(args) -> int:
    """A-posteriori training: the flux NNs optimized THROUGH the embedded host column.

    The JAX package's ``train-embedded`` (``train/embedded.py``): the host
    column ``evaluate --embedded`` scores, ``--substeps`` host steps per save
    interval, every implicit step one Thomas launch on the card (forward,
    checkpoint recompute and the transposed solve of the backward pass).
    The training sims default to the ``--init-from`` checkpoint's; its NNs
    keep their training scalings (``--scaling-sims``, else the checkpoint's
    sims) and their mPP base (``meta["mpp"]``, or ``--mpp-params``).
    Writes the run directory in the JAX format (``meta["sims"]`` is the
    scaling suite, ``train_sims`` the training one).
    """
    from climateparameterizations_jl_tpu_torch.closures.mlp import wind_mixing_mlp
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import FluxNNs
    from climateparameterizations_jl_tpu_torch.train.embedded import train_embedded_wind_mixing
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    device = resolve_device(args.device)
    init_meta: dict = {}
    nns = None
    if args.init_from:
        nns, init_meta = _load_nns(args.init_from, device)
        if int(init_meta.get("ensemble", 0) or 0):
            raise SystemExit("train-embedded: deep-ensemble checkpoints are not supported yet; extract a member first")
    if args.sims:
        names = _sims(args.sims)
    elif init_meta.get("sims"):
        names = _sims(init_meta["sims"])
    else:
        raise SystemExit("train-embedded: pass --sims (or --init-from a checkpoint that records its sims)")
    ds = _load_suite(names, args.nz, args.data_dir, args.n_save, args.dt_save, device=device)

    if args.scaling_sims:
        scaling_names, scaling_src = _sims(args.scaling_sims), "--scaling-sims"
    elif init_meta.get("sims"):
        scaling_names, scaling_src = _sims(init_meta["sims"]), "checkpoint meta"
    else:
        scaling_names, scaling_src = names, "training sims"
    scaling_ds = ds if scaling_names == names else _load_suite(scaling_names, args.nz, args.data_dir, args.n_save,
                                                               args.dt_save, device=device)
    flags = _suite_diurnal_flags(names)
    diurnal = bool(init_meta.get("diurnal", any(flags))) or any(flags)
    base_closure = init_meta.get("base_closure", args.base_closure)
    model = _wind_model(
        scaling_ds, args.nz, diurnal=diurnal, smooth_NN=bool(init_meta.get("smooth_NN", False)),
        smooth_Ri=bool(init_meta.get("smooth_Ri", False)), **_base_closure_overrides(base_closure),
        **_restore_mpp(init_meta, args.mpp_params, device),
    )
    if nns is None:
        gen = torch.Generator().manual_seed(args.seed)
        nns = FluxNNs(*(wind_mixing_mlp(gen, args.nz, scale=args.init_scale, device=device) for _ in range(3)))
    config = NDETrainConfig(
        learning_rate=args.lr, maxiters=args.maxiters, n_substeps=args.substeps,
        gradient_scaling=args.gradient_scaling, optimizer=args.optimizer, tridiag_backend=args.tridiag_backend,
        training_fractions=(
            {"T": args.fraction_T, "dTdz": args.fraction_dTdz, "profile": args.fraction_profile}
            if args.auto_balance
            else None
        ),
    )
    stages = _parse_curriculum(args.curriculum, int(ds.t.shape[-1]), args.substeps, args.maxiters, args.lr,
                               default_window=args.n_train_steps)
    print(f"train-embedded: {len(names)} sim(s), {len(stages)} stage(s), scaling context from {scaling_src} "
          f"({len(scaling_names)} sim(s))", flush=True)
    nns, history = train_embedded_wind_mixing(
        model, nns, ds, config, stages=stages, callback=_history_writer(args.output),
        checkpoint_dir=os.path.join(args.output, "train_state"), resume_from=_resolve_train_state(args.resume_from),
    )
    _save_nns(args.output, nns, {
        "command": "train-embedded",
        # evaluate reads its scaling context from "sims": the scaling suite, the training sims beside it.
        "sims": ",".join(scaling_names), "train_sims": ",".join(names), "nz": args.nz,
        "smooth_NN": bool(init_meta.get("smooth_NN", False)), "smooth_Ri": bool(init_meta.get("smooth_Ri", False)),
        "diurnal": bool(diurnal), "base_closure": base_closure, "ensemble": 0, "mpp": _mpp_meta(model),
    })
    first, last = sum(history[0].values()), sum(history[-1].values())
    print(f"train-embedded: loss {first:.4e} -> {last:.4e}; saved to {args.output}")
    return 0


def cmd_train_embedded_fc(args) -> int:
    """FC a-posteriori training: the heat-flux NN optimized THROUGH the embedded conv-adj host column.

    The JAX package's ``train-embedded-fc``: the host column ``evaluate-fc
    --embedded`` scores, one Thomas launch per host step on the card
    (forward, recompute, transposed solve). The ids default to the
    ``--init-from`` checkpoint's; its NN keeps its training scalings and
    base closure. Writes an ``evaluate-fc``-compatible run directory.
    """
    from climateparameterizations_jl_tpu_torch.closures import mlp
    from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
    from climateparameterizations_jl_tpu_torch.data.free_convection import (
        FREE_CONVECTION_IDS,
        build_free_convection_model,
    )
    from climateparameterizations_jl_tpu_torch.train.checkpoint import save_checkpoint
    from climateparameterizations_jl_tpu_torch.train.embedded import train_embedded_free_convection
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    device = resolve_device(args.device)
    init_meta: dict = {}
    nn = None
    if args.init_from:
        nn, init_meta = _load_fc_nn(args.init_from, device)
        if int(init_meta.get("ensemble", 0) or 0):
            raise SystemExit("train-embedded-fc: deep-ensemble checkpoints are not supported yet; extract a member "
                             "first")
        if init_meta["arch"]["sizes"][-1] + 1 != args.nz:
            raise SystemExit(f"train-embedded-fc: checkpoint arch is Nz={init_meta['arch']['sizes'][-1] + 1}, got "
                             f"--nz {args.nz}")
    if args.sim_ids:
        ids = [int(s) for s in _sims(args.sim_ids)]
    elif init_meta.get("sim_ids"):
        ids = [int(s) for s in init_meta["sim_ids"]]
    else:
        raise SystemExit("train-embedded-fc: pass --sim-ids (or --init-from a checkpoint that records its sims)")
    bad = sorted(set(ids) - set(FREE_CONVECTION_IDS))
    if bad:
        print(f"warning: unknown simulation ids {bad} (valid: {sorted(FREE_CONVECTION_IDS)})")
    ds = _load_fc_suite(ids, args.nz, args.data_dir, args.n_save, args.dt_save, args.source, device,
                        args.les_cache_dir)

    saved = init_meta.get("scalings")
    if saved is not None:
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
        T_scaling = ZeroMeanUnitVarianceScaling(f32(saved["T"]["mu"]), f32(saved["T"]["sigma"]))
        wT_scaling = ZeroMeanUnitVarianceScaling(f32(saved["wT"]["mu"]), f32(saved["wT"]["sigma"]))
    else:
        T_scaling = ZeroMeanUnitVarianceScaling.fit(ds.T.reshape(-1))
        wT_scaling = ZeroMeanUnitVarianceScaling.fit(ds.wT.reshape(-1))
    base_closure = init_meta.get("base_closure", args.base_closure)
    model = build_free_convection_model(ds, T_scaling, wT_scaling, base_closure=base_closure)
    if nn is None:
        nn = mlp.free_convection_mlp(torch.Generator().manual_seed(args.seed), args.nz, device=device)
    config = NDETrainConfig(learning_rate=args.lr, maxiters=args.maxiters, n_substeps=args.substeps,
                            optimizer=args.optimizer, tridiag_backend=args.tridiag_backend)
    n_frames = int(ds.t.shape[-1])
    stages = _parse_curriculum(args.curriculum, n_frames, args.substeps, args.maxiters, args.lr,
                               default_window=min(args.n_train_steps, n_frames))
    print(f"train-embedded-fc: {len(ids)} sim(s), {len(stages)} stage(s), base '{base_closure}', scalings from "
          f"{'checkpoint' if saved else 'training sims'}", flush=True)
    nn, history = train_embedded_free_convection(
        model, nn, ds, config, stages=stages, callback=_history_writer(args.output),
        checkpoint_dir=os.path.join(args.output, "train_state"), resume_from=_resolve_train_state(args.resume_from),
    )
    meta = {
        "command": "train-embedded-fc", "sim_ids": ids, "conv": init_meta.get("conv", 0), "ensemble": 0,
        "base_closure": base_closure,
        "scalings": {
            "T": {"mu": float(T_scaling.mu), "sigma": float(T_scaling.sigma)},
            "wT": {"mu": float(wT_scaling.mu), "sigma": float(wT_scaling.sigma)},
        },
    }
    if isinstance(nn, mlp.ConvMLP):
        meta["arch"] = {"sizes": list(nn.mlp.sizes), "activation": nn.mlp.activation, "conv_width": nn.width}
    else:
        meta["arch"] = {"sizes": list(nn.sizes), "activation": nn.activation}
    save_checkpoint(args.output, nn, meta)
    first, last = sum(history[0].values()), sum(history[-1].values())
    print(f"train-embedded-fc: loss {first:.4e} -> {last:.4e}; saved to {args.output}")
    return 0


def cmd_double_gyre(args) -> int:
    """The 3-D double gyre, optionally with a free-convection closure on every column.

    The JAX package's ``double-gyre``: ``--days`` of ``--dt`` steps at
    ``--nx`` x ``--ny`` x ``--nz-gyre``, ``--n-frames`` saved; the
    closure of ``--checkpoint`` under its training scalings, behind the
    ``--nn-T-remap`` guard and the optional ``--nn-stability-gate``. Every
    step runs three batched implicit solves, on the Thomas kernel on the
    card (``--tridiag-backend auto``). Writes ``double_gyre.npz`` (T, eta,
    the streamfunction psi in Sv, the surface velocities) and prints psi's
    range; ``--animate`` raises (no figures).
    """
    from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
    from climateparameterizations_jl_tpu_torch.embed.double_gyre import (
        DoubleGyreModel,
        DoubleGyreState,
        barotropic_streamfunction,
        run_double_gyre,
    )
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    if args.animate:
        _refuse("--animate", "draws the basin animation", _FIGURES)
    device = resolve_device(args.device)
    model = DoubleGyreModel.default(Nx=args.nx, Ny=args.ny, Nz=args.nz_gyre, advection=args.advection,
                                    momentum_advection=args.momentum_advection, device=device)
    state0 = DoubleGyreState.rest(model)
    nn = T_scaling = wT_scaling = None
    if args.checkpoint:
        nn, meta = _load_fc_nn(args.checkpoint, device)
        saved = meta.get("scalings")
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
        if saved is not None:
            # The NN is only valid under its training normalization.
            T_scaling = ZeroMeanUnitVarianceScaling(f32(saved["T"]["mu"]), f32(saved["T"]["sigma"]))
            wT_scaling = ZeroMeanUnitVarianceScaling(f32(saved["wT"]["mu"]), f32(saved["wT"]["sigma"]))
        else:
            print("warning: checkpoint has no recorded scalings; using --T-mu/--T-sigma/--wT-sigma flags")
            T_scaling = ZeroMeanUnitVarianceScaling(f32(args.T_mu), f32(args.T_sigma))
            wT_scaling = ZeroMeanUnitVarianceScaling(f32(0.0), f32(args.wT_sigma))

    T_remap = None
    if nn is not None and args.nn_T_remap != "none":
        # The reference remaps basin temperatures into the closure's training range
        # (T_profile = 19.65 + T_profile/20, double_gyre_nn.jl:155). "auto" maps the restoring range
        # [T_north, T_south] to mu +- sigma of the checkpoint's scaling.
        if args.nn_T_remap == "auto":
            mu, sigma = float(T_scaling.mu), float(T_scaling.sigma)
            t_lo, t_hi = float(model.T_north), float(model.T_south)
            b = (t_hi - t_lo) / (2.0 * sigma)
            a = mu - 0.5 * (t_lo + t_hi) / b
        else:
            a, b = (float(s) for s in args.nn_T_remap.split(","))
        T_remap = (a, b)
        print(f"NN T remap: T -> {a:.4g} + T/{b:.4g}")

    nn_stability_gate = None
    if nn is not None and args.nn_stability_gate != "none":
        # The drift guard (embed/double_gyre.py::nn_closure_forcing); "auto" is a tenth of the basin's bulk
        # stratification.
        if args.nn_stability_gate == "auto":
            nn_stability_gate = 0.1 * float(model.T_south - model.T_north) / float(model.H)
        else:
            nn_stability_gate = float(args.nn_stability_gate)
        if not nn_stability_gate > 0:
            raise SystemExit(f"--nn-stability-gate must be a positive stratification scale in K/m (or 'auto'/'none'); "
                             f"got {nn_stability_gate}")
        print(f"NN stability gate: sigmoid(-dT/dz / {nn_stability_gate:.4g} K/m)")

    n_steps = int(args.days * 86400.0 / args.dt)
    save_every = max(1, n_steps // max(args.n_frames, 1))
    traj = run_double_gyre(
        model, state0, dt=args.dt, n_save=max(1, n_steps // save_every), save_every=save_every, nn=nn,
        T_scaling=T_scaling, wT_scaling=wT_scaling, T_remap=T_remap,
        tridiag_backend=resolve_tridiag_backend(args.tridiag_backend, save_every, device),
        nn_stability_gate=nn_stability_gate,
    )
    as_np = lambda x: x.detach().cpu().numpy()  # noqa: E731
    psi = as_np(barotropic_streamfunction(model, traj.u[-1])) / 1e6
    os.makedirs(args.output, exist_ok=True)
    np.savez(os.path.join(args.output, "double_gyre.npz"), T=as_np(traj.T), eta=as_np(traj.eta), psi=psi,
             u_surface=as_np(traj.u[..., -1]), v_surface=as_np(traj.v[..., -1]))
    print(json.dumps({"psi_min_Sv": float(psi.min()), "psi_max_Sv": float(psi.max()), "frames": int(traj.T.shape[0])}))
    return 0


def cmd_generate_les(args) -> int:
    """Run the 3-D LES and save its horizontally averaged profiles (``les_profiles.npz``).

    The JAX package's ``generate-les`` (the reference's LES script
    ``wind_mixing/wind_mixing.jl:1-143``): an ``--n-horizontal^2 x
    --nz-les`` box (``data/les.py``), ``--les-method`` at ``--dt`` or the
    stability bound (CFL 0.6 for rk3, 0.2 for euler), one frame every
    ``round(--dt-save / dt)`` steps, every pressure solve one Thomas launch on
    the card. ``--jld2-name`` takes the catalog entry's signed fluxes,
    Coriolis and diurnal flag (a contradicting ``--qu`` / ``--qb`` or a
    ``--diurnal`` on a constant-flux name is refused before the run) and also
    writes the reference-layout ``.jld2`` under that name (h5py; refused
    before the run where it is not installed). The initial noise comes from a
    ``torch.Generator`` seeded with 0, so the fields are not the JAX
    command's. Prints a JSON line.
    """
    from climateparameterizations_jl_tpu_torch.data.free_convection import save_column_npz
    from climateparameterizations_jl_tpu_torch.data.les import LESConfig, run_les, stable_dt

    diurnal = args.diurnal
    if args.jld2_name:
        from climateparameterizations_jl_tpu_torch.data.lesbrary import HAVE_H5PY
        from climateparameterizations_jl_tpu_torch.data.registry import (
            lesbrary_relative_path,
            signed_momentum_flux,
            simulation_parameters,
        )

        spec = simulation_parameters(args.jld2_name)  # raises on an unknown name, before the run
        lesbrary_relative_path(args.jld2_name)
        if diurnal and not spec.diurnal:
            raise SystemExit(f"--diurnal with constant-flux catalog name {args.jld2_name!r}: downstream loaders would "
                             "pin the cyclic data to a constant amplitude; use a *_diurnal_* name")
        diurnal = diurnal or bool(spec.diurnal)
        # A file written under a catalog name carries that name's forcing.
        spec_qu = signed_momentum_flux(spec)
        for flag, value, spec_value in (("--qu", args.qu, spec_qu), ("--qb", args.qb, spec.Qb)):
            if value is not None and abs(value - spec_value) > 1e-12 * max(abs(spec_value), 1e-30):
                raise SystemExit(f"{flag}={value} contradicts catalog entry {args.jld2_name!r} ({flag[2:]}="
                                 f"{spec_value}); drop the flag (the spec's value is the default) or use a matching name")
        if not HAVE_H5PY:
            raise SystemExit("--jld2-name writes a .jld2 file, which needs h5py; it is not installed")
        qu = spec_qu if args.qu is None else args.qu
        qb = spec.Qb if args.qb is None else args.qb
        f_cor = spec.f
    else:
        qu = args.qu if args.qu is not None else -5e-4
        qb = args.qb if args.qb is not None else 3e-8
        f_cor = 1e-4
    device = resolve_device(args.device)
    config = LESConfig.default(Nx=args.n_horizontal, Ny=args.n_horizontal, Nz=args.nz_les, Qu=qu, Qb=qb, f=f_cor,
                               diurnal=diurnal, device=device)
    cfl = 0.6 if args.les_method == "rk3" else 0.2
    dt = args.dt if args.dt else stable_dt(config, u_max=args.u_max, cfl=cfl)
    save_every = max(1, int(round(args.dt_save / dt)))
    ds = run_les(config, dt=dt, n_save=args.n_save, save_every=save_every, method=args.les_method,
                 max_frames_per_dispatch=args.max_frames_per_dispatch,
                 max_steps_per_dispatch=args.max_steps_per_dispatch).to("cpu")
    os.makedirs(args.output, exist_ok=True)
    path = os.path.join(args.output, "les_profiles.npz")
    save_column_npz(path, ds)
    result = {"output": path, "dt": float(dt), "save_every": save_every, "frames": int(ds.t.shape[-1])}
    if args.jld2_name:
        from climateparameterizations_jl_tpu_torch.data.lesbrary import write_les_profiles

        result["jld2"] = write_les_profiles(os.path.join(args.output, lesbrary_relative_path(args.jld2_name)), ds)
    T = ds.T.numpy()
    result["T_final_range"] = [float(T[-1].min()), float(T[-1].max())]
    result["finite"] = bool(np.isfinite(T).all())
    print(json.dumps(result))
    return 0


def _ensemble_perturbation(seed: int, n_members: int, width: int, device) -> torch.Tensor:
    """The ensemble's standard-normal initial perturbation ``(n_members, width)``, f32, from a ``torch.Generator``."""
    return torch.randn((n_members, width), generator=torch.Generator().manual_seed(seed)).to(device)


def cmd_ensemble(args) -> int:
    """Perturbed-IC column ensemble (uncertainty quantification) on one card.

    The JAX package's ``ensemble``: ``--n-members`` copies of the first
    simulation's initial column, each perturbed by ``--perturbation`` times
    standard-normal noise in scaled units, with that simulation's BCs, run
    over its first ``--n-steps`` frames at ``--n-substeps`` split substeps per
    save, all members in one batched solve per substep
    (``parallel/sharding.py``: a one-device mesh; on the card one Thomas
    launch per substep). ``--checkpoint`` gives the closure (member 0 of a
    deep ensemble) over its training-time mPP base (``--mpp-params`` wins);
    without one the run is physics only. The noise comes from a
    ``torch.Generator`` seeded with ``--seed``, so the members are not the
    JAX command's. Writes ``ensemble.npz`` (per-frame mean and std over the
    members, dimensional t) and prints a JSON line.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import training_tensors
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import BoundaryConditions, FluxNNs, pack_flux_nns
    from climateparameterizations_jl_tpu_torch.parallel.sharding import make_mesh, make_sharded_ensemble_solver
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    device = resolve_device(args.device)
    names = _sims(args.sims)
    ds = _load_suite(names, args.nz, args.data_dir, args.n_save, args.dt_save, device=device)
    if args.checkpoint:
        nns, ckpt_meta = _load_nns(args.checkpoint, device)
        if ckpt_meta.get("ensemble"):
            # This command spreads the initial condition under one closure: member 0.
            from climateparameterizations_jl_tpu_torch.train.deep_ensemble import member

            nns = member(nns, 0)
            print(f"deep-ensemble checkpoint (K={int(ckpt_meta['ensemble'])}): perturbed-IC ensemble runs member 0",
                  flush=True)
    else:
        nns, ckpt_meta = FluxNNs(uw=None, vw=None, wT=None), {}
    # The diurnal amplitude is per sim, so constant members keep their frozen BC under any(flags).
    diurnal = bool(ckpt_meta.get("diurnal", any(_suite_diurnal_flags(names))))
    model = _wind_model(
        ds, args.nz, diurnal=diurnal,
        smooth_NN=bool(ckpt_meta.get("smooth_NN", False)),
        smooth_Ri=bool(ckpt_meta.get("smooth_Ri", False)),
        **_base_closure_overrides(ckpt_meta.get("base_closure", "mpp")),
        **_restore_mpp(ckpt_meta, getattr(args, "mpp_params", None), device),
    )
    packed = pack_flux_nns(nns)
    if packed is not None:  # one fused matmul chain per RHS
        nns = packed

    tsteps = np.arange(0, min(args.n_steps, int(ds.t.shape[-1])))
    batch = training_tensors(ds, model.scalings, tsteps, tau=model.tau, diurnal=diurnal)
    E, width = args.n_members, 3 * args.nz
    # The members perturb the first simulation's initial column and take its BCs; later sims only shape the scalings.
    x0_base = batch.x0.reshape(-1, width)[0]
    x0 = x0_base[None, :] + args.perturbation * _ensemble_perturbation(args.seed, E, width, device)
    bcs = BoundaryConditions(**{
        f.name: torch.broadcast_to(torch.as_tensor(getattr(batch.bcs, f.name), device=device).reshape(-1)[0], (E,))
        for f in dataclasses.fields(BoundaryConditions)
    })
    config = NDETrainConfig(n_substeps=args.n_substeps, method="split")
    solver = make_sharded_ensemble_solver(model, config, make_mesh(device=device))
    t = batch.t.detach().cpu().numpy()
    traj = solver(nns, bcs, x0, float(t[0]), float(t[1] - t[0]), len(t) - 1).cpu().numpy()  # (Nt, E, 3 Nz)

    os.makedirs(args.output, exist_ok=True)
    mean, std = traj.mean(axis=1), traj.std(axis=1)
    np.savez(os.path.join(args.output, "ensemble.npz"), mean=mean, std=std, t=t * float(model.tau))
    print(json.dumps({
        "members": E, "frames": int(traj.shape[0]),
        "final_mean_spread": float(std[-1].mean()),
        "finite": bool(np.isfinite(traj).all()),
    }))
    return 0


def _add_common(p, with_sims: bool = True):
    p.add_argument("--config", default=None, help="JSON/YAML config file (flags typed on the command line win)")
    if with_sims:
        p.add_argument("--sims", default="strong_wind", help="comma-separated catalog names")
        p.add_argument("--data-dir", default=None,
                       help="root of local LESbrary .jld2 files (h5py needed; synthetic stand-ins otherwise)")
        p.add_argument("--nz", type=int, default=32)
        p.add_argument("--n-save", type=int, default=96, help="LES frames to generate or load")
        p.add_argument("--dt-save", type=float, default=600.0)
    p.add_argument("--output", default="runs/latest")
    p.add_argument("--seed", type=int, default=0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="climateparameterizations_jl_tpu_torch", description=__doc__)
    parser.add_argument("--device", default=None, help="torch device (default: cuda; pass cpu to run on the CPU)")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("catalog", help="list dataset catalog names").set_defaults(fn=cmd_catalog)

    p = sub.add_parser("train-nn", help="direct flux regression")
    _add_common(p)
    p.add_argument("--fluxes", default="uw,vw,wT")
    p.add_argument("--hidden", type=int, default=400)
    p.add_argument("--activation", default="relu")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gradient-scaling", type=float, default=0.0)
    p.add_argument("--spatial-causality", default="none", choices=["none", "soft", "hard"])
    p.set_defaults(fn=cmd_train_nn)

    p = sub.add_parser("train-nde", help="wind-mixing triple-NN NDE training")
    _add_common(p)
    p.add_argument("--mpp-params", default=None, metavar="JSON",
                   help="optimise-mpp mpp_parameters.json: build the base closure from these calibrated "
                        "parameters (checkpoints record and restore them)")
    p.add_argument("--init-from", default=None, help="checkpoint dir to warm-start the NNs (and its mPP base)")
    p.add_argument("--init-scale", type=float, default=1e-5)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--maxiters", type=int, default=50)
    p.add_argument("--n-substeps", type=int, default=4)
    p.add_argument("--method", default="split", choices=["split", "rk4", "heun", "euler"])
    p.add_argument("--n-train-steps", type=int, default=32)
    p.add_argument("--curriculum", default=None,
                   help="comma-separated window[:stride] stages, e.g. 200:20,577:12,1153:9")
    p.add_argument("--shooting", type=int, default=0, metavar="K",
                   help="multiple-shooting training: stages whose save-interval count K divides train on K "
                        "truth-anchored windows batched with the sims. 0 = sequential (default)")
    p.add_argument("--gradient-scaling", type=float, default=5e-3)
    p.add_argument("--smooth-nn", action="store_true", help="tri-band running-mean filter on the NN flux outputs")
    p.add_argument("--smooth-ri", action="store_true", help="the same filter on the Ri profile before the mPP nu")
    p.add_argument("--base-closure", default="mpp", choices=["mpp", "conv-adj", "none"],
                   help="physics base under the NN fluxes: mPP (default), convective adjustment, or bare NNs")
    p.add_argument("--auto-balance", action="store_true")
    p.add_argument("--fraction-T", type=float, default=0.8)
    p.add_argument("--fraction-dTdz", type=float, default=0.8)
    p.add_argument("--fraction-profile", type=float, default=0.5)
    p.add_argument("--resume-from", default=None, help="run dir (or its train_state/) with params + optimizer state")
    p.add_argument("--trace", default=None, help="write a torch.profiler Chrome trace to DIR/trace.json")
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "lbfgs"])
    p.add_argument("--ensemble", type=int, default=0, metavar="K",
                   help="train a K-member deep ensemble (independently drawn members stacked on a leading axis, "
                        "trained as K solo runs by one optimizer). 0 = single closure (default)")
    p.add_argument("--tridiag-backend", default="auto", choices=["auto", "scan", "pcr", "cuda"],
                   help="split stepper's implicit solve; auto is the CUDA kernel on the card, scan on the CPU "
                        "(train.nde.resolve_tridiag_backend)")
    p.add_argument("--fast-assembly", nargs="?", const="on", default="auto", choices=["on", "off", "auto", "fold"],
                   help="matmul-assembled RHS/tendencies for split or rk4; 'fold' also precomposes the divergence "
                        "matrix into the last NN layer; 'auto' (default) picks 'fold' where supported; bare "
                        "--fast-assembly means 'on'")
    p.set_defaults(fn=cmd_train_nde)

    p = sub.add_parser("extract", help="compact a run dir into an extracted checkpoint")
    p.add_argument("run_dir")
    p.add_argument("out_dir")
    p.set_defaults(fn=cmd_extract)

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

    p = sub.add_parser("train-fc-nde", help="free-convection NDE training")
    _add_common(p, with_sims=False)
    p.add_argument("--sim-ids", default="1", help="comma-separated LESbrary free-convection ids (1..9)")
    p.add_argument("--data-dir", default=None,
                   help="root of free_convection_<id>/instantaneous_statistics_with_halos.jld2 files (h5py needed)")
    p.add_argument("--source", default="auto", choices=["auto", "synthetic", "les3d"],
                   help="les3d generates the data with the 3-D LES (on the card unless --device cpu)")
    p.add_argument("--les-cache-dir", default=None,
                   help="cache dir for les3d-generated profiles (skip identical LES re-runs; either package's files)")
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--n-save", type=int, default=96)
    p.add_argument("--dt-save", type=float, default=600.0)
    p.add_argument("--base-closure", default="convective_adjustment", choices=["convective_adjustment", "none"])
    p.add_argument("--conv", type=int, default=0, help="conv front-end width (> 1 enables the conv variant)")
    p.add_argument("--spatial-causality", default="none", choices=["none", "soft", "hard"])
    p.add_argument("--pretrain-epochs", type=int, default=0, help="flux-regression pre-training epochs")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--maxiters", type=int, default=50)
    p.add_argument("--n-substeps", type=int, default=4)
    p.add_argument("--method", default="split", choices=["split", "rk4", "heun", "euler"])
    p.add_argument("--n-train-steps", type=int, default=32)
    p.add_argument("--curriculum", default=None, help="comma-separated window[:stride] stages, e.g. 8,16,32")
    p.add_argument("--burn-in-lr-decay", type=float, default=0.1, help="LR factor for the final curriculum stage")
    p.add_argument("--ensemble", type=int, default=0, metavar="K",
                   help="train a K-member deep ensemble (stacked members, each pre-trained on its own, then "
                        "trained as K solo runs by one optimizer). 0 = single closure")
    p.add_argument("--tridiag-backend", default="auto", choices=["auto", "scan", "pcr", "cuda"],
                   help="split solver's implicit solve; auto is the CUDA kernel on the card, scan on the CPU")
    p.set_defaults(fn=cmd_train_fc_nde)

    p = sub.add_parser("optimise-mpp", help="mPP diffusivity parameter calibration")
    _add_common(p)
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "lbfgs"],
                   help="reference uses BFGS/LBFGS (optimise_modified_pacanowski_philander_args.jl:66-72)")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--maxiters", type=int, default=100)
    p.add_argument("--n-substeps", type=int, default=4)
    p.add_argument("--method", default="split", choices=["split", "rk4", "heun", "euler"])
    p.add_argument("--n-train-steps", type=int, default=32)
    p.add_argument("--calibration-method", default="gradient", choices=["gradient", "eki"])
    p.add_argument("--n-ensemble", type=int, default=64)
    p.add_argument("--n-eki-iters", type=int, default=8)
    p.add_argument("--eki-inflation", type=float, default=1.0,
                   help="multiplicative covariance inflation per EKI iteration (1.0 = off, the library default; "
                        "the tempered updates already prevent collapse)")
    p.set_defaults(fn=cmd_optimise_mpp)

    p = sub.add_parser("calibrate-kpp", help="KPP parameter search (random, exact-gradient, or ensemble-Kalman)")
    _add_common(p)
    p.add_argument("--calibration-method", default="random", choices=["random", "gradient", "eki"],
                   help="random = the reference's recipe (plugin + finite-difference line search); gradient = plugin "
                        "+ projected adam through the solve; eki = ensemble Kalman inversion")
    p.add_argument("--n-plugin", type=int, default=64)
    p.add_argument("--n-line-search", type=int, default=20)
    p.add_argument("--n-ensemble", type=int, default=64, help="EKI ensemble size")
    p.add_argument("--n-eki-iters", type=int, default=8)
    p.add_argument("--eki-inflation", type=float, default=1.0,
                   help="multiplicative covariance inflation per EKI iteration (1.0 = off)")
    p.add_argument("--n-train-steps", type=int, default=32)
    p.set_defaults(fn=cmd_calibrate_kpp)

    p = sub.add_parser("evaluate", help="NDE-profile comparison vs baselines")
    _add_common(p)
    p.add_argument("--mpp-params", default=None, metavar="JSON",
                   help="optimise-mpp mpp_parameters.json: build the base closure from these calibrated parameters "
                        "(checkpoints record and restore them)")
    # --sims is the SCALING context (the training suite); None resolves it from the checkpoint's recorded sims.
    p.set_defaults(sims=None)
    p.add_argument("--test-sims", default="strong_wind_weak_cooling")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--method", default="split", choices=["split", "rk4", "heun", "euler"])
    p.add_argument("--n-substeps", type=int, default=4)
    p.add_argument("--n-train-steps", type=int, default=32)
    p.add_argument("--eval-stride", type=int, default=2)
    p.add_argument("--animate", action="store_true", help="not ported: figures wait for " + _FIGURES)
    p.add_argument("--gif-stride", type=int, default=None, help="not ported: the animation's frame stride")
    p.add_argument("--embedded", action="store_true", help="also run the host column model (baseline + NN)")
    p.add_argument("--write-jld2", action="store_true",
                   help="write the embedded pair as LESbrary-layout .jld2 sims (requires --embedded; h5py)")
    p.add_argument("--kpp-n-substeps", type=int, default=1,
                   help="inner KPP steps per save interval: 1 = the reference harness (KPP at the save spacing); "
                        "the eval stride gives KPP its native 600 s step on strided evaluations")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("evaluate-fc", help="free-convection comparison across sim ids")
    p.add_argument("--config", default=None, help="JSON/YAML config file (flags typed on the command line win)")
    p.add_argument("--checkpoint", required=True, help="train-fc-nde output dir")
    p.add_argument("--sim-ids", default="1,2", help="comma-separated free-convection ids to evaluate")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--source", default="auto", choices=["auto", "synthetic", "les3d"],
                   help="les3d generates the data with the 3-D LES (on the card unless --device cpu)")
    p.add_argument("--les-cache-dir", default=None,
                   help="cache dir for les3d-generated profiles (skip identical LES re-runs; either package's files)")
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--n-save", type=int, default=96)
    p.add_argument("--dt-save", type=float, default=600.0)
    p.add_argument("--n-eval-steps", type=int, default=96)
    p.add_argument("--eval-stride", type=int, default=4)
    p.add_argument("--n-substeps", type=int, default=8)
    p.add_argument("--embedded", action="store_true")
    p.add_argument("--netcdf", action="store_true",
                   help="also write the reference-layout oceananigans_*.nc pair per sim (requires --embedded; h5py)")
    p.add_argument("--output", default="runs/eval_fc")
    p.add_argument("--kpp-n-substeps", type=int, default=1,
                   help="inner KPP (and TKE) steps per save interval: 1 = the reference harness; the eval stride "
                        "gives both baselines their native 600 s step on strided evaluations")
    p.set_defaults(fn=cmd_evaluate_fc)

    p = sub.add_parser("train-embedded",
                       help="a-posteriori training: optimize the flux NNs through the embedded host column")
    _add_common(p, with_sims=False)
    p.add_argument("--mpp-params", default=None, metavar="JSON",
                   help="optimise-mpp mpp_parameters.json: build the base closure from these calibrated parameters "
                        "(checkpoints record and restore them)")
    p.add_argument("--sims", default=None, help="comma-separated catalog names (default: the --init-from checkpoint's)")
    p.add_argument("--data-dir", default=None,
                   help="root of local LESbrary .jld2 files (h5py needed; synthetic stand-ins otherwise)")
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--n-save", type=int, default=96, help="LES frames to generate or load")
    p.add_argument("--dt-save", type=float, default=600.0)
    p.add_argument("--init-from", default=None, help="checkpoint dir to fine-tune (train-nde output); omit for a fresh "
                                                     "init")
    p.add_argument("--scaling-sims", default=None,
                   help="override the scaling-context suite (default: the checkpoint's recorded sims)")
    p.add_argument("--init-scale", type=float, default=1e-5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--maxiters", type=int, default=50)
    p.add_argument("--substeps", type=int, default=10,
                   help="host steps per save interval (evaluate --embedded uses 10)")
    p.add_argument("--n-train-steps", type=int, default=32)
    p.add_argument("--curriculum", default=None, help="comma-separated window lengths w[:stride], e.g. 8,16,32")
    p.add_argument("--gradient-scaling", type=float, default=5e-3)
    p.add_argument("--base-closure", default="mpp", choices=["mpp", "conv-adj", "none"],
                   help="host base physics for a FRESH init (--init-from checkpoints carry their own)")
    p.add_argument("--auto-balance", action="store_true")
    p.add_argument("--fraction-T", type=float, default=0.8)
    p.add_argument("--fraction-dTdz", type=float, default=0.8)
    p.add_argument("--fraction-profile", type=float, default=0.5)
    p.add_argument("--resume-from", default=None, help="run dir (or its train_state/) with params + optimizer state")
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "lbfgs"])
    p.add_argument("--tridiag-backend", default="auto", choices=["auto", "scan", "pcr", "cuda"],
                   help="host column's implicit solve; auto is the CUDA kernel on the card, scan on the CPU")
    p.set_defaults(fn=cmd_train_embedded)

    p = sub.add_parser("train-embedded-fc",
                       help="FC a-posteriori training: optimize the heat-flux NN through the embedded conv-adj host "
                            "column")
    _add_common(p, with_sims=False)
    p.add_argument("--sim-ids", default=None, help="comma-separated free-convection ids (default: the --init-from "
                                                   "checkpoint's)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--source", default="auto", choices=["auto", "synthetic", "les3d"],
                   help="les3d generates the data with the 3-D LES (on the card unless --device cpu)")
    p.add_argument("--les-cache-dir", default=None,
                   help="cache dir for les3d-generated profiles (skip identical LES re-runs; either package's files)")
    p.add_argument("--nz", type=int, default=32)
    p.add_argument("--n-save", type=int, default=96)
    p.add_argument("--dt-save", type=float, default=600.0)
    p.add_argument("--init-from", default=None, help="train-fc-nde checkpoint to fine-tune; omit for a fresh init")
    p.add_argument("--base-closure", default="convective_adjustment", choices=["convective_adjustment", "none"],
                   help="host base physics for a FRESH init (--init-from checkpoints carry their own)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--maxiters", type=int, default=50)
    p.add_argument("--substeps", type=int, default=10,
                   help="host steps per save interval (evaluate-fc --embedded uses 10)")
    p.add_argument("--n-train-steps", type=int, default=32)
    p.add_argument("--curriculum", default=None, help="comma-separated window lengths w[:stride], e.g. 8,16,32")
    p.add_argument("--resume-from", default=None, help="run dir (or its train_state/) with params + optimizer state")
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "lbfgs"])
    p.add_argument("--tridiag-backend", default="auto", choices=["auto", "scan", "pcr", "cuda"],
                   help="host column's implicit solve; auto is the CUDA kernel on the card, scan on the CPU")
    p.set_defaults(fn=cmd_train_embedded_fc)

    p = sub.add_parser("double-gyre", help="3-D basin run with optional NN closure")
    _add_common(p, with_sims=False)
    p.add_argument("--nx", type=int, default=96)
    p.add_argument("--ny", type=int, default=96)
    p.add_argument("--nz-gyre", type=int, default=32)
    p.add_argument("--days", type=float, default=30.0)
    p.add_argument("--dt", type=float, default=1800.0)
    p.add_argument("--n-frames", type=int, default=10)
    p.add_argument("--checkpoint", default=None, help="free-convection NN checkpoint dir")
    p.add_argument("--T-mu", type=float, default=10.0)
    p.add_argument("--T-sigma", type=float, default=5.0)
    p.add_argument("--wT-sigma", type=float, default=1e-5)
    p.add_argument("--max-steps-per-dispatch", type=int, default=None,
                   help="accepted for the JAX flag set and ignored: the port runs its steps eagerly")
    p.add_argument("--nn-T-remap", default="auto",
                   help="basin-T -> NN-input remap 'a + T/b': 'auto' (from the checkpoint's scalings), 'none' (raw T), "
                        "or 'A,B' (the reference hardcodes 19.65,20 at double_gyre_nn.jl:155)")
    p.add_argument("--nn-stability-gate", default="none",
                   help="taper the NN flux by sigmoid(-dT/dz / s): 'none' (the reference's ungated behavior), 'auto' "
                        "(s = 0.1 x bulk basin stratification), or a value s in K/m")
    p.add_argument("--animate", action="store_true", help="not ported: figures wait for " + _FIGURES)
    p.add_argument("--tridiag-backend", default="auto", choices=["auto", "scan", "pcr", "cuda"],
                   help="implicit vertical-mixing solves; auto is the CUDA kernel on the card, scan on the CPU")
    p.add_argument("--advection", default="weno5", choices=["weno5", "centered"],
                   help="tracer advection scheme (the reference passes WENO5 model-wide)")
    p.add_argument("--momentum-advection", default="weno5", choices=["weno5", "centered"],
                   help="momentum advection scheme (2nd-order advective form or WENO5 flux form)")
    p.set_defaults(fn=cmd_double_gyre)

    p = sub.add_parser("ensemble", help="perturbed-IC column-ensemble forward run (UQ), all members in one solve")
    _add_common(p)
    p.add_argument("--mpp-params", default=None, metavar="JSON",
                   help="optimise-mpp mpp_parameters.json: build the base closure from these calibrated parameters "
                        "(checkpoints record and restore them)")
    p.add_argument("--checkpoint", default=None, help="trained NNs (default: physics only)")
    p.add_argument("--n-members", type=int, default=256)
    p.add_argument("--perturbation", type=float, default=1e-2, help="IC noise in scaled units")
    p.add_argument("--n-steps", type=int, default=32)
    p.add_argument("--n-substeps", type=int, default=4)
    p.set_defaults(fn=cmd_ensemble)

    p = sub.add_parser("generate-les", help="run the 3-D LES and save averaged training profiles")
    p.add_argument("--n-horizontal", type=int, default=32)
    p.add_argument("--nz-les", type=int, default=32)
    p.add_argument("--qu", type=float, default=None,
                   help="surface momentum flux [m2/s2]; default -5e-4, or the catalog value when --jld2-name is given "
                        "(a mismatch with the named entry is refused)")
    p.add_argument("--qb", type=float, default=None,
                   help="surface buoyancy flux [m2/s3]; default 3e-8, or the catalog value when --jld2-name is given")
    p.add_argument("--dt", type=float, default=None, help="LES step [s] (default: the stability bound)")
    p.add_argument("--u-max", type=float, default=0.2, help="velocity scale for the stability bound")
    p.add_argument("--dt-save", type=float, default=600.0)
    p.add_argument("--n-save", type=int, default=48)
    p.add_argument("--les-method", default="rk3", choices=["euler", "rk3"])
    p.add_argument("--max-frames-per-dispatch", type=int, default=256,
                   help="accepted for the JAX flag set and ignored: the port runs its steps eagerly")
    p.add_argument("--max-steps-per-dispatch", type=int, default=None,
                   help="accepted for the JAX flag set and ignored: the port runs its steps eagerly")
    p.add_argument("--diurnal", action="store_true",
                   help="sinusoidal daily surface-flux cycle (Qb = amplitude); inferred from a diurnal --jld2-name")
    p.add_argument("--jld2-name", default=None, help="also write a reference-layout .jld2 under this catalog name")
    p.add_argument("--output", default="runs/les")
    p.set_defaults(fn=cmd_generate_les)
    return parser


def _explicit_dests(argv) -> set:
    """The dests typed in ``argv``: a re-parse by a parser whose defaults are all suppressed.

    Matching option strings would miss argparse's prefix abbreviations
    (``--maxit`` for ``--maxiters``).
    """
    probe = build_parser()
    parsers = [probe] + [sub for a in probe._subparsers._group_actions for sub in a.choices.values()]  # noqa: SLF001
    for p in parsers:
        for a in p._actions:  # noqa: SLF001
            a.default = argparse.SUPPRESS
        p._defaults.clear()  # noqa: SLF001 - the set_defaults(fn=...) entries
    return set(vars(probe.parse_known_args(argv)[0]))


def _parse_args(argv) -> argparse.Namespace:
    """Parse ``argv``, then fill flags not typed on the command line from ``--config``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    config = _load_config(getattr(args, "config", None))
    if config:
        sub = parser._subparsers._group_actions[0].choices[args.command]  # noqa: SLF001
        defaults = {a.dest: a.default for a in (*parser._actions, *sub._actions)}  # noqa: SLF001
        _apply_config(args, config, defaults, _explicit_dests(argv))
    return args


def main(argv=None) -> int:
    import sys

    args = _parse_args(list(sys.argv[1:] if argv is None else argv))
    return args.fn(args)
