"""Benchmarks of the port on the card.

- :func:`bench_nde_forward` (``climateparameterizations_jl_tpu/benchmarks.py:192``):
  the flagship wind-mixing model, 1,024 columns x 1,024 RK4 steps, through
  the fused runner, i.e. the CUDA kernel ``csrc/fused_rk4.cu`` (or, with bf16
  NN products, ``csrc/fused_rk4_bf16.cu``).
- :func:`bench_train_step` (``studies/flagship_training.py:566 step_bench``):
  one flagship NDE training step, 18 simulations x 1,152 split substeps,
  every implicit solve through the CUDA kernel ``csrc/thomas.cu``.
- :func:`bench_nde_train_step` (``benchmarks.py:274``): one gradient step
  of 8 simulations x a 32-save window, split or rk4 (with or without the
  matmul assembly).
- :func:`bench_tridiagonal` (``benchmarks.py:420``): the batched solve
  alone, kernel against its plain versions and a dense library solve.
- :func:`bench_gp` (``benchmarks.py:116``) and :func:`bench_gp_ml2_step`
  (``:151``): the exact-GP build of three flux models at n = 1,024 and
  D = 96 (the reference's ``Benchmarking.jl:40-52``), and one ML-II step,
  with every Gram through the CUDA kernel ``csrc/gram.cu`` on the
  ``"cuda"`` backend.
- :func:`bench_gram` and :func:`bench_cholesky`: the Gram kernel and the
  Cholesky kernel ``csrc/cholesky.cu`` alone, beside their plain versions
  and yardsticks.

Each is timed with CUDA events after a warm-up, and runs on the card only:
with no card it raises.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import wind_mixing_mlp
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.models.wind_mixing import (
    BoundaryConditions,
    FluxNNs,
    WindMixingModel,
    WindMixingScalings,
    resolve_fast_assembly,
)
from climateparameterizations_jl_tpu_torch.ops.fused_rhs import make_fused_runner_mxu
from climateparameterizations_jl_tpu_torch.physics.mpp import MPPParameters

FORWARD_DT = 1e-5  # non-dimensional step of the JAX package's forward benchmark

# The flagship training suite (studies/flagship_training.py:45-55, reference
# train_NDE_args.jl:39-59) and its final curriculum stage
# (window, stride, maxiters, learning rate), studies/flagship_training.py:87.
TRAIN_FILES = (
    "wind_-5e-4_cooling_3e-8_new", "wind_-5e-4_cooling_1e-8_new",
    "wind_-2e-4_cooling_3e-8_new", "wind_-2e-4_cooling_1e-8_new",
    "wind_-5e-4_heating_-3e-8_new", "wind_-2e-4_heating_-1e-8_new",
    "wind_-2e-4_heating_-3e-8_new", "wind_-5e-4_heating_-1e-8_new",
    "wind_-3.5e-4_cooling_2e-8_new", "wind_-3.5e-4_heating_-2e-8_new",
    "wind_-5e-4_cooling_2e-8_new", "wind_-3.5e-4_cooling_3e-8_new",
    "wind_-3.5e-4_cooling_1e-8_new", "wind_-2e-4_cooling_2e-8_new",
    "wind_-3.5e-4_heating_-3e-8_new", "wind_-3.5e-4_heating_-1e-8_new",
    "wind_-2e-4_heating_-2e-8_new", "wind_-5e-4_heating_-2e-8_new",
)
N_FRAMES = 1153  # 8 days of 600 s saves
FINAL_STAGE = (1153, 9, 200, 2e-4)


def make_setup(Nz: int = 32, n_columns: int = 1024, seed: int = 0, nns=None, device=None):
    """``(model, nns, bcs, x0)``: the flagship configuration of ``__graft_entry__._make_setup``.

    The constants are the JAX package's; the flux MLPs are ``nns`` when
    given, else drawn from a ``torch.Generator`` seeded with ``seed`` (at the
    JAX setup's 1e-5 weight scale). ``x0`` is ``0.1 N(0, 1)`` from a numpy
    generator seeded with ``seed``.
    """
    device = resolve_device(device)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    sc = lambda m, s: ZeroMeanUnitVarianceScaling(f(m), f(s))  # noqa: E731
    scalings = WindMixingScalings(
        u=sc(0.0, 0.05), v=sc(0.0, 0.05), T=sc(19.0, 0.5),
        uw=sc(0.0, 1e-4), vw=sc(0.0, 1e-4), wT=sc(0.0, 1e-5),
    )
    model = WindMixingModel(
        H=f(256.0), tau=f(691200.0), f=f(1e-4), g=f(9.80665), alpha=f(2e-4),
        kappa=f(10.0), scalings=scalings, mpp=MPPParameters.default(torch.float32, device), Nz=Nz,
    )
    if nns is None:
        gen = torch.Generator().manual_seed(seed)
        nns = FluxNNs(*(wind_mixing_mlp(gen, Nz, scale=1e-5, device=device) for _ in range(3)))
    z = f(0.0)
    bcs = BoundaryConditions(uw_bot=z, uw_top=f(-0.5), vw_bot=z, vw_top=z, wT_bot=z, wT_top=f(0.3))
    x0 = np.random.default_rng(seed).normal(size=(n_columns, 3 * Nz)) * 0.1
    return model, nns, bcs, torch.tensor(x0, dtype=torch.float32, device=device)


def _timed(fn, repeats: int, device) -> tuple[list, object]:
    """CUDA-event ms of ``repeats`` calls of ``fn`` after one warm-up; returns ``(times, last result)``."""
    out = fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, out


def _stats(times: list, device) -> dict:
    return {"device": torch.cuda.get_device_name(device), "ms": times, "ms_min": min(times),
            "ms_median": statistics.median(times), "ms_max": max(times)}


def bench_nde_forward(n_columns: int = 1024, Nz: int = 32, n_steps: int = 1024, repeats: int = 5,
                      nns=None, seed: int = 0, device=None, matmul_dtype: str = "float32") -> dict:
    """Time the fused forward solve; returns ms (min/median/max) and column-timesteps/s.

    ``matmul_dtype="bfloat16"`` times the bf16 kernel ``csrc/fused_rk4_bf16.cu``.
    ``calls`` is the number of runner calls made (warm-up included), each
    one kernel launch.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_nde_forward times the CUDA kernel; it needs a card")
    model, nns, bcs, x0 = make_setup(Nz, n_columns, seed, nns, device)
    run = make_fused_runner_mxu(model, nns, bcs, FORWARD_DT, n_steps, n_columns, matmul_dtype=matmul_dtype,
                                device=device)
    # The warm-up call builds and loads the kernel on first use.
    times, out = _timed(lambda: run(x0), repeats, device)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("forward solve produced non-finite values")
    stats = _stats(times, device)
    return {
        **stats, "n_columns": n_columns, "n_steps": n_steps, "repeats": repeats,
        "column_timesteps_per_sec": n_columns * n_steps / (stats["ms_median"] * 1e-3),
        "calls": repeats + 1,
    }


def _require_card(device, what: str) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"{what} times the CUDA kernels; it needs a card")
    return device


def flagship_train_setup(nns=None, names=TRAIN_FILES, Nz: int = 32, n_frames: int = N_FRAMES, seed: int = 0,
                         device=None) -> dict:
    """The flagship step's inputs: suite, model, flux MLPs, config and batch.

    The suite is generated on the CPU and moved to ``device``
    (``cli/main.py::_load_suite``); the model is fitted on it; ``nns`` are
    the given MLPs, else random at the reference's 1e-5 scale from a
    ``torch.Generator`` seeded with ``seed``. The batch is the final stage's
    ``arange(0, window, stride)`` with its config: split stepper, ``stride``
    substeps per save, the flagship loss fractions, ``fast_assembly`` and
    ``tridiag_backend`` on ``"auto"``.
    """
    device = resolve_device(device)
    from climateparameterizations_jl_tpu_torch.cli.main import _load_suite, _wind_model
    from climateparameterizations_jl_tpu_torch.data.containers import training_tensors
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    ds = _load_suite(list(names), Nz, None, n_frames - 1, 600.0, device=device)
    model = _wind_model(ds, Nz)
    if nns is None:
        gen = torch.Generator().manual_seed(seed)
        nns = FluxNNs(*(wind_mixing_mlp(gen, Nz, scale=1e-5, device=device) for _ in range(3)))
    window, stride, _, lr = FINAL_STAGE
    config = NDETrainConfig(learning_rate=lr, n_substeps=stride, method="split",
                            training_fractions={"T": 0.8, "dTdz": 0.8, "profile": 0.5},
                            tridiag_backend="auto", fast_assembly="auto")
    tsteps = np.arange(0, min(window, n_frames), stride)
    batch = training_tensors(ds, model.scalings, tsteps, tau=model.tau)
    return dict(ds=ds, model=model, nns=nns, config=config, batch=batch,
                substeps=(len(tsteps) - 1) * stride)


def _clone_nns(nns) -> FluxNNs:
    return FluxNNs(*(dataclasses.replace(m, weights=tuple(w.detach().clone() for w in m.weights),
                                         biases=tuple(b.detach().clone() for b in m.biases)) for m in nns))


def train_step_loss_and_grad(setup: dict, **config_overrides):
    """One step's scaled loss and flattened gradient at the setup's parameters (left unchanged)."""
    from climateparameterizations_jl_tpu_torch.train.nde import (
        determine_loss_scalings,
        make_wind_mixing_loss_fn,
        nn_parameters,
    )

    config = dataclasses.replace(setup["config"], **config_overrides)
    nns = _clone_nns(setup["nns"])
    params = [p.requires_grad_(True) for p in nn_parameters(nns)]
    scalings = determine_loss_scalings(setup["model"], nns, setup["batch"], config)
    total, _ = make_wind_mixing_loss_fn(setup["model"], setup["batch"], scalings, config)(nns)
    grads = torch.autograd.grad(total, params)
    return total.detach(), torch.cat([g.reshape(-1) for g in grads])


def bench_train_step(setup: dict | None = None, n_timed: int = 5, device=None, **config_overrides) -> dict:
    """Time the flagship training step on the card: loss, IFT backward and adam.

    One warm-up step, then ``n_timed`` steps, each between two CUDA events
    (host work of the step included, as it delays the next launch). The
    loss scalings come from one pre-solve first (no autograd). Starts from a
    copy of ``setup["nns"]``. ``config_overrides`` replace config fields
    (e.g. ``tridiag_backend="scan"``). Returns ms per step (min/median/max),
    the losses and the work done: ``presolve_substeps`` solves without
    autograd (none when the config has no training fractions), and ``steps``
    steps of ``substeps`` substeps each.
    """
    device = _require_card(device, "bench_train_step")
    from climateparameterizations_jl_tpu_torch.train.nde import (
        _make_optimizer,
        determine_loss_scalings,
        make_wind_mixing_loss_fn,
        resolve_tridiag_backend,
    )

    if setup is None:
        setup = flagship_train_setup(device=device)
    config = dataclasses.replace(setup["config"], **config_overrides)
    model, batch = setup["model"], setup["batch"]
    nns = _clone_nns(setup["nns"])
    scalings = determine_loss_scalings(model, nns, batch, config)
    loss_fn = make_wind_mixing_loss_fn(model, batch, scalings, config)
    optimizer = _make_optimizer(config, nns)

    losses = []

    def step():
        optimizer.zero_grad(set_to_none=True)
        total, _ = loss_fn(nns)
        total.backward()
        optimizer.step()
        losses.append(total.detach())

    times, _ = _timed(step, n_timed, device)
    losses = torch.stack(losses).tolist()
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"training step produced a non-finite loss: {losses}")
    stats = _stats(times, device)
    sims = batch.x0.shape[0]
    return {
        **stats,
        "fast_assembly": resolve_fast_assembly(model, setup["nns"], config.method, config.fast_assembly),
        "tridiag_backend": resolve_tridiag_backend(config.tridiag_backend, setup["substeps"], device),
        "sims": sims, "substeps": setup["substeps"], "Nz": model.Nz,
        "column_timesteps_per_sec": sims * setup["substeps"] / (stats["ms_median"] * 1e-3),
        "losses": losses, "steps": 1 + n_timed,
        "presolve_substeps": setup["substeps"] if config.training_fractions is not None else 0,
    }


def nde_train_step_setup(n_sims: int = 8, Nz: int = 32, n_window: int = 32, method: str = "split",
                         fast_assembly: bool | str = "auto", implicit_solve_grad: bool = True,
                         tridiag_backend: str = "auto", nns=None, device=None) -> dict:
    """The inputs of the JAX package's ``bench_nde_train_step`` (``benchmarks.py:274``).

    ``make_setup``'s model with one MLP triple (``nns``, else random at the
    1e-5 scale), ``n_sims`` states ``0.1 N(0, 1)`` from ``numpy`` seed 0,
    constant BCs (``uw_top = -0.5``, ``wT_top = 0.3``), targets that repeat
    the initial state over ``n_window`` saves 1e-3 apart, 4 substeps per
    save, and the fixed loss weights ``LossChannels.ones(gradient_scaling)``
    (no training fractions, so no pre-solve). The keys are those of
    :func:`flagship_train_setup`, so :func:`bench_train_step` and
    :func:`train_step_loss_and_grad` take it.
    """
    device = resolve_device(device)
    from climateparameterizations_jl_tpu_torch.data.containers import TrainingBatch
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    model, nns, _, _ = make_setup(Nz, 1, nns=nns, device=device)
    x0 = torch.tensor(np.random.default_rng(0).normal(size=(n_sims, 3 * Nz)) * 0.1, dtype=torch.float32,
                      device=device)
    zeros = torch.zeros(n_sims, dtype=torch.float32, device=device)
    bcs = BoundaryConditions(uw_bot=zeros, uw_top=zeros - 0.5, vw_bot=zeros, vw_top=zeros, wT_bot=zeros,
                             wT_top=zeros + 0.3, diurnal_amplitude=zeros)
    batch = TrainingBatch(x0=x0, targets=x0[:, None, :].repeat(1, n_window, 1), bcs=bcs,
                          t=torch.linspace(0.0, 1e-3 * (n_window - 1), n_window, device=device),
                          tau=torch.tensor(691200.0, device=device))
    config = NDETrainConfig(n_substeps=4, method=method, fast_assembly=fast_assembly,
                            implicit_solve_grad=implicit_solve_grad, tridiag_backend=tridiag_backend)
    return dict(model=model, nns=nns, config=config, batch=batch, substeps=(n_window - 1) * 4)


def bench_nde_train_step(n_sims: int = 8, Nz: int = 32, n_window: int = 32, method: str = "split",
                         fast_assembly: bool | str = "auto", implicit_solve_grad: bool = True,
                         tridiag_backend: str = "auto", n_timed: int = 5, nns=None, device=None) -> dict:
    """One NDE gradient step of :func:`nde_train_step_setup`, timed on the card.

    The JAX package's ``bench_nde_train_step`` with the same knobs (the
    solver A/B axes: split or rk4, the matmul assembly, IFT solve
    gradients, the tridiagonal backend), timed as :func:`bench_train_step`
    times: CUDA events, one warm-up step, the median of ``n_timed``.
    ``tridiag_backend="auto"`` puts a split step's solves on the Thomas
    kernel (the JAX default, ``"scan"``, is one of the plain versions here).
    """
    device = _require_card(device, "bench_nde_train_step")
    setup = nde_train_step_setup(n_sims, Nz, n_window, method, fast_assembly, implicit_solve_grad,
                                 tridiag_backend, nns=nns, device=device)
    stats = bench_train_step(setup, n_timed=n_timed, device=device)
    return {**stats, "train_steps_per_sec": 1e3 / stats["ms_median"]}


def _device_ms(on_device_events) -> float:
    """Summed device time (ms) of profiler events: kernels, memcpys, memsets."""
    return sum(e.self_device_time_total for e in on_device_events) * 1e-3


def _on_device(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _per_call_ms(fn, repeats: int, device) -> dict:
    """ms per call of ``fn``: ``wall`` back to back (host work included) and ``device``.

    ``wall``: CUDA events around ``repeats`` calls. ``device``: the summed
    execution time of the kernels the calls ran, from ``torch.profiler``,
    over ``repeats`` (gaps between kernels excluded).
    """
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize(device)
    return {"wall": start.elapsed_time(end) / repeats, "device": _device_ms(_on_device(prof)) / repeats}


def bench_tridiagonal(n_systems: int = 16384, N: int = 32, repeats: int = 50, seed: int = 0, device=None) -> dict:
    """The batched solve alone on the card: ms per call of each backend.

    Diagonally dominant systems from a numpy seed (as the JAX benchmark's
    ``0.1 N(0,1)`` off-diagonals, ``1 + |N(0,1)|`` diagonal). ``cuda`` is the
    kernel through its wrapper ``_thomas_cuda``; ``scan`` (its plain version)
    and ``pcr`` are the plain backends; ``library`` is ``torch.linalg.solve``
    on the same systems densified to ``(B, N, N)`` before timing (a yardstick
    the port never calls). For each, ``<name>_ms`` is the device time per
    call and ``<name>_wall_ms`` the time per call back to back with the host
    work (:func:`_per_call_ms`). Also returns the kernel's largest deviation
    from ``scan``.
    """
    device = _require_card(device, "bench_tridiagonal")
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    rng = np.random.default_rng(seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    dl = f(rng.normal(size=(n_systems, N)) * 0.1)
    du = f(rng.normal(size=(n_systems, N)) * 0.1)
    d = f(1.0 + np.abs(rng.normal(size=(n_systems, N))))
    b = f(rng.normal(size=(n_systems, N)))
    A = torch.diag_embed(d) + torch.diag_embed(dl[:, 1:], -1) + torch.diag_embed(du[:, :-1], 1)
    calls = {
        "cuda": lambda: tri._thomas_cuda(dl, d, du, b),
        "scan": lambda: tri._thomas_scan(dl, d, du, b),
        "pcr": lambda: tri._thomas_pcr(dl, d, du, b),
        "library": lambda: torch.linalg.solve(A, b[..., None])[..., 0],
    }
    out = {"n_systems": n_systems, "N": N, "repeats": repeats}
    results = {name: fn() for name, fn in calls.items()}
    for name, fn in calls.items():
        t = _per_call_ms(fn, repeats, device)
        out[f"{name}_ms"], out[f"{name}_wall_ms"] = t["device"], t["wall"]
    out["max_abs_err_vs_scan"] = float((results["cuda"] - results["scan"]).abs().max())
    out["bytes"] = 5 * n_systems * N * 4
    return out


def profile_train_step(setup: dict, n_saves: int = 2, device=None, **config_overrides) -> dict:
    """Where one training step's time goes: ``torch.profiler`` over a short window.

    One step (loss, backward, adam) over the first ``n_saves`` save intervals
    of the setup's batch, after one unprofiled warm-up step. Returns the
    wall time, the device time of every CUDA kernel, memcpy and memset the
    profiler saw, the device's idle share of the wall time, the device ops
    per substep and the eight largest by device time. Profiling adds host
    time, so the idle share is that of the profiled step. ``device_ops == 0``
    means the profiler saw no device activity (then nothing is measured).
    """
    device = _require_card(device, "profile_train_step")
    from torch.profiler import ProfilerActivity, profile

    from climateparameterizations_jl_tpu_torch.train.nde import (
        _make_optimizer,
        determine_loss_scalings,
        make_wind_mixing_loss_fn,
    )

    config = dataclasses.replace(setup["config"], **config_overrides)
    batch = setup["batch"]
    batch = dataclasses.replace(batch, targets=batch.targets[:, : n_saves + 1], t=batch.t[: n_saves + 1])
    nns = _clone_nns(setup["nns"])
    scalings = determine_loss_scalings(setup["model"], nns, batch, config)
    loss_fn = make_wind_mixing_loss_fn(setup["model"], batch, scalings, config)
    optimizer = _make_optimizer(config, nns)

    def step():
        optimizer.zero_grad(set_to_none=True)
        total, _ = loss_fn(nns)
        total.backward()
        optimizer.step()

    step()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = _on_device(prof)
    busy_ms = _device_ms(on_device)
    ops = sum(e.count for e in on_device)
    substeps = n_saves * config.n_substeps
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "substeps": substeps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "device_ops": ops, "device_ops_per_substep": ops / substeps,
        "top": [(e.key[:60], e.count, e.self_device_time_total * 1e-3) for e in top],
    }


# ---------------------------------------------------------------------------
# Gaussian-process closure
# ---------------------------------------------------------------------------

GP_TARGETS = 33  # Nz + 1 flux faces per flux at Nz = 32


def gp_inputs(n_train: int = 1024, n_features: int = 96, n_targets: int = GP_TARGETS, seed: int = 0, device=None):
    """``(x, ys, z)`` of the GP benchmarks: standard-normal predictors and three target sets.

    The shapes are the JAX package's ``bench_gp`` (reference
    ``Benchmarking.jl:40-52``); the numbers come from a ``torch.Generator``
    seeded with ``seed``, so they are not JAX's (its ``jax.random`` keys).
    """
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n_train, n_features, generator=gen)
    ys = [torch.randn(n_train, n_targets, generator=gen) for _ in range(3)]
    z = torch.linspace(0.0, 1.0, n_features)
    return x.to(device), [y.to(device) for y in ys], z.to(device)


def gp_build_three(x, ys, z, backend: str = "cuda", gamma: float = 1.0):
    """The three flux GPs of the benchmark: one squared-exponential kernel, shared predictors.

    ``gp_fit_multi`` factorizes once with stacked targets on the plain
    backend and fits each flux alone on the kernel backend (one Gram launch
    each), as the JAX package's ``bench_gp`` does for its two backends.
    ``gamma`` is the length scale; the JAX package's benchmark uses 1.
    """
    from climateparameterizations_jl_tpu_torch.closures.gp import get_kernel, gp_fit_multi

    kernel = get_kernel(1, math.log10(gamma), 0.0, "euclidean", dtype=torch.float32, backend=backend, device=x.device)
    return gp_fit_multi(x, ys, [kernel] * 3, z)


def bench_gp(n_train: int = 1024, n_features: int = 96, backend: str = "cuda", repeats: int = 5, seed: int = 0,
             device=None) -> dict:
    """Time the exact-GP build of three flux models (Gram + Cholesky + solve each).

    One warm-up build, then ``repeats`` builds between CUDA events. Returns
    ms per build (min/median/max), ``builds`` (warm-up included) and the
    last build's models.
    """
    device = _require_card(device, "bench_gp")
    x, ys, z = gp_inputs(n_train, n_features, seed=seed, device=device)
    times, models = _timed(lambda: gp_build_three(x, ys, z, backend), repeats, device)
    if not all(bool(torch.isfinite(m.alpha).all()) for m in models):
        raise RuntimeError("GP build produced non-finite weights")
    return {**_stats(times, device), "n_train": n_train, "n_features": n_features, "backend": backend,
            "builds": repeats + 1, "models": models}


def _ml2_raw(device, gamma: float = 1.0):
    """The ML-II parameters ``(log gamma, log sigma, log alpha)`` at ``(gamma, 1, 1)``."""
    return {n: torch.tensor(math.log(gamma) if n == "gamma" else 0.0, dtype=torch.float32, device=device,
                            requires_grad=True) for n in ("gamma", "sigma", "alpha")}


def _ml2_loss(x, y, z, raw, backend: str):
    from climateparameterizations_jl_tpu_torch.closures.gp import GPKernel, gp_fit, mean_log_marginal_loss

    k = GPKernel(gamma=torch.exp(raw["gamma"]), sigma=torch.exp(raw["sigma"]), alpha=torch.exp(raw["alpha"]),
                 backend=backend)
    return mean_log_marginal_loss(gp_fit(x, y, k, z), y, add_constant=True)


def ml2_loss_and_grad(n_train: int = 1024, n_features: int = 96, backend: str = "cuda", seed: int = 0,
                      gamma: float = 1.0, device=None):
    """One ML-II loss and its gradient in ``(log gamma, log sigma, log alpha)`` on the benchmark's inputs.

    The parameters are ``(log gamma, 0, 0)``; ``gamma = 1`` is where the
    JAX package's ``bench_gp_ml2_step`` starts.
    """
    device = resolve_device(device)
    x, ys, z = gp_inputs(n_train, n_features, seed=seed, device=device)
    raw = _ml2_raw(device, gamma)
    loss = _ml2_loss(x, ys[0], z, raw, backend)
    # The squared exponential leaves alpha unused: its gradient is zero.
    grads = torch.autograd.grad(loss, list(raw.values()), allow_unused=True, materialize_grads=True)
    return loss.detach(), torch.stack(grads)


def bench_gp_ml2_step(n_train: int = 1024, n_features: int = 96, backend: str = "cuda", repeats: int = 5,
                      seed: int = 0, device=None) -> dict:
    """Time one ML-II step: the negative log marginal likelihood, its gradient and an adam update.

    The JAX package's ``bench_gp_ml2_step``: a squared-exponential
    :class:`GPKernel` over ``(gamma, sigma, alpha)`` in log space, from 0,
    with adam at learning rate 0.05. Each step builds one Gram (one kernel
    launch on ``backend="cuda"``), factorizes it and differentiates through
    the factorization. Returns ms per step and ``steps`` (warm-up included).
    """
    device = _require_card(device, "bench_gp_ml2_step")
    x, ys, z = gp_inputs(n_train, n_features, seed=seed, device=device)
    raw = _ml2_raw(device)
    optimizer = torch.optim.Adam(list(raw.values()), lr=0.05, betas=(0.9, 0.999), eps=1e-8)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = _ml2_loss(x, ys[0], z, raw, backend)
        loss.backward()
        optimizer.step()
        return loss.detach()

    times, loss = _timed(step, repeats, device)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"ML-II step produced a non-finite loss: {float(loss)}")
    return {**_stats(times, device), "n_train": n_train, "n_features": n_features, "backend": backend,
            "steps": repeats + 1, "loss": float(loss)}


def bench_gram(M: int = 1024, N: int = 1024, D: int = 96, family: str = "squared_exponential",
               repeats: int = 50, seed: int = 0, device=None) -> dict:
    """The Gram kernel alone on the card: device and wall ms per call, beside its plain version.

    ``cuda`` is ``ops/gram.py::gram_cuda`` (the kernel), ``plain`` its plain
    version ``gram_plain``. No single PyTorch call computes a kernel matrix,
    so there is no library yardstick; ``cdist`` (``torch.cdist``, the
    distance part alone) is timed beside it for scale. Times as in
    :func:`bench_tridiagonal`. Also returns the kernel's largest deviation
    from ``gram_plain`` off the coincident pairs.
    """
    device = _require_card(device, "bench_gram")
    from climateparameterizations_jl_tpu_torch.ops import gram as ops_gram

    gen = torch.Generator().manual_seed(seed)
    A = torch.randn(M, D, generator=gen).to(device)
    B = torch.randn(N, D, generator=gen).to(device)
    hyp = [torch.tensor(v, device=device) for v in (1.0, 1.0, 1.0)]
    calls = {
        "cuda": lambda: ops_gram.gram_cuda(A, B, *hyp, family=family),
        "plain": lambda: ops_gram.gram_plain(A, B, *hyp, family=family),
        "cdist": lambda: torch.cdist(A, B),
    }
    out = {"M": M, "N": N, "D": D, "family": family, "repeats": repeats}
    results = {name: fn() for name, fn in calls.items()}
    for name, fn in calls.items():
        t = _per_call_ms(fn, repeats, device)
        out[f"{name}_ms"], out[f"{name}_wall_ms"] = t["device"], t["wall"]
    d2, aa, bb = ops_gram._sq_distances(A, B)
    off = ~(d2 <= 1e-7 * (aa + bb))
    out["max_abs_err_vs_plain"] = float((results["cuda"] - results["plain"]).abs()[off].max())
    out["flops"] = 2 * M * N * D + 2 * (M + N) * D
    out["bytes"] = 4 * (M * D + N * D + M * N)
    return out


def bench_cholesky(n: int = 1024, block: int = 128, repeats: int = 20, seed: int = 0, device=None) -> dict:
    """The Cholesky kernel alone on the card, beside ``cholesky_plain`` and ``torch.linalg.cholesky``.

    The matrix is the jittered squared-exponential Gram of the GP benchmark's
    inputs (``gp_inputs``; gamma = sigma = 1), f32. ``library`` is
    ``torch.linalg.cholesky`` (cuSOLVER), a yardstick the port never calls
    on this kernel's behalf. Times as in :func:`bench_tridiagonal`. Also
    returns the kernel's largest deviation from ``cholesky_plain`` and from
    the library factor, and the factorized ``matrix``.
    """
    device = _require_card(device, "bench_cholesky")
    from climateparameterizations_jl_tpu_torch.closures.gp import default_jitter
    from climateparameterizations_jl_tpu_torch.ops import cholesky as ops_chol
    from climateparameterizations_jl_tpu_torch.ops import gram as ops_gram

    x = gp_inputs(n, seed=seed, device=device)[0]
    K = ops_gram.gram_plain(x, x, 1.0, 1.0)
    K = K + K.max() * default_jitter(K.dtype) * torch.eye(n, device=device)
    calls = {
        "cuda": lambda: ops_chol.cholesky_cuda(K, block),
        "plain": lambda: ops_chol.cholesky_plain(K, block),
        "library": lambda: torch.linalg.cholesky(K),
    }
    out = {"n": n, "block": block, "repeats": repeats}
    results = {name: fn() for name, fn in calls.items()}
    for name, fn in calls.items():
        t = _per_call_ms(fn, repeats, device)
        out[f"{name}_ms"], out[f"{name}_wall_ms"] = t["device"], t["wall"]
    out["max_abs_err_vs_plain"] = float((results["cuda"] - results["plain"]).abs().max())
    out["max_abs_err_vs_library"] = float((results["cuda"] - results["library"]).abs().max())
    out["flops"] = n**3 / 3
    out["bytes"] = 8 * n * n
    out["matrix"] = K
    return out
