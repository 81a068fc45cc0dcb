"""Benchmarks of the port on the card.

- :func:`bench_nde_forward` (``climateparameterizations_jl_tpu/benchmarks.py:192``):
  the flagship wind-mixing model, 1,024 columns x 1,024 RK4 steps, through
  the fused runner, i.e. the CUDA kernel ``csrc/fused_rk4.cu`` (or, with bf16
  NN products, ``csrc/fused_rk4_bf16.cu``).
- :func:`bench_train_step` (``studies/flagship_training.py:566 step_bench``):
  one flagship NDE training step, 18 simulations x 1,152 split substeps
  (or, with ``shooting=K``, 18 K windows of 1,152 / K substeps; with
  ``ensemble=M``, M stacked members, folded onto the batch axis or one
  solve each), every implicit solve through the CUDA kernel
  ``csrc/thomas.cu``.
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
- :func:`bench_fc_forward` (``benchmarks.py:444``, ``BASELINE.md:27``): the
  free-convection convective-adjustment column forward run, 1,024 columns
  x 1,152 split substeps, one implicit solve per substep through the CUDA
  kernel ``csrc/thomas.cu``.
- :func:`bench_kpp` and :func:`bench_tke` (``benchmarks.py:60`` and
  ``:89``): the KPP and TKE baselines over 1,024 columns x 288 steps of a
  2-day column, one stacked solve per step through ``csrc/thomas.cu``.
- :func:`bench_host_column`: the embedded wind-mixing host column
  (``embed/column_model.py``), baseline and +NN over 1,024 columns, one
  stacked solve of ``(u, v, T)`` per host step through ``csrc/thomas.cu``.
- :func:`bench_double_gyre` (``benchmarks.py:321``, ``BASELINE.md``): the
  96x96x32 double gyre with the free-convection MLP on every column, three
  batched solves per step through ``csrc/thomas.cu``.
- :func:`bench_les` (``benchmarks.py:395``): the 3-D LES data generator at
  64^3, forward Euler, one pressure solve per step (the real and imaginary
  parts of every horizontal mode as one batch) through ``csrc/thomas.cu``.
- :func:`bench_column_ensemble` (``benchmarks.py:361``, ``BASELINE.md``):
  the 1,024-member perturbed-IC column ensemble, one split solve of 256
  substeps on one card, one Thomas launch per substep for all members.

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
from climateparameterizations_jl_tpu_torch.studies import flagship_training as fst

FORWARD_DT = 1e-5  # non-dimensional step of the JAX package's forward benchmark

# The flagship training suite, its frames and its final curriculum stage (window, stride, maxiters, learning
# rate): the flagship study's.
TRAIN_FILES, N_FRAMES, FINAL_STAGE = fst.TRAIN_FILES_STANDARD, fst.N_FRAMES, fst.STAGES[-1]


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
    """CUDA-event ms of ``repeats`` calls of ``fn`` after one warm-up (host-clock ms off the card); returns
    ``(times, last result)``."""
    out = fn()
    if device.type != "cuda":
        times = []
        for _ in range(repeats):
            t = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t) * 1e3)
        return times, out
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
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    return {"device": name, "ms": times, "ms_min": min(times),
            "ms_median": statistics.median(times), "ms_max": max(times)}


FORWARD_VARIANTS = ("packed", "fast", "fold")


def rk4_loop(rhs, n_steps: int, dt: float = FORWARD_DT):
    """``run(x0)``: ``n_steps`` eager RK4 steps of ``rhs(x, t)`` from t = 0, without autograd."""
    from climateparameterizations_jl_tpu_torch.models.timestepper import rk4_step

    def run(x):
        with torch.no_grad():
            for i in range(n_steps):
                x = rk4_step(rhs, x, i * dt, dt)
        return x

    return run


def nde_forward_route(model, nns, bcs, n_steps: int, n_columns: int, rhs_variant: str = "packed",
                      chunk_columns: int | None = None, dt: float = FORWARD_DT, matmul_dtype: str = "float32",
                      device=None):
    """``(run, launches_per_call, weight_count)`` of one forward route: ``run(x0)`` is the state after ``n_steps``.

    ``rhs_variant="packed"`` is the fused runner, i.e. the kernel
    ``csrc/fused_rk4.cu`` (or ``fused_rk4_bf16.cu``) on the card and its
    plain version on the CPU; ``"fast"`` and ``"fold"`` are a plain RK4
    loop over :func:`ops.fused_rhs.make_fast_rhs` (without or with the
    divergence folded), the counterpart of the JAX package's XLA scan over
    the same twin. ``chunk_columns`` runs the route once per column chunk
    (one kernel launch each): columns are independent, so the result equals
    one whole run bit for bit. ``weight_count`` is the kernel's packed
    weights (read once per launch), 0 for the eager loops.
    """
    from climateparameterizations_jl_tpu_torch.ops.fused_rhs import make_fast_rhs

    if rhs_variant not in FORWARD_VARIANTS:
        raise ValueError(f"rhs_variant must be 'packed', 'fast' or 'fold', got {rhs_variant!r}")
    if chunk_columns is not None and n_columns % chunk_columns:
        raise ValueError(f"chunk_columns={chunk_columns} must divide n_columns={n_columns}")
    if rhs_variant != "packed" and matmul_dtype != "float32":
        raise ValueError(f"rhs_variant={rhs_variant!r} runs f32 products only")
    width = chunk_columns if chunk_columns is not None and n_columns > chunk_columns else n_columns
    n_chunks = n_columns // width
    weights = 0
    if rhs_variant == "packed":
        evolve = make_fused_runner_mxu(model, nns, bcs, dt, n_steps, width, matmul_dtype=matmul_dtype, device=device)
        if evolve.kernel_weights is not None:
            weights = evolve.kernel_weights.numel()
            if evolve.kernel_frags is not None:
                weights += evolve.kernel_frags.numel() // 2  # bf16: two per f32 word
    else:
        evolve = rk4_loop(make_fast_rhs(model, nns, bcs, fold_divergence=rhs_variant == "fold", device=device),
                          n_steps, dt)

    def run(x0):
        if n_chunks == 1:
            return evolve(x0)
        return torch.cat([evolve(x0[i * width:(i + 1) * width]) for i in range(n_chunks)])

    return run, (n_chunks if rhs_variant == "packed" else 0), weights


def bench_nde_forward(n_columns: int = 1024, Nz: int = 32, n_steps: int = 1024, repeats: int = 5,
                      nns=None, seed: int = 0, device=None, matmul_dtype: str = "float32", packed: bool = True,
                      unroll: int = 4, chunk_columns: int | None = None, rhs_variant: str = "packed") -> dict:
    """Time the forward solve; returns ms (min/median/max) and column-timesteps/s.

    ``matmul_dtype="bfloat16"`` times the bf16 kernel ``csrc/fused_rk4_bf16.cu``.
    ``calls`` is the number of runs made (warm-up included); ``launches``
    the kernel launches they made (one per run and column chunk).
    ``chunk_columns`` and ``rhs_variant`` have the JAX package's meaning
    (:func:`nde_forward_route`); ``unroll`` (the scan unroll) and ``packed``
    are accepted with the JAX checks and recorded: the kernel and the
    eager loops have no scan to unroll.
    """
    return nde_forward_stats(n_columns, Nz, n_steps, repeats, nns, seed, _require_card(device, "bench_nde_forward"),
                             matmul_dtype, packed, unroll, chunk_columns, rhs_variant)


def nde_forward_stats(n_columns: int, Nz: int, n_steps: int, repeats: int, nns, seed: int, device,
                      matmul_dtype: str = "float32", packed: bool = True, unroll: int = 4,
                      chunk_columns: int | None = None, rhs_variant: str = "packed") -> dict:
    """:func:`bench_nde_forward`'s measurement on ``device`` as given: CUDA events on the card, the host clock on
    the CPU (where the kernel's plain version runs)."""
    device = torch.device(device)
    if rhs_variant in ("fast", "fold") and not packed:
        raise ValueError("rhs_variant='fast'/'fold' requires packed=True (keeps the scan unroll comparable)")
    if packed and n_steps % unroll:
        raise ValueError(f"unroll={unroll} must divide n_steps={n_steps}")
    model, nns, bcs, x0 = make_setup(Nz, n_columns, seed, nns, device)
    run, launches_per_call, weights = nde_forward_route(model, nns, bcs, n_steps, n_columns, rhs_variant,
                                                        chunk_columns, matmul_dtype=matmul_dtype, device=device)
    # The warm-up call builds and loads the kernel on first use.
    times, out = _timed(lambda: run(x0), repeats, device)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("forward solve produced non-finite values")
    stats = _stats(times, device)
    h1, h2 = nns.uw.weights[0].shape[0], nns.uw.weights[1].shape[0]
    matmul_flops, other_flops = fused_rk4_flops(n_columns, n_steps, Nz, h1, h2)
    return {
        **stats, "n_columns": n_columns, "n_steps": n_steps, "repeats": repeats, "median_s": stats["ms_median"] * 1e-3,
        "column_timesteps_per_sec": n_columns * n_steps / (stats["ms_median"] * 1e-3),
        "calls": repeats + 1, "launches": (repeats + 1) * launches_per_call, "matmul_flops": matmul_flops,
        "other_flops": other_flops, "bytes": 4 * (2 * n_columns * 3 * Nz + launches_per_call * weights),
        "rhs_variant": rhs_variant, "packed": packed, "unroll": unroll,
        "chunk_columns": chunk_columns,
    }


def nonmatmul_flops_per_column_step(Nz: int, h1: int, h2: int) -> int:
    """The f32 work of the fused RK4 function outside its three NN products, per column and RK4 step.

    Counted from the function as the plain version writes it, whatever a
    kernel's own arithmetic (a cheaper mish does not lower it), per RHS
    evaluation (an FMA is 2; expf, log1pf, tanhf and a division 1 each, so
    this is a lower bound): the face viscosity (3 differences, 3 eps adds,
    Ri 7, the tanh argument 2, tanh, nu 2) on each interior face, the bias
    adds, mish (max, abs, expf, log1pf, add, tanhf, mul) on each hidden
    activation, the mPP term (difference, nu d, coefficient, subtraction) on
    each interior face flux, and the stencil, Coriolis and BC row (7) on each
    lane; then 13 per lane and step for the RK4 stage inputs and combination.
    """
    F, ni = 3 * Nz, Nz - 1
    per_rhs = 18 * ni + 3 * (h1 + h2 + ni) + 7 * 3 * (h1 + h2) + 4 * 3 * ni + 7 * F
    return 4 * per_rhs + 13 * F


def fused_rk4_flops(n_columns: int, n_steps: int, Nz: int, h1: int, h2: int) -> tuple[int, int]:
    """``(matmul, other)`` FLOPs of ``n_steps`` fused RK4 steps over ``n_columns`` columns (``PERF.md`` §6, row 2).

    The products: four RHS evaluations a step of the three packed layers
    ``3 Nz -> 3 h1 -> 3 h2 -> Nz - 1`` (2 per multiply-add); the rest:
    :func:`nonmatmul_flops_per_column_step`.
    """
    F, ni, col_steps = 3 * Nz, Nz - 1, n_columns * n_steps
    matmul = col_steps * 4 * 2 * (F * 3 * h1 + 3 * h1 * h2 + 3 * h2 * ni)
    return matmul, col_steps * nonmatmul_flops_per_column_step(Nz, h1, h2)


def _require_card(device, what: str) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"{what} times the CUDA kernels; it needs a card")
    return device


def fc_forward_setup(n_columns: int = 1024, Nz: int = 32, n_steps: int = 1152, device=None):
    """``(model, T0)`` of the JAX package's ``bench_fc_forward``: the physics-only free-convection column.

    H = 256 m, tau = n_steps x 600 s, a top heat flux of 3e-5 K m/s
    (scaled by sigma_wT = 1e-4), T scaled by (19, 1), and every column the
    linearly stratified profile ``19 + 0.01 (z + H)``.
    """
    from climateparameterizations_jl_tpu_torch.models.free_convection import FreeConvectionModel

    device = resolve_device(device)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    H = 256.0
    Ts = ZeroMeanUnitVarianceScaling(f(19.0), f(1.0))
    ws = ZeroMeanUnitVarianceScaling(f(0.0), f(1e-4))
    model = FreeConvectionModel(
        H=f(H), tau=f(n_steps * 600.0), T_scaling=Ts, wT_scaling=ws, bottom_flux=ws.scale(f(0.0)),
        top_flux=ws.scale(f(3e-5)), kappa=f(10.0), Nz=Nz, base_closure="convective_adjustment",
    )
    zc = (torch.arange(Nz, dtype=torch.float32, device=device) + 0.5) * (H / Nz) - H
    T0 = Ts.scale(torch.broadcast_to(19.0 + 0.01 * (zc + H), (n_columns, Nz)))
    return model, T0


def fc_forward(model, T0, n_steps: int, tridiag_backend: str):
    """One forward run of ``bench_fc_forward``: a single save interval of ``n_steps`` split substeps, no autograd."""
    from climateparameterizations_jl_tpu_torch.models.free_convection import solve_free_convection_split

    with torch.no_grad():
        return solve_free_convection_split(model, None, T0, 0.0, 1.0, 1, n_substeps=n_steps,
                                           tridiag_backend=tridiag_backend)


def bench_fc_forward(n_columns: int = 1024, Nz: int = 32, n_steps: int = 1152, repeats: int = 5,
                     tridiag_backend: str = "auto", device=None) -> dict:
    """Time the free-convection column forward run; returns ms (min/median/max) and column-timesteps/s.

    The JAX package's ``bench_fc_forward`` (``free_convection/convective_adjustment.jl``'s
    operator-split path at the 8-day, 600 s-step scale): ``n_columns``
    columns, ``n_steps`` substeps, each one explicit step of the surface
    flux divergence and one backward-Euler convective adjustment. ``"auto"``
    resolves to the Thomas kernel on the card: ``n_steps`` launches per run.
    CUDA events around each run after one warm-up; ``calls`` counts the runs.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, "bench_fc_forward")
    model, T0 = fc_forward_setup(n_columns, Nz, n_steps, device)
    backend = resolve_tridiag_backend(tridiag_backend, n_steps, device)
    times, out = _timed(lambda: fc_forward(model, T0, n_steps, backend), repeats, device)
    if out.shape != (2, n_columns, Nz) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"free-convection forward run gave shape {tuple(out.shape)} or non-finite values")
    stats = _stats(times, device)
    return {
        **stats, "n_columns": n_columns, "n_steps": n_steps, "repeats": repeats, "tridiag_backend": backend,
        "column_timesteps_per_sec": n_columns * n_steps / (stats["ms_median"] * 1e-3), "calls": repeats + 1,
    }


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
    return dict(ds=ds, model=model, nns=nns, config=config, batch=batch, tsteps=tsteps,
                substeps=(len(tsteps) - 1) * stride)


def shooting_train_setup(setup: dict, shooting: int) -> dict:
    """``setup`` with its batch split into ``shooting`` windows (``multiple_shooting_tensors``).

    The flagship step of ``step_bench(shooting=K)``
    (``studies/flagship_training.py:566``): every (sim, window) pair on the
    batch axis, ``1 / K`` of the substeps per solve.
    """
    from climateparameterizations_jl_tpu_torch.data.containers import multiple_shooting_tensors

    model, tsteps = setup["model"], setup["tsteps"]
    batch = multiple_shooting_tensors(setup["ds"], model.scalings, tsteps, shooting, tau=model.tau)
    substeps = (len(tsteps) - 1) // shooting * setup["config"].n_substeps
    return dict(setup, batch=batch, substeps=substeps)


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


def ensemble_members(setup: dict, ensemble: int, stacked_nns=None):
    """``ensemble`` stacked flux-MLP triples: a copy of ``stacked_nns`` (e.g. a loaded ensemble run), else
    drawn by ``init_ensemble`` from a ``torch.Generator`` seeded with 0 at the reference's 1e-5 scale."""
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import (
        ensemble_size,
        init_ensemble,
        stack_members,
        unstack_members,
    )

    device = setup["batch"].x0.device
    if stacked_nns is None:
        Nz = setup["model"].Nz
        return init_ensemble(torch.Generator().manual_seed(0), ensemble, lambda gen: FluxNNs(
            *(wind_mixing_mlp(gen, Nz, scale=1e-5, device=device) for _ in range(3))))
    if ensemble_size(stacked_nns) != ensemble:
        raise ValueError(f"the given ensemble has {ensemble_size(stacked_nns)} members, not {ensemble}")
    return stack_members([_clone_nns(m) for m in unstack_members(stacked_nns)])


def ensemble_loss_and_grad(setup: dict, stacked_nns, member_fold: bool, scalings=None, **config_overrides) -> dict:
    """One ensemble step's summed loss and flattened gradient (folded or one solve per member); no update.

    ``scalings`` (stacked loss channels) skips the pre-solve, so two forms
    can be compared on the same weights. Returns ``loss``, ``grad``,
    ``scalings`` and the host-clock ms (between two synchronizes) of the
    pre-solve (``presolve_ms``) and of the loss and gradient (``step_ms``).
    """
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import ensemble_size
    from climateparameterizations_jl_tpu_torch.train.nde import nn_parameters

    config = dataclasses.replace(setup["config"], **config_overrides)
    device = setup["batch"].x0.device
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    nns, loss_fn, scalings = _ensemble_step_parts(setup, config, ensemble_size(stacked_nns), member_fold,
                                                  stacked_nns, scalings=scalings)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    params = [p.requires_grad_(True) for p in nn_parameters(nns)]
    total, _ = loss_fn(nns)
    grads = torch.autograd.grad(total, params)
    torch.cuda.synchronize(device)
    return {"loss": total.detach(), "grad": torch.cat([g.reshape(-1) for g in grads]), "scalings": scalings,
            "presolve_ms": (t1 - t0) * 1e3, "step_ms": (time.perf_counter() - t1) * 1e3}


def _ensemble_step_parts(setup: dict, config, ensemble: int, member_fold: bool, stacked_nns=None, batch=None,
                         scalings=None):
    """``(stacked MLPs, loss_fn, scalings)`` of the ensemble step: members, per-member scalings (given, or one
    pre-solve, folded or one per member) and the folded or member-loop loss."""
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import (
        ensemble_loss_scalings,
        make_ensemble_loss_fn,
        make_folded_ensemble_loss_fn,
    )

    model, batch = setup["model"], setup["batch"] if batch is None else batch
    nns = ensemble_members(setup, ensemble, stacked_nns)
    if scalings is None:
        scalings = ensemble_loss_scalings(model, nns, batch, config, member_fold)
    make_loss = make_folded_ensemble_loss_fn if member_fold else make_ensemble_loss_fn
    return nns, make_loss(model, batch, scalings, config), scalings


def bench_train_step(setup: dict | None = None, n_timed: int = 5, device=None, shooting: int = 0,
                     ensemble: int = 0, member_fold: bool = False, stacked_nns=None, **config_overrides) -> dict:
    """Time the flagship training step on the card: loss, IFT backward and adam.

    One warm-up step, then ``n_timed`` steps, each between two CUDA events
    (host work of the step included, as it delays the next launch). The
    loss scalings come from one pre-solve first (no autograd). Starts from a
    copy of ``setup["nns"]``. ``config_overrides`` replace config fields
    (e.g. ``tridiag_backend="scan"``); ``shooting=K`` times the step on the
    setup's K-window multiple-shooting batch (:func:`shooting_train_setup`).
    ``ensemble=M`` times the deep-ensemble step of ``step_bench(ensemble=M)``
    instead: M members (a copy of ``stacked_nns``, else drawn as
    :func:`ensemble_members` draws them) with per-member loss scalings (one
    pre-solve, folded or one per member), their summed loss, folded onto the
    solve's batch axis (``member_fold=True``) or one solve per member.
    Returns ms per step (min/median/max), the losses and the work done:
    ``presolve_substeps`` solves without autograd (none when the config has
    no training fractions), and ``steps`` steps of ``substeps`` substeps
    each over ``sims`` batch rows.
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
    if shooting:
        setup = shooting_train_setup(setup, shooting)
    config = dataclasses.replace(setup["config"], **config_overrides)
    model, batch = setup["model"], setup["batch"]
    if ensemble:
        nns, loss_fn, _ = _ensemble_step_parts(setup, config, ensemble, member_fold, stacked_nns)
    else:
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
        "sims": sims, "shooting": shooting, "ensemble": ensemble, "member_fold": bool(ensemble and member_fold),
        "substeps": setup["substeps"], "Nz": model.Nz,
        "column_timesteps_per_sec": sims * max(ensemble, 1) * setup["substeps"] / (stats["ms_median"] * 1e-3),
        "losses": losses, "steps": 1 + n_timed,
        "presolve_substeps": (setup["substeps"] * (1 if member_fold or not ensemble else ensemble)
                              if config.training_fractions is not None else 0),
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


def _per_call_ms(fn, repeats: int, device, kernel: str | None = None) -> dict:
    """ms per call of ``fn``: ``wall`` back to back (host work included) and ``device``.

    ``wall``: CUDA events around ``repeats`` calls. ``device``: the summed
    execution time of the kernels the calls ran, from ``torch.profiler``,
    over ``repeats`` (gaps between kernels excluded). With ``kernel`` (a
    part of a kernel's name) also ``kernel``, the mean device time of a
    launch of the kernels so named (over the launches the trace recorded:
    it misses one now and then, and late in a long process most or all of
    them), ``kernel_launches_recorded``, the count of those launches
    (``kernel`` is ``None`` when it is 0), and ``other`` and ``other_ops``,
    the time and the count of the calls' other device ops per call.
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
    on_dev = _on_device(prof)
    out = {"wall": start.elapsed_time(end) / repeats, "device": _device_ms(on_dev) / repeats}
    if kernel is not None:
        mine = [e for e in on_dev if kernel in e.key]
        others = [e for e in on_dev if kernel not in e.key]
        recorded = sum(e.count for e in mine)
        out["kernel_launches_recorded"] = recorded
        out["kernel"] = _device_ms(mine) / recorded if recorded else None
        out["other"] = _device_ms(others) / repeats
        out["other_ops"] = sum(e.count for e in others) / repeats
    return out


def _graph_ms(fn, repeats: int, device) -> float:
    """ms per call of ``fn`` from CUDA events around one replay of a CUDA graph of ``repeats`` calls.

    The graph replays the calls' kernels back to back without the host, so
    this is their device time plus the gaps between graph nodes: a check on
    the profiler's per-launch mean that does not depend on which launches
    the profiler records.
    """
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def bench_tridiagonal(n_systems: int = 16384, N: int = 32, repeats: int = 50, seed: int = 0, device=None) -> dict:
    """The batched solve alone on the card: ms per call of each backend.

    Diagonally dominant systems from a numpy seed (as the JAX benchmark's
    ``0.1 N(0,1)`` off-diagonals, ``1 + |N(0,1)|`` diagonal). ``cuda`` is the
    kernel through its wrapper ``_thomas_cuda``; ``scan`` (its plain version)
    and ``pcr`` are the plain backends; ``library`` is ``torch.linalg.solve``
    on the same systems densified to ``(B, N, N)`` before timing (a yardstick
    the port never calls). For each, ``<name>_ms`` is the device time per
    call and ``<name>_wall_ms`` the time per call back to back with the host
    work (:func:`_per_call_ms`); the kernel's is the mean over the launches
    the profiler recorded, ``cuda_recorded`` of ``repeats`` (``None`` when it
    recorded none), and ``cuda_graph_ms`` the kernel's time per launch in a
    CUDA graph of ``repeats`` back-to-back launches (:func:`_graph_ms`). Also
    returns the kernel's largest deviation from ``scan`` and from ``pcr``,
    whether it equals ``scan`` (``cuda_equals_scan``) and the solution's
    largest magnitude.
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
        t = _per_call_ms(fn, repeats, device, kernel="thomas_kernel" if name == "cuda" else None)
        out[f"{name}_ms"], out[f"{name}_wall_ms"] = t.get("kernel", t["device"]), t["wall"]
        if name == "cuda":
            out["cuda_recorded"] = t["kernel_launches_recorded"]
            out["cuda_graph_ms"] = _graph_ms(fn, repeats, device)
    out["max_abs_err_vs_scan"] = float((results["cuda"] - results["scan"]).abs().max())
    out["max_abs_err_vs_pcr"] = float((results["cuda"] - results["pcr"]).abs().max())
    out["cuda_equals_scan"] = bool(torch.equal(results["cuda"], results["scan"]))
    out["max_abs_x"] = float(results["scan"].abs().max())
    out["bytes"] = 5 * n_systems * N * 4
    return out


def profile_train_step(setup: dict, n_saves: int = 2, device=None, ensemble: int = 0, member_fold: bool = False,
                       stacked_nns=None, **config_overrides) -> dict:
    """Where one training step's time goes: ``torch.profiler`` over a short window.

    One step (loss, backward, adam) over the first ``n_saves`` save intervals
    of the setup's batch (:func:`_profiled`); ``ensemble``, ``member_fold``
    and ``stacked_nns`` as in :func:`bench_train_step`.
    """
    device = _require_card(device, "profile_train_step")
    from climateparameterizations_jl_tpu_torch.train.nde import (
        _make_optimizer,
        determine_loss_scalings,
        make_wind_mixing_loss_fn,
    )

    config = dataclasses.replace(setup["config"], **config_overrides)
    batch = setup["batch"]
    batch = dataclasses.replace(batch, targets=batch.targets[:, : n_saves + 1], t=batch.t[: n_saves + 1])
    if ensemble:
        nns, loss_fn, _ = _ensemble_step_parts(setup, config, ensemble, member_fold, stacked_nns, batch)
    else:
        nns = _clone_nns(setup["nns"])
        scalings = determine_loss_scalings(setup["model"], nns, batch, config)
        loss_fn = make_wind_mixing_loss_fn(setup["model"], batch, scalings, config)
    optimizer = _make_optimizer(config, nns)

    def step():
        optimizer.zero_grad(set_to_none=True)
        total, _ = loss_fn(nns)
        total.backward()
        optimizer.step()

    return _profiled(step, n_saves * config.n_substeps, device)


def _profiled(fn, substeps: int, device, kernel: str | None = None) -> dict:
    """One call of ``fn`` under ``torch.profiler`` after an unprofiled warm-up call.

    Returns the wall time, the device time of every CUDA kernel, memcpy and
    memset the profiler saw, the device's idle share of the wall time, the
    device ops in all and per substep, and the eight largest by device time.
    Profiling adds host time, so the idle share is that of the profiled call.
    ``device_ops == 0`` means the profiler saw no device activity (then
    nothing is measured). With ``kernel`` (a part of a kernel's name) also
    ``kernel_ms`` and ``kernel_launches_recorded``, the device time and the
    count of the launches so named that the profiler recorded.
    """
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = _on_device(prof)
    busy_ms = _device_ms(on_device)
    ops = sum(e.count for e in on_device)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    out = {
        "substeps": substeps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "device_ops": ops, "device_ops_per_substep": ops / substeps,
        "top": [(e.key[:60], e.count, e.self_device_time_total * 1e-3) for e in top],
    }
    if kernel is not None:
        mine = [e for e in on_device if kernel in e.key]
        out["kernel_ms"] = _device_ms(mine)
        out["kernel_launches_recorded"] = sum(e.count for e in mine)
    return out


def profile_fc_forward(n_columns: int = 1024, Nz: int = 32, n_steps: int = 1152, tridiag_backend: str = "auto",
                       device=None) -> dict:
    """Where one ``bench_fc_forward`` run's time goes: :func:`_profiled` over one run."""
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, "profile_fc_forward")
    model, T0 = fc_forward_setup(n_columns, Nz, n_steps, device)
    backend = resolve_tridiag_backend(tridiag_backend, n_steps, device)
    return _profiled(lambda: fc_forward(model, T0, n_steps, backend), n_steps, device)


# ---------------------------------------------------------------------------
# KPP and TKE column baselines
# ---------------------------------------------------------------------------

# The Julia reference's recorded wall times for ONE column over the 2-day
# run (wind_mixing/Benchmarking.jl:22-55: single-threaded CPU, circa 2021),
# kept as the JAX package's REFERENCE_SECONDS. They are CPU times of the
# reference, not measurements of any accelerator.
REFERENCE_SECONDS = {"kpp_run_2day_column": 25.762e-3, "tke_run_2day_column": 2.710e-3}


def column_forward_setup(kind: str, n_columns: int = 1024, Nz: int = 32, n_steps: int = 288, device=None) -> dict:
    """The JAX package's ``bench_kpp`` / ``bench_tke`` inputs (``kind`` ``"kpp"`` or ``"tke"``), f32.

    ``n_columns`` linearly stratified columns ``19 + 0.01 (z + H)``, H = 256
    m, at rest (TKE ``e = 1e-6``); ``Fu = -5e-4``, ``Fb = 3e-8`` (KPP also
    ``dTdz_bottom = 0.01``); ``n_steps`` saves of 600 s, one step each; f =
    1e-4, g = 9.81, alpha = 2e-4.
    """
    from climateparameterizations_jl_tpu_torch.physics import kpp, tke

    device = resolve_device(device)
    f32, H = torch.float32, 256.0
    zc = (torch.arange(Nz, dtype=f32, device=device) + 0.5) * (H / Nz) - H
    T0 = torch.broadcast_to(19.0 + 0.01 * (zc + H), (n_columns, Nz)).contiguous()
    zeros = torch.zeros((n_columns, Nz), dtype=f32, device=device)
    full = lambda v: torch.full((n_columns,), v, dtype=f32, device=device)  # noqa: E731
    setup = {"kind": kind, "n_columns": n_columns, "Nz": Nz, "n_steps": n_steps, "H": H,
             "t_save": torch.linspace(0.0, n_steps * 600.0, n_steps + 1, dtype=f32, device=device)}
    if kind == "kpp":
        setup.update(state0=kpp.KPPState(U=zeros, V=zeros, T=T0), params=kpp.KPPParameters.default(device=device),
                     forcing=kpp.KPPForcing(Fu=full(-5e-4), Fb=full(3e-8), dTdz_bottom=full(0.01)))
    elif kind == "tke":
        setup.update(state0=tke.TKEState(U=zeros, V=zeros, T=T0, e=torch.full_like(zeros, 1e-6)),
                     params=tke.TKEParameters.default(device=device), Fu=full(-5e-4), Fb=full(3e-8))
    else:
        raise ValueError(f"unknown column model {kind!r} (kpp | tke)")
    return setup


def column_forward(setup: dict, tridiag_backend: str):
    """One run of the setup's column model: the T trajectory ``(n_steps + 1, n_columns, Nz)``, no autograd."""
    from climateparameterizations_jl_tpu_torch.physics import kpp, tke

    args = (setup["H"], setup["Nz"], 1e-4, 9.81, 2e-4)
    with torch.no_grad():
        if setup["kind"] == "kpp":
            return kpp.solve_kpp(setup["state0"], setup["t_save"], setup["params"], setup["forcing"], *args,
                                 tridiag_backend=tridiag_backend).T
        return tke.solve_tke(setup["state0"], setup["t_save"], setup["params"], setup["Fu"], setup["Fb"], *args,
                             tridiag_backend=tridiag_backend).T


def _bench_column(kind: str, n_columns: int, Nz: int, n_steps: int, repeats: int, tridiag_backend: str,
                  device) -> dict:
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, f"bench_{kind}")
    setup = column_forward_setup(kind, n_columns, Nz, n_steps, device)
    backend = resolve_tridiag_backend(tridiag_backend, n_steps, device)
    times, out = _timed(lambda: column_forward(setup, backend), repeats, device)
    if out.shape != (n_steps + 1, n_columns, Nz) or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{kind} forward run gave shape {tuple(out.shape)} or non-finite values")
    stats = _stats(times, device)
    seconds = stats["ms_median"] * 1e-3
    return {
        **stats, "n_columns": n_columns, "n_steps": n_steps, "repeats": repeats, "tridiag_backend": backend,
        "column_timesteps_per_sec": n_columns * n_steps / seconds,
        # The Julia reference's single-column CPU time over this port's time per column.
        "vs_reference": REFERENCE_SECONDS[f"{kind}_run_2day_column"] / (seconds / n_columns),
        "calls": repeats + 1,
    }


def bench_kpp(n_columns: int = 1024, Nz: int = 32, n_steps: int = 288, repeats: int = 5,
              tridiag_backend: str = "auto", device=None) -> dict:
    """KPP full evolution, a 2-day column at 600 s steps (the JAX package's ``benchmarks.py:60``,
    ``Benchmarking.jl:25``): ms per run (min/median/max), column-timesteps/s and ``vs_reference``.

    ``"auto"`` is the Thomas kernel on the card: one launch per step on
    ``(3, n_columns, Nz)``, ``n_steps`` per run. CUDA events around each run
    after one warm-up; ``calls`` counts the runs.
    """
    return _bench_column("kpp", n_columns, Nz, n_steps, repeats, tridiag_backend, device)


def bench_tke(n_columns: int = 1024, Nz: int = 32, n_steps: int = 288, repeats: int = 5,
              tridiag_backend: str = "auto", device=None) -> dict:
    """TKE full evolution (the JAX package's ``benchmarks.py:89``, ``Benchmarking.jl:37``), as :func:`bench_kpp`.

    One Thomas launch per step on ``(4, n_columns, Nz)``.
    """
    return _bench_column("tke", n_columns, Nz, n_steps, repeats, tridiag_backend, device)


def profile_column_forward(kind: str, n_columns: int = 1024, Nz: int = 32, n_steps: int = 288,
                           tridiag_backend: str = "auto", device=None) -> dict:
    """Where one ``bench_kpp`` / ``bench_tke`` run's time goes: :func:`_profiled` over one run."""
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, f"profile_{kind}")
    setup = column_forward_setup(kind, n_columns, Nz, n_steps, device)
    backend = resolve_tridiag_backend(tridiag_backend, n_steps, device)
    return _profiled(lambda: column_forward(setup, backend), n_steps, device)


# ---------------------------------------------------------------------------
# Embedding: the host column and the double gyre
# ---------------------------------------------------------------------------


def host_column_setup(n_columns: int = 1024, Nz: int = 32, nns=None, seed: int = 0, device=None) -> dict:
    """The embedded wind-mixing host over ``n_columns`` columns, each with its own surface forcing.

    The model of :func:`make_setup` (``nns`` when given, else drawn from a
    seeded generator) in :func:`~..embed.column_model.host_for_wind_mixing`;
    from a numpy generator seeded with ``seed``: per-column ``Fu`` in
    [-5e-4, -1e-4] m^2/s^2 and ``Ftheta`` in [-1.5e-5, 1.5e-5] K m/s (the
    catalog's wind and buoyancy-flux range), ``dTdz_bottom = 0.01``, and
    the states at rest on ``19 + 0.01 (z + H)`` plus ``1e-3 N(0, 1)`` K.
    """
    from climateparameterizations_jl_tpu_torch.embed.column_model import HostColumnState, host_for_wind_mixing

    device = resolve_device(device)
    model, nns, _, _ = make_setup(Nz, 1, seed, nns, device)
    rng = np.random.default_rng(seed)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    host = host_for_wind_mixing(model, f(-1e-4 - 4e-4 * rng.uniform(size=n_columns)),
                                f(1.5e-5 * (2.0 * rng.uniform(size=n_columns) - 1.0)), f(np.full(n_columns, 0.01)))
    H = 256.0
    zc = (np.arange(Nz) + 0.5) * (H / Nz) - H
    T0 = f(19.0 + 0.01 * (zc + H) + 1e-3 * rng.standard_normal((n_columns, Nz)))
    zeros = torch.zeros_like(T0)
    return {"host": host, "nns": nns, "state0": HostColumnState(u=zeros, v=zeros, T=T0), "n_columns": n_columns,
            "Nz": Nz, "dt": 60.0}


def host_column_forward(setup: dict, n_save: int, save_every: int, tridiag_backend: str):
    """The paired host-column runs ``(baseline, with_nn)`` of a setup, no autograd: ``2 n_save save_every`` solves."""
    from climateparameterizations_jl_tpu_torch.embed.column_model import run_paired_columns

    with torch.no_grad():
        return run_paired_columns(setup["host"], setup["nns"], setup["state0"], setup["dt"], n_save, save_every,
                                  tridiag_backend)


def bench_host_column(n_columns: int = 1024, Nz: int = 32, n_save: int = 128, save_every: int = 10,
                      repeats: int = 1, nns=None, tridiag_backend: str = "auto", device=None) -> dict:
    """Time the paired host-column runs (the embedded evaluation's pair, ``evaluate --embedded``).

    ``n_save`` saves of ``save_every`` host steps of 60 s, baseline and
    +NN: ``2 n_save save_every`` stacked solves on ``(3, n_columns, Nz)``
    per run, Thomas launches on the card. CUDA events around each run after
    one warm-up; ``ms_per_host_step`` divides the median run by its steps;
    ``calls`` counts the runs.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, "bench_host_column")
    setup = host_column_setup(n_columns, Nz, nns, device=device)
    steps = 2 * n_save * save_every
    backend = resolve_tridiag_backend(tridiag_backend, steps, device)
    times, (base, with_nn) = _timed(lambda: host_column_forward(setup, n_save, save_every, backend), repeats, device)
    if with_nn.T.shape != (n_save + 1, n_columns, Nz) or not all(
            bool(torch.isfinite(x).all()) for sol in (base, with_nn) for x in (sol.u, sol.v, sol.T)):
        raise RuntimeError(f"host-column run gave shape {tuple(with_nn.T.shape)} or non-finite values")
    stats = _stats(times, device)
    return {
        **stats, "n_columns": n_columns, "n_save": n_save, "save_every": save_every, "host_steps": steps,
        "tridiag_backend": backend, "ms_per_host_step": stats["ms_median"] / steps,
        "column_timesteps_per_sec": n_columns * steps / (stats["ms_median"] * 1e-3), "calls": repeats + 1,
    }


def profile_host_column(n_columns: int = 1024, Nz: int = 32, n_save: int = 2, save_every: int = 10, nns=None,
                        tridiag_backend: str = "auto", device=None) -> dict:
    """Where a paired host-column run's time goes: :func:`_profiled` over one run (ops per host step)."""
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, "profile_host_column")
    setup = host_column_setup(n_columns, Nz, nns, device=device)
    backend = resolve_tridiag_backend(tridiag_backend, n_save * save_every, device)
    return _profiled(lambda: host_column_forward(setup, n_save, save_every, backend), 2 * n_save * save_every,
                     device)


def double_gyre_setup(Nx: int = 96, Ny: int = 96, Nz: int = 32, advection: str = "weno5", seed: int = 0,
                      device=None) -> dict:
    """The JAX package's ``bench_double_gyre`` configuration: the default basin at rest, the FC MLP on every column.

    The MLP is drawn from a ``torch.Generator`` seeded with ``seed`` (JAX
    draws its own with ``jax.random``), T scaled by (15, 5) and wT by (0, 1e-5).
    """
    from climateparameterizations_jl_tpu_torch.closures.mlp import free_convection_mlp
    from climateparameterizations_jl_tpu_torch.embed.double_gyre import DoubleGyreModel, DoubleGyreState

    device = resolve_device(device)
    model = DoubleGyreModel.default(Nx=Nx, Ny=Ny, Nz=Nz, advection=advection, device=device)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return {"model": model, "state0": DoubleGyreState.rest(model),
            "nn": free_convection_mlp(torch.Generator().manual_seed(seed), Nz, device=device),
            "T_scaling": ZeroMeanUnitVarianceScaling(f(15.0), f(5.0)),
            "wT_scaling": ZeroMeanUnitVarianceScaling(f(0.0), f(1e-5))}


def double_gyre_forward(setup: dict, n_steps: int, tridiag_backend: str, dt: float = 1800.0):
    """One save interval of ``n_steps`` basin steps with the NN closure: the trajectory ``(2, ...)``."""
    from climateparameterizations_jl_tpu_torch.embed.double_gyre import run_double_gyre

    return run_double_gyre(setup["model"], setup["state0"], dt, n_save=1, save_every=n_steps, nn=setup["nn"],
                           T_scaling=setup["T_scaling"], wT_scaling=setup["wT_scaling"],
                           tridiag_backend=tridiag_backend)


def bench_double_gyre(Nx: int = 96, Ny: int = 96, Nz: int = 32, n_steps: int = 32, advection: str = "weno5",
                      tridiag_backend: str = "auto", repeats: int = 3, device=None) -> dict:
    """The 3-D double gyre with the embedded NN closure: ms per run and basin column-timesteps per second.

    The JAX package's ``bench_double_gyre`` (``benchmarks.py:321``): the
    default 96x96x32 basin, WENO5, ``n_steps`` steps of 1,800 s, the FC MLP
    on every column; three batched solves per step (9,216 and 2 x 9,312
    systems of 32 levels at the default size), Thomas launches on the card.
    The JAX benchmark's even-``n_steps`` rule belongs to its scan unroll and
    does not apply. CUDA events around each run after one warm-up; ``calls``
    counts the runs.
    """
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, "bench_double_gyre")
    setup = double_gyre_setup(Nx, Ny, Nz, advection, device=device)
    backend = resolve_tridiag_backend(tridiag_backend, n_steps, device)
    times, traj = _timed(lambda: double_gyre_forward(setup, n_steps, backend), repeats, device)
    if not all(bool(torch.isfinite(x).all()) for x in (traj.u, traj.v, traj.T, traj.eta)):
        raise RuntimeError("double-gyre run produced non-finite values")
    stats = _stats(times, device)
    return {
        **stats, "Nx": Nx, "Ny": Ny, "Nz": Nz, "n_steps": n_steps, "repeats": repeats, "tridiag_backend": backend,
        "ms_per_step": stats["ms_median"] / n_steps,
        "column_timesteps_per_sec": Nx * Ny * n_steps / (stats["ms_median"] * 1e-3), "calls": repeats + 1,
    }


def profile_double_gyre(Nx: int = 96, Ny: int = 96, Nz: int = 32, n_steps: int = 8, tridiag_backend: str = "auto",
                        device=None) -> dict:
    """Where a ``bench_double_gyre`` run's time goes: :func:`_profiled` over one run of ``n_steps`` steps."""
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, "profile_double_gyre")
    setup = double_gyre_setup(Nx, Ny, Nz, device=device)
    backend = resolve_tridiag_backend(tridiag_backend, n_steps, device)
    return _profiled(lambda: double_gyre_forward(setup, n_steps, backend), n_steps, device)


# ---------------------------------------------------------------------------
# The 3-D LES data generator and the column ensemble
# ---------------------------------------------------------------------------


def les_setup(n_horizontal: int = 64, Nz: int = 64, device=None) -> dict:
    """The JAX package's ``bench_les`` inputs: the default LES box at ``n_horizontal^2 x Nz``, its
    initial state (noise from a ``torch.Generator`` seeded with 0) and ``stable_dt``.

    ``thomas_systems`` is the batch of each pressure solve, ``2 Ny (Nx // 2 + 1)``
    systems of ``Nz`` levels (the real and imaginary parts of every horizontal mode).
    """
    from climateparameterizations_jl_tpu_torch.data.les import LESConfig, initial_state, stable_dt

    device = resolve_device(device)
    config = LESConfig.default(Nx=n_horizontal, Ny=n_horizontal, Nz=Nz, device=device)
    state0 = initial_state(config)
    return {"config": config, "state0": state0, "dt": stable_dt(config),
            "thomas_systems": 2 * n_horizontal * (n_horizontal // 2 + 1), "thomas_N": Nz}


def les_forward(setup: dict, n_steps: int, tridiag_backend: str):
    """``n_steps`` Euler LES steps from the setup's initial state, at ``t = 0`` each (as the JAX benchmark steps)."""
    from climateparameterizations_jl_tpu_torch.data.les import les_step

    state = setup["state0"]
    for _ in range(n_steps):
        state = les_step(setup["config"], state, setup["dt"], "euler", tridiag_backend=tridiag_backend)
    return state


def bench_les(n_horizontal: int = 64, Nz: int = 64, n_steps: int = 100, repeats: int = 3, profile_steps: int = 10,
              device=None) -> dict:
    """The 3-D LES generator's throughput: ms per run of ``n_steps`` Euler steps and cell-steps per second.

    The JAX package's ``bench_les`` (``benchmarks.py:395``): the default box
    at ``n_horizontal^2 x Nz``, ``stable_dt``, forward Euler. CUDA events
    around each run after one warm-up (``calls`` counts the runs). Each step
    runs one pressure solve: ``thomas_launches_per_step`` is counted over the
    last timed run, on ``thomas_systems x thomas_N``. A run of
    ``profile_steps`` steps under ``torch.profiler`` gives the device ops per
    step, the card's idle share and the Thomas kernel's share of the device
    time (``profile``).
    """
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.train.nde import resolve_tridiag_backend

    device = _require_card(device, "bench_les")
    setup = les_setup(n_horizontal, Nz, device=device)
    backend = resolve_tridiag_backend("auto", n_steps, device)
    times, state = _timed(lambda: les_forward(setup, n_steps, backend), repeats, device)
    if not all(bool(torch.isfinite(x).all()) for x in (state.u, state.v, state.w, state.T)):
        raise RuntimeError("LES run produced non-finite values")
    before = _cuda.THOMAS.launches
    les_forward(setup, n_steps, backend)
    torch.cuda.synchronize(device)
    launches = _cuda.THOMAS.launches - before
    prof = _profiled(lambda: les_forward(setup, profile_steps, backend), profile_steps, device, kernel="thomas_kernel")
    prof["thomas_device_share"] = prof["kernel_ms"] / prof["device_busy_ms"] if prof["device_busy_ms"] else None
    stats = _stats(times, device)
    cells = n_horizontal * n_horizontal * Nz
    return {
        **stats, "n_horizontal": n_horizontal, "Nz": Nz, "n_steps": n_steps, "repeats": repeats, "dt_s": setup["dt"],
        "tridiag_backend": backend, "ms_per_step": stats["ms_median"] / n_steps,
        "cell_steps_per_sec": cells * n_steps / (stats["ms_median"] * 1e-3), "calls": repeats + 1,
        "thomas_launches_per_step": launches / n_steps, "thomas_systems": setup["thomas_systems"],
        "thomas_N": setup["thomas_N"], "profile": prof,
    }


def column_ensemble_setup(n_members: int = 1024, Nz: int = 32, device=None) -> tuple:
    """``(model, nns, bcs, x0)`` of the JAX package's ``bench_column_ensemble`` (``benchmarks.py:361``).

    :func:`make_setup`'s model and MLPs, ``x0 = 0.1 N(0, 1)`` ``(n_members,
    3 Nz)`` from a numpy generator seeded with 0, and per-member BCs: top
    ``uw = -0.5``, top ``wT = 0.3``, the rest and the diurnal amplitude 0.
    """
    model, nns, _, x0 = make_setup(Nz, n_members, 0, device=device)
    zeros = torch.zeros(n_members, dtype=torch.float32, device=x0.device)
    bcs = BoundaryConditions(uw_bot=zeros, uw_top=zeros - 0.5, vw_bot=zeros, vw_top=zeros, wT_bot=zeros,
                             wT_top=zeros + 0.3, diurnal_amplitude=zeros)
    return model, nns, bcs, x0


def bench_column_ensemble(n_members: int = 1024, Nz: int = 32, n_steps: int = 256, repeats: int = 3,
                          device=None) -> dict:
    """The column ensemble on one card: ms per solve and column-timesteps per second.

    The JAX package's ``bench_column_ensemble``: ``n_members`` columns, one
    save of ``n_steps`` split substeps (non-dimensional ``dt_save = 1e-5
    n_steps``) through ``parallel/sharding.py::make_sharded_ensemble_solver``
    on a one-device mesh, i.e. one batched split solve with every member on
    the batch axis: one Thomas launch per substep on ``(3, n_members, Nz)``.
    CUDA events around each solve after one warm-up; ``calls`` counts the
    solves and ``thomas_launches`` the launches of all of them. In a world
    of N ranks (``torchrun``) the mesh spans them and each rank times its
    ``n_members / N`` members (``members_per_rank``).
    """
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.parallel.sharding import (
        make_mesh,
        make_sharded_ensemble_solver,
        shard_ensemble_members,
    )
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    device = _require_card(device, "bench_column_ensemble")
    mesh = make_mesh(device=device)
    model, nns, bcs, x0 = column_ensemble_setup(n_members, Nz, device)
    x0, bcs = shard_ensemble_members((x0, bcs), mesh)
    local = x0.shape[0]
    config = NDETrainConfig(n_substeps=n_steps, method="split")
    solver = make_sharded_ensemble_solver(model, config, mesh)
    before = _cuda.THOMAS.launches
    times, traj = _timed(lambda: solver(nns, bcs, x0, 0.0, 1e-5 * n_steps, 1), repeats, device)
    launches = _cuda.THOMAS.launches - before
    if traj.shape != (2, local, 3 * Nz) or not bool(torch.isfinite(traj).all()):
        raise RuntimeError(f"ensemble solve gave shape {tuple(traj.shape)} or non-finite values")
    stats = _stats(times, device)
    return {
        **stats, "n_members": n_members, "members_per_rank": local, "Nz": Nz, "n_steps": n_steps, "repeats": repeats,
        "column_timesteps_per_sec": n_members * n_steps / (stats["ms_median"] * 1e-3), "calls": repeats + 1,
        "thomas_launches": launches, "thomas_systems": 3 * local, "thomas_N": Nz,
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
    :func:`bench_tridiagonal`, except ``cuda_ms``: the device time of the
    kernel ``gram_kernel`` alone, by its name in the profile; whatever else
    a ``gram_cuda`` call runs on the card is ``cuda_other_ms`` and
    ``cuda_other_ops`` per call (none with f32 hyperparameter tensors on the
    card, as here). Also returns the kernel's largest deviation from
    ``gram_plain`` off the coincident pairs.
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
        t = _per_call_ms(fn, repeats, device, kernel="gram_kernel" if name == "cuda" else None)
        if name == "cuda" and t["kernel"] is None:
            raise RuntimeError("the profile recorded no launch of gram_kernel")
        out[f"{name}_ms"], out[f"{name}_wall_ms"] = t.get("kernel", t["device"]), t["wall"]
        if name == "cuda":
            out["cuda_other_ms"], out["cuda_other_ops"] = t["other"], t["other_ops"]
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


# ---------------------------------------------------------------------------
# The suite runner and the headline
# ---------------------------------------------------------------------------

# bench.py's yardstick: the reference's KPP 2-day column read as 1,153 steps
# in 25.762 ms of single-threaded Julia CPU time (wind_mixing/Benchmarking.jl:25).
BASELINE_COLUMN_TIMESTEPS_PER_SEC = 4.5e4
HEADLINE_METRIC = "column-timesteps/sec (fwd, mPP+3NN RHS, RK4, 32 levels x 1024 columns)"


def gp_build_work(n_train: int, n_features: int = 96, n_targets: int = GP_TARGETS) -> tuple[float, float]:
    """``(flops, bytes)`` of building the three flux GPs of :func:`bench_gp`, fitted one by one.

    Three Grams as ``PERF.md`` §6 row 4 counts one (``2 n^2 D + 4 n D``), three
    Cholesky factorizations (``n^3 / 3``) and three pairs of triangular
    solves with ``n_targets`` right-hand sides (``2 n^2 T``); bytes: the
    inputs (predictors, feature grid, three target sets) read once and the
    three factors and weight sets written once, f32.
    """
    n, D, T = n_train, n_features, n_targets
    flops = 3 * (2 * n * n * D + 4 * n * D) + 3 * n**3 / 3 + 3 * 2 * n * n * T
    n_bytes = 4 * (n * D + D + 3 * n * T + 3 * n * n + 3 * n * T)
    return float(flops), float(n_bytes)


def run_suite(quick: bool = False, device=None) -> dict:
    """Run every benchmark on the card; returns ``{name: stats}`` with JSON values only.

    The JAX package's ``run_suite`` (``benchmarks.py:474-504``): the same
    twelve rows and ``quick`` scaling (sizes x 0.25, with the same floors).
    ``gp_build`` fits on the plain backend and ``gp_build_pallas`` on the
    Gram kernel (``backend="cuda"``; the JAX row's Pallas kernel), without
    the fitted models. Rows whose work ``PERF.md`` §6 counts carry the
    roofline columns of ``utils/profiling.py::attach_roofline``:
    ``nde_forward`` (the fused RK4 count), ``gp_build`` and
    ``gp_build_pallas`` (:func:`gp_build_work`) and ``tridiagonal`` (the
    Thomas kernel's bytes, on its device time per launch).
    """
    from climateparameterizations_jl_tpu_torch.utils.profiling import attach_roofline

    device = _require_card(device, "run_suite")
    scale = 0.25 if quick else 1.0
    n_cols = max(64, int(1024 * scale))
    n_gp = max(128, int(1024 * scale))
    suite = {
        "kpp_2day_columns": bench_kpp(n_columns=n_cols, device=device),
        "tke_2day_columns": bench_tke(n_columns=n_cols, device=device),
        "gp_build": bench_gp(n_train=n_gp, backend="plain", device=device),
        "gp_build_pallas": bench_gp(n_train=n_gp, backend="cuda", device=device),
        "gp_ml2_step": bench_gp_ml2_step(n_train=n_gp, device=device),
        "fc_conv_adj_forward": bench_fc_forward(n_columns=n_cols, n_steps=max(64, int(1152 * scale)), device=device),
        "nde_forward": bench_nde_forward(n_columns=n_cols, n_steps=max(64, int(1024 * scale)), device=device),
        "nde_train_step": bench_nde_train_step(n_sims=max(2, int(8 * scale)), n_window=max(8, int(32 * scale)),
                                               device=device),
        "double_gyre_nn": bench_double_gyre(Nx=max(16, int(96 * scale)), Ny=max(16, int(96 * scale)),
                                            n_steps=max(4, int(32 * scale)), device=device),
        "column_ensemble": bench_column_ensemble(n_members=n_cols, n_steps=max(32, int(256 * scale)), device=device),
        "les_3d": bench_les(n_horizontal=max(16, int(64 * scale)), Nz=max(16, int(64 * scale)),
                            n_steps=max(10, int(100 * scale)), device=device),
        "tridiagonal": bench_tridiagonal(n_systems=max(1024, int(16384 * scale)), device=device),
    }
    for key in ("gp_build", "gp_build_pallas"):
        del suite[key]["models"]
        flops, n_bytes = gp_build_work(suite[key]["n_train"], suite[key]["n_features"])
        attach_roofline(suite[key], flops=flops, bytes=n_bytes)
    fwd = suite["nde_forward"]
    attach_roofline(fwd, flops=fwd["matmul_flops"] + fwd["other_flops"], bytes=fwd["bytes"])
    # The kernel's device time per launch; where the profiler recorded none of its launches (late in a long
    # process), its time per launch in a CUDA graph of back-to-back launches.
    tri = suite["tridiagonal"]
    tri["roofline_ms_from"] = "cuda_ms" if tri["cuda_recorded"] else "cuda_graph_ms"
    attach_roofline(tri, flops=8 * tri["n_systems"] * tri["N"], bytes=tri["bytes"],
                    seconds=tri[tri["roofline_ms_from"]] * 1e-3)
    return suite


def _train_rows(setup: dict, shooting: int, n_timed: int, n_repeats: int, device) -> tuple[list, dict]:
    """``n_repeats`` blocks of :func:`bench_train_step`: the mean ms per step of each block, and the last block."""
    blocks = [bench_train_step(setup, n_timed=n_timed, device=device, shooting=shooting) for _ in range(n_repeats)]
    return [statistics.mean(b["ms"]) for b in blocks], blocks[-1]


def headline(n_timed: int = 5, n_repeats: int = 3, nns=None, setup: dict | None = None, device=None) -> dict:
    """The repo's one-line benchmark on the card: ``bench.py``'s payload, computed by the port.

    ``bench.py::_run_headline`` and ``_payload``: forward column-timesteps
    per second at 1,024 columns x 1,024 RK4 steps (the fused kernel; the
    median of 5 runs, with their min and max as ``spread``),
    ``vs_baseline`` against the reference's 4.5e4, and in ``extra`` the
    32,768-column x 256-step peak row (median of 3, with ``mfu_pct``
    against the f32 peak) and the flagship training-step rows, sequential
    and ``shooting=16`` (:func:`bench_train_step`: ``n_repeats`` blocks of
    ``n_timed`` steps; ms per step is the median over the blocks' means).
    ``nns`` are the forward rows' MLPs and ``setup`` the training rows'
    (:func:`flagship_train_setup`, made when not given). A failing row raises.
    """
    from climateparameterizations_jl_tpu_torch.utils.profiling import attach_roofline, nvidia_smi

    device = _require_card(device, "headline")
    stats = bench_nde_forward(1024, 32, 1024, repeats=5, nns=nns, device=device)
    work = 1024 * 1024
    value = stats["column_timesteps_per_sec"]
    spread = {"min": round(work / (stats["ms_max"] * 1e-3), 1), "max": round(work / (stats["ms_min"] * 1e-3), 1),
              "repeats": 5}
    peak = bench_nde_forward(32768, 32, 256, repeats=3, nns=nns, device=device)
    attach_roofline(peak, flops=peak["matmul_flops"] + peak["other_flops"], bytes=peak["bytes"])
    peak_work = 32768 * 256
    extra = {"peak_fwd_32768_columns": {
        "column_timesteps_per_s": round(peak["column_timesteps_per_sec"], 1),
        "min": round(peak_work / (peak["ms_max"] * 1e-3), 1), "max": round(peak_work / (peak["ms_min"] * 1e-3), 1),
        "mfu_pct": round(peak["mfu_pct"], 1), "repeats": 3,
    }}
    if setup is None:
        setup = flagship_train_setup(nns=None, device=device)
    seq, seq_last = _train_rows(setup, 0, n_timed, n_repeats, device)
    shoot, shoot_last = _train_rows(setup, 16, n_timed, n_repeats, device)
    seq_ms, shoot_ms = statistics.median(seq), statistics.median(shoot)
    extra["train_step_flagship"] = {
        "config": "tridiag=auto + fast_assembly=auto (the port's defaults: the Thomas kernel on the card)",
        "sequential_ms_per_iter": round(seq_ms, 2), "sequential_ms_min": round(min(seq), 2),
        "sequential_ms_max": round(max(seq), 2), "sequential_tridiag": seq_last["tridiag_backend"],
        "shooting16_ms_per_iter": round(shoot_ms, 2), "shooting16_ms_min": round(min(shoot), 2),
        "shooting16_ms_max": round(max(shoot), 2), "shooting16_tridiag": shoot_last["tridiag_backend"],
        "shooting_speedup": round(seq_ms / shoot_ms, 2), "repeats": n_repeats, "sims": seq_last["sims"],
        "inner_steps": seq_last["substeps"],
    }
    return {
        "metric": HEADLINE_METRIC, "value": round(value, 1), "unit": "column-timesteps/s",
        "vs_baseline": round(value / BASELINE_COLUMN_TIMESTEPS_PER_SEC, 2), "platform": "gpu",
        "device": torch.cuda.get_device_name(device), "nvidia_smi": nvidia_smi(), "spread": spread, "extra": extra,
    }
