#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths on the card at full width, with the trained
flagship flux MLPs of ``runs/wm_flagship_fold`` (3 x 96 -> 50 -> 20 -> 31,
mish), Nz = 32:

- serving (phases 3-5): the wind-mixing NDE forward solve, 1,024 columns,
  through the fused RK4 kernel ``csrc/fused_rk4.cu``;
- training (phases 6-10): the flagship NDE training step, 18 simulations x
  1,152 split substeps, IFT gradients and adam, with every implicit solve
  through the batched Thomas kernel ``csrc/thomas.cu``.

It builds both kernels from ``csrc/`` (one ``nvcc`` each, side by side),
holds each against its plain PyTorch version, times it, and checks that each
path's run went through its kernel (launch counts set to 0 just before the
path and read just after).

Every phase prints a line before and after, with the elapsed time, so a hang
shows where it stopped. Any failure raises and the script exits non-zero.
The last two lines are one JSON object describing the kernels and the
contract line ``{"ok": true, "device": {...}}``. Without a card, or without
the rest of the repository beside it, it exits non-zero before printing any
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

T0 = time.perf_counter()
REPO = Path(__file__).resolve().parent
FLAGSHIP_RUN = REPO / "runs" / "wm_flagship_fold"

# Kernel vs plain tolerance: the JAX package's own tolerance for its fused
# kernel against the XLA path (tests/test_fused_rhs.py). Both sides are f32
# with different summation orders, and the stiff tendency scaling (R/dz ~ 1e2
# times mPP coefficients ~ 1e2) amplifies roundoff.
RTOL, ATOL = 2e-4, 2e-6
FULL_COLUMNS, NZ, FULL_STEPS, V1_STEPS = 1024, 32, 64, 16
BENCH_STEPS, BENCH_REPEATS = 1024, 5
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): f32 on the CUDA
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Thomas kernel vs its plain version (_thomas_scan), f32: the same recurrence,
# with the kernel's multiply-adds contracted to FMAs, on diagonally dominant
# systems (condition number below 10), so a few f32 ulps of the solution.
THOMAS_RTOL, THOMAS_ATOL = 1e-5, 1e-6
THOMAS_SHAPES = ((3, 18, 32), (16384, 32), (3, 18, 128), (1000, 33), (100, 1), (40, 256))
# One flagship step, kernel-backed vs "scan"-backed from the same parameters:
# per-solve f32 differences of a few ulps, carried through 1,152 substeps and
# the backward pass, and amplified where the mPP tanh switch is steep.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3  # relative to the gradient's 2-norm
TRAIN_TIMED_STEPS, SCAN_TIMED_STEPS = 3, 1


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


@contextmanager
def phase(name: str):
    log(f"begin {name}")
    t = time.perf_counter()
    try:
        yield
    except BaseException:
        log(f"FAILED {name} after {time.perf_counter() - t:.2f}s")
        raise
    log(f"end {name} ({time.perf_counter() - t:.2f}s)")


def compare(name, got, want, rtol=RTOL, atol=ATOL):
    """Print max abs / max rel error; raise outside ``allclose(rtol, atol)``."""
    import torch

    if got.shape != want.shape:
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: non-finite values")
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp_min(1e-6)).max())
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
    log(f"{name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} allclose(rtol={rtol}, atol={atol})={ok}")
    if not ok:
        raise RuntimeError(f"{name}: outside tolerance (max_abs={max_abs:.3e})")
    return max_abs


def diag_dominant_systems(shape, seed):
    """``(dl, d, du, b)`` f32 on the card: ``|dl|, |du| < 0.5 < 2 <= d``, from a numpy seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-0.5, 0.5, shape), rng.uniform(2.0, 3.0, shape), rng.uniform(-0.5, 0.5, shape),
              rng.normal(size=shape))
    return tuple(torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrays)


def cuda_ms(fn, repeats: int = 1):
    """``(median ms, last result)`` of ``fn()`` over ``repeats`` runs, timed with CUDA events."""
    import torch

    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA card", file=sys.stderr)
        return 2
    try:
        from climateparameterizations_jl_tpu_torch import benchmarks
        from climateparameterizations_jl_tpu_torch.models.wind_mixing import solve_wind_mixing_nde
        from climateparameterizations_jl_tpu_torch.ops import _cuda
        from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri
        from climateparameterizations_jl_tpu_torch.ops.fused_rhs import (
            _multistep_plain,
            make_fused_runner,
            make_fused_runner_mxu,
        )
        from climateparameterizations_jl_tpu_torch.train.checkpoint import load_flux_nns
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 2
    if not (FLAGSHIP_RUN / "state.npz").exists():
        print(f"chip_smoke: {FLAGSHIP_RUN / 'state.npz'} is missing", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    kernel = _cuda.FUSED_RK4
    dt = benchmarks.FORWARD_DT

    with phase("1 card facts"):
        name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"device={name!r} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
        log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
        print(smi, flush=True)

    with phase("2 build fused_rk4 and thomas (one nvcc each, side by side)"):
        _cuda.load_all()
        for k in _cuda.KERNELS.values():
            log(f"{k.source.name}: nvcc+load {k.build_seconds:.2f}s from {k.source.relative_to(REPO)}")
            for line in k.ptxas_report.splitlines():
                if line.strip():
                    log(f"  {line.strip()}")
        lib = kernel.load()
        log(f"launch: {lib.fused_rk4_columns_per_block()} columns and {lib.fused_rk4_threads_per_block()} threads "
            f"per CTA, {lib.fused_rk4_smem_bytes(NZ, 50, 20)} B dynamic shared memory per CTA (flagship widths)")

    flagship = load_flux_nns(str(FLAGSHIP_RUN), device=dev)

    with phase("3 tiny launch (8 columns x 1 step)"):
        model, nns, bcs, x0 = benchmarks.make_setup(NZ, 8, seed=1, nns=flagship, device=dev)
        run = make_fused_runner_mxu(model, nns, bcs, dt, 1, 8, device=dev)
        got = run(x0)
        torch.cuda.synchronize()
        compare("tiny kernel vs plain", got,
                _multistep_plain(x0, run.operands, run.consts, NZ, run.activation, dt, 1))

    errors = {}
    with phase(f"4 full width ({FULL_COLUMNS} columns x {FULL_STEPS} steps, flagship weights)"):
        model, nns, bcs, x0 = benchmarks.make_setup(NZ, FULL_COLUMNS, seed=0, nns=flagship, device=dev)
        run = make_fused_runner_mxu(model, nns, bcs, dt, FULL_STEPS, FULL_COLUMNS, device=dev)
        got = run(x0)
        torch.cuda.synchronize()

        def plain():
            return _multistep_plain(x0, run.operands, run.consts, NZ, run.activation, dt, FULL_STEPS)

        plain_ms_64, want_plain = cuda_ms(plain)
        want_solve = solve_wind_mixing_nde(model, nns, bcs, x0, 0.0, dt * FULL_STEPS, 1, n_substeps=FULL_STEPS)[-1]
        errors["mxu_vs_plain"] = compare("make_fused_runner_mxu kernel vs _multistep_plain", got, want_plain)
        errors["mxu_vs_solve"] = compare("make_fused_runner_mxu kernel vs solve_wind_mixing_nde", got, want_solve)
        moved = float((got - x0).abs().max())
        log(f"max |x - x0| after {FULL_STEPS} steps = {moved:.3e}")
        if not moved > 1e-4:
            raise RuntimeError("the state did not evolve")
        log(f"plain version, {FULL_STEPS} steps (information only): {plain_ms_64:.2f} ms")

        run1 = make_fused_runner(model, nns, bcs, dt, V1_STEPS, FULL_COLUMNS, device=dev)
        got1 = run1(x0)
        want1_plain = _multistep_plain(x0, run1.operands, run1.consts, NZ, run1.activation, dt, V1_STEPS)
        want1_solve = solve_wind_mixing_nde(model, nns, bcs, x0, 0.0, dt * V1_STEPS, 1, n_substeps=V1_STEPS)[-1]
        errors["v1_vs_plain"] = compare("make_fused_runner kernel vs _multistep_plain", got1, want1_plain)
        errors["v1_vs_solve"] = compare("make_fused_runner kernel vs solve_wind_mixing_nde", got1, want1_solve)

    with phase(f"5 timing: bench_nde_forward ({FULL_COLUMNS} x {BENCH_STEPS}, {BENCH_REPEATS} repeats)"):
        _cuda.reset_launch_counts()
        stats = benchmarks.bench_nde_forward(FULL_COLUMNS, NZ, BENCH_STEPS, BENCH_REPEATS, nns=flagship, device=dev)
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        log(f"kernel ms: min={stats['ms_min']:.3f} median={stats['ms_median']:.3f} max={stats['ms_max']:.3f} "
            f"all={[round(t, 3) for t in stats['ms']]}")
        log(f"column-timesteps/s (median) = {stats['column_timesteps_per_sec']:.4e}")
        log(f"launch counts on the serving path: {launches}; runner calls made: {stats['calls']}")
        if launches["fused_rk4"] != stats["calls"] or stats["calls"] == 0:
            raise RuntimeError(f"fused_rk4 counted {launches['fused_rk4']} launches for {stats['calls']} calls")

        # The timed trajectory itself, held against its plain version: a fault
        # that grows over a long loop does not show at 64 steps. These launches
        # come after the counts were read.
        model, nns, bcs, x0 = benchmarks.make_setup(NZ, FULL_COLUMNS, seed=0, nns=flagship, device=dev)
        run = make_fused_runner_mxu(model, nns, bcs, dt, BENCH_STEPS, FULL_COLUMNS, device=dev)
        got_long = run(x0)
        plain_ms, want_long = cuda_ms(
            lambda: _multistep_plain(x0, run.operands, run.consts, NZ, run.activation, dt, BENCH_STEPS))
        log(f"plain version, {BENCH_STEPS} steps: {plain_ms:.2f} ms")
        errors[f"mxu_{BENCH_STEPS}_steps_vs_plain"] = compare(
            f"make_fused_runner_mxu kernel vs _multistep_plain, {BENCH_STEPS} steps", got_long, want_long)

        h1 = nns.uw.weights[0].shape[0]
        h2 = nns.uw.weights[1].shape[0]
        F, ni = 3 * NZ, NZ - 1
        flops = FULL_COLUMNS * BENCH_STEPS * 4 * 2 * (F * 3 * h1 + 3 * h1 * h2 + 3 * h2 * ni)
        n_bytes = 4 * (2 * FULL_COLUMNS * F + run.kernel_weights.numel())
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        log(f"bound: {flops:.4e} matmul FLOP / 67 TFLOP/s = {t_ops:.3f} ms; {n_bytes} B / 3.35 TB/s = {t_bytes:.4f} ms; "
            f"share of bound reached = {bound_ms / stats['ms_median']:.3f}")

    record = {
        "name": "fused_rk4",
        "route": "cuda",
        "source": "climateparameterizations_jl_tpu_torch/csrc/fused_rk4.cu",
        "replaces": "climateparameterizations_jl_tpu/ops/fused_rhs.py:535",
        "also_replaces": "climateparameterizations_jl_tpu/ops/fused_rhs.py:257",
        "launches": launches["fused_rk4"],
        "max_abs_err": max(v for k, v in errors.items() if k.endswith("plain")),
        "errors": errors,
        "ms": stats["ms_median"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "shape": {"columns": FULL_COLUMNS, "steps": BENCH_STEPS, "Nz": NZ},
        "build_s": kernel.build_seconds,
    }
    thomas = _cuda.THOMAS
    thomas_errors = {}
    with phase("6 thomas: tiny launch (1 system, N = 4)"):
        tlib = thomas.load()
        log(f"thomas: {tlib.thomas_systems_per_block()} systems per CTA, N <= {tlib.thomas_max_n()}, "
            f"{tlib.thomas_smem_bytes(32)} B shared memory per CTA at N = 32, {tlib.thomas_smem_bytes(256)} at N = 256")
        args = diag_dominant_systems((1, 4), seed=0)
        got = thomas(*args)
        torch.cuda.synchronize()
        compare("tiny thomas vs _thomas_scan", got, tri._thomas_scan(*args))

    with phase("7 thomas vs _thomas_scan on the card"):
        for i, shape in enumerate(THOMAS_SHAPES):
            args = diag_dominant_systems(shape, seed=10 + i)
            got = tri._thomas_cuda(*args)
            torch.cuda.synchronize()
            want = tri._thomas_scan(*args)
            name_ = "x".join(map(str, shape))
            thomas_errors[name_] = compare(f"thomas {name_} vs _thomas_scan", got, want,
                                           rtol=THOMAS_RTOL, atol=THOMAS_ATOL)
        # The IFT gradient through the kernel against the IFT gradient through scan.
        args = diag_dominant_systems((3, 18, 32), seed=30)
        weight = torch.randn(3, 18, 32, generator=torch.Generator().manual_seed(31)).cuda()
        grads = {}
        for backend in ("cuda", "scan"):
            leaves = [a.clone().requires_grad_(True) for a in args]
            x = tri.tridiagonal_solve(*leaves, backend=backend)
            torch.sum(weight * x * x).backward()
            grads[backend] = [leaf.grad for leaf in leaves]
        for label, gk, gs in zip(("dl", "d", "du", "b"), grads["cuda"], grads["scan"]):
            thomas_errors[f"ift_grad_{label}"] = compare(f"IFT gradient d(loss)/d({label}), cuda vs scan", gk, gs,
                                                         rtol=THOMAS_RTOL, atol=THOMAS_ATOL)

    with phase("8 flagship set-up: 18-sim suite (generated on the CPU), model, batch, trained MLPs"):
        t_setup = time.perf_counter()
        setup = benchmarks.flagship_train_setup(nns=flagship, device=dev)
        setup_s = time.perf_counter() - t_setup
        batch = setup["batch"]
        log(f"set-up {setup_s:.2f}s: suite T {tuple(setup['ds'].T.shape)}, x0 {tuple(batch.x0.shape)}, "
            f"targets {tuple(batch.targets.shape)}, {setup['substeps']} substeps per step, config {setup['config']}")

    with phase(f"9 training step at full width ({TRAIN_TIMED_STEPS} timed steps, kernel-backed)"):
        _cuda.reset_launch_counts()
        train = benchmarks.bench_train_step(setup, n_timed=TRAIN_TIMED_STEPS, device=dev)
        train_launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        expected = train["presolve_substeps"] + 3 * train["substeps"] * train["steps"]
        log(f"backend {train['tridiag_backend']}: ms per step min={train['ms_min']:.1f} "
            f"median={train['ms_median']:.1f} max={train['ms_max']:.1f} all={[round(t, 1) for t in train['ms']]}")
        log(f"losses {train['losses']}")
        log(f"launch counts on the training path: {train_launches}; expected thomas launches "
            f"{expected} = {train['presolve_substeps']} (loss-scaling pre-solve) + 3 (forward, checkpoint "
            f"recompute, transposed solve) x {train['substeps']} substeps x {train['steps']} steps")
        if train["tridiag_backend"] != "cuda":
            raise RuntimeError(f"tridiag_backend='auto' resolved to {train['tridiag_backend']!r} on the card")
        if train_launches["thomas"] != expected or expected == 0:
            raise RuntimeError(f"thomas counted {train_launches['thomas']} launches, expected {expected}")

        scan = benchmarks.bench_train_step(setup, n_timed=SCAN_TIMED_STEPS, device=dev, tridiag_backend="scan")
        log(f"same step, tridiag_backend='scan': ms per step {[round(t, 1) for t in scan['ms']]} "
            f"(median {scan['ms_median']:.1f}) vs kernel median {train['ms_median']:.1f}")

        loss_k, grad_k = benchmarks.train_step_loss_and_grad(setup)
        loss_s, grad_s = benchmarks.train_step_loss_and_grad(setup, tridiag_backend="scan")
        loss_rel = abs(float(loss_k) - float(loss_s)) / abs(float(loss_s))
        grad_rel = float((grad_k - grad_s).norm() / grad_s.norm())
        ok = bool(torch.isfinite(grad_k).all()) and loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL
        log(f"one step, kernel vs scan: loss {float(loss_k):.8e} vs {float(loss_s):.8e} (rel {loss_rel:.3e}, "
            f"limit {STEP_LOSS_RTOL}); gradient ({grad_k.numel()} entries) |g_k - g_s| / |g_s| = {grad_rel:.3e} "
            f"(limit {STEP_GRAD_RTOL}); max abs {float((grad_k - grad_s).abs().max()):.3e} of "
            f"max |g| {float(grad_s.abs().max()):.3e}. Reason: per-solve f32 roundoff (FMA in the kernel) "
            f"through 1,152 substeps and the backward pass, amplified by the mPP tanh switch")
        if not ok:
            raise RuntimeError("kernel-backed and scan-backed steps disagree")

        prof = benchmarks.profile_train_step(setup, n_saves=2, device=dev)
        log(f"profiled step over {prof['substeps']} substeps (torch.profiler): wall {prof['wall_ms']:.1f} ms, "
            f"device busy {prof['device_busy_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}, "
            f"{prof['device_ops']} device ops ({prof['device_ops_per_substep']:.0f} per substep)")
        for key, n, ms in prof["top"]:
            log(f"  {key}: {n} x, {ms:.3f} ms")

    tbench = {}
    with phase("10 bench_tridiagonal: kernel, plain versions, torch.linalg.solve"):
        for n_sys in (16384, 54):
            r = benchmarks.bench_tridiagonal(n_sys, 32, device=dev)
            tbench[n_sys] = r
            log(f"{n_sys} x 32, device us per call, torch.profiler (wall us per call back to back, host work "
                f"included): "
                + ", ".join(f"{k} {r[k + '_ms'] * 1e3:.2f} ({r[k + '_wall_ms'] * 1e3:.2f})"
                            for k in ("cuda", "scan", "pcr", "library"))
                + f"; kernel vs scan max abs {r['max_abs_err_vs_scan']:.3e}")
        big = tbench[16384]
        t_bytes = big["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = 8 * 16384 * 32 / PEAK_F32_FLOPS * 1e3
        t_bound, t_bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        log(f"bound at 16384 x 32: {big['bytes']} B / 3.35 TB/s = {t_bytes * 1e3:.2f} us; {8 * 16384 * 32} flop / "
            f"67 TFLOP/s = {t_ops * 1e3:.3f} us; share of bound reached = {t_bound / big['cuda_ms']:.3f}")
        small_bound = tbench[54]["bytes"] / PEAK_BYTES_PER_S * 1e3
        log(f"bound at 54 x 32: {tbench[54]['bytes']} B / 3.35 TB/s = {small_bound * 1e3:.3f} us; share = "
            f"{small_bound / tbench[54]['cuda_ms']:.4f} (launch-bound)")
        thomas_errors["bench_16384x32"] = big["max_abs_err_vs_scan"]

    thomas_record = {
        "name": "thomas",
        "route": "cuda",
        "source": "climateparameterizations_jl_tpu_torch/csrc/thomas.cu",
        "replaces": "climateparameterizations_jl_tpu/ops/tridiagonal.py:159",
        "launches": train_launches["thomas"],
        "max_abs_err": max(thomas_errors.values()),
        "errors": thomas_errors,
        "ms": big["cuda_ms"],
        "plain_ms": big["scan_ms"],
        "bound_ms": t_bound,
        "bound_by": t_bound_by,
        "library_ms": big["library_ms"],
        "shape": {"systems": 16384, "N": 32},
        "wall_ms": big["cuda_wall_ms"],
        "training_shape": {"systems": 54, "N": 32, "ms": tbench[54]["cuda_ms"], "wall_ms": tbench[54]["cuda_wall_ms"],
                           "plain_ms": tbench[54]["scan_ms"], "library_ms": tbench[54]["library_ms"],
                           "bound_ms": small_bound, "bound_by": "bytes"},
        "train_step_ms": {"kernel": train["ms"], "scan": scan["ms"]},
        "train_step_profile": {k: prof[k] for k in ("substeps", "wall_ms", "device_busy_ms", "device_idle_share",
                                                    "device_ops_per_substep")},
        "train_setup_s": setup_s,
        "build_s": thomas.build_seconds,
    }
    print(smi, flush=True)
    print(json.dumps({"kernels": [record, thomas_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
