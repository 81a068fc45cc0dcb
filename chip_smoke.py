#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths on the card at full width, with the trained
flagship flux MLPs of ``runs/wm_flagship_fold`` (3 x 96 -> 50 -> 20 -> 31,
mish), Nz = 32:

- serving (phases 3-5): the wind-mixing NDE forward solve, 1,024 columns,
  through the fused RK4 kernel ``csrc/fused_rk4.cu``;
- training (phases 6-10): the flagship NDE training step, 18 simulations x
  1,152 split substeps, IFT gradients and adam, with every implicit solve
  through the batched Thomas kernel ``csrc/thomas.cu``;
- the Gaussian-process closure (phases 11-17): three flux GPs at n = 1,024
  training points and D = 96 features (squared exponential, f32), their
  build, one ML-II step, the GP-closure DE over 1,024 columns and the
  ``train-gp`` command, with every Gram through ``csrc/gram.cu``; and the
  blocked Cholesky kernel ``csrc/cholesky.cu`` on the slice's own Gram;
- serving with bf16 NN products (phases 18-20): the forward solve of phases
  3-5 through ``csrc/fused_rk4_bf16.cu``, whose products run on the tensor
  cores (checked in its SASS), and the rk4 fast-assembly training step
  (phase 21: ``bench_nde_train_step(method="rk4")``, "fold" against the
  default path).

It builds the five kernels from ``csrc/`` (one ``nvcc`` each, side by
side), holds each against its plain PyTorch version, times it, and checks
that each path's run went through its kernel (launch counts set to 0 just
before the path and read just after).

Every phase prints a line before and after, with the elapsed time, so a hang
shows where it stopped. Any failure raises and the script exits non-zero.
The last two lines are one JSON object describing the kernels and the
contract line ``{"ok": true, "device": {...}}``. Without a card, or without
the rest of the repository beside it, it exits non-zero before printing any
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
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

# Thomas kernel vs its plain version (_thomas_scan), f32: the same sweep with
# the same roundings (no FMA contraction, IEEE quotients), so on normal data
# the two agree bit for bit; the limits are kept as they were for the
# earlier FMA-contracted kernel, a few f32 ulps of the solution on diagonally
# dominant systems (condition number below 10). The number of entries that
# differ at all is printed.
THOMAS_RTOL, THOMAS_ATOL = 1e-5, 1e-6
THOMAS_SHAPES = ((3, 18, 32), (16384, 32), (3, 18, 128), (1000, 33), (100, 1), (40, 256), (54, 31), (200, 64))
# The kernels' device times before their redesign (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md section 6, rows 1 and 5), cited by the logs of phases 10
# and 17 beside this run's times; they are not measured here.
THOMAS_EARLIER_MS = {"16384x32": 0.01280, "54x32": 0.01206}
CHOLESKY_EARLIER_MS = {"jittered_se_gram": 2.2876, "dense_spd": 1.203}
# One flagship step, kernel-backed vs "scan"-backed from the same parameters:
# per-solve f32 differences of a few ulps, carried through 1,152 substeps and
# the backward pass, and amplified where the mPP tanh switch is steep.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3  # relative to the gradient's 2-norm
TRAIN_TIMED_STEPS, SCAN_TIMED_STEPS = 3, 1

# Gram kernel vs gram_plain, the JAX test's tolerance (tests/test_gp.py::
# TestPallasGram): two f32 Gram-trick evaluations that sum in other orders.
# It holds off the coincident pairs. A coincident pair (A_i = B_j, the
# diagonal of a training Gram) has d2 = aa + bb - 2ab = 0 computed as an f32
# cancellation of numbers of size aa + bb, so both sides return k(d2) for
# some d2 in [0, delta], delta = 2 gamma_{D+2} (aa + bb) with
# gamma_k = k u / (1 - k u), u = 2^-24 (the forward error bound of the
# D-term dot products and the two additions); sqrt amplifies it (matern12:
# k drops by 1 - exp(-sqrt(delta) / gamma)). Their difference is held to
# |k(0) - k(delta)|. Pairs are called coincident by the JAX backward's
# mask d2 <= 1e-7 (aa + bb) (ops/gram.py:227), evaluated in f64: in f32 the
# cancellation noise itself can exceed 1e-7 (aa + bb) and would leave
# diagonal pairs unmasked.
GRAM_RTOL, GRAM_ATOL = 2e-5, 2e-6
GRAM_SHAPES = ((37, 23, 12), (300, 257, 130), (1024, 1024, 96))
GP_N, GP_D, GP_NZ = 1024, 96, 32
# The JAX benchmark's length scale gamma = 1 leaves a Gram of standard-normal
# features at D = 96 equal to the identity in f32 (off-diagonal entries
# exp(-d^2 / 2) with d^2 ~ 2 D), so a wrong off-diagonal entry or a wrong
# dK/dgamma cannot show there. Every GP check also runs where K is not
# trivial: gamma^2 = median(d^2) / 2 for the Gram checks, gamma = sqrt(D) for
# the GP build and the ML-II step (off-diagonal entries near exp(-1)).
GP_WIDE_GAMMA = math.sqrt(GP_D)
# Cholesky kernel vs cholesky_plain and torch.linalg.cholesky: the JAX test's
# tolerance (tests/test_tridiagonal.py::TestPallasCholesky), f32 blocked
# factorizations that sum in other orders.
CHOL_TOL = 5e-4
# One ML-II step, kernel vs plain backend from the same parameters, on three
# seeds' inputs, at two points:
# - gamma = sqrt(D): the gradients are compared directly.
# - gamma = sigma = 1 (the benchmark's point): K is the identity to f32
#   precision off the diagonal, so the two training Grams differ only on the
#   diagonal, by the coincident-pair noise above (dK_ii up to about 6e-5).
#   The gradient in log sigma (-0.7 to -7) is the remainder of two terms of
#   size n / 2 = 512, so that noise moves it by sum_i |(K^-1 Y)_i|^2 dK_ii /
#   (2 D), about 3e-3, which the smoke computes from the two diagonals and
#   subtracts; what is left is held to the same limit. The gradient in
#   log gamma there is made of that noise and is ~1e-4.
ML2_LOSS_RTOL = 1e-4
ML2_GRAD_RTOL = 1e-3  # relative to the gradient's 2-norm
ML2_SEEDS = (0, 1, 2)
# GP-closure DE, kernel-backed vs plain-backed GPs with the same weights,
# from states off the training points: f32 Gram roundoff (~1e-7 relative)
# through 128 RK4 steps, amplified by the flux divergence (~32 / dz_hat).
DE_RTOL, DE_ATOL = 1e-4, 1e-5
DE_SAVES, DE_SUBSTEPS, DE_DT_SAVE = 32, 4, 1e-4

# The bf16 fused RK4 kernel against its plain version (the runner's ``plain``:
# _multistep_plain with bf16 products): the f32 kernel's tolerance. Both sides
# round the same f32 inputs to bf16 to nearest even, so every product is
# exact; they differ by the order of the f32 sums (the MMA accumulates in its
# own order) and, where an activation lies within that roundoff of a bf16
# rounding midpoint, by one bf16 ulp in one input. The RK4 map at dt = 1e-5 does not amplify such
# differences over 1,024 steps (the f32 kernel holds 2.98e-7 there).
BF16_RTOL, BF16_ATOL = RTOL, ATOL
# Against the f32 kernel: the JAX package's own bf16 tolerance, over its own
# horizon (tests/test_fused_rhs.py::test_bf16_matmuls_close). The 1,024-step
# gap is printed, not held.
JAX_BF16_RTOL, JAX_BF16_ATOL, JAX_BF16_STEPS = 3e-2, 3e-3, 4
# Published H100 SXM dense bf16 tensor-core peak at 700 W (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
# The rk4 fast-assembly training step, "fold" against the default path from
# the same parameters: the loss within 1e-5 relative, each gradient leaf
# within the JAX suite's tolerance for the same comparison
# (tests/test_fused_rhs.py::TestFastRK4::test_gradients_match).
FAST_LOSS_RTOL, FAST_GRAD_RTOL, FAST_GRAD_ATOL = 1e-5, 1e-4, 1e-6
FAST_TIMED_STEPS = 2


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


def ptxas_summary(report: str) -> list:
    """Registers, shared memory and spills of each kernel in an ``nvcc -Xptxas -v`` report."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = demangled(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append({"function": name, "registers": int(m.group(1)), "smem_bytes": int(m.group(2) or 0),
                        "spill_store_bytes": spills})
            name = None
    return out


def demangled(symbol: str) -> str:
    """The last name of an Itanium-mangled symbol with the integers of its template arguments, nested
    ones included: ``gram_kernel<3>``, ``fused_rk4_kernel<4,9,2,32,50,20>``."""
    rest = re.sub(r"^_ZN?", "", symbol)
    name = symbol
    while (m := re.match(r"(\d+)", rest)):
        n = int(m.group(1))
        name, rest = rest[len(m.group(1)):len(m.group(1)) + n], rest[len(m.group(1)) + n:]
    args = re.findall(r"Li(\d+)E", rest.split("Ev", 1)[0]) if rest.startswith("I") else []
    return name + (f"<{','.join(args)}>" if args else "")


def gamma_bound(k: int) -> float:
    u = 2.0**-24
    return k * u / (1 - k * u)


def compare_gram(name, got, want, A, B, family, hyp):
    """Kernel vs plain Gram: ``allclose(GRAM_RTOL, GRAM_ATOL)`` off the coincident pairs, the f32
    cancellation bound on them. Returns ``(max abs error off them, max abs error on them, count)``."""
    import torch

    from climateparameterizations_jl_tpu_torch.ops import gram as ops_gram

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, or non-finite values")
    d2, aa, bb = ops_gram._sq_distances(A.double(), B.double())
    co = d2 <= 1e-7 * (aa + bb)
    diff = (got - want).abs()
    off = ~co
    ok_off = bool(torch.allclose(got[off], want[off], rtol=GRAM_RTOL, atol=GRAM_ATOL))
    max_off = float(diff[off].max()) if bool(off.any()) else 0.0
    max_co, ok_co = 0.0, True
    if bool(co.any()):
        delta = (2.0 * gamma_bound(A.shape[1] + 2) * (aa + bb)).expand_as(d2)[co]
        h = [torch.as_tensor(v, dtype=torch.float64, device=got.device) for v in hyp]
        bound = (ops_gram._epilogue(family, torch.zeros_like(delta), *h)
                 - ops_gram._epilogue(family, delta, *h)).abs()
        max_co = float(diff[co].max())
        ok_co = bool((diff[co].double() <= bound).all())
        extra = f"; {int(co.sum())} coincident pairs: max_abs={max_co:.3e} (bound up to {float(bound.max()):.3e})"
    else:
        extra = "; no coincident pairs"
    log(f"{name}: off-coincident max_abs={max_off:.3e} allclose(rtol={GRAM_RTOL}, atol={GRAM_ATOL})={ok_off}{extra}")
    if not (ok_off and ok_co):
        raise RuntimeError(f"{name}: kernel and plain Gram disagree")
    return max_off, max_co, int(co.sum())


def device_args(n_rows, n_cols, seed, dev, scale=1.0):
    """A standard-normal ``(n_rows, n_cols)`` f32 tensor on the card, from a numpy seed."""
    import numpy as np
    import torch

    return torch.tensor(scale * np.random.default_rng(seed).normal(size=(n_rows, n_cols)), dtype=torch.float32,
                        device=dev)


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


def gp_phases(dev):
    """Phases 11-17, the Gaussian-process path; returns the gram and cholesky records."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.closures import gp as tgp
    from climateparameterizations_jl_tpu_torch.models import gp_closure as tgc
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import cholesky as ops_chol
    from climateparameterizations_jl_tpu_torch.ops import gram as ops_gram

    gram_k, chol_k = _cuda.GRAM, _cuda.CHOLESKY
    gram_errors, gram_coincident = {}, {}
    with phase("11 gram: tiny launch, then every family x metric vs gram_plain"):
        glib = gram_k.load()
        log(f"gram: {glib.gram_tile()} x {glib.gram_tile()} output tile and {glib.gram_threads_per_block()} threads "
            f"per CTA")
        A, B = device_args(3, 2, 40, dev), device_args(2, 2, 41, dev)
        got = ops_gram.gram_cuda(A, B, 1.0, 1.0)
        torch.cuda.synchronize()
        compare_gram("tiny gram vs gram_plain", got, ops_gram.gram_plain(A, B, 1.0, 1.0), A, B,
                     "squared_exponential", (1.0, 1.0, 1.0))
        for i, (M, N, D) in enumerate(GRAM_SHAPES):
            A = device_args(M, D, 50 + i, dev)
            B = A if (M, N, D) == (GP_N, GP_N, GP_D) else device_args(N, D, 60 + i, dev)
            z = torch.linspace(0.0, 1.0, D, device=dev)
            for metric in ("euclidean", "derivative"):
                tf = tgp._DISTANCE_TRANSFORMS[metric]
                At, Bt = tf(A, z), tf(B, z)
                # The JAX test's hyperparameters, then a length scale with
                # gamma^2 = median(d^2) / 2, where the entries are O(0.1-1).
                gamma_med = math.sqrt(0.5 * float(ops_gram._sq_distances(At.double(), Bt.double())[0].median()))
                for hyp in ((1.7, 0.8, 1.3), (gamma_med, 0.8, 1.3)):
                    for family in _cuda.GRAM_FAMILIES:
                        got = ops_gram.gram_cuda(At, Bt, *hyp, family=family)
                        torch.cuda.synchronize()
                        want = ops_gram.gram_plain(At, Bt, *hyp, family=family)
                        key = f"{M}x{N}x{D} {family} {metric} gamma={hyp[0]:.5g}"
                        gram_errors[key], gram_coincident[key], _ = compare_gram(
                            f"gram {key}{' (training Gram, B is A)' if B is A else ''}; median |K| "
                            f"{float(want.abs().median()):.3e}", got, want, At, Bt, family, hyp)

    chol_errors = {}
    with phase("12 cholesky vs cholesky_plain and torch.linalg.cholesky (n = 256 and 1,024)"):
        clib = chol_k.load()
        log(f"cholesky: {clib.cholesky_tile()} x {clib.cholesky_tile()} tiles, {clib.cholesky_panel_rows_per_block()} "
            f"panel rows per factor-and-panel CTA, windows of {clib.cholesky_window()} pivots; "
            f"{chol_k.launches_per_call(GP_N)} launches per factorization at n = {GP_N} (2 ceil(n / 64))")
        x_gp = benchmarks.gp_inputs(GP_N, GP_D, device=dev)[0]
        def jittered_se(gamma):
            K = ops_gram.gram_cuda(x_gp, x_gp, gamma, 1.0)
            return K + K.max() * tgp.default_jitter(K.dtype) * torch.eye(GP_N, device=dev)

        cases = []
        for n, block, seed in ((256, 128, 70), (1024, 128, 71)):
            A = device_args(n, n, seed, dev)
            cases.append((f"A A^T + n I, n = {n}, block {block}", A @ A.T + n * torch.eye(n, device=dev), block))
        cases.append((f"jittered squared-exponential Gram, n = {GP_N}, block 128", jittered_se(1.0), 128))
        cases.append((f"jittered squared-exponential Gram at gamma = sqrt(D), n = {GP_N}, block 128",
                      jittered_se(GP_WIDE_GAMMA), 128))
        _cuda.reset_launch_counts()
        factors = [ops_chol.cholesky_cuda(K, block) for _, K, block in cases]
        torch.cuda.synchronize()
        chol_launches = chol_k.launches
        expected_chol = sum(chol_k.launches_per_call(K.shape[0]) for _, K, _ in cases)
        log(f"cholesky: {len(cases)} factorizations, {chol_launches} kernel launches counted; expected "
            f"{expected_chol} = sum of 2 ceil(n / 64) over n = {[K.shape[0] for _, K, _ in cases]}")
        if chol_launches != expected_chol or any(chol_k.launches_per_call(K.shape[0]) != 2 * -(-K.shape[0] // 64)
                                                 for _, K, _ in cases):
            raise RuntimeError(f"cholesky counted {chol_launches} launches, expected {expected_chol}")
        for (label, K, block), L in zip(cases, factors):
            upper = float(torch.triu(L, 1).abs().max())
            log(f"{label}: upper triangle max |L_ij| = {upper}")
            if upper != 0.0:
                raise RuntimeError(f"{label}: the upper triangle is not exactly zero")
            chol_errors[f"{label} vs plain"] = compare(f"cholesky {label} vs cholesky_plain", L,
                                                       ops_chol.cholesky_plain(K, block), rtol=CHOL_TOL, atol=CHOL_TOL)
            chol_errors[f"{label} vs library"] = compare(f"cholesky {label} vs torch.linalg.cholesky", L,
                                                         torch.linalg.cholesky(K), rtol=CHOL_TOL, atol=CHOL_TOL)

    gram_launches, path_checks = {}, {}
    with phase(f"13 bench_gp({GP_N}, {GP_D}, backend='cuda'): three flux GPs, kernel vs plain build"):
        _cuda.reset_launch_counts()
        gp = benchmarks.bench_gp(GP_N, GP_D, backend="cuda", repeats=5, device=dev)
        gram_launches["bench_gp"] = gram_k.launches
        log(f"cuda backend: ms per build min={gp['ms_min']:.3f} median={gp['ms_median']:.3f} max={gp['ms_max']:.3f} "
            f"all={[round(t, 3) for t in gp['ms']]}; gram launches {gram_k.launches} for {gp['builds']} builds "
            f"(expected 3 per build)")
        if gram_k.launches != 3 * gp["builds"]:
            raise RuntimeError(f"bench_gp counted {gram_k.launches} gram launches for {gp['builds']} builds")
        plain_gp = benchmarks.bench_gp(GP_N, GP_D, backend="plain", repeats=3, device=dev)
        log(f"plain backend (one shared factorization): ms per build median={plain_gp['ms_median']:.3f} "
            f"all={[round(t, 3) for t in plain_gp['ms']]}")
        # The two training Grams differ only on their diagonal (coincident pairs, bound of phase 11 for the
        # squared exponential), and K is within 4e-4 of the identity here: alpha differs by at most that bound.
        aa = (x_gp.double() ** 2).sum(1)
        alpha_rtol = 1.0 - math.exp(-gamma_bound(GP_D + 2) * 2.0 * float(aa.max()))
        for flux, mk, mp in zip(("uw", "vw", "wT"), gp["models"], plain_gp["models"]):
            rel = float((mk.alpha - mp.alpha).norm() / mp.alpha.norm())
            log(f"alpha[{flux}] kernel vs plain build: |da| / |a| = {rel:.3e} (limit {alpha_rtol:.3e}, the diagonal's "
                f"f32 cancellation bound for the squared exponential)")
            if not rel <= alpha_rtol:
                raise RuntimeError("kernel-built and plain-built GPs disagree")
            path_checks[f"bench_gp alpha[{flux}] rel"] = rel
        # The same build at gamma = sqrt(D), where K is far from the identity.
        # The two builds solve in f32 with other Grams and other solves, so
        # alpha may differ by the first-order error of a backward-stable solve,
        # kappa(K_j) u with u = 2^-24; a kernel error of relative size e off the
        # diagonal would add up to kappa e.
        x_gp, ys_gp, z_gp = benchmarks.gp_inputs(GP_N, GP_D, device=dev)
        before = gram_k.launches
        wide = {be: benchmarks.gp_build_three(x_gp, ys_gp, z_gp, be, gamma=GP_WIDE_GAMMA) for be in ("cuda", "plain")}
        if gram_k.launches != before + 3:
            raise RuntimeError(f"the build at gamma = sqrt(D) counted {gram_k.launches - before} gram launches, not 3")
        K_p = wide["plain"][0].kernel.gram(x_gp, x_gp, z_gp).double()
        K_k = wide["cuda"][0].kernel.gram(x_gp, x_gp, z_gp).double()
        K_j = K_p + float(K_p.max()) * tgp.default_jitter(torch.float32) * torch.eye(GP_N, device=dev,
                                                                                        dtype=torch.float64)
        eig = torch.linalg.eigvalsh(K_j)
        kappa = float(eig[-1] / eig[0])
        wide_rtol = kappa * 2.0**-24
        off = ~torch.eye(GP_N, dtype=torch.bool, device=dev)
        log(f"gamma = sqrt(D) = {GP_WIDE_GAMMA:.4f}: off-diagonal K median {float(K_p[off].median()):.3e}, min "
            f"{float(K_p[off].min()):.3e}; kernel vs plain Gram max |dK| off the diagonal "
            f"{float((K_k - K_p)[off].abs().max()):.3e}, on it {float((K_k - K_p).diagonal().abs().max()):.3e}; "
            f"kappa(K_j) = {kappa:.4e}")
        for flux, mk, mp in zip(("uw", "vw", "wT"), wide["cuda"], wide["plain"]):
            a_p = mp.alpha.double()
            rel = float((mk.alpha.double() - a_p).norm() / a_p.norm())
            gram_part = float(torch.linalg.solve(K_j, (K_k - K_p) @ a_p).norm() / a_p.norm())
            log(f"alpha[{flux}] at gamma = sqrt(D), kernel vs plain build: |da| / |a| = {rel:.3e} (limit kappa u = "
                f"{wide_rtol:.3e}; the Grams' difference alone, to first order: {gram_part:.3e})")
            if not (bool(torch.isfinite(mk.alpha).all()) and rel <= wide_rtol):
                raise RuntimeError("kernel-built and plain-built GPs disagree at gamma = sqrt(D)")
            path_checks[f"bench_gp gamma=sqrt(D) alpha[{flux}] rel"] = rel

    with phase(f"14 bench_gp_ml2_step({GP_N}, {GP_D}, 'cuda'): one ML-II step, kernel vs plain"):
        _cuda.reset_launch_counts()
        ml2 = benchmarks.bench_gp_ml2_step(GP_N, GP_D, backend="cuda", repeats=5, device=dev)
        gram_launches["ml2_step"] = gram_k.launches
        log(f"cuda backend: ms per step min={ml2['ms_min']:.3f} median={ml2['ms_median']:.3f} max={ml2['ms_max']:.3f} "
            f"all={[round(t, 3) for t in ml2['ms']]}; gram launches {gram_k.launches} for {ml2['steps']} steps")
        if gram_k.launches != ml2["steps"]:
            raise RuntimeError(f"bench_gp_ml2_step counted {gram_k.launches} gram launches for {ml2['steps']} steps")
        plain_ml2 = benchmarks.bench_gp_ml2_step(GP_N, GP_D, backend="plain", repeats=3, device=dev)
        log(f"plain backend: ms per step median={plain_ml2['ms_median']:.3f}")
        for gamma in (GP_WIDE_GAMMA, 1.0):
            for seed in ML2_SEEDS:
                label = f"gamma={gamma:.4g} seed={seed}"
                loss_k, grad_k = benchmarks.ml2_loss_and_grad(GP_N, GP_D, "cuda", seed=seed, gamma=gamma, device=dev)
                loss_p, grad_p = benchmarks.ml2_loss_and_grad(GP_N, GP_D, "plain", seed=seed, gamma=gamma, device=dev)
                loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
                gap = grad_k - grad_p
                extra = ""
                if gamma == 1.0:
                    # First order in the diagonal difference dK_ii at gamma =
                    # sigma = 1: the log sigma gradient is g = (n - tr(K^-1 Y
                    # Y^T) / D) / 2 (K and its jitter both scale with sigma), so
                    # dg = sum_i |(K^-1 Y)_i|^2 dK_ii / (2 D).
                    x_ml, ys_ml, _ = benchmarks.gp_inputs(GP_N, GP_D, seed=seed, device=dev)
                    one = torch.ones((), device=dev)
                    K_k = tgp.GPKernel(one, one, one, backend="cuda").gram(x_ml, x_ml, None)
                    K_p = tgp.GPKernel(one, one, one).gram(x_ml, x_ml, None)
                    dK = torch.diagonal(K_k) - torch.diagonal(K_p)
                    K_j = K_p.double() + float(K_p.max()) * tgp.default_jitter(torch.float32) * torch.eye(
                        GP_N, device=dev, dtype=torch.float64)
                    Kinv_y = torch.linalg.solve(K_j, ys_ml[0].double())
                    predicted = float(((Kinv_y**2).sum(1) * dK.double()).sum()) / (2 * ys_ml[0].shape[1])
                    gap = gap - torch.tensor([0.0, predicted, 0.0], device=dev)
                    extra = (f"; diagonals: max |dK_ii| = {float(dK.abs().max()):.3e}, mean dK_ii = "
                             f"{float(dK.mean()):.3e}; log sigma gap {float(grad_k[1] - grad_p[1]):.4e}, first-order "
                             f"prediction {predicted:.4e}; raw |g_k - g_p| / |g_p| = "
                             f"{float((grad_k - grad_p).norm() / grad_p.norm()):.3e}")
                    path_checks[f"ml2 {label} max |dK_ii|"] = float(dK.abs().max())
                grad_rel = float(gap.norm() / grad_p.norm())
                log(f"ML-II {label}, kernel vs plain: loss {float(loss_k):.8e} vs {float(loss_p):.8e} (rel "
                    f"{loss_rel:.3e}, limit {ML2_LOSS_RTOL}); gradient (log gamma, log sigma, log alpha) "
                    f"{grad_k.tolist()} vs {grad_p.tolist()}: |g_k - g_p{' - prediction' if extra else ''}| / |g_p| "
                    f"= {grad_rel:.3e} (limit {ML2_GRAD_RTOL}){extra}")
                if not (bool(torch.isfinite(grad_k).all()) and loss_rel <= ML2_LOSS_RTOL and grad_rel <= ML2_GRAD_RTOL):
                    raise RuntimeError(f"kernel-backed and plain ML-II steps disagree ({label})")
                path_checks[f"ml2 {label} loss rel"] = loss_rel
                path_checks[f"ml2 {label} grad rel"] = grad_rel

    with phase(f"15 solve_gp_closure: {GP_N} columns x {DE_SAVES} saves x {DE_SUBSTEPS} RK4 substeps, kernel GPs"):
        model = benchmarks.make_setup(GP_NZ, 8, device=dev)[0]
        gps = tgc.FluxGPs(*gp["models"])
        if not tgc._share_gram(gps):
            raise RuntimeError("the three kernel-backed GPs do not share one Gram")
        plain_kernel = dataclasses.replace(gps.uw.kernel, backend="plain")
        plain_gps = tgc.FluxGPs(*(dataclasses.replace(m, kernel=plain_kernel) for m in gps))
        x0 = gps.uw.x_train + device_args(GP_N, GP_D, 80, dev, scale=0.1)
        _cuda.reset_launch_counts()
        t_de = time.perf_counter()
        traj = tgc.solve_gp_closure(model, gps, x0, 0.0, DE_DT_SAVE, DE_SAVES, n_substeps=DE_SUBSTEPS)
        torch.cuda.synchronize()
        de_s = time.perf_counter() - t_de
        gram_launches["gp_closure_de"] = gram_k.launches
        expected_de = DE_SAVES * DE_SUBSTEPS * 4
        log(f"GP-closure DE: {de_s * 1e3:.1f} ms wall; gram launches {gram_k.launches}, expected {expected_de} = "
            f"{DE_SAVES} saves x {DE_SUBSTEPS} substeps x 4 RK4 stages (one shared Gram per stage)")
        if gram_k.launches != expected_de:
            raise RuntimeError(f"the GP-closure DE counted {gram_k.launches} gram launches, expected {expected_de}")
        t_de = time.perf_counter()
        want_de = tgc.solve_gp_closure(model, plain_gps, x0, 0.0, DE_DT_SAVE, DE_SAVES, n_substeps=DE_SUBSTEPS)
        torch.cuda.synchronize()
        de_plain_s = time.perf_counter() - t_de
        log(f"plain-backed DE: {de_plain_s * 1e3:.1f} ms wall; max |x - x0| = {float((traj[-1] - x0).abs().max()):.3e}")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t_p = time.perf_counter()
            tgc.solve_gp_closure(model, gps, x0, 0.0, DE_DT_SAVE, 2, n_substeps=DE_SUBSTEPS)
            torch.cuda.synchronize()
            de_prof_wall = (time.perf_counter() - t_p) * 1e3
        on_dev = benchmarks._on_device(prof)
        de_busy = benchmarks._device_ms(on_dev)
        de_ops = sum(e.count for e in on_dev)
        log(f"profiled DE window, 2 saves x {DE_SUBSTEPS} substeps x 4 stages (torch.profiler): wall {de_prof_wall:.2f} ms, "
            f"device busy {de_busy:.3f} ms, idle share {1.0 - de_busy / de_prof_wall:.3f}, {de_ops} device ops "
            f"({de_ops / (2 * DE_SUBSTEPS * 4):.1f} per stage)")
        for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.key[:60]}: {e.count} x, {e.self_device_time_total * 1e-3:.3f} ms")
        if not float((traj[-1] - x0).abs().max()) > 1e-4:
            raise RuntimeError("the GP-closure DE did not evolve")
        path_checks["gp_closure_de_trajectory"] = compare(
            "GP-closure DE trajectory, kernel vs plain Gram", traj, want_de, rtol=DE_RTOL, atol=DE_ATOL)

    with phase("16 train-gp CLI on the card: two synthetic sims, ML-II with --gram-backend cuda, --integrate"):
        with tempfile.TemporaryDirectory() as out:
            cmd = [sys.executable, "-m", "climateparameterizations_jl_tpu_torch.cli", "train-gp",
                   "--sims", "strong_wind", "--test-sims", "strong_wind_weak_cooling", "--fluxes", "uw,vw,wT",
                   "--optimize-hyperparams", "--hyperopt-iters", "5", "--gram-backend", "cuda", "--integrate",
                   "--output", out]
            t_cli = time.perf_counter()
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
            cli_s = time.perf_counter() - t_cli
            for line in (proc.stdout + proc.stderr).strip().splitlines()[-12:]:
                log(f"  {line}")
            if proc.returncode != 0:
                raise RuntimeError(f"train-gp exited {proc.returncode}")
            with open(Path(out) / "gp_report.json") as f:
                report = json.load(f)
        log(f"train-gp took {cli_s:.1f}s; gp_report.json: {json.dumps(report)}")
        if sorted(report) != ["gp_de", "uw", "vw", "wT"] or not all(
                math.isfinite(report[f]["mse"]) and report[f]["mean_posterior_variance"] >= 0.0 for f in ("uw", "vw", "wT")):
            raise RuntimeError("gp_report.json lacks a flux or holds a non-finite value")
        if not (math.isfinite(report["gp_de"]["trajectory_mse"]) and report["gp_de"]["frames"] == 33):
            raise RuntimeError("gp_report.json has no finite GP-closure DE result")

    with phase("17 bench_gram / bench_cholesky at the path's shapes"):
        gbench = {fam: benchmarks.bench_gram(GP_N, GP_N, GP_D, family=fam, device=dev)
                  for fam in ("squared_exponential", "matern12")}
        for fam, r in gbench.items():
            log(f"gram {GP_N}x{GP_N}x{GP_D} {fam}, device us per call, torch.profiler (wall us back to back): "
                + ", ".join(f"{k} {r[k + '_ms'] * 1e3:.2f} ({r[k + '_wall_ms'] * 1e3:.2f})" for k in ("cuda", "plain", "cdist"))
                + f"; kernel vs plain max abs off the coincident pairs {r['max_abs_err_vs_plain']:.3e}")
        g = gbench["squared_exponential"]
        g_ops, g_bytes = g["flops"] / PEAK_F32_FLOPS * 1e3, g["bytes"] / PEAK_BYTES_PER_S * 1e3
        g_bound, g_bound_by = (g_ops, "operations") if g_ops >= g_bytes else (g_bytes, "bytes")
        log(f"gram bound: {g['flops']:.4e} flop / 67 TFLOP/s = {g_ops * 1e3:.3f} us; {g['bytes']} B / 3.35 TB/s = "
            f"{g_bytes * 1e3:.3f} us; share of bound reached = {g_bound / g['cuda_ms']:.3f}")
        cb = benchmarks.bench_cholesky(GP_N, 128, repeats=3, device=dev)
        log(f"cholesky n = {GP_N}, device us per call, torch.profiler (wall us back to back): "
            + ", ".join(f"{k} {cb[k + '_ms'] * 1e3:.2f} ({cb[k + '_wall_ms'] * 1e3:.2f})" for k in ("cuda", "plain", "library"))
            + f"; kernel vs plain {cb['max_abs_err_vs_plain']:.3e}, vs library {cb['max_abs_err_vs_library']:.3e}")
        # Kernel against torch.linalg.cholesky by CUDA events, in turns (kernel,
        # library, library, kernel; median of 10 calls each) on the path's
        # jittered SE Gram (gamma = 1: its off-diagonal exp(-d^2 / 2) ~ exp(-96)
        # are subnormal in f32), on the same Gram at gamma = sqrt(D), and on a
        # dense SPD matrix without subnormal entries.
        A = device_args(GP_N, GP_N, 90, dev)
        chol_matrices = {"jittered_se_gram": cb["matrix"], "jittered_se_gram_gamma_sqrt_d": cases[-1][1],
                         "dense_spd": A @ A.T + GP_N * torch.eye(GP_N, device=dev)}
        chol_turns = {}
        for key, K in chol_matrices.items():
            kernel_fn, library_fn = (lambda K=K: ops_chol.cholesky_cuda(K, 128)), (lambda K=K: torch.linalg.cholesky(K))
            turns = [cuda_ms(fn, repeats=10)[0] for fn in (kernel_fn, library_fn, library_fn, kernel_fn)]
            kernel_ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            chol_turns[key] = {"kernel_ms": [turns[0], turns[3]], "library_ms": [turns[1], turns[2]],
                               "kernel_over_library": kernel_ms / library_ms}
            log(f"cholesky n = {GP_N}, {key}: median ms per call by CUDA events, in turns kernel {turns[0]:.4f}, "
                f"library {turns[1]:.4f}, library {turns[2]:.4f}, kernel {turns[3]:.4f}; kernel / library = "
                f"{kernel_ms / library_ms:.3f}"
                + (f"; earlier kernel {CHOLESKY_EARLIER_MS[key]:.4f} ms" if key in CHOLESKY_EARLIER_MS else ""))
        log(f"subnormal entries in the SE Gram: {int(((cb['matrix'] != 0) & (cb['matrix'].abs() < 1.1754944e-38)).sum())}")
        c_ops, c_bytes = cb["flops"] / PEAK_F32_FLOPS * 1e3, cb["bytes"] / PEAK_BYTES_PER_S * 1e3
        c_bound, c_bound_by = (c_ops, "operations") if c_ops >= c_bytes else (c_bytes, "bytes")
        log(f"cholesky bound: {cb['flops']:.4e} flop / 67 TFLOP/s = {c_ops * 1e3:.3f} us; {cb['bytes']} B / 3.35 TB/s = "
            f"{c_bytes * 1e3:.3f} us; share of bound reached = {c_bound / cb['cuda_ms']:.4f}")

    gram_record = {
        "name": "gram",
        "route": "cuda",
        "source": "climateparameterizations_jl_tpu_torch/csrc/gram.cu",
        "replaces": "climateparameterizations_jl_tpu/ops/gram.py:125",
        "launches": gram_launches["gp_closure_de"],
        "launches_by_path": gram_launches,
        "max_abs_err": max(gram_errors.values()),
        "coincident_max_abs_err": max(gram_coincident.values()),
        "errors": gram_errors,
        "path_checks": path_checks,
        "ms": g["cuda_ms"],
        "plain_ms": g["plain_ms"],
        "bound_ms": g_bound,
        "bound_by": g_bound_by,
        "library_ms": None,
        "cdist_ms": g["cdist_ms"],
        "wall_ms": g["cuda_wall_ms"],
        "matern12_ms": gbench["matern12"]["cuda_ms"],
        "shape": {"M": GP_N, "N": GP_N, "D": GP_D, "family": "squared_exponential"},
        "bench_gp_ms": {"cuda": gp["ms"], "plain": plain_gp["ms"]},
        "ml2_step_ms": {"cuda": ml2["ms"], "plain": plain_ml2["ms"]},
        "gp_closure_de_s": {"cuda": de_s, "plain": de_plain_s},
        "gp_closure_de_profile": {"stages": 2 * DE_SUBSTEPS * 4, "wall_ms": de_prof_wall, "device_busy_ms": de_busy,
                                  "device_idle_share": 1.0 - de_busy / de_prof_wall, "device_ops": de_ops},
        "train_gp_cli_s": cli_s,
        "ptxas": ptxas_summary(gram_k.ptxas_report),
        "build_s": gram_k.build_seconds,
    }
    chol_record = {
        "name": "cholesky",
        "route": "cuda",
        "source": "climateparameterizations_jl_tpu_torch/csrc/cholesky.cu",
        "replaces": "climateparameterizations_jl_tpu/ops/cholesky.py:122",
        "launches": chol_launches,
        "factorizations": len(cases),
        "max_abs_err": max(chol_errors.values()),
        "errors": chol_errors,
        "ms": cb["cuda_ms"],
        "plain_ms": cb["plain_ms"],
        "bound_ms": c_bound,
        "bound_by": c_bound_by,
        "library_ms": cb["library_ms"],
        "wall_ms": cb["cuda_wall_ms"],
        "library_wall_ms": cb["library_wall_ms"],
        "event_ms_in_turns": chol_turns,
        "share_of_bound": c_bound / cb["cuda_ms"],
        "shape": {"n": GP_N, "block": 128, "launches_per_call": chol_k.launches_per_call(GP_N)},
        "ptxas": ptxas_summary(chol_k.ptxas_report),
        "build_s": chol_k.build_seconds,
    }
    return gram_record, chol_record


def nonmatmul_flops_per_column_step(Nz: int, h1: int, h2: int) -> int:
    """The f32 work of the fused RK4 function outside its three NN products, per column and RK4 step.

    Counted from the function as the plain version writes it, whatever a
    kernel's own arithmetic (a cheaper mish does not lower it), per RHS
    evaluation (an FMA is 2; expf, log1pf,
    tanhf and a division 1 each, so this is a lower bound): the face
    viscosity (3 differences, 3 eps adds, Ri 7, the tanh argument 2, tanh,
    nu 2) on each interior face, the bias adds, mish (max, abs, expf,
    log1pf, add, tanhf, mul) on each hidden activation, the mPP term
    (difference, nu d, coefficient, subtraction) on each interior face
    flux, and the stencil, Coriolis and BC row (7) on each lane; then 13
    per lane and step for the RK4 stage inputs and combination.
    """
    F, ni = 3 * Nz, Nz - 1
    per_rhs = 18 * ni + 3 * (h1 + h2 + ni) + 7 * 3 * (h1 + h2) + 4 * 3 * ni + 7 * F
    return 4 * per_rhs + 13 * F


def bf16_phases(dev, flagship, f32_ms: float) -> dict:
    """Phases 18-21: the bf16 fused RK4 kernel and the rk4 fast-assembly training step; returns the kernel's record."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops.fused_rhs import make_fused_runner_mxu
    from climateparameterizations_jl_tpu_torch.train.nde import nn_parameters

    kernel = _cuda.FUSED_RK4_BF16
    dt = benchmarks.FORWARD_DT
    errors = {}
    with phase("18 fused_rk4_bf16: tiny launch (8 columns x 1 step)"):
        lib = kernel.load()
        shapes = kernel.shapes()
        smem = [lib.fused_rk4_bf16_smem_bytes(NZ, 50, 20, i) for i in range(len(shapes))]
        log(f"fused_rk4_bf16 launch shapes (columns, warps per CTA; the first is the default): {shapes}; dynamic "
            f"shared memory per CTA at the flagship widths: {smem} B")
        model, nns, bcs, x0 = benchmarks.make_setup(NZ, 8, seed=1, nns=flagship, device=dev)
        run = make_fused_runner_mxu(model, nns, bcs, dt, 1, 8, matmul_dtype="bfloat16", device=dev)
        got = run(x0)
        torch.cuda.synchronize()
        errors["tiny_vs_plain"] = compare("tiny bf16 kernel vs bf16 plain version", got, run.plain(x0),
                                          rtol=BF16_RTOL, atol=BF16_ATOL)

    with phase(f"19 fused_rk4_bf16 at full width ({FULL_COLUMNS} columns x {BENCH_STEPS} steps, flagship weights)"):
        model, nns, bcs, x0 = benchmarks.make_setup(NZ, FULL_COLUMNS, seed=0, nns=flagship, device=dev)
        run = make_fused_runner_mxu(model, nns, bcs, dt, BENCH_STEPS, FULL_COLUMNS, matmul_dtype="bfloat16",
                                    device=dev)
        before = kernel.launches
        got = run(x0)
        torch.cuda.synchronize()
        log(f"fused_rk4_bf16 launches for one runner call: {kernel.launches - before}")
        if kernel.launches != before + 1:
            raise RuntimeError(f"one bf16 runner call counted {kernel.launches - before} launches, expected 1")
        plain_ms, want = cuda_ms(lambda: run.plain(x0))
        log(f"bf16 plain version, {BENCH_STEPS} steps: {plain_ms:.2f} ms")
        errors[f"{BENCH_STEPS}_steps_vs_plain"] = compare(
            f"bf16 kernel vs bf16 plain version, {BENCH_STEPS} steps", got, want, rtol=BF16_RTOL, atol=BF16_ATOL)
        moved = float((got - x0).abs().max())
        log(f"max |x - x0| after {BENCH_STEPS} steps = {moved:.3e}")
        if not moved > 1e-4:
            raise RuntimeError("the state did not evolve")
        short = {mdt: make_fused_runner_mxu(model, nns, bcs, dt, JAX_BF16_STEPS, FULL_COLUMNS, matmul_dtype=mdt,
                                            device=dev)(x0) for mdt in ("bfloat16", "float32")}
        errors[f"{JAX_BF16_STEPS}_steps_vs_f32_kernel"] = compare(
            f"bf16 kernel vs f32 kernel, {JAX_BF16_STEPS} steps (the JAX bf16 test's horizon and tolerance)",
            short["bfloat16"], short["float32"], rtol=JAX_BF16_RTOL, atol=JAX_BF16_ATOL)
        f32_long = make_fused_runner_mxu(model, nns, bcs, dt, BENCH_STEPS, FULL_COLUMNS, device=dev)(x0)
        gap = (got - f32_long).abs()
        gap_max = float(gap.max())
        gap_ok = bool(torch.allclose(got, f32_long, rtol=JAX_BF16_RTOL, atol=JAX_BF16_ATOL))
        log(f"bf16 kernel vs f32 kernel, {BENCH_STEPS} steps (printed, not held): max_abs={gap_max:.3e} "
            f"median_abs={float(gap.median()):.3e} max |x| {float(f32_long.abs().max()):.3e}; inside "
            f"allclose(rtol={JAX_BF16_RTOL}, atol={JAX_BF16_ATOL}): {gap_ok}")

    with phase(f"20 timing: bench_nde_forward with bf16 matmuls ({FULL_COLUMNS} x {BENCH_STEPS}, {BENCH_REPEATS} "
               f"repeats), launch shapes, tensor-core check"):
        _cuda.reset_launch_counts()
        stats = benchmarks.bench_nde_forward(FULL_COLUMNS, NZ, BENCH_STEPS, BENCH_REPEATS, nns=flagship, device=dev,
                                             matmul_dtype="bfloat16")
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        log(f"bf16 kernel ms: min={stats['ms_min']:.3f} median={stats['ms_median']:.3f} max={stats['ms_max']:.3f} "
            f"all={[round(t, 3) for t in stats['ms']]}; f32 kernel (phase 5, same run) median {f32_ms:.3f} ms")
        log(f"launch counts on the bf16 serving path: {launches}; runner calls made: {stats['calls']}")
        if launches["fused_rk4_bf16"] != stats["calls"] or stats["calls"] == 0 or launches["fused_rk4"] != 0:
            raise RuntimeError(f"the bf16 serving path counted {launches} for {stats['calls']} runner calls")
        sweep = {}
        for i, (cols, warps) in enumerate(shapes):
            def launch(i=i):
                return kernel(x0, run.kernel_weights, run.kernel_frags, run.kernel_params, shape=i)

            launch()
            sweep[f"{cols} columns x {warps} warps"] = cuda_ms(launch, repeats=BENCH_REPEATS)[0]
        log(f"launch-shape sweep, median ms of {BENCH_REPEATS} at {FULL_COLUMNS} x {BENCH_STEPS}: {sweep}")
        cuobjdump = Path(_cuda.find_nvcc()).with_name("cuobjdump")
        if not cuobjdump.exists():
            raise RuntimeError(f"{cuobjdump} is missing: the tensor-core check cannot run")
        sass = subprocess.run([str(cuobjdump), "-sass", str(kernel.library_path)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
        hmma = [line.split(";")[0].split("*/")[-1].strip() for line in sass.splitlines() if "HMMA" in line]
        log(f"cuobjdump -sass {kernel.library_path.name}: {len(hmma)} HMMA instructions (over {len(shapes)} launch "
            f"shapes, each for the flagship and the generic widths), e.g. {hmma[:1]}")
        if not hmma:
            raise RuntimeError("no HMMA instruction in the bf16 kernel's SASS: its products are not on the tensor cores")
        h1, h2 = nns.uw.weights[0].shape[0], nns.uw.weights[1].shape[0]
        F, ni, col_steps = 3 * NZ, NZ - 1, FULL_COLUMNS * BENCH_STEPS
        mm_flops = col_steps * 4 * 2 * (F * 3 * h1 + 3 * h1 * h2 + 3 * h2 * ni)
        ew_flops = col_steps * nonmatmul_flops_per_column_step(NZ, h1, h2)
        n_bytes = 4 * (2 * FULL_COLUMNS * F + run.kernel_weights.numel()) + 2 * run.kernel_frags.numel()
        t_tc, t_cc = mm_flops / PEAK_BF16_FLOPS * 1e3, ew_flops / PEAK_F32_FLOPS * 1e3
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        bound_ms = max(t_tc, t_cc, t_bytes)
        bound_by = "bytes" if t_bytes == bound_ms else "operations"
        log(f"bound: tensor cores {mm_flops:.4e} bf16 FLOP / 989 TFLOP/s = {t_tc:.4f} ms; CUDA cores {ew_flops:.4e} "
            f"f32 FLOP / 67 TFLOP/s = {t_cc:.4f} ms; {n_bytes} B / 3.35 TB/s = {t_bytes:.5f} ms; bound {bound_ms:.4f} "
            f"ms ({bound_by}); share of bound reached = {bound_ms / stats['ms_median']:.4f}")

    with phase("21 rk4 fast-assembly training step: bench_nde_train_step(method='rk4'), fast_assembly 'fold' vs False"):
        steps = {}
        for fa in ("fold", False):
            steps[fa] = benchmarks.bench_nde_train_step(method="rk4", fast_assembly=fa, n_timed=FAST_TIMED_STEPS,
                                                        nns=flagship, device=dev)
            r = steps[fa]
            log(f"fast_assembly={fa!r} (resolved {r['fast_assembly']!r}): ms per step min={r['ms_min']:.1f} "
                f"median={r['ms_median']:.1f} max={r['ms_max']:.1f} all={[round(t, 1) for t in r['ms']]}; losses "
                f"{r['losses']}")
        if steps["fold"]["fast_assembly"] != "fold" or steps[False]["fast_assembly"] is not False:
            raise RuntimeError("bench_nde_train_step did not run the requested assembly")
        setup = benchmarks.nde_train_step_setup(method="rk4", nns=flagship, device=dev)
        sizes = [p.numel() for p in nn_parameters(setup["nns"])]
        (loss_f, grad_f), (loss_d, grad_d) = (benchmarks.train_step_loss_and_grad(setup, fast_assembly=fa)
                                              for fa in ("fold", False))
        loss_rel = abs(float(loss_f) - float(loss_d)) / abs(float(loss_d))
        worst, ok = 0.0, bool(torch.isfinite(grad_f).all()) and loss_rel <= FAST_LOSS_RTOL
        for gf, gd in zip(torch.split(grad_f, sizes), torch.split(grad_d, sizes)):
            limit = FAST_GRAD_ATOL * max(1.0, float(gd.abs().max())) + FAST_GRAD_RTOL * gd.abs()
            worst = max(worst, float(((gf - gd).abs() / limit).max()))
        ok = ok and worst <= 1.0
        log(f"one step, fold vs default: loss {float(loss_f):.8e} vs {float(loss_d):.8e} (rel {loss_rel:.3e}, limit "
            f"{FAST_LOSS_RTOL}); {len(sizes)} gradient leaves, worst |g_f - g_d| / (atol + rtol |g_d|) = {worst:.3e} "
            f"(limit 1; rtol {FAST_GRAD_RTOL}, atol {FAST_GRAD_ATOL} max(1, max|g|)); max |g| {float(grad_d.abs().max()):.3e}")
        if not ok:
            raise RuntimeError("the rk4 fast-assembly step and the default step disagree")

    return {
        "name": "fused_rk4_bf16",
        "route": "cuda",
        "source": "climateparameterizations_jl_tpu_torch/csrc/fused_rk4_bf16.cu",
        "replaces": "climateparameterizations_jl_tpu/ops/fused_rhs.py:535 (matmul_dtype=bfloat16)",
        "launches": launches["fused_rk4_bf16"],
        "max_abs_err": max(errors["tiny_vs_plain"], errors[f"{BENCH_STEPS}_steps_vs_plain"]),
        "errors": errors,
        "ms": stats["ms_median"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "tensor_core_bound_ms": t_tc,
        "cuda_core_bound_ms": t_cc,
        "bytes_bound_ms": t_bytes,
        "f32_kernel_ms": f32_ms,
        "gap_to_f32_kernel": {"steps": BENCH_STEPS, "max_abs": gap_max, "inside_jax_bf16_tolerance": gap_ok},
        "launch_shape_sweep_ms": sweep,
        "hmma_instructions": len(hmma),
        "smem_bytes_per_shape": dict(zip([f"{c}x{w}" for c, w in shapes], smem)),
        "shape": {"columns": FULL_COLUMNS, "steps": BENCH_STEPS, "Nz": NZ},
        "rk4_fast_assembly_step": {
            "ms": {str(fa): steps[fa]["ms"] for fa in steps}, "loss_rel": loss_rel, "worst_grad_ratio": worst,
        },
        "ptxas": ptxas_summary(kernel.ptxas_report),
        "build_s": kernel.build_seconds,
    }


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
        from climateparameterizations_jl_tpu_torch.ops.fused_rhs import make_fused_runner, make_fused_runner_mxu
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

    with phase("2 build fused_rk4, fused_rk4_bf16, thomas, gram and cholesky (one nvcc each, side by side)"):
        _cuda.load_all()
        for k in _cuda.KERNELS.values():
            log(f"{k.source.name}: nvcc+load {k.build_seconds:.2f}s from {k.source.relative_to(REPO)}")
            for line in k.ptxas_report.splitlines():
                if line.strip():
                    log(f"  {line.strip()}")
        lib = kernel.load()
        log(f"fused_rk4 launch: {lib.fused_rk4_columns_per_block()} columns and {lib.fused_rk4_threads_per_block()} "
            f"threads per CTA, {lib.fused_rk4_smem_bytes(NZ, 50, 20)} B dynamic shared memory per CTA (flagship "
            f"widths); the flagship widths have their own instantiation: {bool(lib.fused_rk4_specialized(NZ, 50, 20))}")
        blib = _cuda.FUSED_RK4_BF16.load()
        bshapes = _cuda.FUSED_RK4_BF16.shapes()
        log("fused_rk4_bf16 launch shapes (columns, warps per CTA), dynamic shared memory per CTA at the flagship "
            "widths: " + ", ".join(f"{c} x {w}: {blib.fused_rk4_bf16_smem_bytes(NZ, 50, 20, i)} B"
                                   for i, (c, w) in enumerate(bshapes)))
        for k in (_cuda.FUSED_RK4, _cuda.FUSED_RK4_BF16):
            for r in ptxas_summary(k.ptxas_report):
                log(f"{k.source.name} {r['function']}: {r['registers']} registers, {r['spill_store_bytes']} B of "
                    f"spill stores, {r['smem_bytes']} B static shared memory")
                if r["spill_store_bytes"]:
                    raise RuntimeError(f"{r['function']} spills registers")

    flagship = load_flux_nns(str(FLAGSHIP_RUN), device=dev)

    with phase("3 tiny launch (8 columns x 1 step)"):
        model, nns, bcs, x0 = benchmarks.make_setup(NZ, 8, seed=1, nns=flagship, device=dev)
        run = make_fused_runner_mxu(model, nns, bcs, dt, 1, 8, device=dev)
        got = run(x0)
        torch.cuda.synchronize()
        compare("tiny kernel vs plain", got, run.plain(x0))

    errors = {}
    with phase(f"4 full width ({FULL_COLUMNS} columns x {FULL_STEPS} steps, flagship weights)"):
        model, nns, bcs, x0 = benchmarks.make_setup(NZ, FULL_COLUMNS, seed=0, nns=flagship, device=dev)
        run = make_fused_runner_mxu(model, nns, bcs, dt, FULL_STEPS, FULL_COLUMNS, device=dev)
        got = run(x0)
        torch.cuda.synchronize()
        plain_ms_64, want_plain = cuda_ms(lambda: run.plain(x0))
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
        want1_plain = run1.plain(x0)
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
            lambda: run.plain(x0))
        log(f"plain version, {BENCH_STEPS} steps: {plain_ms:.2f} ms")
        errors[f"mxu_{BENCH_STEPS}_steps_vs_plain"] = compare(
            f"make_fused_runner_mxu kernel vs _multistep_plain, {BENCH_STEPS} steps", got_long, want_long)

        h1 = nns.uw.weights[0].shape[0]
        h2 = nns.uw.weights[1].shape[0]
        F, ni, col_steps = 3 * NZ, NZ - 1, FULL_COLUMNS * BENCH_STEPS
        # The products and the work outside them run on the same CUDA cores in f32.
        mm_flops = col_steps * 4 * 2 * (F * 3 * h1 + 3 * h1 * h2 + 3 * h2 * ni)
        ew_flops = col_steps * nonmatmul_flops_per_column_step(NZ, h1, h2)
        n_bytes = 4 * (2 * FULL_COLUMNS * F + run.kernel_weights.numel())
        t_ops, t_bytes = (mm_flops + ew_flops) / PEAK_F32_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
        bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        log(f"bound: ({mm_flops:.4e} matmul + {ew_flops:.4e} other) f32 FLOP / 67 TFLOP/s = {t_ops:.3f} ms "
            f"(matmul alone {mm_flops / PEAK_F32_FLOPS * 1e3:.3f} ms); {n_bytes} B / 3.35 TB/s = {t_bytes:.4f} ms; "
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
        "matmul_bound_ms": mm_flops / PEAK_F32_FLOPS * 1e3,
        "shape": {"columns": FULL_COLUMNS, "steps": BENCH_STEPS, "Nz": NZ},
        "build_s": kernel.build_seconds,
    }
    thomas = _cuda.THOMAS
    thomas_errors = {}
    with phase("6 thomas: tiny launch (1 system, N = 4)"):
        tlib = thomas.load()
        log(f"thomas: one thread per system, {tlib.thomas_systems_per_block()} systems per CTA of "
            f"{tlib.thomas_threads_per_block() // 32} warps (all stage the rows by cp.async, one solves), N <= "
            f"{tlib.thomas_max_n()}; 16-byte copies and a float4 sweep where N % 4 == 0 and the rows are "
            f"16-byte aligned, else 4-byte copies; {tlib.thomas_smem_bytes(32)} B of shared memory per CTA at "
            f"N = 32 ({tlib.thomas_smem_bytes(256)} at N = 256); the operations of _thomas_scan in its rounding, "
            f"one reciprocal per level shared by its two IEEE quotients")
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
            log(f"  entries that differ from _thomas_scan at all: {int((got != want).sum())} of {got.numel()}")
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
            f"max |g| {float(grad_s.abs().max()):.3e}. Reason: per-solve f32 differences between kernel and scan "
            f"through 1,152 substeps and the backward pass, amplified by the mPP tanh switch")
        if not ok:
            raise RuntimeError("kernel-backed and scan-backed steps disagree")
        # Information, not a check: how far the plain "pcr" backend (parallel
        # cyclic reduction, another rounding of the same solves) moves the step.
        loss_p, grad_p = benchmarks.train_step_loss_and_grad(setup, tridiag_backend="pcr")
        pcr_loss_rel = abs(float(loss_p) - float(loss_s)) / abs(float(loss_s))
        pcr_grad_rel = float((grad_p - grad_s).norm() / grad_s.norm())
        log(f"one step, plain pcr vs scan (information): loss rel {pcr_loss_rel:.3e}, gradient "
            f"|g_p - g_s| / |g_s| = {pcr_grad_rel:.3e}")

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
            f"67 TFLOP/s = {t_ops * 1e3:.3f} us; share of bound reached = {t_bound / big['cuda_ms']:.3f} "
            f"(earlier kernel {THOMAS_EARLIER_MS['16384x32'] * 1e3:.2f} us: {t_bound / THOMAS_EARLIER_MS['16384x32']:.3f})")
        small_bound = tbench[54]["bytes"] / PEAK_BYTES_PER_S * 1e3
        log(f"bound at 54 x 32: {tbench[54]['bytes']} B / 3.35 TB/s = {small_bound * 1e3:.3f} us; share of bound "
            f"reached = {small_bound / tbench[54]['cuda_ms']:.4f} (latency-bound; earlier kernel "
            f"{THOMAS_EARLIER_MS['54x32'] * 1e3:.2f} us: {small_bound / THOMAS_EARLIER_MS['54x32']:.4f})")
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
        "share_of_bound": t_bound / big["cuda_ms"],
        "training_shape": {"systems": 54, "N": 32, "ms": tbench[54]["cuda_ms"], "wall_ms": tbench[54]["cuda_wall_ms"],
                           "plain_ms": tbench[54]["scan_ms"], "library_ms": tbench[54]["library_ms"],
                           "bound_ms": small_bound, "bound_by": "bytes"},
        "train_step_ms": {"kernel": train["ms"], "scan": scan["ms"]},
        "train_step_vs_scan": {"kernel": {"loss_rel": loss_rel, "grad_rel": grad_rel},
                               "pcr_plain": {"loss_rel": pcr_loss_rel, "grad_rel": pcr_grad_rel}},
        "train_step_profile": {k: prof[k] for k in ("substeps", "wall_ms", "device_busy_ms", "device_idle_share",
                                                    "device_ops_per_substep")},
        "train_setup_s": setup_s,
        "build_s": thomas.build_seconds,
    }
    gram_record, chol_record = gp_phases(dev)
    bf16_record = bf16_phases(dev, flagship, stats["ms_median"])
    record["ptxas"] = ptxas_summary(kernel.ptxas_report)
    thomas_record["ptxas"] = ptxas_summary(thomas.ptxas_report)
    print(smi, flush=True)
    print(json.dumps({"kernels": [record, thomas_record, gram_record, chol_record, bf16_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
