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
  default path);
- the ``train-nde`` command (phase 22), run in-process through
  ``cli.main.main``: the 18 flagship sims at full width, the three-stage
  curriculum ``200:20,577:12,1153:9`` with multiple shooting (K = 16) over
  the calibrated mPP base of ``runs/wm_les_shoot16``, a resume, the losses
  of the first two stages (plain, then shooting) with the Thomas kernel
  against the plain scan (and every system the kernel solved there against
  ``_thomas_scan``), and
  ``extract``; every implicit solve through ``csrc/thomas.cu``;
- free convection (phases 23-24): ``bench_fc_forward``, 1,024 physics-only
  columns x 1,152 split substeps with one Thomas launch per substep, its
  trajectory equal to the scan-backed one; and the ``train-fc-nde``
  command in-process at full width (nine ids x 1,153 frames, Nz = 32, flux
  pre-training, a curriculum whose last stage spans the window), its first
  stage again on the plain scan with equal losses;
- deep ensembles and calibration (phases 25-29): the flagship step of the
  4-member ensemble ``runs/wm_flagship_ens4``, its members folded onto the
  solve's batch axis (one Thomas launch per solve for all members) and one
  solve per member, held to each other and to scan; ``train-nde --ensemble
  4`` in-process (two stages, a resume, the first stage on scan); the
  ensemble's uncertainty bands on the three held-out sims with a band
  calibration; ``optimise-mpp`` by EKI (64 parameter sets on the solve's
  batch axis), adam and lbfgs; ``train-fc-nde --ensemble 4`` at phase 24's
  size and ``fc_ensemble_uq``;
- the physics baselines and the evaluation harnesses (phases 30-34):
  ``bench_kpp`` and ``bench_tke`` (1,024 columns x 288 steps, one stacked
  Thomas launch per step on (3, 1024, 32) and (4, 1024, 32), trajectories
  equal to the scan-backed ones); the ``evaluate`` command on the three
  held-out sims (the flagship closure against mPP alone and KPP) and
  ``evaluate-fc`` on ids 8 and 9 (against convective adjustment, KPP and
  TKE), each with its launches counted and its baselines equal on kernel and
  scan; ``calibrate-kpp`` on the 18 flagship sims (random, gradient and EKI,
  64 parameter sets per solve on (3, 64, 18, 32), the population equal on
  kernel and scan and to its single solves); and the blocked f64 GP fit at
  n = 16,384 against the unblocked one (no hand-written kernel runs there);
- the embedding and the double gyre (phases 35-38): the host column's paired
  runs over 1,024 columns with the flagship MLPs (one stacked Thomas launch
  on (3, 1024, 32) per host step, the first saves against the scan-backed
  pair); ``train-embedded`` and ``train-embedded-fc`` in-process (a resume,
  the first stage again on scan); ``evaluate --embedded`` of
  ``runs/wm_flagship_default`` on one of the three held-out sims (beside the stored
  JAX run) and ``evaluate-fc --embedded``; and the 96x96x32 double gyre with
  the FC MLP (``bench_double_gyre``, three launches per step on (96, 96, 32),
  (96, 97, 32) and (97, 96, 32), kernel against scan, then the
  ``double-gyre`` command for 5 days with its volume and wall invariants);
- the 3-D LES (phase 39): ``bench_les`` at 64^3 (one Thomas launch per
  Euler step on the 4,224 x 64 pressure systems), 20 Euler and 4 RK3 steps
  kernel-backed against scan-backed (equal, divergence-free), the
  ``generate-les`` command at its 32^3 default (1,088 x 32) and the
  free-convection ``les3d`` source at 64 x 64 x 128 (4,224 x 128) through
  its cache;
- the column ensemble on one card (phase 40): ``bench_column_ensemble``
  (1,024 members x 256 split substeps, one launch per substep on (3, 1024,
  32)), kernel against scan, and the ``ensemble`` command;
- the suite and the headline (phases 41-42): ``benchmark --suite --quick``
  through the CLI (the twelve rows of ``benchmarks.run_suite``, with the
  Thomas, fused RK4 and Gram kernels launched), then
  ``benchmarks.headline`` at full width (the 1,024 x 1,024 forward, the
  32,768-column peak row, one sequential and one ``shooting=16`` flagship
  step) and ``eval/report.py::training_report`` of the flagship closure on a
  held-out sim with matplotlib hidden (the card's machine has none): its
  arrays, its summary and the stderr line naming the figures not drawn;
- the parallel layer (phase 43): a world of ``torch.cuda.device_count()``
  spawned NCCL ranks (one on a one-card machine) runs every path of
  ``parallel/dryrun.py`` at the flagship widths (the data-parallel and
  member-parallel steps, the embedded steps, the 1,024-member column
  ensemble, the 2-D suite, the kernel search on phase 13's data, EKI with 64
  members, the 64^3 LES and the 96 x 96 x 32 gyre), each held to the port's
  single-device entry on the same inputs, with its collectives and its
  Thomas / Gram launches; then, on one card, the 2-D suite's block solved
  whole and as four tiles, equal bit for bit (``cut_control``);
- the studies (phase 44): ``studies/flagship_training.py`` of the port at
  full width (18 sims x 1,153 frames), ``--mode train --calibrate-mpp``
  (pretraining, L-BFGS, the first three curriculum stages at their full windows, one
  iteration each) with the Thomas launches of each stage against their
  derivation, then ``--eval-checkpoint runs/wm_flagship_fold``: the held-out
  evaluation against mPP and KPP beside the stored JAX run; and
  ``studies/adjoint_parity.py``: its dt refinement in f32 on the kernel and in
  f64 on scan;
- the studies, continued (phase 45): ``studies/forward_scaling.py`` at 1,024
  and 131,072 columns on the fused RK4 kernel (chunked launches equal to one
  launch bit for bit, both kernels' time there against their bounds),
  ``fused_kernel_sweep.py``'s every distinct route against the f32 kernel,
  ``fc_fair_substep_check.py``'s KPP and TKE baselines on the Thomas kernel
  equal to scan, and ``gp_at_scale.py --smoke`` and ``--gram-only`` with the
  Gram kernel at 8,192 x 8,192 x 96 against its plain version;
- the data files (phase 46): ``generate-les --jld2-name`` at its 32^3
  default, its ``.jld2`` equal to its npz bit for bit; ``train-nde
  --data-dir`` on a catalog name's stand-in written as a LESbrary file,
  its first loss and Thomas launches those of the stand-in's run; and a
  free-convection id's ``instantaneous_statistics_with_halos.jld2`` read
  by ``load_free_convection_suite`` to the stand-in suite. Phases 31 and 32
  write the embedded pairs (``--write-jld2``, ``--netcdf``) and read them
  back. Every file goes through the port's own HDF5 code
  (``data/hdf5.py``): every phase fails if h5py was imported.

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
SHOOT16_RUN = REPO / "runs" / "wm_les_shoot16"  # trained by the JAX package over calibrated mPP, K = 16

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
# One timed step after the warm-up: a depth cut that keeps the whole run inside its limit on a slower host.
TRAIN_TIMED_STEPS = 1
# The kernel-vs-scan loss and gradient over the window's first 144 substeps (16 saves x 9), the timed step over all
# 1,152: a depth cut (the whole window until phase 45 joined: 16.6 s on the kernel and 38.3 s on scan on a slow
# host; then 288 substeps, 13.0 s for both).
TRAIN_COMPARE_SUBSTEPS = 144

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
FAST_TIMED_STEPS = 1

# Phase 22: train-nde at full width. The curriculum of the JAX package's
# calibrated-base shooting run (runs/wm_les_shoot16, studies/
# flagship_training.py:87 without its repeated last stage), one iteration per
# stage, at the last stage's learning rate (the closure is trained already).
# Run C repeats the first two stages (the plain 200:20, 18 rows of 180
# substeps, and the first shooting stage 577:12, K = 16, 288 rows of 36
# substeps: the Thomas kernel at (3, 18, 32) and (3, 288, 32)) on a
# 577-frame suite (phase 8's first 577 frames) for NDE_C_ITERS iterations
# each, once with the kernel and once with the plain scan. Every loss is held to phase 9's STEP_LOSS_RTOL, for
# phase 9's reason: per-solve f32 differences of a few ulps through the
# substeps, and after the first loss through the backward passes (checkpoint
# recompute and transposed IFT solves) and adam steps, amplified where the
# mPP tanh switch is steep.
NDE_CURRICULUM, NDE_SHOOTING, NDE_LR = "200:20,577:12,1153:9", 16, "2e-4"
NDE_N_SAVE = 1152  # 1,153 frames (8 days of 600 s saves)
# Run C ran two iterations per stage until phase 44 joined (a depth cut: the second stage's loss still follows the
# first stage's backward pass and adam step).
NDE_C_STAGES, NDE_C_N_SAVE, NDE_C_ITERS = "200:20,577:12", 576, 1  # run C: the first two stages on 577 frames
NDE_FRACTIONS = ["--auto-balance", "--fraction-T", "0.8", "--fraction-dTdz", "0.8", "--fraction-profile", "0.5"]

# Phase 23: bench_fc_forward at the JAX benchmark's size (benchmarks.py:444 there): 1,024 physics-only
# columns x 1,152 split substeps, one Thomas launch per substep. The kernel runs the scan's sweep in its
# roundings (phase 7 counts the differing entries), so the kernel-backed trajectory must equal the
# scan-backed one exactly. Three timed runs (five until after phase 45 joined: a depth cut of 1.2 s a run).
FC_COLUMNS, FC_STEPS, FC_REPEATS = 1024, 1152, 3
FC_PROFILE_STEPS = 288  # the profiled run: its op count per substep and idle share, without 1,152 substeps of tracing
# Phase 24: train-fc-nde at full width: all nine ids, Nz = 32, 1,153 frames (8 days of 600 s saves), split
# solver with 4 substeps per save, flux pre-training, and a two-stage curriculum of 288 and 576 substeps per solve
# (depth cuts: a 2,304-substep middle stage of 577:8 ran before the evaluation phases joined, the last stage spanned
# the window, 1153:16 or 4,608 substeps, before the embedding phases joined, and was 577:16, 2,304 substeps, before
# phase 44 joined; the first stage was 145:8, 576 substeps, and the second 289:16, 1,152 substeps, until phase 45
# joined), 2 iterations per stage. Then
# the first stage again with --tridiag-backend scan: both losses must equal the kernel-backed run's, for the reason
# above.
FC_IDS, FC_N_SAVE, FC_CURRICULUM, FC_ITERS = "1,2,3,4,5,6,7,8,9", 1152, "73:8,145:16", 2
FC_ARGS = ["--nz", str(NZ), "--n-save", str(FC_N_SAVE), "--dt-save", "600", "--method", "split", "--n-substeps", "4",
           "--pretrain-epochs", "20", "--lr", "1e-3", "--maxiters", str(FC_ITERS)]

# Phases 25-29: deep ensembles, their bands and mPP calibration, every implicit solve through the Thomas
# kernel. The 4-member flagship ensemble trained by the JAX package on the 18 TRAIN_FILES (no mPP meta: the
# default base). Folded against looped step: the JAX test's limits for the same comparison
# (tests/test_deep_ensemble.py::TestMemberFold), the gradient relative to its 2-norm.
ENS_RUN = REPO / "runs" / "wm_flagship_ens4"
ENS_K, ENS_TIMED_STEPS = 4, 1  # one timed folded step (two before the KPP/TKE phases joined; depth cut, not width)
# The folded step (its warm-up and its timed step) over the first 64 of the window's 128 saves, 576 split substeps:
# a depth cut made after phase 45 joined (the whole window took 18.9 s per step on a slow host). Its launches per
# substep are still held to phase 9's.
ENS_STEP_SAVES = 64
# The member loop, and the folded-vs-loop and kernel-vs-scan comparisons, over the first 16 of the window's 128 saves
# (144 split substeps; the whole window before the KPP/TKE phases joined, then 64 saves, then 32 before phase 44
# joined: depth cuts, the widths are unchanged). Not fewer: the gradient shrinks with the window while the
# folded-vs-loop rounding gap does not, so at 8 saves the gap can pass ENS_GRAD_RTOL.
ENS_LOOP_SAVES = 16
ENS_LOSS_RTOL, ENS_GRAD_RTOL = 1e-5, 5e-4
# Phase 26: two stages, one iteration each; the second was 1153:9 (1,152 substeps) until phase 44 joined (a depth cut).
ENS_CURRICULUM = "200:20,577:12"
# Phase 27: the held-out sims of studies/flagship_training.py:58, every 9th of 1,153 frames, 9 split substeps per
# save; a band calibration fit on the first, applied to the other two (evaluate_ensemble there).
UQ_TEST_FILES = ("wind_-4.5e-4_cooling_2.5e-8", "wind_-2.5e-4_cooling_1.5e-8", "wind_-4.5e-4_heating_-2.5e-8")
UQ_STRIDE = 9
UQ_SIMS = 2  # the bands of the first two (the validation sim and one test sim): all three until phase 44 joined
# Phase 28: optimise-mpp with the JAX command's defaults (32 saves x 4 substeps; EKI: 64 parameter sets, 8
# iterations) on the 18 TRAIN_FILES; the gradient runs cut to 3 iterations (5 until phase 45 joined: a depth cut).
MPP_ITERS, MPP_N_SAVE, MPP_EKI_J, MPP_EKI_ITERS, MPP_SUBSTEPS = 3, 96, 64, 8, 4
# Phase 29: train-fc-nde --ensemble 4 at phase 24's size, its first stage alone, then fc_ensemble_uq on id 1 over
# the first quarter of the window, 2 days (every 8th of 289 frames, 4 substeps per 600 s save; the whole window
# before the KPP/TKE phases joined, then 577 frames before phase 44 joined: depth cuts, the widths are unchanged).
FC_ENS_STAGE, FC_UQ_STRIDE, FC_UQ_FRAMES = "145:8", 8, 289
# Free-convection suites generated once and shared by phases 24 and 29; wind-mixing suites shared by phases 27, 28,
# 31 and 33 (keyed as cached_suites keys them).
FC_SUITES: dict = {}
WM_SUITES: dict = {}
# Phase 30: bench_kpp / bench_tke at the JAX package's defaults (benchmarks.py:60 and :89 there): 1,024 linearly
# stratified columns x 288 steps of 600 s (a 2-day run), Nz = 32; one stacked Thomas launch per step on (3, 1024, 32)
# and (4, 1024, 32). The kernel runs the scan's sweep in its roundings, so the kernel-backed trajectory must equal
# the scan-backed one exactly.
COL_COLUMNS, COL_STEPS, COL_REPEATS = 1024, 288, 3
COL_PROFILE_STEPS = 32  # the profiled run: its op count per step and idle share, without 288 steps of tracing
# Phase 31: evaluate --embedded of runs/wm_flagship_default on the first EVAL_SIMS (phase 45's constants; all three
# until phase 45 joined) of the three held-out sims at the layout of
# runs/wm_flagship_default_eval (written by the JAX command): every 9th of the 1,152 saves (128 frames), 9 split
# substeps and 9 KPP steps (KPP's native 600 s) per save, and the host column's 10 steps per save. Until the embedding
# joined this phase evaluated runs/wm_flagship_fold without the embedded pair at the layout of
# runs/wm_flagship_fold_eval; one run of the command now serves phases 31 and 37 (a depth cut: the run of the other
# checkpoint went).
EVAL_STRIDE = 9
# The KPP trajectory against scan over its first 33 frames (288 of 1,152 KPP steps; the kernel's whole trajectory is
# still the npz's): a depth cut made after phase 45 joined (scan over all 128 frames took 13.7 s on a slow host).
EVAL_SCAN_FRAMES = 33
# Phase 32: evaluate-fc of runs/fc_flagship on its held-out ids 8 and 9 at the layout of runs/fc_flagship_eval: every
# 16th save, the command's 8 split substeps per save, KPP and TKE at 600 s (16 per save); over the first 576 of the
# 1,152 saves (36 frames, 4 days), a depth cut made when phases 41-42 joined (the whole window took 22.8 s for the
# command and 27 s for its KPP / TKE rerun on kernel and scan). The stored runs' own truth below keeps its frames.
FC_RUN, FC_EVAL = REPO / "runs" / "fc_flagship", REPO / "runs" / "fc_flagship_eval"
FC_EVAL_IDS, FC_EVAL_STRIDE, FC_EVAL_SUBSTEPS, FC_EVAL_WINDOW = (8, 9), 16, 8, 576
# The KPP and TKE trajectories against scan over their first 10 frames (144 of 560 steps; the kernel's whole
# trajectories are still the npz's): a depth cut made after phase 45 joined (scan over all 36 took 10.7 s).
FC_EVAL_SCAN_FRAMES = 10
# runs/fc_flagship and runs/fc_flagship_eval were made by the JAX commands with --source les3d (the 3-D LES at its
# full 64 x 64 x 128 box, 1,153 saves; studies/chip_session_fc.sh), far beyond this run's time; its evaluate-fc runs
# the 1-D stand-ins of the same ids. Phase 32 therefore also runs the port's profile of each stored FC run on that
# run's own truth (its sim<i>.npz frames, with each id's constants), with KPP and TKE stepped once per frame as the
# stored runs were (FC_STORED_KPP_STEPS: they predate the KPP step knob), and holds each member's mean loss to the
# stored run's within FC_STORED_RTOL: the largest gap a CPU run of the port showed, with a small margin. The CPU run
# (PERF.md section 6) gave runs/fc_flagship nde -1.51 % (the NDE's first-frame transient, ROADMAP.md queue 3),
# tke +0.20 %, kpp -0.01 %; runs/fc_les3d and runs/fc_les3d_conv (144 frames every 4,800 s) tke -0.66 %, kpp -0.12 %,
# nde -0.001 %. It was 0.15 while KPP and TKE ran at 16 steps per frame. tests/test_torch_fc_cli.py holds the two
# commands to each other on that truth in float64.
FC_STORED_KPP_STEPS = 1
FC_STORED_RTOL = 0.02
FC_STORED_RUNS = (
    (FC_RUN, FC_EVAL),
    (REPO / "runs" / "fc_les3d", REPO / "runs" / "fc_les3d_eval"),
    (REPO / "runs" / "fc_les3d_conv", REPO / "runs" / "fc_les3d_conv_eval"),
)
# Phase 33: calibrate-kpp with the JAX command's defaults on the 18 TRAIN_FILES: 96 saves generated, the first 32
# fitted (31 KPP steps of 600 s per solve); 64 plugin draws, 20 line-search or adam iterations; EKI 64 members x 8.
KPP_N_SAVE, KPP_TRAIN_STEPS, KPP_PLUGIN, KPP_REFINE, KPP_EKI_J, KPP_EKI_ITERS = 96, 32, 64, 20, 64, 8
KPP_LADDER = 12  # random_line_search's n_steps
# The population's loss is a mean over (P, n) rows, the single loss over one (n,) vector: on the card the two
# reductions may round differently, so the adopted loss is held to the plugin's best within a few f32 ulps.
KPP_LOSS_SLACK = 1e-6
# Phase 34: the blocked f64 GP fit at the size that motivates the JAX module (ops/blocked_gp.py there), squared
# exponential at gamma = sqrt(D) (K is not the identity), 33 random targets, against the unblocked fit.
BGP_N, BGP_D, BGP_BLOCK, BGP_RTOL = 16384, 96, 4096, 1e-8
# Phase 35: the embedded wind-mixing host column (embed/column_model.py) over 1,024 columns with the flagship MLPs,
# baseline and +NN, 64 saves x 10 host steps of 60 s (128 saves until after phase 45 joined: a depth cut, 10.0 s per
# paired run on a slow host): one stacked Thomas launch on (3, 1024, 32) per host step. Here
# the momentum diffusing down from the surface decays into the subnormal range (below 2^-126) in the deep levels. The
# kernel's quotients fall back to IEEE division wherever its fast path is not exact (csrc/thomas.cu, quotient), so
# over the first HOST_CHECK_SAVES saves the kernel-backed pair must equal the scan-backed one in every entry (the
# subnormal entries are counted and printed); the scan pair is the slow side, so the whole run is timed on the kernel
# only.
HOST_COLUMNS, HOST_SAVES, HOST_SUBSTEPS, HOST_CHECK_SAVES, HOST_PROFILE_SAVES = 1024, 64, 10, 8, 2
# Phase 36 (its second stage 8,32 until phase 44 joined: a depth cut): train-embedded from runs/wm_flagship_fold on
# the 18 TRAIN_FILES (phase 8's suite) and train-embedded-fc
# from runs/fc_flagship on the nine stand-in ids (phase 24's suite), two iterations per stage, 10 host steps per save;
# the first stage again on scan, its losses held to phase 9's STEP_LOSS_RTOL (per-solve f32 differences through the
# host steps, the checkpoint recompute and the transposed IFT solves).
EMB_CURRICULUM, EMB_FC_CURRICULUM, EMB_ITERS, EMB_SUBSTEPS, EMB_LR = "8,16", "17", 2, 10, "2e-4"
# Phase 37: the embedded pairs of phases 31 and 32 (evaluate --embedded of runs/wm_flagship_default,
# evaluate-fc --embedded of runs/fc_flagship), beside the stored JAX run runs/wm_flagship_default_eval.
EMBEDDED_RUN, EMBEDDED_EVAL = REPO / "runs" / "wm_flagship_default", REPO / "runs" / "wm_flagship_default_eval"
EMBEDDED_SUBSTEPS = 10  # eval/profile.py's embedded_substeps default, which the commands use
# Phase 38: bench_double_gyre at the JAX defaults (96 x 96 x 32, WENO5, 32 steps of 1,800 s, the FC MLP), three
# Thomas launches per step on (96, 96, 32), (96, 97, 32) and (97, 96, 32); then the double-gyre command for 5 days
# (10 until phase 45 joined: a depth cut).
GYRE_N, GYRE_NZ, GYRE_STEPS, GYRE_REPEATS, GYRE_PROFILE_STEPS, GYRE_DAYS = 96, 32, 32, 3, 8, 5
GYRE_SHAPES = {(GYRE_N, GYRE_N, GYRE_NZ), (GYRE_N, GYRE_N + 1, GYRE_NZ), (GYRE_N + 1, GYRE_N, GYRE_NZ)}
# The JAX test's volume bound (tests/test_embed.py::TestDoubleGyre::test_volume_conserved): |mean eta| per frame.
GYRE_VOLUME_ATOL = 1e-6
# Phase 39: the 3-D LES (data/les.py). Each pressure solve is one Thomas launch on 2 Ny (Nx // 2 + 1) systems of Nz
# levels (the real and imaginary parts of every horizontal mode): 1,088 x 32 at generate-les's default 32^3 box,
# 4,224 x 64 at bench_les's 64^3, 4,224 x 128 for the les3d sources' 64 x 64 x 128 (LES_THOMAS_SHAPES, timed in
# phase 10). (a) bench_les at the JAX defaults: 64^3, 100 Euler steps per run, 3 timed runs, a profiled run of
# LES_PROFILE_STEPS steps. (b) LES_EULER_STEPS Euler steps, then LES_RK3_STEPS RK3 steps, at 64^3 from bench_les's
# state, kernel-backed and scan-backed side by side: every field equal after every step (the kernel equals the scan
# to the last bit, and both runs make the same other calls), and after every step max |div u| below LES_DIV_LIMIT:
# a CPU f32 run of the same steps gave at most 4.47e-7 1/s (u up to 0.024 m/s, dx = 8 m), the limit is
# 4.5 times that. (c) generate-les in-process at its defaults (32^3, RK3 at dt = 24 s, 25 steps per 600 s save)
# with --n-save cut to LES_GEN_N_SAVE (48 by default; a depth cut). Its heat budget: the LES's diffusion is
# kappa * Laplacian(T) with kappa varying (non-conservative form, as in the JAX package, which the port equals to
# 1e-13 in tests/test_torch_les.py), so under the wind's eddy diffusivity at the top cell the column loses far more
# heat than the surface flux takes: the CPU f32 run of the same command lost LES_HEAT_RATIO_CPU = 10.70 times
# the surface and bottom fluxes' heat over 4 saves (-0.3953 K m against -0.03695 K m), and the card 10.690 at the same
# 4 saves (14.13 and 14.127 over 8 saves). The phase holds the ratio within LES_HEAT_RATIO_RTOL = 3 % of
# LES_HEAT_RATIO_CPU, a band that a doubled or halved flux or eddy diffusivity leaves. (d) the free-convection les3d
# source, id 1, at its full 64 x 64 x 128 box (RK3 at dt = 12 s, 50 steps per save) with n_save cut to LES_FC_N_SAVE
# (a depth cut), through a cache directory: a second load reads the cache, equal, with no launch. The cuts of (a), (c)
# and (d) (a profile of 5 steps, not 10; 4 saves, not 8; 1 save, not 2) came after a clean-tree smoke took 1,102 s on
# a slow host.
LES_THOMAS_SHAPES = ((2 * 32 * 17, 32), (2 * 64 * 33, 64), (2 * 64 * 33, 128))
# Phase 10 times those shapes over 10 calls per backend, not 50: the plain backends and the densified library solve
# at 128 levels take 19 s over 50 (a depth cut that keeps the smoke near 900 s). Since phases 41-42 joined, the
# five shapes of phases 30, 33 and 38 are timed over 10 calls too (they took 4.1-5.2 s each over 50), and since
# phase 45 joined every other shape of thomas_bench_record (phases 23, 25 and 28: 4.8-7.5 s each over 50).
LES_BENCH_REPEATS = 10
LES_N, LES_NZ, LES_STEPS, LES_REPEATS, LES_PROFILE_STEPS = 64, 64, 100, 3, 5
LES_EULER_STEPS, LES_RK3_STEPS, LES_DIV_LIMIT = 20, 4, 2e-6
LES_GEN_N_SAVE, LES_HEAT_RATIO_CPU, LES_HEAT_RATIO_RTOL = 4, 10.70, 0.03
LES_FC_N_SAVE = 1
# Phase 46: the data files. (a) generate-les --jld2-name DATA_NAME (the default run's forcing: Qu = -5e-4, Qb = 3e-8,
# f = 1e-4, constant) at its 32^3 default with DATA_GEN_N_SAVE saves: the .jld2 read back equals the run's
# les_profiles.npz bit for bit in u, v, T, the fluxes and t; the boundary constants too, theta_top within DATA_ULPS
# f32 ulps (the file keeps the buoyancy flux theta alpha g, the reader divides by alpha g in f64, as JAX's does; for
# f32 inputs that rounds back exactly, the bound allows one ulp). (b) DATA_NAME's stand-in (DATA_N_SAVE saves at 128
# levels) written with write_les_profiles under its lesbrary_relative_path, then train-nde --data-dir, one stage
# DATA_CURRICULUM and one iteration, against the same run on the stand-in: the suites are equal bit for bit (f32 through
# the file), so the first loss is held to DATA_LOSS_RTOL and the Thomas launches are equal. (c) free-convection id
# DATA_FC_ID's stand-in written with write_fc_fieldset, loaded by load_free_convection_suite(data_dir=...): equal to
# the stand-in suite after coarsening in every field the layout carries (all but f and beta, which it does not record).
DATA_NAME, DATA_GEN_N_SAVE, DATA_ULPS = "wind_-5e-4_cooling_3e-8_new", 8, 1
DATA_N_SAVE, DATA_CURRICULUM, DATA_LOSS_RTOL, DATA_FC_ID = 96, "97:4", 1e-6, 1
# Phase 40: the column ensemble on one card: bench_column_ensemble at the JAX defaults (1,024 members, Nz = 32, one
# save of 256 split substeps: one Thomas launch per substep on (3, 1024, 32)), the same solve kernel-backed and
# scan-backed (equal), and the ensemble command at its defaults (256 members, 32 frames, 4 substeps per save) with the
# flagship closure on phase 8's 18-sim suite (it perturbs the first sim).
ENSEMBLE_MEMBERS, ENSEMBLE_STEPS, ENSEMBLE_REPEATS = 1024, 256, 3
# Phase 43: the data-parallel step's window cut in depth to 144 substeps (16 saves x 9; 288 until phase 44 joined),
# the member-parallel step's to 36 (4 saves x 9, its four members one solve each); the embedded steps over 4 saves x
# 10 host steps; EKI over the KPP forward map of the first 8 saves; the kernel search on phase 13's data.
PAR_SUBSTEPS, PAR_ENS_SUBSTEPS, PAR_EMB_FRAMES, PAR_EKI_FRAMES = 144, 36, 5, 9
PAR_SUITE_MEMBERS, PAR_SUITE_SUBSTEPS, PAR_GYRE_STEPS = 64, 16, 6
PAR_EKI_MEMBERS, PAR_EKI_ITERS, PAR_GP_VAL, PAR_GP_KERNELS = 64, 2, 256, (1, 2, 3, 4)
# The CPU tests' tolerances (tests/test_torch_parallel.py, test_torch_parallel_fields.py).
PAR_TOLERANCES = {
    "nde_step": {"rtol": 1e-4, "atol": 1e-7}, "embedded_step": {"rtol": 1e-4, "atol": 1e-7},
    "embedded_fc_step": {"rtol": 1e-4, "atol": 1e-7}, "deep_ensemble_step": {"rtol": 1e-6, "atol": 0.0},
    "ensemble_solver": {"rtol": 1e-5, "atol": 1e-7}, "suite_ensemble_solver": {"rtol": 1e-5, "atol": 1e-7},
    "kernel_search": {"rtol": 0.0, "atol": 0.0}, "eki": {"rtol": 1e-5, "atol": 1e-5},
    "les": {"rtol": 2e-5, "atol": 1e-7}, "gyre": {"rtol": 2e-4, "atol": 1e-6},
}
# The kernels each path must launch.
PAR_KERNELS = {name: ("thomas",) for name in PAR_TOLERANCES} | {"kernel_search": ("gram",)}
# Phase 41: benchmark --suite --quick, its twelve rows (the JAX run_suite's keys) and the time each is checked by;
# phase 42: the training report's window (frames 0, 9, 18, 27: 4 frames, 3 save intervals of 5,400 s) and its
# substeps per save interval (300 s, the JAX report test's step).
SUITE_KEYS = ("kpp_2day_columns", "tke_2day_columns", "gp_build", "gp_build_pallas", "gp_ml2_step",
              "fc_conv_adj_forward", "nde_forward", "nde_train_step", "double_gyre_nn", "column_ensemble", "les_3d",
              "tridiagonal")
SUITE_TIME_KEYS = {"tridiagonal": "cuda_graph_ms"}
# The report's window was 64 frames (8 saved frames) until phase 44 joined (a depth cut).
REPORT_WINDOW, REPORT_SUBSTEPS = 28, 18
# Phase 44: the flagship study (climateparameterizations_jl_tpu_torch/studies/flagship_training.py) at full width:
# the 18 TRAIN_FILES x 1,153 frames (phase 8's suite), Nz = 32, the 96 -> 50 -> 20 -> 31 mish MLPs, every implicit
# solve on the Thomas kernel. (a) --mode train --calibrate-mpp: pretraining at the study's 150 epochs, L-BFGS cut to
# FLAG_LBFGS_ITERS iteration (60 in the study; one iteration evaluates the loss at the start and along its line
# search, and the best evaluated point is the start), the four STAGES at their full windows and strides with
# FLAG_ITERS iteration each (150 / 100 / 130 / 200 in the study), then the held-out evaluation on the first
# FLAG_HELD_OUT of the three held-out sims ((b) runs the same evaluate on all three). Thomas launches per stage: the
# loss-scaling pre-solve (one per substep) and 3 per substep per iteration (forward, checkpoint recompute, transposed
# IFT solve); per L-BFGS loss evaluation 3 per substep (no pre-solve: the calibration has fixed channel weights); per
# held-out sim 3 x 1,152 (NDE, mPP alone, KPP at 600 s) + 128 (KPP at the save spacing, kpp_ref_dt). (b)
# --eval-checkpoint runs/wm_flagship_fold on the first FLAG_EVAL_HELD_OUT held-out sims (all three until phase 45
# joined), beside the stored docs/flagship_run_fold.json
# (made by the JAX script on a TPU): the gaps are printed, and any above FLAG_STORED_NOTE with the reason below.
# (c) The adjoint-parity study: dt_refinement on its stiff column (AP_FRAMES saves, the ladder AP_SUBSTEPS against
# AP_FINE substeps), f32 on the kernel and f64 on scan, each ladder's split gradient error falling monotonically as
# the JAX test requires, and on the kernel every split solve launched (scan: none). The f32 solves' distance from f64
# over the whole flagship window (studies/adjoint_parity.py --problem flagship: the kernel, scan and pcr) is measured
# outside the smoke (PERF.md section 6). Depth cuts made when the phase joined, after its first runs took 194.8 and
# 131.7 s: L-BFGS 1 iteration (2), no held-out sim in (a) (3, then 1), the stiff column over 4 saves with the
# ladder (1, 4, 8) against 16 substeps (12 saves, (1, 4, 16) against 64 in the JAX test; 6 and 32 first), and the
# precision gap over two flagship sims moved out of the smoke.
FLAG_ITERS, FLAG_LBFGS_ITERS, FLAG_PRETRAIN_EPOCHS, FLAG_HELD_OUT = 1, 1, 150, 0
# The first two of the four STAGES, the 200- and 577-frame windows: the fourth repeats the third's window and stride
# at another learning rate, and the third spans the whole window as phase 9's step does (depth cuts made after phase
# 45 joined: they took 19.1 s and 13.9 s on slow hosts).
FLAG_STAGES = 2
FLAG_RUN_JSON = REPO / "docs" / "flagship_run_fold.json"
FLAG_STORED_NOTE = 0.01
AP_FRAMES, AP_SUBSTEPS, AP_FINE = 4, (1, 4, 8), 16
# Phase 45: the other four studies of climateparameterizations_jl_tpu_torch/studies/. (a) forward_scaling on the f32
# kernel at 1,024 and 131,072 columns x 1,024 steps (one timed run each after its warm-up: 2 launches per size), then
# at 131,072 columns with the flagship MLPs one launch against --chunk-columns 32,768 (4 launches), equal bit for bit,
# and the run's last 1,024 columns (its highest CTA indices) against the plain version. (b) fused_kernel_sweep at 1,024
# x 64 with the flagship MLPs, one timed call per distinct route (three calls each: the state, the first call, one
# timed; the JAX no-op variants are aliases and not run), each held to the f32 kernel (bf16 to the JAX bf16 limit of
# phase 18). (c) fc_fair_substep_check's baselines
# on sim 8's first 49 frames of runs/fc_les3d_eval at 1 and 8 substeps in f32 (T shifted by its initial column mean,
# as the study runs it): 48 + 384 KPP and as many TKE steps, each one launch, equal on kernel and scan. (d)
# gp_at_scale --smoke on phase 8's suite and the held-out sims of phase 27, then --gram-only at n = 8,192 (its gamma = 1
# leaves K the identity in f32: timing only), and one 8,192 x 8,192 x 96 training Gram at gamma^2 = median(d^2) / 2,
# kernel against plain at phase 11's limits, and timed there. Paid for by depth cuts: phase 31 on the
# first EVAL_SIMS held-out sim (three before) and phase 44 (b) on the first FLAG_EVAL_HELD_OUT (three before); the
# first clean-tree smoke with phase 45 and two sims in each took 1,080.6 s on a slow host, so both went to one; after
# it reached 1,108.1 s, phases 9, 24, 28, 31, 32, 38 and 44 were cut in depth too (each named beside its constant).
STUDY_COLUMNS, STUDY_CHUNK, STUDY_TAIL = (1024, 131072), 32768, 1024
SWEEP_COLUMNS, SWEEP_STEPS = 1024, 64
FAIR_FRAMES, FAIR_SIM = 49, 8
GRAM_AB_N = 8192
EVAL_SIMS, FLAG_EVAL_HELD_OUT = 1, 1


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


@contextmanager
def phase(name: str):
    log(f"begin {name}")
    t = time.perf_counter()
    try:
        yield
        if "h5py" in sys.modules:  # the card's machine has none: the port reads and writes HDF5 with its own code
            raise RuntimeError(f"phase {name.split()[0]}: h5py was imported")
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


def timed_calls(module, name: str, seconds: list):
    """Replace ``module.<name>`` by a wrapper that appends each call's seconds to ``seconds``; returns the original."""
    original = getattr(module, name)

    def wrapper(*args, **kw):
        t = time.perf_counter()
        out = original(*args, **kw)
        seconds.append(time.perf_counter() - t)
        return out

    setattr(module, name, wrapper)
    return original


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (numpy arrays or CPU tensors)."""
    import numpy as np

    a, b = (np.asarray(x.numpy() if hasattr(x, "numpy") else x) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


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
        gram_grid = gram_k.grid(GP_N, GP_N, dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        gram_ptxas = ptxas_summary(gram_k.ptxas_report)
        log(f"gram: {glib.gram_tile_rows()} x {glib.gram_tile_cols()} output tiles, {glib.gram_threads_per_block()} "
            f"threads and {glib.gram_smem_bytes()} B of dynamic shared memory per CTA; at {GP_N} x {GP_N} a grid of "
            f"{gram_grid} CTAs on {sms} SMs; ptxas: {gram_ptxas}")
        if any(r["spill_store_bytes"] for r in gram_ptxas):
            raise RuntimeError("gram.cu spills registers")
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
                        if B is A:
                            # The kernel sums the product and the norms in one order: d2 = 0, K_ii = sigma.
                            exact = int((got.diagonal() == hyp[1]).sum())
                            log(f"  diagonal entries equal to sigma exactly: {exact} of {M}")
                            if exact != M:
                                raise RuntimeError(f"gram {key}: the training Gram's diagonal is not exact")

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
                + f"; cuda is gram_kernel alone, beside it {r['cuda_other_ops']:g} other device ops per call "
                f"({r['cuda_other_ms'] * 1e3:.2f} us); kernel vs plain max abs off the coincident pairs "
                f"{r['max_abs_err_vs_plain']:.3e}")
        g = gbench["squared_exponential"]
        g_ops, g_bytes = g["flops"] / PEAK_F32_FLOPS * 1e3, g["bytes"] / PEAK_BYTES_PER_S * 1e3
        g_bound, g_bound_by = (g_ops, "operations") if g_ops >= g_bytes else (g_bytes, "bytes")
        log(f"gram bound: {g['flops']:.4e} flop / 67 TFLOP/s = {g_ops * 1e3:.3f} us; {g['bytes']} B / 3.35 TB/s = "
            f"{g_bytes * 1e3:.3f} us; share of bound reached by the kernel's own time = {g_bound / g['cuda_ms']:.3f}")
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
        "other_device_ops_per_call": g["cuda_other_ops"],
        "share_of_bound": g_bound / g["cuda_ms"],
        "grid": gram_grid,
        "matern12_ms": gbench["matern12"]["cuda_ms"],
        "shape": {"M": GP_N, "N": GP_N, "D": GP_D, "family": "squared_exponential"},
        "bench_gp_ms": {"cuda": gp["ms"], "plain": plain_gp["ms"]},
        "ml2_step_ms": {"cuda": ml2["ms"], "plain": plain_ml2["ms"]},
        "gp_closure_de_s": {"cuda": de_s, "plain": de_plain_s},
        "gp_closure_de_profile": {"stages": 2 * DE_SUBSTEPS * 4, "wall_ms": de_prof_wall, "device_busy_ms": de_busy,
                                  "device_idle_share": 1.0 - de_busy / de_prof_wall, "device_ops": de_ops,
                                  "device_ops_per_stage": de_ops / (2 * DE_SUBSTEPS * 4)},
        "train_gp_cli_s": cli_s,
        "ptxas": gram_ptxas,
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
        F = 3 * NZ
        mm_flops, ew_flops = benchmarks.fused_rk4_flops(FULL_COLUMNS, BENCH_STEPS, NZ, h1, h2)
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


def curriculum_thomas_launches(spec: str, n_frames: int, shooting: int, maxiters: int) -> tuple[int, list]:
    """Thomas launches of a train-nde run, from its curriculum alone.

    Per stage ``w:s`` the save ladder is ``arange(0, min(w, n_frames), s)``;
    a stage whose interval count K divides runs K windows of ``intervals / K``
    saves; each save interval takes ``s`` substeps. The loss-scaling
    pre-solve launches once per substep, each iteration three times (forward,
    checkpoint recompute, transposed IFT solve). Returns the total and
    ``(rows per sim, substeps per solve)`` per stage.
    """
    total, stages = 0, []
    for item in spec.split(","):
        w, _, s = item.partition(":")
        stride = int(s or 1)
        points = len(range(0, min(int(w), n_frames), stride))
        k = shooting if shooting and points > shooting and (points - 1) % shooting == 0 else 1
        substeps = (points - 1) // k * stride
        total += substeps + 3 * substeps * maxiters
        stages.append((k, substeps))
    return total, stages


def train_nde_phase(dev, setup, k0_step: dict, smi: str) -> dict:
    """Phase 22: the train-nde command on the card (runs A, B, C, extract) and the K = 16 step."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri
    from climateparameterizations_jl_tpu_torch.train import checkpoint as ck
    from climateparameterizations_jl_tpu_torch.train import nde

    with open(SHOOT16_RUN / "meta.json") as f:
        calibrated = json.load(f)["mpp"]
    record = {}
    with phase(f"22 train-nde CLI on the card at full width: {len(benchmarks.TRAIN_FILES)} sims, curriculum "
               f"{NDE_CURRICULUM}, --shooting {NDE_SHOOTING}, calibrated mPP of {SHOOT16_RUN.name}"), \
            tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        mpp_json = tmp / "mpp_parameters.json"
        mpp_json.write_text(json.dumps(calibrated))
        timings = []
        originals = (cli._load_suite, nde._train_loop, nde.determine_loss_scalings, tri._thomas_cuda)
        solved = []  # (dl, d, du, b, x) of every kernel solve in run C, forward and transposed

        def recording(*args):
            x = originals[3](*args)
            solved.append(tuple(a.detach().clone() for a in (*args, x)))
            return x

        def timed(kind, fn):
            def wrapper(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                entry = {"kind": kind, "s": time.perf_counter() - t}
                if kind == "presolve":
                    batch, config = args[2], args[3]
                    entry.update(rows=batch.x0.shape[0], substeps=(batch.t.shape[0] - 1) * config.n_substeps)
                if kind == "train_loop":
                    entry["iterations"] = args[3]
                timings.append(entry)
                return out
            return wrapper

        def run(label, argv, n_frames, spec, maxiters=1):
            """One train-nde run with the launch counts set to 0 just before it and read just after."""
            timings.clear()
            expected, stages = curriculum_thomas_launches(spec, n_frames, NDE_SHOOTING if "--shooting" in argv else 0,
                                                          maxiters)
            _cuda.reset_launch_counts()
            rc = cli.main(argv)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            if rc != 0:
                raise RuntimeError(f"train-nde run {label} exited {rc}")
            gen = [e["s"] for e in timings if e["kind"] == "suite"]
            pre = [e for e in timings if e["kind"] == "presolve"]
            loops = [e for e in timings if e["kind"] == "train_loop"]
            log(f"run {label}: suite generation {gen[0]:.2f}s; per stage (rows, substeps per solve, pre-solve ms, "
                f"wall ms per iteration): " + "; ".join(
                    f"{p['rows']} x {p['substeps']}, {p['s'] * 1e3:.1f}, {lp['s'] * 1e3 / lp['iterations']:.1f}"
                    for p, lp in zip(pre, loops)))
            log(f"run {label}: launch counts {launches}; expected thomas launches {expected} from the curriculum "
                f"(K and substeps per stage {stages})")
            rows = [(p["rows"], p["substeps"]) for p in pre]
            want_rows = [(len(benchmarks.TRAIN_FILES) * k, sub) for k, sub in stages]
            if rows != want_rows:
                raise RuntimeError(f"run {label}: stage batches {rows}, expected {want_rows}")
            return launches, expected, {"suite_s": gen[0], "stages": [
                {"rows": p["rows"], "substeps": p["substeps"], "presolve_ms": p["s"] * 1e3,
                 "ms_per_iteration": lp["s"] * 1e3 / lp["iterations"]} for p, lp in zip(pre, loops)]}

        def history(out):
            with open(out / "history.jsonl") as f:
                return [json.loads(line) for line in f]

        def count(out):
            with np.load(out / "train_state" / "state.npz") as data:
                return int(data["['opt_state']/[0]/.count"])

        sims = ",".join(benchmarks.TRAIN_FILES)
        full = ["train-nde", "--sims", sims, "--nz", str(NZ), "--n-save", str(NDE_N_SAVE), "--dt-save", "600",
                "--n-substeps", "1", "--method", "split", "--lr", NDE_LR, "--maxiters", "1", *NDE_FRACTIONS]
        # Phase 8's suite, and its first 577 frames for run C (equal to a 577-frame generation, bit for bit).
        names = tuple(benchmarks.TRAIN_FILES)
        cli._load_suite = timed("suite", cached_suites(cli, {
            (names, NZ, None, NDE_N_SAVE, 600.0, 128): setup["ds"],
            (names, NZ, None, NDE_C_N_SAVE, 600.0, 128): _first_frames(setup["ds"], NDE_C_N_SAVE + 1, dev)}))
        nde._train_loop = timed("train_loop", nde._train_loop)
        nde.determine_loss_scalings = timed("presolve", nde.determine_loss_scalings)
        try:
            out_a = tmp / "a"
            launches, expected, record["run_a"] = run(
                "A", [*full, "--curriculum", NDE_CURRICULUM, "--shooting", str(NDE_SHOOTING),
                      "--init-from", str(SHOOT16_RUN), "--mpp-params", str(mpp_json), "--output", str(out_a)],
                NDE_N_SAVE + 1, NDE_CURRICULUM)
            hist_a = history(out_a)
            meta_a = json.loads((out_a / "meta.json").read_text())
            nns, _ = cli._load_nns(str(out_a), dev)
            finite = all(bool(torch.isfinite(p).all()) for p in nde.nn_parameters(nns))
            log(f"run A: losses {[h['loss'] for h in hist_a]}; meta mpp {meta_a['mpp']}; adam count "
                f"{count(out_a)}; reloaded MLPs finite {finite}")
            if launches["thomas"] != expected or expected == 0:
                raise RuntimeError(f"run A: thomas counted {launches['thomas']} launches, expected {expected}")
            if len(hist_a) != 3 or not all(math.isfinite(h["loss"]) for h in hist_a):
                raise RuntimeError(f"run A: history.jsonl holds {hist_a}")
            if meta_a["mpp"] != calibrated:
                raise RuntimeError(f"run A: meta.json mpp {meta_a['mpp']} is not {calibrated}")
            if not finite or count(out_a) != 3:
                raise RuntimeError("run A: the saved MLPs are not finite or adam's count is not 3")
            record["run_a"].update(launches=launches["thomas"], expected=expected, losses=[h["loss"] for h in hist_a])

            out_b = tmp / "b"
            launches, expected, record["run_b"] = run(
                "B", [*full, "--curriculum", "1153:9", "--shooting", str(NDE_SHOOTING), "--init-from", str(out_a),
                      "--resume-from", str(out_a), "--mpp-params", str(mpp_json), "--output", str(out_b)],
                NDE_N_SAVE + 1, "1153:9")
            hist_b = history(out_b)
            meta_b = json.loads((out_b / "meta.json").read_text())
            log(f"run B (resumed from A): loss {hist_b[0]['loss']}, adam count {count(out_b)}, meta mpp equals the "
                f"json: {meta_b['mpp'] == calibrated}")
            if (count(out_b) != 4 or len(hist_b) != 1 or not math.isfinite(hist_b[0]["loss"])
                    or meta_b["mpp"] != calibrated or launches["thomas"] != expected):
                raise RuntimeError(f"run B: count {count(out_b)}, history {hist_b}, launches {launches['thomas']} "
                                   f"(expected {expected})")
            record["run_b"].update(launches=launches["thomas"], expected=expected, loss=hist_b[0]["loss"])

            losses_c = {}
            stage_c = ["train-nde", "--sims", sims, "--nz", str(NZ), "--n-save", str(NDE_C_N_SAVE), "--dt-save",
                       "600", "--n-substeps", "1", "--method", "split", "--lr", NDE_LR, "--maxiters",
                       str(NDE_C_ITERS), *NDE_FRACTIONS, "--curriculum", NDE_C_STAGES, "--shooting", str(NDE_SHOOTING),
                       "--init-from", str(SHOOT16_RUN), "--mpp-params", str(mpp_json)]
            for backend in ("cuda", "scan"):
                out_c = tmp / f"c_{backend}"
                tri._thomas_cuda = recording if backend == "cuda" else originals[3]
                launches, expected, record[f"run_c_{backend}"] = run(
                    f"C ({backend}, {NDE_C_N_SAVE + 1}-frame suite)",
                    [*stage_c, "--tridiag-backend", backend, "--output", str(out_c)], NDE_C_N_SAVE + 1, NDE_C_STAGES,
                    maxiters=NDE_C_ITERS)
                tri._thomas_cuda = originals[3]
                if backend == "cuda":
                    kernel_launches = launches["thomas"]
                losses_c[backend] = [h["loss"] for h in history(out_c)]
                want = expected if backend == "cuda" else 0
                if launches["thomas"] != want:
                    raise RuntimeError(f"run C ({backend}): thomas counted {launches['thomas']}, expected {want}")
            rels = [abs(got - want) / abs(want) for got, want in zip(losses_c["cuda"], losses_c["scan"])]
            log(f"run C: losses with the kernel {losses_c['cuda']!r}, with scan {losses_c['scan']!r}, rel "
                f"{[f'{r:.3e}' for r in rels]} (limit {STEP_LOSS_RTOL}; reason: per-solve f32 differences through "
                f"the substeps, and after the first loss through the backward passes and adam steps, amplified "
                f"by the mPP tanh switch)")
            n_losses = len(NDE_C_STAGES.split(",")) * NDE_C_ITERS
            if len(rels) != n_losses or not all(r <= STEP_LOSS_RTOL for r in rels):
                raise RuntimeError("run C: kernel-backed and scan-backed losses disagree")
            record["run_c_loss_rel"] = rels
            # Every system the kernel solved in run C (the loss-scaling pre-solve, the forward and checkpoint
            # recompute solves and the transposed IFT solves), against _thomas_scan on the same inputs.
            shapes = sorted({tuple(c[3].shape) for c in solved})
            n = solved[0][3].shape[-1]
            dl, d, du, b, x = (torch.cat([c[i].reshape(-1, n) for c in solved]) for i in range(5))
            log(f"run C: {len(solved)} kernel solves recorded (thomas counted {kernel_launches}), shapes {shapes}")
            if len(solved) != kernel_launches:
                raise RuntimeError("run C: the recorded solves are not the kernel's launches")
            want = tri._thomas_scan(dl, d, du, b)
            record["run_c_kernel_vs_plain"] = {"solves": len(solved), "shapes": shapes, "max_abs_err": compare(
                f"thomas on run C's {len(solved)} solves vs _thomas_scan", x, want, rtol=THOMAS_RTOL,
                atol=THOMAS_ATOL)}
            log(f"  entries that differ from _thomas_scan at all: {int((x != want).sum())} of {x.numel()}")
            solved.clear()
        finally:
            cli._load_suite, nde._train_loop, nde.determine_loss_scalings, tri._thomas_cuda = originals

        if cli.main(["extract", str(out_a), str(tmp / "extracted")]) != 0:
            raise RuntimeError("extract exited non-zero")
        losses = ck.load_extracted_losses(str(tmp / "extracted"))
        log(f"extract: losses.npz {{{', '.join(f'{k}: {v.shape}' for k, v in sorted(losses.items()))}}}")
        if not losses or any(v.shape != (3,) for v in losses.values()):
            raise RuntimeError("losses.npz does not hold 3 entries per channel")

        k16 = benchmarks.bench_train_step(setup, n_timed=TRAIN_TIMED_STEPS, device=dev, shooting=NDE_SHOOTING)
        log(f"flagship step with --shooting {NDE_SHOOTING} ({k16['sims']} rows x {k16['substeps']} substeps): ms "
            f"per step median {k16['ms_median']:.1f} all={[round(t, 1) for t in k16['ms']]}; K = 0 step (phase 9, "
            f"{k0_step['sims']} rows x {k0_step['substeps']} substeps) median {k0_step['ms_median']:.1f} "
            f"(information only)")
        log(f"card: {smi}")
        record["shooting_step_ms"] = k16["ms"]
        record["k0_step_ms"] = k0_step["ms"]
    return record


def fc_forward_phase(dev, smi: str) -> dict:
    """Phase 23: bench_fc_forward at full width, the kernel-backed run against the scan-backed one."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.ops import _cuda

    with phase(f"23 bench_fc_forward ({FC_COLUMNS} columns x {FC_STEPS} split substeps, Nz = {NZ}): the free-"
               f"convection forward run on the Thomas kernel"):
        _cuda.reset_launch_counts()
        stats = benchmarks.bench_fc_forward(FC_COLUMNS, NZ, FC_STEPS, FC_REPEATS, device=dev)
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        expected = FC_STEPS * stats["calls"]
        log(f"backend {stats['tridiag_backend']}: ms per run min={stats['ms_min']:.2f} median={stats['ms_median']:.2f} "
            f"max={stats['ms_max']:.2f} all={[round(t, 2) for t in stats['ms']]}; column-timesteps/s (median) = "
            f"{stats['column_timesteps_per_sec']:.4e}")
        log(f"launch counts: {launches}; expected thomas launches {expected} = {FC_STEPS} per run x {stats['calls']} "
            f"runs (warm-up included)")
        if stats["tridiag_backend"] != "cuda":
            raise RuntimeError(f"tridiag_backend='auto' resolved to {stats['tridiag_backend']!r} on the card")
        if launches["thomas"] != expected or any(v for k, v in launches.items() if k != "thomas"):
            raise RuntimeError(f"bench_fc_forward counted {launches}, expected {expected} thomas launches only")

        # These launches come after the counts were read.
        model, T0 = benchmarks.fc_forward_setup(FC_COLUMNS, NZ, FC_STEPS, dev)
        got = benchmarks.fc_forward(model, T0, FC_STEPS, "cuda")
        scan_ms, want = cuda_ms(lambda: benchmarks.fc_forward(model, T0, FC_STEPS, "scan"))
        T_end = model.T_scaling.unscale(got[-1])
        cooled = float(model.T_scaling.unscale(T0)[0, -1] - T_end[0, -1])
        log(f"kernel vs scan trajectory: torch.equal {torch.equal(got, want)}, entries that differ "
            f"{int((got != want).sum())} of {got.numel()}, max abs {float((got - want).abs().max()):.3e}; the scan-backed "
            f"run took {scan_ms:.1f} ms (information); surface cell cooled by {cooled:.4f} K, columns identical "
            f"{bool((T_end == T_end[:1]).all())}")
        if not (torch.equal(got, want) and bool(torch.isfinite(got).all()) and cooled > 0.0
                and bool((T_end == T_end[:1]).all())):
            raise RuntimeError("the kernel-backed free-convection run is not the scan-backed one, or not physical")

        prof = benchmarks.profile_fc_forward(FC_COLUMNS, NZ, FC_PROFILE_STEPS, device=dev)
        log(f"profiled run (torch.profiler): wall {prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.2f} ms, "
            f"idle share {prof['device_idle_share']:.3f}, {prof['device_ops']} device ops "
            f"({prof['device_ops_per_substep']:.1f} per substep)")
        for key, n, ms in prof["top"]:
            log(f"  {key}: {n} x, {ms:.3f} ms")

        shapes = {f"{n_sys}x{NZ}": thomas_bench_record(benchmarks, dev, n_sys)
                  for n_sys in (FC_COLUMNS, len(FC_IDS.split(",")))}
        log(f"card: {smi}")
    return {"ms": stats["ms"], "ms_median": stats["ms_median"],
            "column_timesteps_per_sec": stats["column_timesteps_per_sec"], "launches": launches["thomas"],
            "launches_per_run": FC_STEPS, "runs": stats["calls"], "scan_run_ms": scan_ms,
            "profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "device_ops",
                                             "device_ops_per_substep")},
            "thomas_shapes": shapes}


def fc_curriculum_thomas_launches(spec: str, n_frames: int, n_substeps: int, maxiters: int) -> tuple[int, list]:
    """Thomas launches of a train-fc-nde run from its curriculum: per stage ``w:s``, ``(points - 1) s n_substeps``
    substeps per solve, three launches each per iteration (forward, checkpoint recompute, transposed IFT solve);
    the free-convection trainer has no pre-solve. Returns the total and the substeps per stage."""
    stages = []
    for item in spec.split(","):
        w, _, s = item.partition(":")
        stride = int(s or 1)
        stages.append((len(range(0, min(int(w), n_frames), stride)) - 1) * stride * n_substeps)
    return sum(3 * sub * maxiters for sub in stages), stages


def train_fc_nde_phase(dev, smi: str) -> dict:
    """Phase 24: the train-fc-nde command on the card at full width, then its first stage on the plain scan."""
    import torch

    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.data import free_convection as fcd
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.train import nde

    record = {}
    n_ids = len(FC_IDS.split(","))
    with phase(f"24 train-fc-nde CLI on the card at full width: {n_ids} ids, Nz = {NZ}, {FC_N_SAVE + 1} frames, "
               f"curriculum {FC_CURRICULUM}, {FC_ITERS} iterations per stage"), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        originals = (fcd.load_free_convection_suite, nde._train_loop)
        timings = []
        cached_suite = fc_suites(originals[0], timings)  # both runs train on one suite, generated once on the CPU

        def timed_loop(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = originals[1](*args, **kw)
            torch.cuda.synchronize()
            timings.append({"kind": "train_loop", "s": time.perf_counter() - t, "iterations": args[3]})
            return out

        def run(label, argv, spec):
            timings_before = len(timings)
            expected, stages = fc_curriculum_thomas_launches(spec, FC_N_SAVE + 1, 4, FC_ITERS)
            _cuda.reset_launch_counts()
            rc = cli.main(argv)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            if rc != 0:
                raise RuntimeError(f"train-fc-nde run {label} exited {rc}")
            loops = [e for e in timings[timings_before:] if e["kind"] == "train_loop"]
            per_iter = [e["s"] * 1e3 / e["iterations"] for e in loops]
            log(f"run {label}: wall ms per iteration per stage {[round(v, 1) for v in per_iter]} at substeps per "
                f"solve {stages}; launch counts {launches}; expected thomas launches {expected} from the curriculum")
            if len(loops) != len(stages):
                raise RuntimeError(f"run {label}: {len(loops)} stages trained, expected {len(stages)}")
            return launches, expected, stages, per_iter

        def losses(out):
            with open(out / "history.jsonl") as f:
                return [json.loads(line)["loss"] for line in f]

        fcd.load_free_convection_suite, nde._train_loop = cached_suite, timed_loop
        try:
            out_a = tmp / "a"
            launches, expected, stages, per_iter = run(
                "A (kernel)", ["train-fc-nde", "--sim-ids", FC_IDS, *FC_ARGS, "--curriculum", FC_CURRICULUM,
                               "--output", str(out_a)], FC_CURRICULUM)
            hist_a = losses(out_a)
            nn, meta = cli._load_fc_nn(str(out_a), dev)
            finite = all(bool(torch.isfinite(p).all()) for p in nde.nn_parameters(nn))
            log(f"run A: suite generation {timings[0]['s']:.2f}s; losses {hist_a}; meta arch {meta['arch']}, "
                f"scalings {meta['scalings']}; reloaded closure finite {finite}")
            if launches["thomas"] != expected or any(v for k, v in launches.items() if k != "thomas"):
                raise RuntimeError(f"run A: counted {launches}, expected {expected} thomas launches only")
            if len(hist_a) != len(stages) * FC_ITERS or not all(math.isfinite(v) for v in hist_a) or not finite:
                raise RuntimeError(f"run A: history {hist_a}, closure finite {finite}")
            record["run_a"] = {"launches": launches["thomas"], "expected": expected, "substeps": stages,
                               "ms_per_iteration": per_iter, "losses": hist_a, "suite_s": timings[0]["s"]}

            first = FC_CURRICULUM.split(",")[0]
            out_c = tmp / "c"
            launches, _, _, per_iter_c = run(
                "C (scan, first stage)", ["train-fc-nde", "--sim-ids", FC_IDS, *FC_ARGS, "--curriculum", first,
                                          "--tridiag-backend", "scan", "--output", str(out_c)], first)
            hist_c = losses(out_c)
            log(f"run C: losses with scan {hist_c!r}, run A's first stage with the kernel {hist_a[:FC_ITERS]!r}; "
                f"per iteration {per_iter_c[0]:.1f} ms (scan) against {per_iter[0]:.1f} ms (kernel)")
            if launches["thomas"] != 0 or hist_c != hist_a[:FC_ITERS]:
                raise RuntimeError(f"run C: thomas counted {launches['thomas']} (expected 0), or its losses differ")
            record["run_c_scan"] = {"losses": hist_c, "ms_per_iteration": per_iter_c}
        finally:
            fcd.load_free_convection_suite, nde._train_loop = originals
        log(f"card: {smi}")
    return record


def thomas_shapes(tri):
    """A stand-in for ``tri._thomas_cuda`` that records each launch's right-hand-side shape, and its list."""
    shapes, original = [], tri._thomas_cuda

    def recording(*args):
        shapes.append(tuple(args[3].shape))
        return original(*args)

    return recording, shapes


def thomas_bench_record(benchmarks, dev, n_sys: int, N: int = NZ, repeats: int = LES_BENCH_REPEATS) -> dict:
    """``bench_tridiagonal`` at ``n_sys`` x ``N`` (``repeats`` calls per backend), with its byte bound, logged and
    returned.

    The kernel's device time is the mean over the launches the profiler
    recorded: late in this long process it has recorded few or none of them
    (then "not measured"), so phase 10 measures every shape of the port's
    paths first. The kernel must equal ``_thomas_scan`` and lie within
    THOMAS_RTOL / THOMAS_ATOL of ``_thomas_pcr`` (of the solution's largest
    magnitude), or this raises.
    """
    r = benchmarks.bench_tridiagonal(n_sys, N, repeats=repeats, device=dev)
    bound = r["bytes"] / PEAK_BYTES_PER_S * 1e3
    kernel = ("not measured (the profiler recorded none of its launches)" if r["cuda_ms"] is None else
              f"{r['cuda_ms'] * 1e3:.2f} us per launch ({r['cuda_recorded']} of {r['repeats']} launches recorded)")
    pcr_limit = THOMAS_ATOL + THOMAS_RTOL * r["max_abs_x"]
    log(f"thomas at {n_sys} x {N}: device {kernel} (in a CUDA graph of {r['repeats']} launches "
        f"{r['cuda_graph_ms'] * 1e3:.2f} us each; back to back {r['cuda_wall_ms'] * 1e3:.2f} us); scan "
        f"{r['scan_ms'] * 1e3:.1f} us; torch.linalg.solve {r['library_ms'] * 1e3:.1f} us; byte bound {r['bytes']} B / "
        f"3.35 TB/s = {bound * 1e3:.4f} us; max abs vs scan {r['max_abs_err_vs_scan']:.3e} (equal: "
        f"{r['cuda_equals_scan']}); max abs vs pcr {r['max_abs_err_vs_pcr']:.3e} (limit {pcr_limit:.3e})")
    if not (r["cuda_equals_scan"] and r["max_abs_err_vs_pcr"] <= pcr_limit):
        raise RuntimeError(f"thomas at {n_sys} x {N}: not equal to _thomas_scan, or outside the limit of _thomas_pcr")
    return {"ms": r["cuda_ms"], "recorded": r["cuda_recorded"], "graph_ms": r["cuda_graph_ms"],
            "wall_ms": r["cuda_wall_ms"], "plain_ms": r["scan_ms"], "pcr_ms": r["pcr_ms"],
            "library_ms": r["library_ms"], "bound_ms": bound, "bound_by": "bytes",
            "max_abs_err_vs_scan": r["max_abs_err_vs_scan"], "equals_scan": r["cuda_equals_scan"],
            "max_abs_err_vs_pcr": r["max_abs_err_vs_pcr"]}


def ensemble_step_phase(dev, setup, k0_step: dict, smi: str) -> dict:
    """Phase 25: the deep-ensemble flagship step, folded and looped, kernel against scan."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_run

    ens, meta = load_run(str(ENS_RUN), dev)
    record = {}
    with phase(f"25 deep-ensemble training step: {ENS_RUN.name} (K = {ENS_K}) on the {len(benchmarks.TRAIN_FILES)}-sim "
               f"flagship step, folded over its first {ENS_STEP_SAVES} saves ({ENS_TIMED_STEPS} timed steps) and one "
               f"solve per member"):
        if meta.get("ensemble") != ENS_K or "mpp" in meta:
            raise RuntimeError(f"{ENS_RUN.name}: meta {meta.get('ensemble')} members, mpp {meta.get('mpp')}")
        batch = setup["batch"]
        saves = batch.t.shape[0] - 1
        head = dict(setup, batch=dataclasses.replace(batch, targets=batch.targets[:, : ENS_STEP_SAVES + 1],
                                                     t=batch.t[: ENS_STEP_SAVES + 1]),
                    tsteps=setup["tsteps"][: ENS_STEP_SAVES + 1],
                    substeps=setup["substeps"] * ENS_STEP_SAVES // saves)
        part = dict(setup, batch=dataclasses.replace(batch, targets=batch.targets[:, : ENS_LOOP_SAVES + 1],
                                                     t=batch.t[: ENS_LOOP_SAVES + 1]))
        recording, shapes = thomas_shapes(tri)
        original = tri._thomas_cuda
        tri._thomas_cuda = recording
        try:
            _cuda.reset_launch_counts()
            folded = benchmarks.bench_train_step(head, n_timed=ENS_TIMED_STEPS, device=dev, ensemble=ENS_K,
                                                 member_fold=True, stacked_nns=ens)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            fold_shapes = sorted(set(shapes))
            shapes.clear()
            _cuda.reset_launch_counts()
            loop = benchmarks.ensemble_loss_and_grad(part, ens, member_fold=False)
            loop_launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            loop_shapes = sorted(set(shapes))
        finally:
            tri._thomas_cuda = original
        substeps = folded["substeps"]
        expected = folded["presolve_substeps"] + 3 * substeps * folded["steps"]
        solo_per_step = 3 * k0_step["substeps"] * ENS_STEP_SAVES // saves  # phase 9's over the same saves
        log(f"folded over the first {ENS_STEP_SAVES} of {saves} saves ({substeps} substeps): ms per step "
            f"min={folded['ms_min']:.1f} median={folded['ms_median']:.1f} all={[round(t, 1) for t in folded['ms']]}; "
            f"phase 9's solo step over all {saves} saves, median {k0_step['ms_median']:.1f}; losses (member sums) "
            f"{folded['losses']}")
        log(f"folded launch counts {launches}; expected thomas {expected} = {folded['presolve_substeps']} (one folded "
            f"pre-solve) + 3 x {substeps} x {folded['steps']} steps, i.e. {3 * substeps} per step as phase 9's "
            f"{3 * k0_step['substeps']} over {saves} saves gives over {ENS_STEP_SAVES} ({solo_per_step}); shapes "
            f"{fold_shapes}")
        want_fold = [(3, len(benchmarks.TRAIN_FILES), ENS_K, NZ)]
        if (launches["thomas"] != expected or 3 * substeps != solo_per_step or folded["presolve_substeps"] != substeps
                or fold_shapes != want_fold):
            raise RuntimeError(f"folded step: thomas {launches['thomas']} (expected {expected}), shapes {fold_shapes}")
        loop_substeps = substeps * ENS_LOOP_SAVES // ENS_STEP_SAVES
        loop_expected = ENS_K * loop_substeps + ENS_K * 3 * loop_substeps
        log(f"member loop over the first {ENS_LOOP_SAVES} saves ({loop_substeps} substeps): pre-solve "
            f"{loop['presolve_ms']:.1f} ms, one loss + gradient {loop['step_ms']:.1f} ms (no adam); launch counts "
            f"{loop_launches}; expected thomas {loop_expected} = {ENS_K} x ({loop_substeps} pre-solve + 3 x "
            f"{loop_substeps}); shapes {loop_shapes}")
        if loop_launches["thomas"] != loop_expected or loop_shapes != [(3, len(benchmarks.TRAIN_FILES), NZ)]:
            raise RuntimeError(f"member loop: thomas {loop_launches['thomas']} (expected {loop_expected}), "
                               f"shapes {loop_shapes}")

        # These launches come after the counts were read. Every form on the member loop's loss scalings, as the
        # JAX test compares them: the weights must not differ by the two pre-solves' roundings.
        same = loop["scalings"]
        fold_k = benchmarks.ensemble_loss_and_grad(part, ens, member_fold=True, scalings=same)
        fold_s = benchmarks.ensemble_loss_and_grad(part, ens, member_fold=True, scalings=same, tridiag_backend="scan")

        def rel(a, b):
            return abs(float(a["loss"]) - float(b["loss"])) / abs(float(b["loss"])), float(
                (a["grad"] - b["grad"]).norm() / b["grad"].norm())

        fl_loss, fl_grad = rel(fold_k, loop)
        ks_loss, ks_grad = rel(fold_k, fold_s)
        log(f"folded vs member loop (kernel): loss {float(fold_k['loss']):.8e} vs {float(loop['loss']):.8e} (rel "
            f"{fl_loss:.3e}, limit {ENS_LOSS_RTOL}); gradient ({fold_k['grad'].numel()} entries) rel 2-norm "
            f"{fl_grad:.3e} (limit {ENS_GRAD_RTOL}; the JAX test's limits: the same sums in other orders)")
        log(f"folded, kernel vs scan: loss rel {ks_loss:.3e} (limit {STEP_LOSS_RTOL}), gradient rel 2-norm "
            f"{ks_grad:.3e} (limit {STEP_GRAD_RTOL}); phase 9's reason; loss and gradient {fold_s['step_ms']:.1f} ms on "
            f"scan against {fold_k['step_ms']:.1f} ms on the kernel (the member loop {loop['step_ms']:.1f} ms)")
        if not (bool(torch.isfinite(fold_k["grad"]).all()) and fl_loss <= ENS_LOSS_RTOL and fl_grad <= ENS_GRAD_RTOL
                and ks_loss <= STEP_LOSS_RTOL and ks_grad <= STEP_GRAD_RTOL):
            raise RuntimeError("the folded ensemble step disagrees with the member loop or with scan")
        prof = benchmarks.profile_train_step(setup, n_saves=2, device=dev, ensemble=ENS_K, member_fold=True,
                                             stacked_nns=ens)
        log(f"profiled folded step over {prof['substeps']} substeps: wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}, "
            f"{prof['device_ops_per_substep']:.0f} device ops per substep")
        for key, n, ms in prof["top"]:
            log(f"  {key}: {n} x, {ms:.3f} ms")
        record["thomas_72x32"] = thomas_bench_record(benchmarks, dev, 3 * len(benchmarks.TRAIN_FILES) * ENS_K)
        log(f"card: {smi}")
    record.update(
        folded={"saves": ENS_STEP_SAVES, "ms": folded["ms"], "ms_median": folded["ms_median"],
                "launches": launches["thomas"], "expected": expected, "shapes": fold_shapes, "losses": folded["losses"]},
        loop={"saves": ENS_LOOP_SAVES, "presolve_ms": loop["presolve_ms"], "step_ms": loop["step_ms"],
              "launches": loop_launches["thomas"], "expected": loop_expected, "shapes": loop_shapes},
        k0_step_ms_median=k0_step["ms_median"], folded_vs_loop={"loss_rel": fl_loss, "grad_rel": fl_grad},
        kernel_vs_scan={"loss_rel": ks_loss, "grad_rel": ks_grad},
        profile={k: prof[k] for k in ("substeps", "wall_ms", "device_busy_ms", "device_idle_share",
                                      "device_ops_per_substep")})
    return record


def cached_suites(cli, seed: dict):
    """A stand-in for ``cli._load_suite`` that generates each suite once (``seed``: the suites already made, a dict
    the stand-in adds to, so phases that pass one dict share their suites)."""
    original, cache = cli._load_suite, seed

    def load(names, Nz, data_dir=None, n_save=288, dt_save=600.0, Nz_les=128, device=None):
        key = (tuple(names), Nz, data_dir, n_save, dt_save, Nz_les)
        if key not in cache:
            cache[key] = original(names, Nz, data_dir, n_save, dt_save, Nz_les, device=device)
        return cache[key]

    return load


def fc_suites(original, timings: list | None = None):
    """A stand-in for ``data.free_convection.load_free_convection_suite`` that generates each suite once.

    Suites are kept in ``FC_SUITES`` under their ids and other arguments; ids
    that a kept suite of the same arguments holds are taken from it (each
    id's stand-in is the single-id generator's, ``load_free_convection_suite``).
    A generation's seconds are appended to ``timings`` where given.
    """
    def load(ids, *args, **kw):
        rest = repr((args, sorted(kw.items())))
        for (have, kept_rest), suite in FC_SUITES.items():
            if kept_rest == rest and set(ids) <= set(have):
                return [suite[have.index(i)] for i in ids]
        t = time.perf_counter()
        FC_SUITES[(tuple(ids), rest)] = suite = original(ids, *args, **kw)
        if timings is not None:
            timings.append({"kind": "suite", "s": time.perf_counter() - t})
        return suite

    return load


def train_nde_ensemble_phase(dev, setup, smi: str) -> dict:
    """Phase 26: ``train-nde --ensemble 4`` (members folded) on the card: runs A (two stages), B (resumed), C (scan)."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.train import checkpoint as ck
    from climateparameterizations_jl_tpu_torch.train import nde

    record = {}
    names = tuple(benchmarks.TRAIN_FILES)
    with phase(f"26 train-nde --ensemble {ENS_K} (members folded) at full width: {len(names)} sims, curriculum "
               f"{ENS_CURRICULUM}, from {ENS_RUN.name}"), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sims = ",".join(names)
        base = ["train-nde", "--sims", sims, "--nz", str(NZ), "--n-save", str(NDE_N_SAVE), "--dt-save", "600",
                "--n-substeps", "1", "--method", "split", "--lr", NDE_LR, "--maxiters", "1", *NDE_FRACTIONS,
                "--ensemble", str(ENS_K)]
        try:
            cli.main([*base, "--optimizer", "lbfgs", "--output", str(tmp / "l")])
        except SystemExit as e:
            log(f"--ensemble {ENS_K} --optimizer lbfgs refused: {e}")
        else:
            raise RuntimeError("train-nde accepted --ensemble with --optimizer lbfgs")
        original = cli._load_suite
        # Phase 8's suite is the one these runs load (the same names, widths and frames).
        cli._load_suite = cached_suites(cli, {(names, NZ, None, NDE_N_SAVE, 600.0, 128): setup["ds"]})

        def run(label, argv, spec):
            expected, _ = curriculum_thomas_launches(spec, NDE_N_SAVE + 1, 0, 1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            rc = cli.main(argv)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            out = Path(argv[argv.index("--output") + 1])
            hist = [json.loads(line) for line in open(out / "history.jsonl")]
            with np.load(out / "train_state" / "state.npz") as data:
                count = int(data["['opt_state']/[0]/.count"])
            log(f"run {label}: {wall:.2f} s; losses {[h['loss'] for h in hist]}; adam count {count}; launch counts "
                f"{launches}; expected thomas {expected} (the solo curriculum's count: one folded solve per substep)")
            want = 0 if "--tridiag-backend" in argv else expected
            if rc != 0 or launches["thomas"] != want:
                raise RuntimeError(f"run {label}: exit {rc}, thomas {launches['thomas']} (expected {want})")
            # history.jsonl holds the member MEAN: its loss is the sum of its (member-mean) channels.
            channels = ("u", "v", "T", "dudz", "dvdz", "dTdz")
            if not all(math.isfinite(h["loss"]) and abs(h["loss"] - sum(h[c] for c in channels)) <= 1e-6 * h["loss"]
                       for h in hist):
                raise RuntimeError(f"run {label}: history {hist}")
            return hist, count, {"s": wall, "launches": launches["thomas"], "losses": [h["loss"] for h in hist]}

        try:
            out_a, out_b, out_c = tmp / "a", tmp / "b", tmp / "c"
            hist_a, count_a, record["run_a"] = run(
                "A", [*base, "--curriculum", ENS_CURRICULUM, "--init-from", str(ENS_RUN), "--output", str(out_a)],
                ENS_CURRICULUM)
            first = ENS_CURRICULUM.split(",")[0]
            hist_b, count_b, record["run_b"] = run(
                "B (resumed from A)", [*base, "--curriculum", first, "--init-from", str(out_a), "--resume-from",
                                       str(out_a), "--output", str(out_b)], first)
            hist_c, _, record["run_c_scan"] = run(
                "C (scan, first stage)", [*base, "--curriculum", first, "--init-from", str(ENS_RUN),
                                          "--tridiag-backend", "scan", "--output", str(out_c)], first)
        finally:
            cli._load_suite = original
        rel = abs(hist_c[0]["loss"] - hist_a[0]["loss"]) / abs(hist_a[0]["loss"])
        nns, meta = ck.load_run(str(out_a), dev)
        finite = all(bool(torch.isfinite(p).all()) for p in nde.nn_parameters(nns))
        log(f"run C's loss {hist_c[0]['loss']!r} against run A's first {hist_a[0]['loss']!r}: rel {rel:.3e} (limit "
            f"{STEP_LOSS_RTOL}); load_run(A): {meta['ensemble']} members, uw layer 0 {tuple(nns.uw.weights[0].shape)}, "
            f"finite {finite}; adam counts A {count_a}, B {count_b}")
        if (len(hist_a) != 2 or count_a != 2 or count_b != 3 or rel > STEP_LOSS_RTOL or meta["ensemble"] != ENS_K
                or tuple(nns.uw.weights[0].shape) != (ENS_K, 50, 3 * NZ) or not finite):
            raise RuntimeError("train-nde --ensemble: the runs or the saved ensemble are not as expected")
        record["scan_vs_kernel_loss_rel"] = rel
        log(f"card: {smi}")
    return record


def ensemble_uq_phase(dev, setup, smi: str) -> dict:
    """Phase 27: nde_ensemble_uq of the K = 4 ensemble on the three held-out sims, a band calibration."""
    import numpy as np

    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.eval.ensemble_uq import nde_ensemble_uq
    from climateparameterizations_jl_tpu_torch.eval.uq_calibration import band_report, fit_band_calibration
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_run

    ens, _ = load_run(str(ENS_RUN), dev)
    model = setup["model"]  # fitted on the 18 training sims, the default mPP base: the ensemble's own
    tsteps = np.arange(0, NDE_N_SAVE + 1, UQ_STRIDE)
    record = {"sims": {}}
    with phase(f"27 nde_ensemble_uq of {ENS_RUN.name} on {UQ_SIMS} of the {len(UQ_TEST_FILES)} held-out sims, every "
               f"{UQ_STRIDE}th of {NDE_N_SAVE + 1} frames, {UQ_STRIDE} split substeps per save"):
        t = time.perf_counter()
        suite = cli._load_suite(list(UQ_TEST_FILES), NZ, None, NDE_N_SAVE, 600.0, device=dev)
        log(f"held-out suite generated in {time.perf_counter() - t:.2f} s")
        for i, name in enumerate(UQ_TEST_FILES):  # phase 31 evaluates the same sims, one by one
            WM_SUITES[((name,), NZ, None, NDE_N_SAVE, 600.0, 128)] = cli._select_sims(suite, i)
        calibration = None
        for i, name in enumerate(UQ_TEST_FILES[:UQ_SIMS]):
            ds = cli._select_sims(suite, [i])  # a stacked suite of one
            _cuda.reset_launch_counts()
            t = time.perf_counter()
            uq = nde_ensemble_uq(model, ens, ds, tsteps, solver="split", n_substeps=UQ_STRIDE)
            wall = time.perf_counter() - t
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            expected = (len(tsteps) - 1) * UQ_STRIDE
            truth = ds.T[0].index_select(0, ds.T.new_tensor(tsteps).long()).cpu().numpy()
            mean, std = uq["ensemble_T_mean"], uq["ensemble_T_std"]
            member = uq["losses_member_T"].mean(axis=0)
            jensen = bool(np.all(uq["losses_ensemble_mean_T"] <= member * (1 + 1e-5) + 1e-10))
            row = {"wall_s": wall, "launches": launches["thomas"], "expected": expected,
                   "loss_member_mean_T": float(member.mean()),
                   "loss_ensemble_mean_T": float(uq["losses_ensemble_mean_T"].mean()),
                   "losses_members_T": [float(v) for v in uq["losses_member_T"].mean(axis=1)], "jensen": jensen,
                   "before": band_report(truth, mean, std)}
            if calibration is None:
                calibration = fit_band_calibration(truth, mean, std)
                row.update(role="validation", lam_nll=calibration.lam_nll, lam_coverage=calibration.lam_coverage)
            else:
                row.update(role="test", after=band_report(truth, mean, std, lam=calibration.lam))
            log(f"{name} ({row['role']}): {wall:.2f} s, thomas {launches['thomas']} (expected {expected}, one folded "
                f"solve of (3, {ENS_K}, {NZ}) per substep); scaled T loss of the ensemble mean "
                f"{row['loss_ensemble_mean_T']:.4e} <= member mean {row['loss_member_mean_T']:.4e} at every frame: "
                f"{jensen}; members {[f'{v:.3e}' for v in row['losses_members_T']]}; 2-sigma coverage "
                f"{row['before']['coverage']:.3f}" + (f" -> {row['after']['coverage']:.3f} after inflation by "
                                                       f"lambda = {calibration.lam:.3f}" if "after" in row else
                                                       f" (fit here: lambda_coverage {calibration.lam_coverage:.3f}, "
                                                       f"lambda_nll {calibration.lam_nll:.3f})"))
            if launches["thomas"] != expected or not jensen or not np.isfinite(mean).all():
                raise RuntimeError(f"{name}: thomas {launches['thomas']} (expected {expected}), Jensen {jensen}")
            record["sims"][name] = row
        record["lam"] = calibration.lam
        log(f"card: {smi}")
    return record


def optimise_mpp_phase(dev, setup, smi: str) -> dict:
    """Phase 28: optimise-mpp on the 18 TRAIN_FILES: EKI with the defaults, then adam and lbfgs."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri
    from climateparameterizations_jl_tpu_torch.train import mpp_calibration as mc

    record = {}
    n_sims = len(benchmarks.TRAIN_FILES)
    substeps = 31 * MPP_SUBSTEPS  # --n-train-steps 32: 31 save intervals
    with phase(f"28 optimise-mpp on the {n_sims} TRAIN_FILES: EKI (J = {MPP_EKI_J}, {MPP_EKI_ITERS} iterations), adam "
               f"and lbfgs ({MPP_ITERS} iterations)"), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        common = ["optimise-mpp", "--sims", ",".join(benchmarks.TRAIN_FILES), "--nz", str(NZ), "--n-save",
                  str(MPP_N_SAVE), "--dt-save", "600"]
        originals = (cli._load_suite, mc._solve, tri._thomas_cuda)
        first = []

        def recording(model, nns, batch, config):
            out = originals[1](model, nns, batch, config)
            if not first and batch.x0.dim() == 3:  # the first EKI forward: (S, J, 3 Nz)
                first.append((model, batch, config, out.detach().clone()))
            return out

        shape_rec, shapes = thomas_shapes(tri)
        cli._load_suite, mc._solve, tri._thomas_cuda = cached_suites(cli, WM_SUITES), recording, shape_rec
        try:
            runs = {}
            for label, extra in (("eki", ["--calibration-method", "eki"]),
                                 ("adam", ["--maxiters", str(MPP_ITERS)]),
                                 ("lbfgs", ["--optimizer", "lbfgs", "--maxiters", str(MPP_ITERS)])):
                out = tmp / label
                shapes.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                _cuda.reset_launch_counts()
                rc = cli.main([*common, *extra, "--output", str(out)])
                launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                result = json.loads((out / "mpp_parameters.json").read_text())
                iters = MPP_EKI_ITERS if label == "eki" else MPP_ITERS
                runs[label] = {"s": wall, "s_per_iteration": wall / iters, "launches": launches["thomas"],
                               "shapes": sorted(set(shapes)), "result": result}
                log(f"{label}: exit {rc}, {wall:.2f} s ({wall / iters:.2f} s per iteration, the suite generation in the "
                    f"first run), thomas {launches['thomas']} launches of shapes {sorted(set(shapes))}; {result}")
                if rc != 0:
                    raise RuntimeError(f"optimise-mpp {label} exited {rc}")
        finally:
            cli._load_suite, mc._solve, tri._thomas_cuda = originals
        eki, adam, lbfgs = runs["eki"], runs["adam"], runs["lbfgs"]
        eki_expected = (MPP_EKI_ITERS + 1) * substeps
        adam_expected = 3 * substeps * MPP_ITERS  # fixed channel weights: no pre-solve
        std = eki["result"]["posterior_std"]
        ok_eki = (eki["result"]["misfit_final"] < eki["result"]["misfit_initial"]
                  and all(math.isfinite(v) and v > 0 for v in std.values()) and eki["launches"] == eki_expected
                  and eki["shapes"] == [(3, n_sims, MPP_EKI_J, NZ)])
        log(f"EKI misfit {eki['result']['misfit_initial']:.4e} -> {eki['result']['misfit_final']:.4e}; posterior std "
            f"{std}; thomas {eki['launches']} (expected {eki_expected} = {MPP_EKI_ITERS + 1} forward evaluations x "
            f"{substeps} substeps, one launch over 3 x {n_sims} x {MPP_EKI_J} systems each)")
        # The first EKI forward evaluation again with the plain scan: the kernel runs its sweep in its roundings.
        model, batch, config, got = first[0]
        with torch.no_grad():
            want = originals[1](model, mc.NO_NNS, batch, dataclasses.replace(config, tridiag_backend="scan"))
        record["eki_first_forward_max_abs_err"] = compare(
            f"first EKI forward evaluation {tuple(got.shape)}, kernel vs scan", got, want, rtol=THOMAS_RTOL,
            atol=THOMAS_ATOL)
        log(f"  entries that differ at all: {int((got != want).sum())} of {got.numel()}")
        losses = {k: (runs[k]["result"]["loss_initial"], runs[k]["result"]["loss_final"]) for k in ("adam", "lbfgs")}
        log(f"gradient runs (loss_initial, loss_final): {losses}; adam thomas {adam['launches']} (expected "
            f"{adam_expected}); lbfgs thomas {lbfgs['launches']} (3 per substep per evaluation: "
            f"{lbfgs['launches'] / (3 * substeps):.0f} evaluations in {MPP_ITERS} iterations)")
        ok_grad = (adam["launches"] == adam_expected and lbfgs["launches"] % (3 * substeps) == 0
                   and lbfgs["launches"] >= adam_expected
                   and all(math.isfinite(a) and math.isfinite(b) and b <= a for a, b in losses.values()))
        if not (ok_eki and ok_grad):
            raise RuntimeError("optimise-mpp: the EKI misfit did not fall, a launch count is off or a loss is not finite")
        record.update(runs=runs, eki_expected=eki_expected, adam_expected=adam_expected,
                      thomas_1152x32=thomas_bench_record(benchmarks, dev, 3 * n_sims * MPP_EKI_J))
        log(f"card: {smi}")
    return record


def train_fc_nde_ensemble_phase(dev, smi: str) -> dict:
    """Phase 29: train-fc-nde --ensemble 4 at phase 24's size (first stage), then fc_ensemble_uq on id 1."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.data import free_convection as fcd
    from climateparameterizations_jl_tpu_torch.eval.ensemble_uq import fc_ensemble_uq
    from climateparameterizations_jl_tpu_torch.models.free_convection import solve_free_convection_nde
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.train import deep_ensemble as de

    record = {}
    n_ids = len(FC_IDS.split(","))
    with phase(f"29 train-fc-nde --ensemble {ENS_K} at full width: {n_ids} ids, {FC_N_SAVE + 1} frames, curriculum "
               f"{FC_ENS_STAGE}, {FC_ITERS} iterations; then fc_ensemble_uq on id 1"), \
            tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        originals = (fcd.load_free_convection_suite, de.train_free_convection_deep_ensemble)
        calls = []
        cached_suite = fc_suites(originals[0])

        def recording(model, stacked_nn, T0, targets, t, config, **kw):
            calls.append((model, de.stack_members([de.member(stacked_nn, m) for m in range(ENS_K)]), T0, targets, t,
                          config))
            return originals[1](model, stacked_nn, T0, targets, t, config, **kw)

        expected, stages = fc_curriculum_thomas_launches(FC_ENS_STAGE, FC_N_SAVE + 1, 4, FC_ITERS)
        expected *= ENS_K
        out = tmp / "fc_ens"
        fcd.load_free_convection_suite, de.train_free_convection_deep_ensemble = cached_suite, recording
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            rc = cli.main(["train-fc-nde", "--sim-ids", FC_IDS, *FC_ARGS, "--curriculum", FC_ENS_STAGE, "--ensemble",
                           str(ENS_K), "--output", str(out)])
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            fcd.load_free_convection_suite, de.train_free_convection_deep_ensemble = originals
        hist = [json.loads(line) for line in open(out / "history.jsonl")]
        log(f"exit {rc} in {wall:.2f} s ({stages[0]} substeps per solve, one solve per member); losses "
            f"{[h['loss'] for h in hist]}; launch counts {launches}; expected thomas {expected} = {ENS_K} members x "
            f"3 x {stages[0]} x {FC_ITERS} iterations")
        if rc != 0 or launches["thomas"] != expected or len(hist) != FC_ITERS:
            raise RuntimeError(f"train-fc-nde --ensemble: exit {rc}, thomas {launches['thomas']} (expected {expected})")
        # The history's loss is the member MEAN: each member's MSE at its first-iteration weights, one by one.
        model, stacked, T0, targets, t_hat, config = calls[0]
        n_save = t_hat.shape[0] - 1
        with torch.no_grad():
            mses = [float(torch.mean((torch.movedim(solve_free_convection_nde(
                model, nn, T0, t_hat[0], (t_hat[-1] - t_hat[0]) / n_save, n_save, config.n_substeps, config.method,
                tridiag_backend="cuda"), 0, -2) - targets) ** 2)) for nn in de.unstack_members(stacked)]
        rel = abs(float(np.mean(mses)) - hist[0]["loss"]) / hist[0]["loss"]
        log(f"members' first losses {mses}: mean {np.mean(mses)!r} against the history's {hist[0]['loss']!r} (rel "
            f"{rel:.3e}, limit {STEP_LOSS_RTOL}); the sum would be {np.sum(mses):.6e}")
        if rel > STEP_LOSS_RTOL:
            raise RuntimeError("train-fc-nde --ensemble: the history does not hold the member mean")
        stacked_out, meta = cli._load_fc_nn(str(out), dev)
        # Id 1 on its own, with the training scalings and its own boundary fluxes (taken from the suite kept above).
        fcd.load_free_convection_suite = cached_suite
        try:
            suite = cli._load_fc_suite([1], NZ, None, FC_N_SAVE, 600.0, device=dev)
        finally:
            fcd.load_free_convection_suite = originals[0]
        model_1 = fcd.build_free_convection_model(suite, model.T_scaling, model.wT_scaling, model.base_closure)
        tsteps = np.arange(0, FC_UQ_FRAMES, FC_UQ_STRIDE)
        _cuda.reset_launch_counts()
        t = time.perf_counter()
        uq = fc_ensemble_uq(model_1, stacked_out, suite, tsteps, n_substeps=4 * FC_UQ_STRIDE)
        uq_wall = time.perf_counter() - t
        uq_launches = _cuda.KERNELS["thomas"].launches
        uq_expected = ENS_K * (len(tsteps) - 1) * 4 * FC_UQ_STRIDE
        member = uq["losses_member_T"].mean(axis=0)
        jensen = bool(np.all(uq["losses_ensemble_mean_T"] <= member * (1 + 1e-5) + 1e-10))
        log(f"fc_ensemble_uq on id 1 ({len(tsteps)} frames): {uq_wall:.2f} s, thomas {uq_launches} (expected "
            f"{uq_expected}); mean T loss of the ensemble mean {float(uq['losses_ensemble_mean_T'].mean()):.4e} <= "
            f"member mean {float(member.mean()):.4e} at every frame: {jensen}; T std max "
            f"{float(uq['ensemble_T_std'].max()):.4e} K")
        if (uq_launches != uq_expected or not jensen or meta["ensemble"] != ENS_K
                or not np.isfinite(uq["ensemble_T_mean"]).all()):
            raise RuntimeError("fc_ensemble_uq: launches, Jensen, the saved ensemble or the bands are off")
        record.update(s=wall, launches=launches["thomas"], expected=expected, losses=[h["loss"] for h in hist],
                      member_mean_rel=rel, uq={"s": uq_wall, "launches": uq_launches, "expected": uq_expected,
                                               "jensen": jensen})
        log(f"card: {smi}")
    return record


def column_baselines_phase(dev, smi: str) -> dict:
    """Phase 30: bench_kpp and bench_tke at the JAX defaults, each run on the Thomas kernel against the scan."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    record = {}
    with phase(f"30 bench_kpp and bench_tke ({COL_COLUMNS} columns x {COL_STEPS} steps of 600 s, Nz = {NZ}): the "
               f"physics baselines on the Thomas kernel"):
        for kind, n_var in (("kpp", 3), ("tke", 4)):
            original = tri._thomas_cuda
            shape_rec, shapes = thomas_shapes(tri)
            tri._thomas_cuda = shape_rec
            try:
                _cuda.reset_launch_counts()
                stats = getattr(benchmarks, f"bench_{kind}")(COL_COLUMNS, NZ, COL_STEPS, COL_REPEATS, device=dev)
                launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            finally:
                tri._thomas_cuda = original
            expected = COL_STEPS * stats["calls"]
            log(f"{kind}: backend {stats['tridiag_backend']}; ms per run min={stats['ms_min']:.2f} median="
                f"{stats['ms_median']:.2f} max={stats['ms_max']:.2f} all={[round(t, 2) for t in stats['ms']]}; "
                f"column-timesteps/s (median) {stats['column_timesteps_per_sec']:.4e}; vs the Julia reference's "
                f"single-column CPU time {stats['vs_reference']:.1f}x; launch counts {launches}, expected thomas "
                f"{expected} = {COL_STEPS} per run x {stats['calls']} runs, shapes {sorted(set(shapes))}")
            if (stats["tridiag_backend"] != "cuda" or launches["thomas"] != expected
                    or any(v for k, v in launches.items() if k != "thomas")
                    or set(shapes) != {(n_var, COL_COLUMNS, NZ)}):
                raise RuntimeError(f"bench_{kind}: backend {stats['tridiag_backend']}, {launches}, shapes {set(shapes)}")

            setup = benchmarks.column_forward_setup(kind, COL_COLUMNS, NZ, COL_STEPS, dev)
            got = benchmarks.column_forward(setup, "cuda")
            scan_ms, want = cuda_ms(lambda: benchmarks.column_forward(setup, "scan"))
            cooled = float(got[0, 0, -1] - got[-1, 0, -1])
            same = bool((got[-1] == got[-1, :1]).all())
            log(f"{kind} kernel vs scan trajectory {tuple(got.shape)}: torch.equal {torch.equal(got, want)}, entries "
                f"that differ {int((got != want).sum())} of {got.numel()}; the scan-backed run took {scan_ms:.1f} ms "
                f"(information); surface cell cooled by {cooled:.4f} K over 2 days; columns identical {same}")
            if not (torch.equal(got, want) and bool(torch.isfinite(got).all()) and cooled > 0.0 and same):
                raise RuntimeError(f"{kind}: the kernel-backed run is not the scan-backed one, or not physical")

            prof = benchmarks.profile_column_forward(kind, COL_COLUMNS, NZ, COL_PROFILE_STEPS, device=dev)
            log(f"{kind} profiled run of {COL_PROFILE_STEPS} steps (torch.profiler): wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}, {prof['device_ops']} "
                f"device ops ({prof['device_ops_per_substep']:.1f} per step)")
            for key, n, ms in prof["top"]:
                log(f"  {key}: {n} x, {ms:.3f} ms")
            record[kind] = {"ms": stats["ms"], "ms_median": stats["ms_median"],
                            "column_timesteps_per_sec": stats["column_timesteps_per_sec"],
                            "vs_reference": stats["vs_reference"], "launches": launches["thomas"],
                            "launches_per_run": COL_STEPS, "runs": stats["calls"],
                            "shape": [n_var, COL_COLUMNS, NZ], "scan_run_ms": scan_ms,
                            "profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                             "device_ops", "device_ops_per_substep")}}
        log(f"card: {smi}")
    return record


def _kpp_tke_trajectories(ds, t_dim, n_substeps: int, backend: str, wind: bool, tke: bool):
    """The T trajectories of the KPP (and TKE) baselines of ``eval/profile.py`` for one simulation, on ``backend``."""
    import torch

    from climateparameterizations_jl_tpu_torch.physics import kpp, tke as tke_mod

    dev, T0 = ds.T.device, ds.T[..., 0, :]
    zeros = torch.zeros_like(T0)
    Fb = ds.theta_top * ds.g * ds.alpha
    forcing = kpp.KPPForcing(Fu=ds.u_top if wind else torch.zeros_like(ds.u_top), Fb=Fb, dTdz_bottom=ds.theta_bottom)
    state0 = kpp.KPPState(U=ds.u[..., 0, :], V=ds.v[..., 0, :], T=T0) if wind else kpp.KPPState(zeros, zeros, T0)
    with torch.no_grad():
        out = [kpp.solve_kpp(state0, t_dim, kpp.KPPParameters.default(device=dev), forcing, ds.H, NZ, ds.f, ds.g,
                             ds.alpha, n_substeps=n_substeps, tridiag_backend=backend).T]
        if tke:
            out.append(tke_mod.solve_tke(
                tke_mod.TKEState(zeros, zeros, T0, torch.full_like(zeros, 1e-6)), t_dim,
                tke_mod.TKEParameters.default(device=dev), torch.zeros_like(ds.u_top), Fb, ds.H, NZ, ds.f, ds.g,
                ds.alpha, n_substeps=n_substeps, tridiag_backend=backend, dTdz_bottom=ds.theta_bottom).T)
    return out


def _summary_beside(port: dict, path: Path, flat: bool):
    """Log the port's summary beside the JAX command's stored one (information: the data differ)."""
    stored = json.loads(path.read_text())
    stored = stored if flat else stored["mean"]
    for m, v in port.items():
        log(f"  {m}: port {v:.6e}, " + (f"stored JAX run {stored[m]:.6e}" if m in stored else "no stored value"))


def evaluate_phase(dev, setup, smi: str) -> dict:
    """Phase 31: the evaluate --embedded command in-process on the held-out sims, KPP on kernel and scan."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.data import lesbrary
    from climateparameterizations_jl_tpu_torch.eval import profile as prof
    from climateparameterizations_jl_tpu_torch.ops import _cuda

    names = tuple(benchmarks.TRAIN_FILES)
    sims = UQ_TEST_FILES[:EVAL_SIMS]
    tsteps = np.arange(0, NDE_N_SAVE, EVAL_STRIDE)  # --n-train-steps 1152: the stored run's 128 frames
    saves = len(tsteps) - 1
    per_sim = 3 * saves * EVAL_STRIDE + 2 * saves * EMBEDDED_SUBSTEPS  # NDE, mPP alone, KPP; the host pair
    expected = per_sim * len(sims)
    with phase(f"31 evaluate --embedded --write-jld2 of {EMBEDDED_RUN.name} on {len(sims)} of the "
               f"{len(UQ_TEST_FILES)} held-out sims: "
               f"{len(tsteps)} frames (every {EVAL_STRIDE}th of {NDE_N_SAVE} saves), {EVAL_STRIDE} split substeps and "
               f"{EVAL_STRIDE} KPP steps per save, {EMBEDDED_SUBSTEPS} host steps per save"), \
            tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "eval"
        original = cli._load_suite
        WM_SUITES[(names, NZ, None, NDE_N_SAVE, 600.0, 128)] = setup["ds"]  # phase 8's suite: the scaling context
        cli._load_suite = cached_suites(cli, WM_SUITES)  # the held-out sims of phase 27
        write_s, evaluated = [], []  # each .jld2 write's seconds; (model, truth, tsteps) of each sim's nde_profile
        original_write = timed_calls(lesbrary, "write_les_profiles", write_s)
        original_profile = prof.nde_profile

        def recording_profile(model, nns, ds, ts, **kw):
            evaluated.append((model, ds, ts))
            return original_profile(model, nns, ds, ts, **kw)

        prof.nde_profile = recording_profile
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            rc = cli.main(["evaluate", "--embedded", "--write-jld2", "--checkpoint", str(EMBEDDED_RUN), "--test-sims",
                           ",".join(sims), "--nz", str(NZ), "--n-save", str(NDE_N_SAVE), "--dt-save", "600",
                           "--n-train-steps", str(NDE_N_SAVE), "--eval-stride", str(EVAL_STRIDE), "--n-substeps",
                           str(EVAL_STRIDE), "--kpp-n-substeps", str(EVAL_STRIDE), "--output", str(out)])
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            first = cli._load_suite([UQ_TEST_FILES[0]], NZ, None, NDE_N_SAVE, 600.0, device=dev)
        finally:
            cli._load_suite, lesbrary.write_les_profiles, prof.nde_profile = original, original_write, original_profile
        summary = json.loads((out / "summary.json").read_text())
        log(f"exit {rc} in {wall:.2f} s ({wall / len(sims):.2f} s per sim); launch counts {launches}; expected "
            f"thomas {expected} = {len(sims)} sims x (3 solves (NDE, mPP alone, KPP) x {saves} saves x "
            f"{EVAL_STRIDE} + 2 host runs x {saves} saves x {EMBEDDED_SUBSTEPS})")
        if rc != 0 or launches["thomas"] != expected or any(v for k, v in launches.items() if k != "thomas"):
            raise RuntimeError(f"evaluate: exit {rc}, launches {launches} (expected thomas {expected})")
        with np.load(out / f"evaluation_{UQ_TEST_FILES[0]}.npz") as ev:
            t_dim, kpp_T = ev["t"], ev["kpp_T"]
            finite = all(bool(np.isfinite(ev[k]).all()) for k in ev.files)
            keys = sorted(ev.files)
        kernel, = _kpp_tke_trajectories(first, t_dim, EVAL_STRIDE, "cuda", wind=True, tke=False)
        scan_ms, (scan,) = cuda_ms(lambda: _kpp_tke_trajectories(first, t_dim[:EVAL_SCAN_FRAMES], EVAL_STRIDE, "scan",
                                                                  wind=True, tke=False))
        head = kernel[:EVAL_SCAN_FRAMES]
        same_file = bool(np.array_equal(kernel.cpu().numpy(), kpp_T))
        log(f"{UQ_TEST_FILES[0]}: KPP trajectory {tuple(kernel.shape)}; its first {EVAL_SCAN_FRAMES} frames kernel vs "
            f"scan torch.equal {torch.equal(head, scan)} (differing entries {int((head != scan).sum())}; scan "
            f"{scan_ms:.0f} ms), the npz's kpp_T is the kernel run: {same_file}; {len(keys)} keys, all finite {finite}")
        if not (torch.equal(head, scan) and same_file and finite):
            raise RuntimeError("evaluate: the KPP baseline differs on kernel and scan, or the profile is not finite")
        files = embedded_pair_read_back(out, UQ_TEST_FILES[0], evaluated[0], write_s)
        log(f"card: {smi}")
    return {"s": wall, "s_per_sim": wall / len(sims), "sims": len(sims), "launches": launches["thomas"], "expected": expected,
            "frames": len(tsteps), "summary": summary["mean"], "kpp_kernel_equals_scan": True, "keys": keys,
            "jld2": files}


def embedded_pair_read_back(out: Path, sim: str, evaluated: tuple, write_s: list) -> dict:
    """Phase 31's ``<sim>/baseline.jld2`` and ``neural_network.jld2``, read back through the port's reader and
    through ``nde_profile_from_saved``: every profile and flux equal to the command's in-memory (npz) values."""
    import numpy as np

    from climateparameterizations_jl_tpu_torch.data.lesbrary import read_les_profiles
    from climateparameterizations_jl_tpu_torch.eval.profile import nde_profile_from_saved

    pairs = (("baseline", "embedded_baseline"), ("neural_network", "embedded"))
    with np.load(out / f"evaluation_{sim}.npz") as z:
        ev = {k: z[k] for k in z.files}
    t = time.perf_counter()
    saved = {tag: read_les_profiles(str(out / sim / f"{tag}.jld2"), dtype=ev["embedded_T"].dtype) for tag, _ in pairs}
    read_s = time.perf_counter() - t
    model, truth, tsteps = evaluated
    t = time.perf_counter()
    from_saved = nde_profile_from_saved(str(out / sim), model, truth, tsteps).to_dict()
    from_saved_s = time.perf_counter() - t
    fields = ("u", "v", "T", "uw", "vw", "wT")
    equal = {tag: all(same_bits(getattr(saved[tag], f), ev[f"{m}_{f}"]) for f in fields)
             and same_bits(saved[tag].t, ev["t"].astype(ev["embedded_T"].dtype)) for tag, m in pairs}
    via_profile = all(same_bits(from_saved[f"{m}_{f}"], ev[f"{m}_{f}"]) for _, m in pairs for f in fields)
    log(f"--write-jld2: {len(write_s)} files written in {sum(write_s):.3f} s, read back in {read_s:.3f} s "
        f"({tuple(saved['baseline'].T.shape)} frames x levels each); equal to the npz bit for bit in "
        f"{', '.join(fields)} and t: {equal}; through nde_profile_from_saved ({from_saved_s:.2f} s): {via_profile}")
    if len(write_s) != 2 or not all(equal.values()) or not via_profile:
        raise RuntimeError("evaluate --write-jld2: the saved pair is not the command's in-memory profiles")
    return {"write_s": sum(write_s), "read_s": read_s, "from_saved_s": from_saved_s, "equal": True}


def evaluate_fc_phase(dev, smi: str) -> dict:
    """Phase 32: the evaluate-fc --embedded command in-process on ids 8 and 9, KPP and TKE on kernel and scan."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.data import free_convection as fcd
    from climateparameterizations_jl_tpu_torch.data import netcdf
    from climateparameterizations_jl_tpu_torch.ops import _cuda

    tsteps = np.arange(0, FC_EVAL_WINDOW, FC_EVAL_STRIDE)  # --n-eval-steps 576 of 1,153 frames
    saves = len(tsteps) - 1
    # NDE and conv-adj; KPP and TKE; the host pair
    per_id = 2 * saves * FC_EVAL_SUBSTEPS + 2 * saves * FC_EVAL_STRIDE + 2 * saves * EMBEDDED_SUBSTEPS
    expected = per_id * len(FC_EVAL_IDS)
    ids = ",".join(map(str, FC_EVAL_IDS))
    with phase(f"32 evaluate-fc --embedded --netcdf of {FC_RUN.name} on ids {ids}: {len(tsteps)} frames (every "
               f"{FC_EVAL_STRIDE}th of the first {FC_EVAL_WINDOW} saves), {FC_EVAL_SUBSTEPS} split substeps, {FC_EVAL_STRIDE} KPP / TKE "
               f"steps and {EMBEDDED_SUBSTEPS} host steps per save"), \
            tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "eval_fc"
        original = fcd.load_free_convection_suite
        fcd.load_free_convection_suite = fc_suites(original)  # ids 8 and 9 of phase 24's nine-id suite
        write_s = []  # each id's pair of .nc files: seconds
        original_write = timed_calls(netcdf, "write_paired_column_netcdf", write_s)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            rc = cli.main(["evaluate-fc", "--embedded", "--netcdf", "--checkpoint", str(FC_RUN), "--sim-ids", ids,
                           "--nz", str(NZ),
                           "--n-save", str(FC_N_SAVE), "--dt-save", "600", "--n-eval-steps", str(FC_EVAL_WINDOW), "--eval-stride",
                           str(FC_EVAL_STRIDE), "--n-substeps", str(FC_EVAL_SUBSTEPS), "--kpp-n-substeps",
                           str(FC_EVAL_STRIDE), "--output", str(out)])
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            suite = cli._load_fc_suite(list(FC_EVAL_IDS), NZ, None, FC_N_SAVE, 600.0, device=dev)
        finally:
            fcd.load_free_convection_suite, netcdf.write_paired_column_netcdf = original, original_write
        summary = json.loads((out / "summary.json").read_text())
        log(f"exit {rc} in {wall:.2f} s; launch counts {launches}; "
            f"expected thomas {expected} = {len(FC_EVAL_IDS)} ids x ({saves} saves x {FC_EVAL_SUBSTEPS} substeps x 2 "
            f"(NDE, conv-adj) + {saves} x {FC_EVAL_STRIDE} steps x 2 (KPP, TKE) + {saves} x {EMBEDDED_SUBSTEPS} host steps "
            f"x 2 (the pair))")
        if rc != 0 or launches["thomas"] != expected or any(v for k, v in launches.items() if k != "thomas"):
            raise RuntimeError(f"evaluate-fc: exit {rc}, launches {launches} (expected thomas {expected})")
        ds = cli._select_sims(suite, 0)
        with np.load(out / f"sim{FC_EVAL_IDS[0]}.npz") as ev:
            t_dim, stored = ev["t"], (ev["kpp_T"], ev["tke_T"])
            finite = all(bool(np.isfinite(ev[k]).all()) for k in ev.files)
            keys = sorted(ev.files)
        kernel = _kpp_tke_trajectories(ds, t_dim, FC_EVAL_STRIDE, "cuda", wind=False, tke=True)
        scan_ms, scan = cuda_ms(lambda: _kpp_tke_trajectories(ds, t_dim[:FC_EVAL_SCAN_FRAMES], FC_EVAL_STRIDE, "scan",
                                                              wind=False, tke=True))
        ok = finite
        for label, k, s_, f in zip(("KPP", "TKE"), kernel, scan, stored):
            head = k[:FC_EVAL_SCAN_FRAMES]
            same, same_file = torch.equal(head, s_), bool(np.array_equal(k.cpu().numpy(), f))
            log(f"id {FC_EVAL_IDS[0]} {label} trajectory {tuple(k.shape)}: its first {FC_EVAL_SCAN_FRAMES} frames kernel "
                f"vs scan torch.equal {same} (differing entries {int((head != s_).sum())}); the npz's is the kernel "
                f"run: {same_file}")
            ok = ok and same and same_file
        log(f"(both scan runs {scan_ms:.0f} ms); all npz values finite {finite}")
        if not ok:
            raise RuntimeError("evaluate-fc: a baseline differs on kernel and scan, or the profile is not finite")
        log("mean scaled T loss per member, beside the stored JAX run (runs/fc_flagship_eval/summary.json; "
            "information only: the stored run's truth is the 3-D LES, the port's the 1-D stand-ins):")
        _summary_beside(summary, FC_EVAL / "summary.json", flat=True)
        on_stored = _fc_profile_on_stored_truth(cli, dev, [cli._select_sims(suite, k) for k in range(len(FC_EVAL_IDS))])
        files = netcdf_pairs_read_back(out, write_s)
        log(f"card: {smi}")
    return {"s": wall, "launches": launches["thomas"], "expected": expected, "frames": len(tsteps),
            "summary": summary, "kernel_equals_scan": True, "on_stored_truth": on_stored, "keys": keys,
            "netcdf": files}


def netcdf_pairs_read_back(out: Path, write_s: list) -> dict:
    """Phase 32's ``sim<i>/oceananigans_*.nc`` pairs, read back through ``read_netcdf``: the variables, their
    dimensions and coordinates equal to the command's in-memory (npz) values bit for bit."""
    import numpy as np

    from climateparameterizations_jl_tpu_torch.data.netcdf import read_netcdf

    equal, read_s = {}, 0.0
    for i in FC_EVAL_IDS:
        with np.load(out / f"sim{i}.npz") as z:
            ev = {k: z[k] for k in z.files}
        for name, want in (("oceananigans_convective_adjustment.nc", {"T": ("zC", ev["embedded_baseline_T"])}),
                           ("oceananigans_neural_network.nc", {"T": ("zC", ev["embedded_T"]),
                                                               "wT": ("zF", ev["embedded_wT"])})):
            t = time.perf_counter()
            variables, coords, attrs = read_netcdf(str(out / f"sim{i}" / name))
            read_s += time.perf_counter() - t
            equal[f"sim{i}/{name}"] = (
                sorted(variables) == sorted(want) and int(attrs["simulation_id"]) == i
                and all(variables[k][0] == ("time", z) and same_bits(variables[k][1], v) for k, (z, v) in want.items())
                and all(same_bits(coords[d], ev[key]) for d, key in (("time", "t"), ("zC", "zc"), ("zF", "zf"))
                        if d in coords))
    log(f"--netcdf: {len(write_s)} pairs written in {sum(write_s):.3f} s, read back in {read_s:.3f} s; variables, "
        f"dimensions and coordinates equal to the npz bit for bit: {equal}")
    if len(write_s) != len(FC_EVAL_IDS) or not all(equal.values()):
        raise RuntimeError("evaluate-fc --netcdf: a saved pair is not the command's in-memory profiles")
    return {"write_s": sum(write_s), "read_s": read_s, "equal": True}


def _fc_profile_on_stored_truth(cli, dev, stand_ins: list) -> dict:
    """The port's ``free_convection_profile`` of each stored FC run (``FC_STORED_RUNS``) on its own stored truth.

    ``stand_ins`` are the ids' 1-D stand-ins (their constants are the ids'); each run's log first shows how far
    their frames lie from its stored truth. Each member's mean loss over the ids must lie within FC_STORED_RTOL of
    the stored run's summary.
    """
    out = {}
    for run, eval_dir in FC_STORED_RUNS:
        out[run.name] = _stored_fc_run(cli, dev, stand_ins, run, eval_dir)
    return out


def _stored_fc_run(cli, dev, stand_ins: list, run: Path, eval_dir: Path) -> dict:
    """:func:`_fc_profile_on_stored_truth` for one run: its checkpoint on ``eval_dir``'s truth of ``FC_EVAL_IDS``,
    ``FC_EVAL_SUBSTEPS`` split substeps and, as the stored runs were made, one KPP and one TKE step per frame."""
    import dataclasses

    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
    from climateparameterizations_jl_tpu_torch.data.free_convection import build_free_convection_model
    from climateparameterizations_jl_tpu_torch.eval.profile import free_convection_profile

    nn, meta = cli._load_fc_nn(str(run), dev)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    T_scaling, wT_scaling = (ZeroMeanUnitVarianceScaling(f32(meta["scalings"][v]["mu"]),
                                                         f32(meta["scalings"][v]["sigma"])) for v in ("T", "wT"))
    losses: dict = {}
    log(f"{run.name} on the stored truth of {eval_dir.name}:")
    for i, stand_in in zip(FC_EVAL_IDS, stand_ins):
        with np.load(eval_dir / f"sim{i}.npz") as ev:
            stored = {k: ev[k] for k in ev.files}
        T, wT = stored["truth_T"], stored["truth_wT"]
        stride = int(round(float(stored["t"][1] - stored["t"][0]) / 600.0))
        frames = np.arange(0, stand_in.T.shape[0], stride)[: T.shape[0]]
        gap = float(np.abs(stand_in.T[frames].cpu().numpy() - T[: len(frames)]).max())
        ds = dataclasses.replace(stand_in, T=f32(T), wT=f32(wT), t=f32(stored["t"]), u=f32(np.zeros_like(T)),
                                 v=f32(np.zeros_like(T)), uw=f32(np.zeros_like(wT)), vw=f32(np.zeros_like(wT)))
        model = build_free_convection_model(ds, T_scaling, wT_scaling,
                                            base_closure=meta.get("base_closure", "convective_adjustment"))
        ev = free_convection_profile(model, nn, ds, np.arange(T.shape[0]), n_substeps=FC_EVAL_SUBSTEPS,
                                     kpp_n_substeps=FC_STORED_KPP_STEPS)
        log(f"id {i}: the stand-in's frames lie up to {gap:.4f} K from the stored run's truth (max |dT|); the port "
            f"on the stored truth ({T.shape[0]} frames, every {stride}th save), mean scaled T loss beside the stored "
            f"run's:")
        for m in ("nde", "conv_adj", "kpp", "tke"):
            port, want = float(np.mean(ev[f"losses_{m}_T"])), float(np.mean(stored[f"losses_{m}_T"]))
            losses.setdefault(m, []).append(port)
            log(f"  {m}: port {port:.6e}, stored JAX run {want:.6e} (port / stored - 1 = {port / want - 1:+.4f})")
    summary = json.loads((eval_dir / "summary.json").read_text())
    means = {m: float(np.mean(v)) for m, v in losses.items()}
    rel = {m: means[m] / summary[m] - 1 for m in means}
    log(f"mean over ids {FC_EVAL_IDS}: " + ", ".join(f"{m} {means[m]:.6e} against {summary[m]:.6e} ({rel[m]:+.4f})"
                                                     for m in means) + f"; limit {FC_STORED_RTOL}")
    if not all(abs(r) <= FC_STORED_RTOL and np.isfinite(r) for r in rel.values()):
        raise RuntimeError(f"evaluate-fc: on {eval_dir.name}'s truth the port's losses differ from it by {rel}")
    return {"means": means, "stored": {m: summary[m] for m in means}, "rel": rel, "limit": FC_STORED_RTOL}


def calibrate_kpp_phase(dev, smi: str) -> dict:
    """Phase 33: calibrate-kpp on the 18 TRAIN_FILES with the JAX command's defaults: random, gradient, EKI."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri
    from climateparameterizations_jl_tpu_torch.train import eki as eki_mod
    from climateparameterizations_jl_tpu_torch.train import kpp_calibration as kc

    names = tuple(benchmarks.TRAIN_FILES)
    S, steps = len(names), KPP_TRAIN_STEPS - 1
    expected = {"random": steps * (2 + 3 * KPP_REFINE), "gradient": steps * (1 + 2 * KPP_REFINE),
                "eki": steps * (KPP_EKI_ITERS + 1)}
    pop, single, ladder = (3, KPP_PLUGIN, S, NZ), (3, S, NZ), (3, KPP_LADDER, S, NZ)
    want_shapes = {"random": {pop, single, ladder}, "gradient": {pop, single}, "eki": {(3, KPP_EKI_J, S, NZ)}}
    record = {}
    with phase(f"33 calibrate-kpp on the {S} TRAIN_FILES ({steps} KPP steps per solve): random ({KPP_PLUGIN} draws, "
               f"{KPP_REFINE} line-search iterations), gradient ({KPP_PLUGIN} + {KPP_REFINE} adam), EKI "
               f"({KPP_EKI_J} x {KPP_EKI_ITERS})"), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        originals = (cli._load_suite, kc.calibrate_kpp, eki_mod.calibrate_kpp_eki, tri._thomas_cuda)
        results = {}

        def calibrate(*args, **kw):
            params, info = originals[1](*args, **kw)
            results["info"] = info
            return params, info

        def calibrate_eki(*args, **kw):
            params, res = originals[2](*args, **kw)
            results["eki"] = res
            return params, res

        shape_rec, shapes = thomas_shapes(tri)
        cli._load_suite, kc.calibrate_kpp, eki_mod.calibrate_kpp_eki = cached_suites(cli, WM_SUITES), calibrate, \
            calibrate_eki
        tri._thomas_cuda = shape_rec
        try:
            for label in ("random", "gradient", "eki"):
                shapes.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                _cuda.reset_launch_counts()
                rc = cli.main(["calibrate-kpp", "--sims", ",".join(names), "--nz", str(NZ), "--n-save",
                               str(KPP_N_SAVE), "--dt-save", "600", "--n-train-steps", str(KPP_TRAIN_STEPS),
                               "--n-plugin", str(KPP_PLUGIN), "--n-line-search", str(KPP_REFINE), "--n-ensemble",
                               str(KPP_EKI_J), "--n-eki-iters", str(KPP_EKI_ITERS), "--calibration-method", label,
                               "--output", str(tmp / label)])
                launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                result = json.loads((tmp / label / "kpp_parameters.json").read_text())
                record[label] = {"s": wall, "launches": launches["thomas"], "expected": expected[label],
                                 "shapes": sorted(set(shapes)), "result": result}
                log(f"{label}: exit {rc}, {wall:.2f} s (the suite's generation in the first run), thomas "
                    f"{launches['thomas']} launches (expected {expected[label]}) of shapes {sorted(set(shapes))}; "
                    f"{result}")
                if rc != 0 or launches["thomas"] != expected[label] or set(shapes) != want_shapes[label]:
                    raise RuntimeError(f"calibrate-kpp {label}: exit {rc}, {launches}, shapes {set(shapes)}")
                if label != "eki":
                    info = results.pop("info")
                    hist = info["history"]
                    record[label].update(plugin_best_loss=info["plugin_best_loss"], final_loss=info["final_loss"],
                                         history=hist)
                    log(f"  plugin best {info['plugin_best_loss']:.6e}, adopted {info['final_loss']:.6e}; history "
                        f"{[f'{h:.4e}' for h in hist]}")
                    if not (all(math.isfinite(h) for h in hist)
                            and info["final_loss"] <= info["plugin_best_loss"] * (1 + KPP_LOSS_SLACK)):
                        raise RuntimeError(f"calibrate-kpp {label}: a loss is not finite or the plugin's best is lost")
            res = results["eki"]
            log(f"eki misfit {res.misfit_history[0]:.4e} -> {res.misfit_history[-1]:.4e} "
                f"({[f'{m:.3e}' for m in res.misfit_history]}); posterior std {res.theta_std.tolist()}")
            if not (res.misfit_history[-1] < res.misfit_history[0] and bool(torch.isfinite(res.theta_std).all())):
                raise RuntimeError("calibrate-kpp eki: the misfit did not fall")
            record["eki"]["misfit_history"] = res.misfit_history

            # The first population again (the plugin's draws of --seed 0) on the kernel and on the scan, and two of
            # its members alone: one solve of P sets is the P single solves, bit for bit.
            ds = cli._load_suite(list(names), NZ, None, KPP_N_SAVE, 600.0, device=dev)
        finally:
            cli._load_suite, kc.calibrate_kpp, eki_mod.calibrate_kpp_eki, tri._thomas_cuda = originals
        gen = torch.Generator().manual_seed(0)
        lo = torch.tensor([p[0] for p in kc.DEFAULT_PRIORS.values()], dtype=torch.float64)
        hi = torch.tensor([p[1] for p in kc.DEFAULT_PRIORS.values()], dtype=torch.float64)
        cand = lo + (hi - lo) * torch.rand((KPP_PLUGIN, len(lo)), generator=gen, dtype=torch.float64)
        tsteps = list(range(KPP_TRAIN_STEPS))
        with torch.no_grad():
            fwd_k, _ = kc.make_kpp_forward_fn(ds, tsteps, NZ)
            fwd_s, _ = kc.make_kpp_forward_fn(ds, tsteps, NZ, tridiag_backend="scan")
            got = fwd_k(cand)
            want = fwd_s(cand)
            singles = [bool(torch.equal(fwd_k(cand[i]), got[i])) for i in (0, KPP_PLUGIN - 1)]
        log(f"first population {tuple(got.shape)} (Thomas on {pop} = {KPP_PLUGIN * S} columns x 3): kernel vs scan "
            f"torch.equal {torch.equal(got, want)} (differing entries {int((got != want).sum())}); members 0 and "
            f"{KPP_PLUGIN - 1} alone equal their rows: {singles}")
        if not (torch.equal(got, want) and all(singles)):
            raise RuntimeError("calibrate-kpp: the population differs on kernel and scan, or from its single solves")
        record["population_kernel_equals_scan"] = True
        record["population_equals_singles"] = singles
        log(f"card: {smi}")
    return record


def blocked_gp_phase(dev, smi: str) -> dict:
    """Phase 34: the blocked f64 GP fit at n = 16,384 against the unblocked fit: seconds, peak memory, alphas."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.closures import gp
    from climateparameterizations_jl_tpu_torch.ops import _cuda, blocked_gp

    with phase(f"34 gp_fit_blocked at n = {BGP_N}, D = {BGP_D}, block {BGP_BLOCK}, f64, squared exponential (gamma "
               f"= sqrt(D)), against the unblocked gp_fit"):
        x, ys, z = benchmarks.gp_inputs(BGP_N, BGP_D, seed=0, device=dev)
        x, y, z = x.double(), ys[0].double(), z.double()
        kernel = gp.get_kernel(1, 0.5 * math.log10(BGP_D), device=dev)
        out = {}
        for label, fit in (("blocked", lambda: blocked_gp.gp_fit_blocked(x, y, kernel, z, block=BGP_BLOCK)[0]),
                           ("unblocked", lambda: gp.gp_fit(x, y, kernel, z))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            _cuda.reset_launch_counts()
            t = time.perf_counter()
            model = fit()
            torch.cuda.synchronize()
            out[label] = {"s": time.perf_counter() - t, "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
                          "launches": sum(k.launches for k in _cuda.KERNELS.values()), "alpha": model.alpha}
            log(f"{label}: {out[label]['s']:.3f} s, peak device memory above the inputs "
                f"{out[label]['peak_bytes'] / 2**30:.3f} GiB, hand-written kernel launches {out[label]['launches']}")
            del model
        a_b, a_u = out["blocked"].pop("alpha"), out["unblocked"].pop("alpha")
        rel = float((a_b - a_u).abs().max() / a_u.abs().max())
        log(f"alphas {tuple(a_b.shape)}: max |blocked - unblocked| / max |unblocked| = {rel:.3e} (limit {BGP_RTOL}); "
            f"finite {bool(torch.isfinite(a_b).all())}")
        if not (rel <= BGP_RTOL and bool(torch.isfinite(a_b).all())):
            raise RuntimeError("gp_fit_blocked disagrees with gp_fit")
        record = {**out, "alpha_rel": rel, "n": BGP_N, "D": BGP_D, "block": BGP_BLOCK}
        log(f"blocked GP record (no hand-written kernel runs here): {json.dumps(record)}")
        log(f"card: {smi}")
    return record


def host_column_phase(dev, flagship, smi: str) -> dict:
    """Phase 35: the paired host-column runs at full width on the Thomas kernel, the first saves against scan."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    steps = 2 * HOST_SAVES * HOST_SUBSTEPS
    with phase(f"35 the host column at full width: run_paired_columns over {HOST_COLUMNS} columns, flagship MLPs, "
               f"Nz = {NZ}, {HOST_SAVES} saves x {HOST_SUBSTEPS} host steps, baseline and +NN"):
        original = tri._thomas_cuda
        shape_rec, shapes = thomas_shapes(tri)
        tri._thomas_cuda = shape_rec
        try:
            _cuda.reset_launch_counts()
            stats = benchmarks.bench_host_column(HOST_COLUMNS, NZ, HOST_SAVES, HOST_SUBSTEPS, repeats=1, nns=flagship,
                                                 device=dev)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        finally:
            tri._thomas_cuda = original
        expected = steps * stats["calls"]
        log(f"backend {stats['tridiag_backend']}: ms per paired run {[round(t, 1) for t in stats['ms']]}, "
            f"{stats['ms_per_host_step']:.3f} ms per host step, column-timesteps/s {stats['column_timesteps_per_sec']:.4e}; "
            f"launch counts {launches}, expected thomas {expected} = 2 x {HOST_SAVES} x {HOST_SUBSTEPS} per run x "
            f"{stats['calls']} runs, shapes {sorted(set(shapes))}")
        if (stats["tridiag_backend"] != "cuda" or launches["thomas"] != expected
                or any(v for k, v in launches.items() if k != "thomas") or set(shapes) != {(3, HOST_COLUMNS, NZ)}):
            raise RuntimeError(f"host column: backend {stats['tridiag_backend']}, {launches}, shapes {set(shapes)}")

        setup = benchmarks.host_column_setup(HOST_COLUMNS, NZ, flagship, device=dev)
        got = benchmarks.host_column_forward(setup, HOST_CHECK_SAVES, HOST_SUBSTEPS, "cuda")
        scan_ms, want = cuda_ms(lambda: benchmarks.host_column_forward(setup, HOST_CHECK_SAVES, HOST_SUBSTEPS, "scan"))
        tiny = torch.finfo(torch.float32).tiny  # the smallest normal f32, 2^-126
        ok, differ, subnormal, total, worst = True, 0, 0, 0, 0.0
        for label, g, w in zip(("baseline", "with_nn"), got, want):
            for field in ("u", "v", "T"):
                a, b = getattr(g, field), getattr(w, field)
                mask = a != b
                differ += int(mask.sum())
                subnormal += int(((a != 0) & (a.abs() < tiny)).sum())
                if bool(mask.any()):
                    worst = max(worst, float((a - b).abs().max()))
                total += a.numel()
                ok = ok and bool(torch.isfinite(a).all())
        moved = float((got[1].T[-1] - got[0].T[-1]).abs().max())
        log(f"kernel vs scan over the first {HOST_CHECK_SAVES} saves ({HOST_CHECK_SAVES * HOST_SUBSTEPS} host steps per "
            f"run, both runs, u, v and T): entries that differ {differ} of {total} (limit 0; {subnormal} entries of the "
            f"kernel-backed run are subnormal, below {tiny:.3e}, where the kernel's quotients take the IEEE division), "
            f"largest difference {worst:.3e}; the scan-backed pair took {scan_ms:.1f} ms (information); the NN moved T "
            f"by up to {moved:.3e} K")
        if not ok or differ or not moved > 0.0:
            raise RuntimeError("host column: the kernel-backed pair is not the scan-backed one, or the NN did nothing")

        prof = benchmarks.profile_host_column(HOST_COLUMNS, NZ, HOST_PROFILE_SAVES, HOST_SUBSTEPS, nns=flagship,
                                              device=dev)
        log(f"profiled pair of {prof['substeps']} host steps (torch.profiler): wall {prof['wall_ms']:.1f} ms, device "
            f"busy {prof['device_busy_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}, {prof['device_ops']} "
            f"device ops ({prof['device_ops_per_substep']:.1f} per host step)")
        for key, n, ms in prof["top"]:
            log(f"  {key}: {n} x, {ms:.3f} ms")
        log(f"card: {smi}")
    return {"ms": stats["ms"], "ms_median": stats["ms_median"], "ms_per_host_step": stats["ms_per_host_step"],
            "column_timesteps_per_sec": stats["column_timesteps_per_sec"], "launches": launches["thomas"],
            "launches_per_run": steps, "runs": stats["calls"], "shape": [3, HOST_COLUMNS, NZ],
            "kernel_vs_scan": {"saves": HOST_CHECK_SAVES, "differ": differ, "of": total, "subnormal_entries": subnormal,
                               "max_abs_diff": worst},
            "scan_pair_ms": scan_ms,
            "profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "device_ops",
                                             "device_ops_per_substep")}}


def embedded_thomas_launches(spec: str, n_frames: int, substeps: int, maxiters: int, presolve: bool) -> tuple:
    """Thomas launches of a train-embedded(-fc) run from its curriculum: per stage ``w[:s]``, ``(points - 1) s
    substeps`` host steps per solve, three launches each per iteration (forward, checkpoint recompute, transposed
    IFT solve), plus one forward pre-solve per stage for the auto-balanced loss scalings (wind mixing). Returns the
    total and the host steps per stage."""
    stages = []
    for item in spec.split(","):
        w, _, s = item.partition(":")
        stride = int(s or 1)
        stages.append((len(range(0, min(int(w), n_frames), stride)) - 1) * stride * substeps)
    return sum((1 if presolve else 0) * n + 3 * n * maxiters for n in stages), stages


def train_embedded_phase(dev, setup, smi: str) -> dict:
    """Phase 36: train-embedded and train-embedded-fc in process on the card, each first stage again on scan."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.data import free_convection as fcd
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.train import nde

    names = tuple(benchmarks.TRAIN_FILES)
    record = {}
    common = ["--nz", str(NZ), "--n-save", str(NDE_N_SAVE), "--dt-save", "600", "--substeps", str(EMB_SUBSTEPS),
              "--maxiters", str(EMB_ITERS), "--lr", EMB_LR]
    wm_args = ["train-embedded", "--init-from", str(FLAGSHIP_RUN), "--sims", ",".join(names), *common, *NDE_FRACTIONS]
    fc_args = ["train-embedded-fc", "--init-from", str(FC_RUN), "--sim-ids", FC_IDS, *common]
    with phase(f"36 train-embedded ({len(names)} sims, curriculum {EMB_CURRICULUM}) and train-embedded-fc (ids "
               f"{FC_IDS}, curriculum {EMB_FC_CURRICULUM}) in process, {EMB_ITERS} iterations per stage, "
               f"{EMB_SUBSTEPS} host steps per save"), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        originals = (cli._load_suite, fcd.load_free_convection_suite)
        WM_SUITES[(names, NZ, None, NDE_N_SAVE, 600.0, 128)] = setup["ds"]  # phase 8's suite
        cli._load_suite = cached_suites(cli, WM_SUITES)
        fcd.load_free_convection_suite = fc_suites(originals[1])  # phase 24's nine-id suite

        def run(label, argv, spec, presolve):
            expected, stages = embedded_thomas_launches(spec, NDE_N_SAVE + 1, EMB_SUBSTEPS, EMB_ITERS, presolve)
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            rc = cli.main(argv)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            out = Path(argv[argv.index("--output") + 1])
            with open(out / "history.jsonl") as f:
                losses = [json.loads(line)["loss"] for line in f]
            scan = "--tridiag-backend" in argv
            want = 0 if scan else expected
            derived = "" if scan else f" = sum over stages of ({'1 pre-solve + ' * presolve}3 x {EMB_ITERS}) x host steps"
            log(f"{label}: exit {rc} in {wall:.2f} s; host steps per solve per stage {stages}; losses {losses}; launch "
                f"counts {launches}, expected thomas {want}{derived}")
            if (rc != 0 or launches["thomas"] != want or any(v for k, v in launches.items() if k != "thomas")
                    or len(losses) != len(stages) * EMB_ITERS or not all(math.isfinite(v) for v in losses)):
                raise RuntimeError(f"{label}: exit {rc}, launches {launches} (expected {want}), losses {losses}")
            return {"s": wall, "launches": launches["thomas"], "expected": want, "host_steps": stages,
                    "losses": losses}

        try:
            for kind, argv, spec, presolve in (("train-embedded", wm_args, EMB_CURRICULUM, True),
                                               ("train-embedded-fc", fc_args, EMB_FC_CURRICULUM, False)):
                out_a, out_b, out_c = (str(tmp / f"{kind}_{x}") for x in "abc")
                first = spec.split(",")[0]
                a = run(f"{kind} A (kernel)", [*argv, "--curriculum", spec, "--output", out_a], spec, presolve)
                b = run(f"{kind} B (resumed from A, first stage)", [*argv, "--curriculum", first, "--resume-from", out_a,
                                                                   "--output", out_b], first, presolve)
                c = run(f"{kind} C (scan, first stage)", [*argv, "--curriculum", first, "--tridiag-backend", "scan",
                                                          "--output", out_c], first, presolve)
                n = len(c["losses"])
                rel = [abs(k - s_) / abs(s_) for k, s_ in zip(a["losses"][:n], c["losses"])]
                log(f"{kind}: first stage, kernel {a['losses'][:n]} vs scan {c['losses']}: rel {rel} (limit "
                    f"{STEP_LOSS_RTOL}); resumed run's losses {b['losses']} against A's first {a['losses'][:n]}")
                if not all(r <= STEP_LOSS_RTOL for r in rel):
                    raise RuntimeError(f"{kind}: kernel and scan losses differ by {rel}")
                if b["losses"][0] == a["losses"][0]:
                    raise RuntimeError(f"{kind}: the resumed run starts from A's initial parameters, not its end")
                record[kind] = {"run_a": a, "run_b_resumed": b, "run_c_scan": c, "kernel_vs_scan_rel": rel}
        finally:
            cli._load_suite, fcd.load_free_convection_suite = originals
        log(f"card: {smi}")
    return record


def evaluate_embedded_phase(evaluate: dict, evaluate_fc: dict, smi: str) -> dict:
    """Phase 37: the embedded pairs of the evaluate --embedded and evaluate-fc --embedded runs of phases 31 and 32.

    One run of each command serves both phases (their launch counts, which include the host pair, are held there):
    here the pair's channels must be in the first file of each and its members in each summary, which the
    wind-mixing one prints beside the stored JAX run of the same command and checkpoint.
    """
    members = ("embedded", "embedded_baseline")
    with phase("37 the embedded pairs: evaluate --embedded (phase 31's run) and evaluate-fc --embedded (phase 32's)"):
        wm_keys = {f"{m}_{c}" for m in members for c in ("u", "v", "T", "uw", "vw", "wT", "Ri")}
        fc_keys = {"embedded_T", "embedded_baseline_T", "embedded_wT"}
        missing = sorted((wm_keys - set(evaluate["keys"])) | (fc_keys - set(evaluate_fc["keys"])))
        absent = [m for m in members if m not in evaluate["summary"] or m not in evaluate_fc["summary"]]
        log(f"evaluate --embedded: {evaluate['s']:.2f} s for {evaluate['sims']} sims, thomas {evaluate['launches']}; "
            f"evaluate-fc --embedded: {evaluate_fc['s']:.2f} s for ids {FC_EVAL_IDS}, thomas {evaluate_fc['launches']}; "
            f"embedded channels missing {missing}, members missing from a summary {absent}")
        if missing or absent:
            raise RuntimeError(f"embedded evaluation: channels {missing} or members {absent} missing")
        log("mean scaled T loss per member of evaluate --embedded, beside the stored JAX run (runs/"
            "wm_flagship_default_eval/summary.json; information only: the card's suites are the port's f32 stand-ins, "
            "not JAX's. The gap of embedded to the stored run is explained (ROADMAP.md queue 3, item 3a): the stored "
            "run's stand-ins had a bottom gradient of 0.002 K/m, the port's (as the JAX package's now) 0; on the "
            "stored truth with that gradient, embedded_stored_truth.py --stored-bottom-gradient gives embedded "
            "8.905e-5 against the stored 8.918e-5, on the CPU):")
        log(f"  (the port's mean over the first {evaluate['sims']} held-out sims, the stored run's over all three)")
        _summary_beside(evaluate["summary"], EMBEDDED_EVAL / "summary.json", flat=False)
        log(f"evaluate-fc --embedded, the stand-ins of ids {FC_EVAL_IDS}: "
            + ", ".join(f"{m} {evaluate_fc['summary'][m]:.6e}" for m in members))
        log(f"card: {smi}")
    return {m: {"evaluate": evaluate["summary"][m], "evaluate_fc": evaluate_fc["summary"][m]} for m in members}


def double_gyre_phase(dev, smi: str) -> dict:
    """Phase 38: bench_double_gyre on the Thomas kernel against scan, then the double-gyre command for 5 days."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.embed import double_gyre as dg
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    record = {}
    with phase(f"38 the double gyre: bench_double_gyre ({GYRE_N} x {GYRE_N} x {GYRE_NZ}, WENO5, {GYRE_STEPS} steps of "
               f"1,800 s, the FC MLP on every column), then double-gyre --checkpoint {FC_RUN.name} --days {GYRE_DAYS}"), \
            tempfile.TemporaryDirectory() as tmp:
        original = tri._thomas_cuda
        shape_rec, shapes = thomas_shapes(tri)
        tri._thomas_cuda = shape_rec
        try:
            _cuda.reset_launch_counts()
            stats = benchmarks.bench_double_gyre(GYRE_N, GYRE_N, GYRE_NZ, GYRE_STEPS, repeats=GYRE_REPEATS, device=dev)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        finally:
            tri._thomas_cuda = original
        expected = 3 * GYRE_STEPS * stats["calls"]
        log(f"backend {stats['tridiag_backend']}: ms per {GYRE_STEPS}-step run {[round(t, 1) for t in stats['ms']]}, "
            f"{stats['ms_per_step']:.2f} ms per step, basin column-timesteps/s {stats['column_timesteps_per_sec']:.4e}; "
            f"launch counts {launches}, expected thomas {expected} = 3 x {GYRE_STEPS} x {stats['calls']} runs, shapes "
            f"{sorted(set(shapes))}")
        if (stats["tridiag_backend"] != "cuda" or launches["thomas"] != expected
                or any(v for k, v in launches.items() if k != "thomas") or set(shapes) != GYRE_SHAPES):
            raise RuntimeError(f"bench_double_gyre: backend {stats['tridiag_backend']}, {launches}, shapes {set(shapes)}")

        setup = benchmarks.double_gyre_setup(GYRE_N, GYRE_N, GYRE_NZ, device=dev)
        got = benchmarks.double_gyre_forward(setup, GYRE_STEPS, "cuda")
        scan_ms, want = cuda_ms(lambda: benchmarks.double_gyre_forward(setup, GYRE_STEPS, "scan"))
        differ = {f: int((getattr(got, f) != getattr(want, f)).sum()) for f in ("u", "v", "T", "eta")}
        same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("u", "v", "T", "eta"))
        log(f"kernel vs scan trajectory ({GYRE_STEPS} steps): entries that differ {differ}; the scan-backed run took "
            f"{scan_ms:.1f} ms (information)")
        if not same:
            raise RuntimeError(f"double gyre: the kernel-backed run is not the scan-backed one ({differ})")

        prof = benchmarks.profile_double_gyre(GYRE_N, GYRE_N, GYRE_NZ, GYRE_PROFILE_STEPS, device=dev)
        log(f"profiled run of {GYRE_PROFILE_STEPS} steps (torch.profiler): wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}, {prof['device_ops']} device "
            f"ops ({prof['device_ops_per_substep']:.1f} per step)")
        for key, n, ms in prof["top"]:
            log(f"  {key}: {n} x, {ms:.3f} ms")

        kept = {}
        run_original = dg.run_double_gyre

        def keep(*args, **kw):
            kept["traj"] = run_original(*args, **kw)
            return kept["traj"]

        dg.run_double_gyre = keep
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            rc = cli.main(["double-gyre", "--checkpoint", str(FC_RUN), "--days", str(GYRE_DAYS),
                           "--output", str(Path(tmp) / "gyre")])
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            dg.run_double_gyre = run_original
        traj = kept["traj"]
        n_steps = int(GYRE_DAYS * 86400 / 1800)
        with np.load(Path(tmp) / "gyre" / "double_gyre.npz") as out:
            psi = out["psi"]
        volume = float(traj.eta.mean(dim=(1, 2)).abs().max())
        walls = max(float(traj.u[:, :, 0].abs().max()), float(traj.u[:, :, -1].abs().max()),
                    float(traj.v[:, 0].abs().max()), float(traj.v[:, -1].abs().max()))
        finite = all(bool(torch.isfinite(x).all()) for x in (traj.u, traj.v, traj.T, traj.eta))
        log(f"double-gyre: exit {rc} in {wall:.2f} s ({wall / n_steps * 1e3:.2f} ms per step), {traj.T.shape[0]} frames; "
            f"launch counts {launches}, expected thomas {3 * n_steps}; psi {psi.min():.4f} to {psi.max():.4f} Sv; "
            f"max |mean eta| over frames {volume:.3e} m (limit {GYRE_VOLUME_ATOL}); max |normal velocity| on the walls "
            f"{walls} (must be 0); all finite {finite}")
        if (rc != 0 or launches["thomas"] != 3 * n_steps or any(v for k, v in launches.items() if k != "thomas")
                or not finite or volume > GYRE_VOLUME_ATOL or walls != 0.0):
            raise RuntimeError(f"double-gyre: exit {rc}, launches {launches}, volume {volume}, walls {walls}, "
                               f"finite {finite}")
        record = {"bench": {k: stats[k] for k in ("ms", "ms_median", "ms_per_step", "column_timesteps_per_sec",
                                                   "calls")},
                  "launches": launches["thomas"], "shapes": sorted(GYRE_SHAPES), "scan_run_ms": scan_ms,
                  "profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share", "device_ops",
                                                   "device_ops_per_substep")},
                  "command": {"s": wall, "steps": n_steps, "psi_min_Sv": float(psi.min()),
                              "psi_max_Sv": float(psi.max()), "volume": volume}}
        log(f"card: {smi}")
    return record


def les_phase(dev, smi: str) -> dict:
    """Phase 39: the 3-D LES on the card: bench_les, kernel against scan, generate-les and the les3d source."""
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.data import free_convection as fcd
    from climateparameterizations_jl_tpu_torch.data import les
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    bench_shape = (2, LES_N, LES_N // 2 + 1, LES_NZ)
    record: dict = {}
    with phase(f"39 the 3-D LES: bench_les ({LES_N}^2 x {LES_NZ}, {LES_STEPS} Euler steps), kernel vs scan, "
               f"generate-les (32^3, RK3, {LES_GEN_N_SAVE} saves) and the les3d source (64 x 64 x 128, "
               f"{LES_FC_N_SAVE} saves)"), tempfile.TemporaryDirectory() as tmp:
        original = tri._thomas_cuda
        shape_rec, shapes = thomas_shapes(tri)
        tri._thomas_cuda = shape_rec
        try:
            # (a) bench_les
            _cuda.reset_launch_counts()
            b = benchmarks.bench_les(LES_N, LES_NZ, LES_STEPS, repeats=LES_REPEATS, profile_steps=LES_PROFILE_STEPS,
                                     device=dev)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            expected = (b["calls"] + 1) * LES_STEPS + 2 * LES_PROFILE_STEPS
            prof = b["profile"]
            log(f"(a) bench_les: dt {b['dt_s']:.3f} s, ms per run of {LES_STEPS} steps {[round(t, 1) for t in b['ms']]}, "
                f"{b['ms_per_step']:.3f} ms per step, cell-steps/s {b['cell_steps_per_sec']:.4e}; thomas launches per "
                f"step {b['thomas_launches_per_step']} on {b['thomas_systems']} x {b['thomas_N']}; launch counts "
                f"{launches}, expected thomas {expected} = ({b['calls']} timed + 1 counted) x {LES_STEPS} + 2 x "
                f"{LES_PROFILE_STEPS} (profiled); shapes {sorted(set(shapes))}")
            log(f"    profiled run of {prof['substeps']} steps: wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}, "
                f"{prof['device_ops_per_substep']:.1f} device ops per step; thomas {prof['kernel_ms']:.3f} ms over "
                f"{prof['kernel_launches_recorded']} recorded launches, {prof['thomas_device_share']:.4f} of the "
                f"device time")
            for key, n, ms in prof["top"]:
                log(f"      {key}: {n} x, {ms:.3f} ms")
            if (b["tridiag_backend"] != "cuda" or launches["thomas"] != expected or b["thomas_launches_per_step"] != 1
                    or any(v for k, v in launches.items() if k != "thomas") or set(shapes) != {bench_shape}):
                raise RuntimeError(f"bench_les: backend {b['tridiag_backend']}, {launches}, shapes {set(shapes)}")
            record["bench_les"] = {k: b[k] for k in ("ms", "ms_median", "ms_per_step", "cell_steps_per_sec", "dt_s",
                                                     "thomas_launches_per_step", "thomas_systems", "thomas_N")}
            record["bench_les"]["launches"] = launches["thomas"]
            record["bench_les"]["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                                   "device_ops_per_substep", "kernel_ms",
                                                                   "thomas_device_share")}

            # (b) kernel against scan, step by step
            setup = benchmarks.les_setup(LES_N, LES_NZ, device=dev)
            c, dt = setup["config"], setup["dt"]
            sk = ss = setup["state0"]
            del shapes[:]
            _cuda.reset_launch_counts()
            divs, first_differ = [], None
            for k in range(LES_EULER_STEPS + LES_RK3_STEPS):
                method = "euler" if k < LES_EULER_STEPS else "rk3"
                sk = les.les_step(c, sk, dt, method, tridiag_backend="cuda")
                ss = les.les_step(c, ss, dt, method, tridiag_backend="scan")
                same = all(torch.equal(getattr(sk, f), getattr(ss, f)) for f in ("u", "v", "w", "T"))
                if not same and first_differ is None:
                    first_differ = k
                divs.append(float(les._divergence(c, sk.u, sk.v, sk.w).abs().max()))
            torch.cuda.synchronize()
            launches_b = _cuda.THOMAS.launches
            expected_b = LES_EULER_STEPS + 3 * LES_RK3_STEPS
            finite = all(bool(torch.isfinite(getattr(sk, f)).all()) for f in ("u", "v", "w", "T"))
            log(f"(b) {LES_EULER_STEPS} Euler + {LES_RK3_STEPS} RK3 steps at {LES_N}^2 x {LES_NZ}, kernel vs scan: "
                f"first step where a field differs {first_differ} (none: equal throughout); thomas launches "
                f"{launches_b} (expected {expected_b}) on {sorted(set(shapes))}; max |div| per step max {max(divs):.3e} "
                f"(limit {LES_DIV_LIMIT}), last {divs[-1]:.3e}; max |u| {float(sk.u.abs().max()):.4e} m/s, max |w| "
                f"{float(sk.w.abs().max()):.4e} m/s")
            if (first_differ is not None or not finite or max(divs) > LES_DIV_LIMIT or launches_b != expected_b
                    or set(shapes) != {bench_shape}):
                raise RuntimeError("LES: the kernel-backed run is not the scan-backed one, or it is not divergence-free")
            record["kernel_vs_scan"] = {"steps": LES_EULER_STEPS + LES_RK3_STEPS, "equal": True,
                                        "max_div": max(divs), "launches": launches_b}

            # (c) generate-les
            out = Path(tmp) / "les"
            del shapes[:]
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rc = cli.main(["generate-les", "--n-save", str(LES_GEN_N_SAVE), "--output", str(out)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            ds = fcd.load_column_npz(str(out / "les_profiles.npz"))
            save_every = int(round(600.0 / 24.0))
            steps = LES_GEN_N_SAVE * save_every
            finite = all(bool(torch.isfinite(getattr(ds, f)).all()) for f in ("u", "v", "T", "uw", "vw", "wT"))
            dz = float(ds.H) / ds.T.shape[-1]
            heat = ds.T.double().sum(-1) * dz
            span = float(ds.t[-1] - ds.t[0])
            want_dH = -(float(ds.theta_top) + 1e-5 * float(ds.theta_bottom)) * span
            ratio = float(heat[-1] - heat[0]) / want_dH
            log(f"(c) generate-les: exit {rc} in {wall:.2f} s ({wall / steps * 1e3:.2f} ms per RK3 step), frames "
                f"{ds.T.shape[0]} (expected {LES_GEN_N_SAVE + 1}), finite {finite}; launch counts {launches}, expected "
                f"thomas {3 * steps} = 3 x {steps} RK3 steps on {sorted(set(shapes))}; heat content change "
                f"{float(heat[-1] - heat[0]):.4e} K m against the surface and bottom fluxes' {want_dH:.4e} K m: ratio "
                f"{ratio:.3f} (the CPU f32 run: {LES_HEAT_RATIO_CPU}; limit {LES_HEAT_RATIO_RTOL:.0%} of it)")
            if (rc != 0 or ds.T.shape[0] != LES_GEN_N_SAVE + 1 or not finite or launches["thomas"] != 3 * steps
                    or any(v for k, v in launches.items() if k != "thomas") or set(shapes) != {(2, 32, 17, 32)}
                    or not abs(ratio / LES_HEAT_RATIO_CPU - 1) <= LES_HEAT_RATIO_RTOL):
                raise RuntimeError(f"generate-les: exit {rc}, frames {ds.T.shape[0]}, finite {finite}, {launches}, "
                                   f"shapes {set(shapes)}, heat ratio {ratio}")
            record["generate_les"] = {"s": wall, "steps": steps, "launches": launches["thomas"], "heat_ratio": ratio}

            # (d) the free-convection les3d source at the full box, through a cache
            cache = str(Path(tmp) / "cache")
            del shapes[:]
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            first = fcd.load_free_convection_simulation(1, n_save=LES_FC_N_SAVE, source="les3d", les_cache_dir=cache,
                                                        device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches_d = _cuda.THOMAS.launches
            again = fcd.load_free_convection_simulation(1, n_save=LES_FC_N_SAVE, source="les3d", les_cache_dir=cache,
                                                        device=dev)
            steps = LES_FC_N_SAVE * 50
            same = all(torch.equal(getattr(first, f), getattr(again, f)) for f in ("u", "v", "T", "uw", "vw", "wT", "t"))
            finite = all(bool(torch.isfinite(getattr(first, f)).all()) for f in ("u", "v", "T", "uw", "vw", "wT"))
            log(f"(d) les3d source, id 1 at 64 x 64 x 128: {wall:.2f} s ({wall / steps * 1e3:.2f} ms per RK3 step), "
                f"coarse T {tuple(first.T.shape)}, finite {finite}; thomas launches {launches_d} (expected {3 * steps} "
                f"= 3 x {steps} RK3 steps) on {sorted(set(shapes))}; then {_cuda.THOMAS.launches - launches_d} more "
                f"for the cached load, which equals the first: {same}")
            if (launches_d != 3 * steps or _cuda.THOMAS.launches != launches_d or not same or not finite
                    or first.T.shape != (LES_FC_N_SAVE + 1, NZ) or set(shapes) != {(2, 64, 33, 128)}):
                raise RuntimeError("les3d source: wrong launches or shapes, or the cached load differs")
            record["les3d_source"] = {"s": wall, "steps": steps, "launches": launches_d}
        finally:
            tri._thomas_cuda = original
        log(f"card: {smi}")
    return record


def column_ensemble_phase(dev, setup, smi: str) -> dict:
    """Phase 40: the column ensemble on one card: bench_column_ensemble, kernel vs scan, the ensemble command."""
    import contextlib
    import io

    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri
    from climateparameterizations_jl_tpu_torch.parallel import sharding
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    names = tuple(benchmarks.TRAIN_FILES)
    record: dict = {}
    with phase(f"40 the column ensemble: bench_column_ensemble ({ENSEMBLE_MEMBERS} members x {ENSEMBLE_STEPS} split "
               f"substeps), kernel vs scan, the ensemble command on phase 8's {len(names)}-sim suite"), \
            tempfile.TemporaryDirectory() as tmp:
        original, original_suite = tri._thomas_cuda, cli._load_suite
        shape_rec, shapes = thomas_shapes(tri)
        tri._thomas_cuda = shape_rec
        try:
            _cuda.reset_launch_counts()
            b = benchmarks.bench_column_ensemble(ENSEMBLE_MEMBERS, NZ, ENSEMBLE_STEPS, repeats=ENSEMBLE_REPEATS,
                                                 device=dev)
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            expected = b["calls"] * ENSEMBLE_STEPS
            log(f"bench_column_ensemble: ms per solve {[round(t, 1) for t in b['ms']]}, column-timesteps/s "
                f"{b['column_timesteps_per_sec']:.4e}; launch counts {launches}, expected thomas {expected} = "
                f"{b['calls']} solves x {ENSEMBLE_STEPS} substeps; shapes {sorted(set(shapes))}")
            if (launches["thomas"] != expected or b["thomas_launches"] != expected
                    or any(v for k, v in launches.items() if k != "thomas")
                    or set(shapes) != {(3, ENSEMBLE_MEMBERS, NZ)}):
                raise RuntimeError(f"bench_column_ensemble: {launches}, shapes {set(shapes)}")
            record["bench"] = {k: b[k] for k in ("ms", "ms_median", "column_timesteps_per_sec", "thomas_launches")}

            model, nns, bcs, x0 = benchmarks.column_ensemble_setup(ENSEMBLE_MEMBERS, NZ, dev)
            mesh = sharding.make_mesh(device=dev)
            trajs = {}
            for backend in ("cuda", "scan"):
                config = NDETrainConfig(n_substeps=ENSEMBLE_STEPS, method="split", tridiag_backend=backend)
                trajs[backend] = sharding.make_sharded_ensemble_solver(model, config, mesh)(
                    nns, bcs, x0, 0.0, 1e-5 * ENSEMBLE_STEPS, 1)
            same = torch.equal(trajs["cuda"], trajs["scan"])
            log(f"kernel vs scan, {ENSEMBLE_MEMBERS} members x {ENSEMBLE_STEPS} substeps: torch.equal {same} (differing "
                f"entries {int((trajs['cuda'] != trajs['scan']).sum())} of {trajs['cuda'].numel()})")
            if not same:
                raise RuntimeError("ensemble: the kernel-backed solve differs from the scan-backed one")

            WM_SUITES[(names, NZ, None, NDE_N_SAVE, 600.0, 128)] = setup["ds"]  # phase 8's suite
            cli._load_suite = cached_suites(cli, WM_SUITES)
            del shapes[:]
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = Path(tmp) / "ensemble"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["ensemble", "--sims", ",".join(names), "--n-save", str(NDE_N_SAVE), "--checkpoint",
                               str(FLAGSHIP_RUN), "--output", str(out)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            expected = (32 - 1) * 4  # the command's defaults: 32 frames, 4 substeps per save
            log(f"ensemble command: exit {rc} in {wall:.2f} s, {line}; launch counts {launches}, expected thomas "
                f"{expected} = 31 saves x 4 substeps on {sorted(set(shapes))}")
            if (rc != 0 or not line["finite"] or line["members"] != 256 or line["frames"] != 32
                    or launches["thomas"] != expected or set(shapes) != {(3, 256, NZ)}
                    or not line["final_mean_spread"] > 0.0):
                raise RuntimeError(f"ensemble command: exit {rc}, {line}, {launches}, shapes {set(shapes)}")
            record["command"] = {"s": wall, "launches": launches["thomas"], **line}
        finally:
            tri._thomas_cuda, cli._load_suite = original, original_suite
        log(f"card: {smi}")
    return record


def _first_frames(ds, n: int, device="cpu"):
    """A suite cut to its first ``n`` saved frames, on ``device`` (the CPU: to hand to the spawned ranks). The
    stand-ins are generated save by save, so this equals the suite generated with ``n`` frames, bit for bit."""
    cut = {f: getattr(ds, f)[..., :n, :] for f in ("u", "v", "T", "uw", "vw", "wT")}
    return dataclasses.replace(ds, **cut, t=ds.t[..., :n]).to(device)


def parallel_setups(dev, inputs: dict) -> dict:
    """Phase 43's inputs for every path of ``parallel/dryrun.py``, at the flagship widths, on ``dev``."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling
    from climateparameterizations_jl_tpu_torch.models.free_convection import FreeConvectionModel
    from climateparameterizations_jl_tpu_torch.train.checkpoint import _map_leaves, load_fc_run, load_flux_nns, load_run
    from climateparameterizations_jl_tpu_torch.train.deep_ensemble import ensemble_loss_scalings
    from climateparameterizations_jl_tpu_torch.train.embedded import (
        embedded_fc_training_tensors,
        embedded_training_tensors,
        host_from_fc_suite,
        host_from_suite,
    )
    from climateparameterizations_jl_tpu_torch.train.kpp_calibration import DEFAULT_PRIORS, make_kpp_forward_fn
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig

    to = lambda tree: _map_leaves(tree, lambda _k, x: x.to(dev))  # noqa: E731
    model, batch, ds, config = to(inputs["model"]), to(inputs["batch"]), inputs["ds"].to(dev), inputs["config"]
    nns = load_flux_nns(str(FLAGSHIP_RUN), dev)
    stacked, _ = load_run(str(ENS_RUN), dev)
    de_config = dataclasses.replace(config, training_fractions=None)
    de_frames = PAR_ENS_SUBSTEPS // config.n_substeps + 1
    de_batch = dataclasses.replace(batch, targets=batch.targets[:, :de_frames], t=batch.t[:de_frames])
    fc_nn, fc_meta = load_fc_run(str(FC_RUN), dev)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    sc = fc_meta["scalings"]
    T_scaling = ZeroMeanUnitVarianceScaling(f(sc["T"]["mu"]), f(sc["T"]["sigma"]))
    fc_model = FreeConvectionModel(H=model.H, tau=model.tau, T_scaling=T_scaling,
                                   wT_scaling=ZeroMeanUnitVarianceScaling(f(sc["wT"]["mu"]), f(sc["wT"]["sigma"])),
                                   bottom_flux=f(0.0), top_flux=f(0.0), kappa=model.kappa, Nz=NZ)
    emb_config = NDETrainConfig(n_substeps=EMBEDDED_SUBSTEPS, learning_rate=config.learning_rate)
    emb_tsteps = np.arange(PAR_EMB_FRAMES)
    e_model, e_nns, e_bcs, e_x0 = benchmarks.column_ensemble_setup(ENSEMBLE_MEMBERS, NZ, dev)
    gen = torch.Generator().manual_seed(43)
    S = batch.x0.shape[0]
    suite_x0 = batch.x0[:, None, :] + 0.05 * torch.randn((S, PAR_SUITE_MEMBERS, 3 * NZ), generator=gen).to(dev)
    x_gp, ys_gp, z_gp = benchmarks.gp_inputs(GP_N, GP_D, device=dev)
    x_val, ys_val, _ = benchmarks.gp_inputs(PAR_GP_VAL, GP_D, seed=1, device=dev)
    kpp_forward, kpp_y = make_kpp_forward_fn(ds, np.arange(PAR_EKI_FRAMES), NZ)
    les = benchmarks.les_setup(LES_N, LES_NZ, dev)
    gyre = benchmarks.double_gyre_setup(GYRE_N, GYRE_N, GYRE_NZ, device=dev)
    return {
        "nde_step": dict(model=model, nns=nns, batch=batch, config=config, optimizer="adam"),
        "deep_ensemble_step": dict(model=model, stacked=stacked, batch=de_batch, config=de_config, optimizer="adam",
                                   scalings=ensemble_loss_scalings(model, stacked, de_batch, de_config)),
        # sgd, as the JAX package's embedded-step tests: adam's m / sqrt(v) turns the reduction order's rounding
        # on near-zero gradient components of the trained closures into full steps of either sign.
        "embedded_step": dict(host=host_from_suite(model, ds), nns=nns, config=emb_config, optimizer="sgd",
                              batch=embedded_training_tensors(ds, model.scalings, emb_tsteps)),
        "embedded_fc_step": dict(host=host_from_fc_suite(fc_model, ds), nns=fc_nn, config=emb_config,
                                 optimizer="sgd", batch=embedded_fc_training_tensors(ds, T_scaling, emb_tsteps)),
        "ensemble_solver": dict(model=e_model, nns=e_nns, bcs=e_bcs, x0=e_x0, t0=0.0,
                                config=NDETrainConfig(n_substeps=ENSEMBLE_STEPS, method="split"),
                                dt_save=1e-5 * ENSEMBLE_STEPS, n_save=1),
        "suite_ensemble_solver": dict(model=model, nns=nns, bcs=batch.bcs, x0=suite_x0, t0=0.0,
                                      config=NDETrainConfig(n_substeps=PAR_SUITE_SUBSTEPS, method="split"),
                                      dt_save=float(batch.t[1] - batch.t[0]), n_save=2),
        "kernel_search": dict(x_train=x_gp, y_train=ys_gp[2], x_val=x_val, y_val=ys_val[2], z=z_gp,
                              kernel_ids=PAR_GP_KERNELS, log_gammas=None),
        "eki": dict(forward=kpp_forward, y_obs=kpp_y, priors=dict(DEFAULT_PRIORS), n_ensemble=PAR_EKI_MEMBERS,
                    n_iterations=PAR_EKI_ITERS, seed=0),
        "les": dict(config=les["config"], state=les["state0"], dt=les["dt"], method="rk3", n_steps=LES_RK3_STEPS),
        "gyre": dict(model=gyre["model"], state=gyre["state0"], dt=1800.0, n_steps=PAR_GYRE_STEPS, nn=gyre["nn"],
                     T_scaling=gyre["T_scaling"], wT_scaling=gyre["wT_scaling"]),
    }


def parallel_rank(inputs: dict) -> dict | None:
    """One rank of phase 43 (spawned on NCCL): every path of ``dryrun_multichip`` at the flagship widths.

    Returns rank 0's records (the other ranks return ``None``).
    """
    import torch

    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.parallel import dryrun, sharding, world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    _cuda.load_all()  # built by phase 2: each library is loaded from its cache
    mesh = sharding.make_mesh()
    dev = world.device_of(mesh)
    ready_s = time.perf_counter() - t
    t = time.perf_counter()
    setups = parallel_setups(dev, inputs)
    setup_s = time.perf_counter() - t
    if world.is_rank0():
        log(f"rank 0: kernels loaded and mesh made in {ready_s:.2f} s, set-up {setup_s:.2f} s")
    records = {}
    for name in dryrun.PATHS:  # dryrun_multichip's loop, with a line per path
        t = time.perf_counter()
        records[name] = dryrun.run_path(name, setups[name], mesh)
        if world.is_rank0():
            log(f"rank 0: {name} and its unsharded run in {time.perf_counter() - t:.2f} s")
    return {"records": records, "setup_s": setup_s} if world.is_rank0() else None


def cut_control(dev, setup: dict) -> dict:
    """The split solve against how its block is cut, on one card: phase 43's 2-D suite block (the first sims, an
    even number, x 64 members) solved whole and as the four tiles of a (2, 2) ``("sim", "ens")`` mesh, with the packed
    chain's products in fixed row blocks (``models/wind_mixing.py::_rows_product``, must be equal) and, as the
    control, as plain ``@`` GEMMs (cuBLAS picks its kernel by the row count; printed, not checked); then the first
    ``ROW_BLOCK`` rows of each packed layer's product at several row counts against the same rows at two blocks."""
    import torch

    from climateparameterizations_jl_tpu_torch.models import wind_mixing as wm
    from climateparameterizations_jl_tpu_torch.train.checkpoint import _map_leaves, load_flux_nns
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, solve_with_config

    model, batch = setup["model"], setup["batch"]
    nns = load_flux_nns(str(FLAGSHIP_RUN), dev)
    S, E = batch.x0.shape[0] - batch.x0.shape[0] % 2, PAR_SUITE_MEMBERS
    gen = torch.Generator().manual_seed(43)
    x0 = (batch.x0[:S, None, :] + 0.05 * torch.randn((S, E, 3 * NZ), generator=gen).to(dev)).contiguous()
    sims = lambda lo, hi: _map_leaves(batch.bcs, lambda _k, b: b[lo:hi] if b.dim() == 1 else b)  # noqa: E731
    h, half = S // 2, E // 2
    config = NDETrainConfig(n_substeps=PAR_SUITE_SUBSTEPS, method="split")
    dt = float(batch.t[1] - batch.t[0])
    record, original = {}, wm._rows_product
    for name, product in (("rows_product", original), ("plain_gemm", lambda x, A: x @ A)):
        wm._rows_product = product
        try:
            with torch.no_grad():
                whole = solve_with_config(model, nns, sims(0, S), x0, 0.0, dt, 2, config)
                cut = torch.cat([torch.cat([
                    solve_with_config(model, nns, sims(i * h, (i + 1) * h),
                                      x0[i * h:(i + 1) * h, j * half:(j + 1) * half].contiguous(), 0.0, dt, 2, config)
                    for j in range(2)], dim=2) for i in range(2)], dim=1)
        finally:
            wm._rows_product = original
        diff = (cut - whole).abs()
        record[name] = {"differ": int((diff > 0).sum()), "max_abs": float(diff.max()), "entries": whole.numel()}
        log(f"cut control, {name}: ({S}, {E}) block whole vs four ({h}, {half}) tiles, {PAR_SUITE_SUBSTEPS} "
            f"substeps x 2 saves: {record[name]['differ']} of {whole.numel()} entries differ, max_abs "
            f"{record[name]['max_abs']:.3e}")
    counts = tuple(k * wm.ROW_BLOCK for k in (2, 3, 8, 9, 144))
    packed = wm.pack_flux_nns(nns)
    unit = lambda *r: torch.as_tensor(wm.divergence_matrix(*r, NZ), dtype=torch.float32, device=dev)  # noqa: E731
    Ru, Rv, RT = wm._tendency_coefficients(model)
    Dr = Ru * unit(1.0, 0.0, 0.0) + Rv * unit(0.0, 1.0, 0.0) + RT * unit(0.0, 0.0, 1.0)
    # The three layers, then the last one padded and folded with the divergence, as the split solve runs it.
    for layer, A in enumerate((*packed.matrices, wm._pad_packed_chain(packed, NZ)[0][-1] @ Dr)):
        inputs = torch.randn((max(counts), A.shape[0]), generator=gen).to(dev)
        for name, product in (("rows_product", original), ("plain_gemm", lambda x, A: x @ A)):
            first = product(inputs[:counts[0]], A)[:wm.ROW_BLOCK]
            differ = {n: int((product(inputs[:n], A)[:wm.ROW_BLOCK] != first).sum()) for n in counts[1:]}
            record[f"layer{layer}_{name}"] = differ
            log(f"cut control, layer {layer} {tuple(A.shape)}, {name}: the first {wm.ROW_BLOCK} rows at {counts[0]} "
                f"rows against {list(differ)} rows, entries differing {list(differ.values())}")
    if dev.type == "cuda":  # the folded chain's cost both ways: CUDA events, median of 50 after 10 warm-ups
        mats, biases = wm._pad_packed_chain(packed, NZ)
        mats, act = (*mats[:-1], mats[-1] @ Dr), wm._ACTIVATIONS[packed.activation]
        for n in (S, S * E, 16384):
            x = torch.randn((n, 3 * NZ), generator=gen).to(dev)
            for name, product in (("rows_product", original), ("plain_gemm", lambda x, A: x @ A)) * 2:
                times = []
                for _ in range(60):
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    y = x
                    for i, A in enumerate(mats):
                        y = product(y, A) + biases[i]
                        y = act(y) if i < len(mats) - 1 else y
                    b.record()
                    torch.cuda.synchronize()
                    times.append(a.elapsed_time(b))
                ms = sorted(times[10:])[25]
                record.setdefault(f"chain_ms_{n}_rows", {}).setdefault(name, []).append(ms)
            log(f"cut control, the folded chain at {n} rows, ms (in turns, twice): {record[f'chain_ms_{n}_rows']}")
    if record["rows_product"]["differ"] or any(v for k, d in record.items() if k.endswith("_rows_product")
                                               for v in d.values()):
        raise RuntimeError(f"cut control: the split solve's rows depend on how the block is cut: {record}")
    return record


def flagship_study_phase(dev, setup: dict, smi: str) -> dict:
    """Phase 44: the flagship study (train with --calibrate-mpp, --eval-checkpoint) and the adjoint-parity study."""
    import torch

    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.studies import adjoint_parity as ap
    from climateparameterizations_jl_tpu_torch.studies import flagship_training as fst
    from climateparameterizations_jl_tpu_torch.train import mpp_calibration, nde

    record: dict = {}
    stages = [(w, s, FLAG_ITERS, lr) for w, s, _, lr in fst.STAGES[:FLAG_STAGES]]
    n_frames, n_sims = fst.N_FRAMES, len(fst.TRAIN_FILES_STANDARD)
    n_held, eval_saves = FLAG_EVAL_HELD_OUT, len(range(0, fst.N_FRAMES, 9)) - 1
    per_sim_eval = 3 * eval_saves * 9 + eval_saves
    with phase(f"44 the flagship study at full width ({n_sims} sims x {n_frames} frames, Nz = {NZ}): --mode train "
               f"--calibrate-mpp (L-BFGS {FLAG_LBFGS_ITERS} iteration, stages {stages}), --eval-checkpoint "
               f"{FLAGSHIP_RUN.name} on {FLAG_EVAL_HELD_OUT} held-out sims, then the adjoint-parity study (f32 kernel, "
               f"f64 scan)"), \
            tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        WM_SUITES[(tuple(fst.TRAIN_FILES_STANDARD), NZ, None, n_frames - 1, 600.0, 128)] = setup["ds"]  # phase 8's
        originals = (cli._load_suite, fst.STAGES, fst.calibrate_mpp, nde.train_wind_mixing_nde,
                     mpp_calibration._solve, fst.TEST_FILES_STANDARD)
        stage_log, evals = [], [0]

        def counted_stage(*args, **kw):
            torch.cuda.synchronize()
            before, t = _cuda.THOMAS.launches, time.perf_counter()
            out = originals[3](*args, **kw)
            torch.cuda.synchronize()
            batch, config = args[2], args[3]
            stage_log.append({"rows": batch.x0.shape[0], "substeps": (batch.t.shape[0] - 1) * config.n_substeps,
                              "iterations": config.maxiters, "s": time.perf_counter() - t,
                              "launches": _cuda.THOMAS.launches - before})
            return out

        def counted_solve(*args, **kw):
            evals[0] += 1
            return originals[4](*args, **kw)

        def calibrate(ds, model, maxiters=60, **kw):
            return originals[2](ds, model, maxiters=FLAG_LBFGS_ITERS, **kw)

        cli._load_suite = cached_suites(cli, WM_SUITES)  # phase 8's suite and phase 27's held-out sims
        fst.STAGES, fst.calibrate_mpp = stages, calibrate
        nde.train_wind_mixing_nde, mpp_calibration._solve = counted_stage, counted_solve
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            fst.TEST_FILES_STANDARD = originals[5][:FLAG_HELD_OUT]
            train = fst.main(["--mode", "train", "--calibrate-mpp", "--pretrain-epochs", str(FLAG_PRETRAIN_EPOCHS),
                              "--save-nns", str(tmp / "a"), "--out", str(tmp / "a.json")])
            torch.cuda.synchronize()
            train_s, train_launches = time.perf_counter() - t, _cuda.THOMAS.launches
            fst.TEST_FILES_STANDARD = originals[5][:FLAG_EVAL_HELD_OUT]
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            held = fst.main(["--eval-checkpoint", str(FLAGSHIP_RUN), "--out", str(tmp / "b.json")])
            torch.cuda.synchronize()
            eval_s, eval_launches = time.perf_counter() - t, _cuda.THOMAS.launches
        finally:
            (cli._load_suite, fst.STAGES, fst.calibrate_mpp, nde.train_wind_mixing_nde,
             mpp_calibration._solve, fst.TEST_FILES_STANDARD) = originals
        # (a) the pipeline: keys, stages and their launches, the calibration, the held-out losses.
        mpp = train["mpp_calibration"]
        cal_substeps = (len(range(0, min(200, n_frames), 20)) - 1) * 20
        want_cal = 3 * cal_substeps * evals[0]
        log(f"train: {train_s:.2f} s (data {train['data_s']:.2f} s, pretraining {train['pretrain_s']:.2f} s at "
            f"{FLAG_PRETRAIN_EPOCHS} epochs: {train['pretrain']}); L-BFGS {mpp['wall_s']:.2f} s, {evals[0]} loss "
            f"evaluations: {mpp['loss_initial']:.4e} -> {mpp['loss_final']:.4e}, {mpp['params']}")
        want_stages, stage_launches = [], 0
        for (w, s, iters, _), e, r in zip(stages, stage_log, train["stages"]):
            sub = (len(range(0, w, s)) - 1) * s
            want = sub + 3 * sub * iters
            want_stages.append((n_sims, sub, iters, want))
            stage_launches += e["launches"]
            log(f"  stage {w}:{s}: {e['rows']} rows x {e['substeps']} substeps, {e['iterations']} iteration(s): "
                f"{e['s']:.2f} s ({r['s_per_iter']:.2f} s per iteration, pre-solve included), loss "
                f"{r['loss_initial']:.4e}; thomas {e['launches']} (derived {want} = {sub} pre-solve + 3 x {sub} x "
                f"{iters})")
        eval_a = train_launches - stage_launches - (want_cal if mpp else 0)
        log(f"  L-BFGS thomas {want_cal} = 3 x {cal_substeps} substeps x {evals[0]} evaluations (derived, not counted "
            f"apart); held-out evaluation thomas {eval_a} (derived {FLAG_HELD_OUT * per_sim_eval} = {FLAG_HELD_OUT} "
            f"sim(s) x (3 x {eval_saves} x 9 + {eval_saves})); total {train_launches}")
        for name, row in train["held_out"].items():
            log(f"  held-out {name}: nde {row['nde']:.4e}, mpp (calibrated base) {row['mpp']:.4e}, kpp {row['kpp']:.4e} "
                f"(win_vs_mpp {row['win_vs_mpp']:.2f}, win_vs_kpp {row['win_vs_kpp']:.1f}; one iteration per stage)")
        keys_ok = (set(train) == {"sims", "frames", "data_s", "mpp_calibration", "ensemble", "shooting", "data_dir",
                                  "host_matched_substeps", "pretrain", "pretrain_s", "stages", "held_out",
                                  "total_wall_s"}
                   and all(set(r) == {"window", "stride", "maxiters", "lr", "shooting", "n_saveat", "inner_steps",
                                      "loss_initial", "loss_final", "wall_s", "s_per_iter", "loss_curve"}
                           for r in train["stages"]))
        numbers = [v for _, v in _numbers({"s": train["stages"], "h": train["held_out"], "m": mpp})]
        got_stages = [(e["rows"], e["substeps"], e["iterations"], e["launches"]) for e in stage_log]
        saved, meta = cli._load_nns(str(tmp / "a"), dev)
        if (not keys_ok or got_stages != want_stages or eval_a != FLAG_HELD_OUT * per_sim_eval or evals[0] < 1
                or not all(math.isfinite(v) for v in numbers)
                or set(train["held_out"]) != set(UQ_TEST_FILES[:FLAG_HELD_OUT])
                or meta["mpp"] != {k: mpp["params"][k] for k in meta["mpp"]}):
            raise RuntimeError(f"flagship train: keys {keys_ok}, stages {got_stages} (derived {want_stages}), held-out "
                               f"launches {eval_a}, evaluations {evals[0]}, meta {meta.get('mpp')}")
        record["train"] = {"s": train_s, "launches": train_launches, "stages": stage_log, "lbfgs_evaluations": evals[0],
                           "mpp_calibration": mpp, "held_out": train["held_out"]}

        # (b) the stored checkpoint on the held-out sims, beside the stored run.
        stored = json.loads(FLAG_RUN_JSON.read_text())["held_out"]
        gaps = {}
        for name, row in held["held_out"].items():
            gaps[name] = {k: row[k] / stored[name][k] - 1 for k in ("nde", "mpp", "kpp", "kpp_ref_dt")}
            log(f"  {FLAGSHIP_RUN.name} on {name}: " + ", ".join(
                f"{k} {row[k]:.4e} (stored {stored[name][k]:.4e}, {100 * g:+.2f} %)" for k, g in gaps[name].items()))
        worst = max(abs(g) for row in gaps.values() for g in row.values())
        log(f"--eval-checkpoint: {eval_s:.2f} s, thomas {eval_launches} (derived {n_held * per_sim_eval}); largest gap "
            f"to the stored TPU run {100 * worst:.2f} %" + (
                "" if worst <= FLAG_STORED_NOTE else
                " (above 1 %: the held-out truth differs, not the evaluation. The port generates its synthetic "
                "stand-ins itself in f32, and over 1,152 saves they drift from the JAX package's by up to 4.4e-4 K in "
                "T; on the JAX package's own suite the port's evaluation of this checkpoint equals the JAX package's "
                "within 8e-5 (3.7e-4 for kpp_ref_dt), and the JAX package lands within 0.15 % of the stored run: "
                "CPU runs, PERF.md section 6)"))
        if (eval_launches != n_held * per_sim_eval or held["ensemble"] != 0
                or not all(math.isfinite(v) and v > 0 for row in held["held_out"].values() for v in row.values())):
            raise RuntimeError(f"--eval-checkpoint: launches {eval_launches}, held-out {held['held_out']}")
        record["eval_checkpoint"] = {"s": eval_s, "launches": eval_launches, "held_out": held["held_out"],
                                     "gap_to_stored": gaps}

        # (c) the adjoint-parity study: f32 on the kernel against f64 on scan.
        model, batch, nns = ap.build_problem(stiff=True, n_frames=AP_FRAMES, device=dev)
        refinement = {}
        for label, args, backend in (("f32 kernel", (model, batch, nns), "cuda"),
                                     ("f64 scan", ap.to_f64((model, batch, nns)), "scan")):
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            rows, meta_r = ap.dt_refinement(*args, substeps=AP_SUBSTEPS, fine=AP_FINE, tridiag_backend=backend)
            split = [r["grad_rel_err"] for r in rows if r["method"] == "split"]
            refinement[label] = {"rows": rows, "meta": meta_r, "s": time.perf_counter() - t,
                                 "launches": _cuda.THOMAS.launches}
            rk4 = [round(r["grad_rel_err"], 6) for r in rows if r["method"] == "rk4"]
            log(f"  dt_refinement {label}: {refinement[label]['s']:.2f} s, thomas {_cuda.THOMAS.launches}; L* "
                f"{meta_r['L_star']:.6e}; gradient error against it at {AP_SUBSTEPS} substeps: split "
                f"{[round(e, 6) for e in split]}, rk4 {rk4}")
            if not (split[0] > split[1] > split[2]) or (backend == "cuda") != (_cuda.THOMAS.launches > 0):
                raise RuntimeError(f"dt_refinement {label}: split errors {split}, launches {_cuda.THOMAS.launches}")
        record["adjoint_parity"] = {"refinement": refinement}
        log(f"card: {smi}")
    return record


def studies_phase(dev, flagship, smi: str) -> dict:
    """Phase 45: forward_scaling, fused_kernel_sweep, fc_fair_substep_check and gp_at_scale on their kernels."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import gram as ops_gram
    from climateparameterizations_jl_tpu_torch.ops.fused_rhs import make_fused_runner_mxu
    from climateparameterizations_jl_tpu_torch.studies import fc_fair_substep_check as fair
    from climateparameterizations_jl_tpu_torch.studies import forward_scaling as fs
    from climateparameterizations_jl_tpu_torch.studies import fused_kernel_sweep as fks
    from climateparameterizations_jl_tpu_torch.studies import gp_at_scale as gps

    record: dict = {}
    with phase(f"45 the studies, continued: forward_scaling at {STUDY_COLUMNS} columns x {BENCH_STEPS} steps, "
               f"fused_kernel_sweep at {SWEEP_COLUMNS} x {SWEEP_STEPS}, fc_fair_substep_check on sim {FAIR_SIM}'s first "
               f"{FAIR_FRAMES} frames, gp_at_scale --smoke and --gram-only (n = {GRAM_AB_N})"), \
            tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) forward_scaling: one launch per run on the f32 kernel.
        torch.cuda.synchronize()
        t = time.perf_counter()
        _cuda.reset_launch_counts()
        rows = fs.main(["--columns", ",".join(map(str, STUDY_COLUMNS)), "--n-steps", str(BENCH_STEPS), "--repeats",
                        "1", "--out", str(tmp / "fs.jsonl")])
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        want = 2 * len(STUDY_COLUMNS)
        for r in rows:
            log(f"  forward_scaling {r['n_columns']} x {r['n_steps']}: {r['median_s'] * 1e3:.3f} ms, "
                f"{r['col_ts_per_s']:.4e} column-timesteps/s, mfu {r['mfu_pct']:.2f} %")
        log(f"forward_scaling: {time.perf_counter() - t:.2f} s, launch counts {launches} (derived fused_rk4 {want}: "
            f"one warm-up and one timed run per size)")
        if (len(rows) != len(STUDY_COLUMNS) or launches["fused_rk4"] != want
                or not all(math.isfinite(r["col_ts_per_s"]) and r["col_ts_per_s"] > 0 for r in rows)):
            raise RuntimeError(f"forward_scaling: rows {rows}, launches {launches}")
        n = STUDY_COLUMNS[-1]
        model, nns, bcs, x0 = benchmarks.make_setup(NZ, n, nns=flagship, device=dev)
        whole = benchmarks.nde_forward_route(model, nns, bcs, BENCH_STEPS, n, device=dev)[0](x0)
        chunked = benchmarks.nde_forward_route(model, nns, bcs, BENCH_STEPS, n, chunk_columns=STUDY_CHUNK,
                                               device=dev)[0](x0)
        equal = torch.equal(whole, chunked)
        tail = make_fused_runner_mxu(model, nns, bcs, benchmarks.FORWARD_DT, BENCH_STEPS, STUDY_TAIL, device=dev)
        tail_err = compare(f"the {n}-column kernel run's last {STUDY_TAIL} columns vs the plain version", whole[-STUDY_TAIL:],
                           tail.plain(x0[-STUDY_TAIL:].contiguous()))
        log(f"  {n} columns: one launch vs --chunk-columns {STUDY_CHUNK} ({n // STUDY_CHUNK} launches) torch.equal "
            f"{equal}; grid {n // _cuda.FUSED_RK4.load().fused_rk4_columns_per_block()} CTAs")
        if not equal:
            raise RuntimeError("forward_scaling: the chunked run differs from one launch")
        del whole, chunked, x0
        # Both kernels' device time at the largest batch against their bounds (rows 2 and 2b of PERF.md: the 1,024 x
        # 1,024 bounds scaled by the column count).
        h1, h2 = flagship.uw.weights[0].shape[0], flagship.uw.weights[1].shape[0]
        mm_flops, ew_flops = benchmarks.fused_rk4_flops(n, BENCH_STEPS, NZ, h1, h2)
        big = {}
        for mdt, bound_ms in (("float32", (mm_flops + ew_flops) / PEAK_F32_FLOPS * 1e3),
                              ("bfloat16", max(ew_flops / PEAK_F32_FLOPS, mm_flops / PEAK_BF16_FLOPS) * 1e3)):
            stats = benchmarks.bench_nde_forward(n, NZ, BENCH_STEPS, 1, nns=flagship, device=dev, matmul_dtype=mdt)
            big[mdt] = {"ms": stats["ms_median"], "bound_ms": bound_ms, "share_of_bound": bound_ms / stats["ms_median"]}
            log(f"  bench_nde_forward {n} x {BENCH_STEPS} {mdt}: {stats['ms_median']:.2f} ms, bound {bound_ms:.2f} ms "
                f"(operations), share {bound_ms / stats['ms_median']:.3f}")
        record["forward_scaling"] = {"rows": rows, "launches": want, "chunk_equal": equal,
                                     "tail_max_abs_vs_plain": tail_err, "at_131072": big}

        # (b) fused_kernel_sweep: every distinct route against the f32 kernel, bf16 to the JAX bf16 limit.
        torch.cuda.synchronize()
        t = time.perf_counter()
        _cuda.reset_launch_counts()
        states: dict = {}
        rows = fks.sweep(SWEEP_COLUMNS, SWEEP_STEPS, dev, tmp / "sweep.jsonl", iters=1, warmup=0, nns=flagship,
                         states=states)
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        timed = [r for r in rows if r["alias_of"] is None]  # each distinct computation, timed once
        f32_names = [r["config"] for r in timed if r["kernel"] == "fused_rk4"]
        bf16_names = [r["config"] for r in timed if r["kernel"] == "fused_rk4_bf16"]
        want_f32 = 3 * (len(f32_names) - 1) + 3 * SWEEP_STEPS  # the single-step loop: SWEEP_STEPS launches a call
        want_bf16 = 3 * len(bf16_names)
        reference = next(states[r["config"]] for r in timed if r["config"].endswith(" float32")
                         and r["config"].startswith("cuda mxu fused_rk4 "))
        errors = {}
        for r in timed:
            bf16 = r["kernel"] == "fused_rk4_bf16"
            errors[r["config"]] = compare(
                f"  sweep route {r['config']!r} ({r['col_ts_per_sec']:.4e} column-timesteps/s) vs the f32 kernel",
                states[r["config"]], reference, **({"rtol": JAX_BF16_RTOL, "atol": JAX_BF16_ATOL} if bf16 else {}))
        aliases = {r["config"]: r["alias_of"] for r in rows if r["alias_of"] is not None}
        log(f"fused_kernel_sweep: {time.perf_counter() - t:.2f} s, {len(rows)} routes of which {len(timed)} timed "
            f"and {len(aliases)} aliases ({aliases}), launch counts {launches} (derived fused_rk4 {want_f32}, "
            f"fused_rk4_bf16 {want_bf16} over {len(bf16_names)} launch shapes)")
        if ((launches["fused_rk4"], launches["fused_rk4_bf16"]) != (want_f32, want_bf16) or len(rows) != 16
                or len(f32_names) != 2 or len(timed) != 5 + len(bf16_names)):
            raise RuntimeError(f"fused_kernel_sweep: {len(rows)} rows ({len(timed)} timed), launches {launches}")
        record["fused_kernel_sweep"] = {"rows": rows, "launches": {k: launches[k] for k in ("fused_rk4",
                                                                                            "fused_rk4_bf16")}}
        del states, reference

        # (c) fc_fair_substep_check: every KPP and TKE step one launch, kernel equal to scan.
        z = np.load(fair.RUNS / "fc_les3d_eval" / f"sim{FAIR_SIM}.npz")
        truth = torch.tensor(z["truth_T"][:FAIR_FRAMES], dtype=torch.float64, device=dev)
        shift = float(truth[0].mean())
        T0, t_dim = (truth[0] - shift).float(), torch.tensor(z["t"][:FAIR_FRAMES], device=dev)
        fair_rec = {}
        for nsub in (1, 8):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            kernel = fair.run_baselines(T0, t_dim, z["zf"], z["zc"], FAIR_SIM, nsub)
            torch.cuda.synchronize()
            k_s, k_launches = time.perf_counter() - t, _cuda.THOMAS.launches
            t = time.perf_counter()
            scan = fair.run_baselines(T0, t_dim, z["zf"], z["zc"], FAIR_SIM, nsub, tridiag_backend="scan")
            torch.cuda.synchronize()
            s_s = time.perf_counter() - t
            pairs = [(kernel[0].T, scan[0].T), (kernel[0].U, scan[0].U), (kernel[1], scan[1]), (kernel[2].T, scan[2].T),
                     (kernel[2].e, scan[2].e), (kernel[3], scan[3])]
            equal = all(torch.equal(a, b) for a, b in pairs)
            want = 2 * (FAIR_FRAMES - 1) * nsub
            loss = float(torch.mean(((kernel[0].T.double() + shift) - truth) ** 2))
            log(f"  fc_fair sim {FAIR_SIM} at {nsub} substep(s): kernel {k_s:.2f} s, thomas {k_launches} (derived {want} "
                f"= {FAIR_FRAMES - 1} x {nsub} KPP + as many TKE steps); scan {s_s:.2f} s; every trajectory and flux "
                f"torch.equal {equal}; KPP T mean squared error {loss:.4e} K^2")
            if k_launches != want or not equal:
                raise RuntimeError(f"fc_fair at {nsub} substeps: launches {k_launches} (derived {want}), equal {equal}")
            fair_rec[nsub] = {"launches": k_launches, "kernel_s": k_s, "scan_s": s_s, "equal": equal}
        record["fc_fair"] = fair_rec

        # (d) gp_at_scale --smoke on the cached suites, then the Gram A/B at 8,192 and one Gram there.
        original = cli._load_suite
        cli._load_suite = cached_suites(cli, WM_SUITES)  # phase 8's suite and phase 27's held-out sims
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            smoke = gps.main(["--smoke", "--out", str(tmp / "gp.json")])
            torch.cuda.synchronize()
            smoke_s, smoke_launches = time.perf_counter() - t, _cuda.GRAM.launches
        finally:
            cli._load_suite = original
        numbers = [v for _, v in _numbers({k: smoke[k] for k in ("build_f32", "build_f64", "gp_full", "gp_de")})]
        log(f"gp_at_scale --smoke: {smoke_s:.2f} s; selection {[smoke['selection'][f]['kernel'] for f in smoke['selection']]}"
            f"; final fit {smoke['final_fit']}; GP-DE {smoke['gp_de']['frames']} frames, T mse "
            f"{smoke['gp_de']['trajectory_mse_T']:.4e}; gram launches {smoke_launches} (derived 18: the A/B's "
            f"kernel builds, 6 x 3)")
        if (smoke_launches != 18 or smoke["gp_de"]["frames"] != 49 or smoke["n_full"] != 2048
                or not all(math.isfinite(v) for v in numbers)):
            raise RuntimeError(f"gp_at_scale --smoke: launches {smoke_launches}, {smoke['final_fit']}, {smoke['gp_de']}")
        _cuda.reset_launch_counts()
        ab = gps.main(["--gram-only", "--out", str(tmp / "gram.json")])
        ab_launches = _cuda.GRAM.launches
        # The A/B's gamma = 1 leaves this Gram the identity in f32 (see GP_WIDE_GAMMA), so the kernel is held to
        # plain, and timed, where K is not trivial: gamma^2 = median(d^2) / 2 on the same inputs, as phase 11.
        x, _, _ = benchmarks.gp_inputs(GRAM_AB_N, GP_D, device=dev)
        gamma = math.sqrt(0.5 * float(ops_gram._sq_distances(x.double(), x.double())[0].median()))
        got = ops_gram.gram_cuda(x, x, gamma, 1.0)
        torch.cuda.synchronize()
        want = ops_gram.gram_plain(x, x, gamma, 1.0)
        off = ~torch.eye(GRAM_AB_N, dtype=torch.bool, device=dev)
        k_off = want[off]
        log(f"  gram at {GRAM_AB_N} x {GRAM_AB_N} x {GP_D}, gamma = {gamma:.5g}: off-diagonal K median "
            f"{float(k_off.median()):.3e}, min {float(k_off.min()):.3e}, max {float(k_off.max()):.3e}")
        err_off, err_co, _ = compare_gram(f"gram {GRAM_AB_N}x{GRAM_AB_N}x{GP_D} squared_exponential gamma={gamma:.5g} "
                                          f"(the --gram-only inputs) vs gram_plain", got, want, x, x,
                                          "squared_exponential", (gamma, 1.0, 1.0))
        exact = int((got.diagonal() == 1.0).sum())
        del got, want, k_off, off
        # Device time at 8,192 x 8,192 x 96 on those inputs (PERF.md row 4): kernel, plain version and torch.cdist
        # (the distance part alone), against the bound of 2 n^2 D FLOP at the f32 peak (the output's bytes take
        # less).
        kernel_ms, _ = cuda_ms(lambda: ops_gram.gram_cuda(x, x, gamma, 1.0), repeats=5)
        plain_ms, _ = cuda_ms(lambda: ops_gram.gram_plain(x, x, gamma, 1.0), repeats=5)
        cdist_ms, _ = cuda_ms(lambda: torch.cdist(x, x), repeats=5)
        g_ops = 2.0 * GRAM_AB_N * GRAM_AB_N * GP_D / PEAK_F32_FLOPS * 1e3
        g_bytes = 4.0 * (2 * GRAM_AB_N * GP_D + GRAM_AB_N * GRAM_AB_N) / PEAK_BYTES_PER_S * 1e3
        log(f"  gram at {GRAM_AB_N} x {GRAM_AB_N} x {GP_D}, gamma = {gamma:.5g}: kernel {kernel_ms:.4f} ms, "
            f"gram_plain {plain_ms:.4f} ms, torch.cdist {cdist_ms:.4f} ms (CUDA events, median of 5); bound "
            f"{max(g_ops, g_bytes):.4f} ms (operations {g_ops:.4f} ms, bytes {g_bytes:.4f} ms), share "
            f"{max(g_ops, g_bytes) / kernel_ms:.3f}")
        log(f"gp_at_scale --gram-only at n = {GRAM_AB_N} (the study's gamma = 1, timing only): three builds "
            f"{ab['gram_plain']['ms_median']:.2f} ms plain, {ab['gram_cuda']['ms_median']:.2f} ms on the kernel; gram "
            f"launches {ab_launches} (derived 18); the training Gram's diagonal equal to sigma exactly: {exact} of "
            f"{GRAM_AB_N}")
        if ab_launches != 18 or exact != GRAM_AB_N:
            raise RuntimeError(f"gp_at_scale --gram-only: launches {ab_launches}, exact diagonal {exact}")
        record["gp_at_scale"] = {"smoke_s": smoke_s, "smoke_gram_launches": smoke_launches,
                                 "final_fit": smoke["final_fit"], "gp_de": smoke["gp_de"], "gram_ab": ab,
                                 "gram_launches": ab_launches, "gram_max_abs_vs_plain": err_off,
                                 "gram_coincident_max_abs": err_co, "gram_8192_ms": kernel_ms,
                                 "gram_8192_plain_ms": plain_ms, "cdist_8192_ms": cdist_ms, "gram_8192_gamma": gamma,
                                 "gram_8192_bound_ms": max(g_ops, g_bytes)}
        log(f"card: {smi}")
    return record


def parallel_phase(dev, setup: dict, smi: str) -> dict:
    """Phase 43: the parallel layer on a world of one NCCL rank per card, each path held to its single-device run;
    then :func:`cut_control`."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch.parallel import world
    from climateparameterizations_jl_tpu_torch.train.checkpoint import _map_leaves

    n = torch.cuda.device_count()
    record: dict = {}
    with phase(f"43 the parallel layer: dryrun_multichip on a world of {n} NCCL rank(s), every sharded path at the "
               f"flagship widths (the data-parallel step's window cut in depth to {PAR_SUBSTEPS} substeps)"):
        batch = setup["batch"]
        S = batch.x0.shape[0]
        sims = S - S % n  # the data-parallel paths split the sims evenly: a world that does not divide 18 takes fewer
        cpu = lambda tree: _map_leaves(tree, lambda _k, x: (x[:sims] if x.dim() and x.shape[0] == S else x).detach().cpu())  # noqa: E731
        frames = PAR_SUBSTEPS // setup["config"].n_substeps + 1
        cut = dataclasses.replace(batch, targets=batch.targets[:, :frames], t=batch.t[:frames])
        log(f"data-parallel step: {batch.x0.shape[0]} sims, window cut from {batch.t.shape[0]} to {frames} frames "
            f"({(frames - 1) * setup['config'].n_substeps} of {setup['substeps']} substeps) for depth only; the "
            f"member-parallel step's to {PAR_ENS_SUBSTEPS} substeps")
        if sims != S:
            log(f"{sims} of the {S} sims: the world of {n} ranks does not divide {S}")
        inputs = {"model": cpu(setup["model"]), "batch": cpu(cut), "config": setup["config"],
                  "ds": cpu(_first_frames(setup["ds"], max(PAR_EMB_FRAMES, PAR_EKI_FRAMES)))}
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out = world.spawn_world(parallel_rank, n, (inputs,), backend="nccl")[0]
        wall = time.perf_counter() - t
        log(f"world of {n} rank(s) on NCCL: {wall:.2f} s in all (spawn, set-up {out['setup_s']:.2f} s, paths, the "
            f"unsharded runs); card: {smi}")
        failures = []  # every path is checked and printed before the phase fails
        for name, rec in out["records"].items():
            tol = PAR_TOLERANCES[name]
            errors = {}
            for key, got in rec["sharded"].items():
                want = rec["unsharded"][key]
                try:
                    errors[key] = compare(f"{name}.{key}: world {rec['world']} vs unsharded", torch.from_numpy(
                        np.asarray(got, np.float64)), torch.from_numpy(np.asarray(want, np.float64)), **tol)
                except RuntimeError as e:
                    failures.append(str(e))
            expect = PAR_KERNELS[name]
            log(f"{name}: world={rec['world']} backend={rec['backend']} {rec['seconds'] * 1e3:.1f} ms; collectives "
                f"{rec['collectives']}; launches {rec['launches']}; local {rec['local']}; replicas equal "
                f"{rec['replicas_equal']}; card: {smi}")
            if rec["backend"] != "nccl" or rec["world"] != n:
                failures.append(f"{name}: ran on {rec['backend']} at world {rec['world']}")
            if any(rec["launches"][k] == 0 for k in expect) or rec["replicas_equal"] is False:
                failures.append(f"{name}: no launch of {expect} in {rec['launches']}, or replicas differ")
            record[name] = {"ms": rec["seconds"] * 1e3, "launches": rec["launches"], "collectives": rec["collectives"],
                            "max_abs_err": errors}
        try:  # the 2-D suite's tiles at world 1 are the whole block: cut it on the card here
            record["cut_control"] = cut_control(dev, setup)
        except RuntimeError as e:
            failures.append(str(e))
        if failures:
            raise RuntimeError("phase 43: " + "; ".join(failures))
        record["wall_s"] = wall
    return record


def _numbers(tree, path=""):
    """Every int and float of a JSON-like tree with its path (bools are not numbers here)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numbers(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _numbers(v, f"{path}[{i}]")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, tree


def suite_phase(smi: str) -> dict:
    """Phase 41: ``benchmark --suite --quick`` through the CLI; every row present, finite and timed."""
    import contextlib
    import io

    import torch

    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.ops import _cuda

    with phase("41 benchmark --suite --quick through the CLI: the twelve rows of benchmarks.run_suite on the card"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _cuda.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["benchmark", "--suite", "--quick"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        suite = json.loads(buf.getvalue())
        log(f"exit {rc} in {wall:.2f} s; rows {list(suite)}; launch counts {launches}")
        if rc != 0 or list(suite) != list(SUITE_KEYS):
            raise RuntimeError(f"benchmark --suite: exit {rc}, rows {list(suite)}")
        bad = [(p, v) for p, v in _numbers(suite) if not math.isfinite(v)]
        skipped = [k for k, row in suite.items() if "skipped" in row or "error" in row]
        timed = {k: suite[k][SUITE_TIME_KEYS.get(k, "ms_median")] for k in suite}
        if bad or skipped or not all(v is not None and v > 0 for v in timed.values()):
            raise RuntimeError(f"benchmark --suite: non-finite {bad[:5]}, skipped {skipped}, times {timed}")
        for k, row in suite.items():
            roof = (f"; bound {row['bound_ms']:.4f} ms by {row['bound_by']}, share {row['share_of_bound']:.4f}, "
                    f"mfu {row['mfu_pct']:.3f} %, {row['hbm_gbps']:.1f} GB/s" if "bound_ms" in row else "")
            log(f"  {k}: {SUITE_TIME_KEYS.get(k, 'ms_median')} {timed[k]:.4f}{roof}")
        for name in ("thomas", "fused_rk4", "gram"):
            if not launches[name] > 0:
                raise RuntimeError(f"benchmark --suite launched {name} no time")
        log(f"card: {smi}")
    return {"s": wall, "launches": launches, "ms": timed,
            "roofline": {k: {c: row[c] for c in ("bound_ms", "bound_by", "share_of_bound", "mfu_pct", "hbm_gbps")}
                         for k, row in suite.items() if "bound_ms" in row}}


def headline_report_phase(dev, setup, flagship, smi: str) -> dict:
    """Phase 42: benchmarks.headline at full width, then training_report on a held-out sim without matplotlib."""
    import contextlib
    import io

    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.eval import training_report
    from climateparameterizations_jl_tpu_torch.ops import _cuda

    record: dict = {}
    tsteps = np.arange(0, REPORT_WINDOW, EVAL_STRIDE)
    saves = len(tsteps) - 1
    # rk4 (first, with the host pair): KPP one step per save, 2 host runs x saves x 10; split: NDE, mPP alone x
    # saves x REPORT_SUBSTEPS substeps, and KPP again.
    expected = saves + 2 * saves * EMBEDDED_SUBSTEPS + 2 * saves * REPORT_SUBSTEPS + saves
    with phase(f"42 benchmarks.headline(n_timed=1, n_repeats=1) at full width, then training_report of "
               f"{FLAGSHIP_RUN.name} on {UQ_TEST_FILES[0]} ({len(tsteps)} frames, rk4 and split) without matplotlib"), \
            tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _cuda.reset_launch_counts()
        line = benchmarks.headline(n_timed=1, n_repeats=1, nns=flagship, setup=setup, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        log(f"headline in {wall:.2f} s: {json.dumps(line)}")
        log(f"launch counts {launches}")
        bad = [(p, v) for p, v in _numbers(line) if not (math.isfinite(v) and v > 0)]
        if bad or not launches["fused_rk4"] > 0 or not launches["thomas"] > 0:
            raise RuntimeError(f"headline: not finite and positive {bad}, launches {launches}")
        record["headline"] = {"s": wall, "line": line, "launches": launches}

        ds_test = cached_suites(cli, WM_SUITES)([UQ_TEST_FILES[0]], NZ, None, NDE_N_SAVE, 600.0, device=dev)
        history = [{"iter": i, "loss": 1.0 / (i + 1)} for i in range(4)]
        hidden = {name: sys.modules.pop(name) for name in list(sys.modules)
                  if name == "matplotlib" or name.startswith("matplotlib.")
                  or name == "climateparameterizations_jl_tpu_torch.eval.animations"}
        sys.modules["matplotlib"] = None  # the card's machine has no matplotlib: hide it where a host has one
        err = io.StringIO()
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _cuda.reset_launch_counts()
            with contextlib.redirect_stderr(err):
                out = training_report(setup["model"], flagship, ds_test, tsteps, str(Path(tmp) / "report"),
                                      history=history, n_substeps=REPORT_SUBSTEPS, animate=False)
            torch.cuda.synchronize()
            report_s = time.perf_counter() - t
        finally:
            del sys.modules["matplotlib"]
            sys.modules.update(hidden)
        launches = {k: v.launches for k, v in _cuda.KERNELS.items()}
        files = sorted(p.name for p in (Path(tmp) / "report").iterdir())
        summary = out["summary"]
        log(f"training_report in {report_s:.2f} s: files {files}; stderr {err.getvalue().strip()!r}; launch counts "
            f"{launches}, expected thomas {expected} = rk4 ({saves} KPP steps + 2 host runs x {saves} saves x "
            f"{EMBEDDED_SUBSTEPS}) + split (2 solves x {saves} saves x {REPORT_SUBSTEPS} + {saves} KPP steps)")
        log(f"summary {summary}")
        want_keys = {f"{m}_{s}" for s in ("rk4", "split") for m in ("nde", "mpp", "kpp")} | {
            "embedded_rk4", "embedded_baseline_rk4"}
        undrawn = ("training_loss.png", "loss_rk4.png", "loss_split.png")
        finite = True
        for solver in ("rk4", "split"):
            with np.load(Path(tmp) / "report" / f"profile_{solver}.npz") as ev:
                finite &= all(bool(np.isfinite(ev[k]).all()) for k in ev.files if not k.endswith("_Ri"))
        line_ok = err.getvalue().count("\n") == 1 and "matplotlib" in err.getvalue() and all(
            n in err.getvalue() for n in undrawn)
        if (files != ["profile_rk4.npz", "profile_split.npz", "summary.json"] or set(summary) != want_keys
                or not all(math.isfinite(v) for v in summary.values()) or not finite or not line_ok
                or launches["thomas"] != expected):
            raise RuntimeError(f"training_report: files {files}, summary {summary}, finite {finite}, stderr "
                               f"{err.getvalue()!r}, launches {launches} (expected thomas {expected})")
        record["report"] = {"s": report_s, "frames": len(tsteps), "launches": launches["thomas"], "summary": summary}
        log(f"card: {smi}")
    return record


def data_files_phase(dev, smi: str) -> dict:
    """Phase 46: the LESbrary and netCDF files on the card, through the port's own HDF5 code (no h5py)."""
    import numpy as np
    import torch

    from climateparameterizations_jl_tpu_torch.cli import main as cli
    from climateparameterizations_jl_tpu_torch.data import free_convection as fcd
    from climateparameterizations_jl_tpu_torch.data import lesbrary
    from climateparameterizations_jl_tpu_torch.data import registry
    from climateparameterizations_jl_tpu_torch.data.synthetic import (
        _synthetic_free_convection_les_batch,
        _synthetic_wind_mixing_les_batch,
    )
    from climateparameterizations_jl_tpu_torch.ops import _cuda

    record: dict = {}
    fields = ("u", "v", "T", "uw", "vw", "wT", "t")
    with phase(f"46 the data files: generate-les --jld2-name {DATA_NAME} (32^3, {DATA_GEN_N_SAVE} saves), train-nde "
               f"--data-dir on its stand-in ({DATA_N_SAVE} saves, {DATA_CURRICULUM}), free-convection id "
               f"{DATA_FC_ID} through write_fc_fieldset"), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) generate-les writes the .jld2 beside its npz
        _cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = cli.main(["generate-les", "--jld2-name", DATA_NAME, "--n-save", str(DATA_GEN_N_SAVE), "--output",
                       str(tmp / "les")])
        wall = time.perf_counter() - t
        launches = _cuda.THOMAS.launches
        npz = fcd.load_column_npz(str(tmp / "les" / "les_profiles.npz"))
        path = tmp / "les" / registry.lesbrary_relative_path(DATA_NAME)
        t = time.perf_counter()
        back = lesbrary.read_les_profiles(str(path))
        read_s = time.perf_counter() - t
        steps = DATA_GEN_N_SAVE * int(round(600.0 / 24.0))
        profiles = {f: same_bits(getattr(back, f), getattr(npz, f)) for f in fields}
        ulps = {c: abs(int(np.float32(float(getattr(back, c))).view(np.int32))
                       - int(np.float32(float(getattr(npz, c))).view(np.int32)))
                for c in ("H", "f", "g", "alpha", "beta", "u_top", "theta_top", "theta_bottom")}
        log(f"(a) generate-les: exit {rc} in {wall:.2f} s; thomas launches {launches} (expected {3 * steps} = 3 x "
            f"{steps} RK3 steps); {path.relative_to(tmp / 'les')} ({path.stat().st_size} B) read back in "
            f"{read_s:.3f} s: equal to les_profiles.npz bit for bit {profiles}; f32 ulps apart per constant {ulps} "
            f"(theta_top within {DATA_ULPS}, the others 0)")
        if (rc != 0 or launches != 3 * steps or not all(profiles.values()) or ulps["theta_top"] > DATA_ULPS
                or any(v for c, v in ulps.items() if c != "theta_top")):
            raise RuntimeError(f"generate-les --jld2-name: exit {rc}, launches {launches}, or the file differs from "
                               "the npz")
        record["generate_les"] = {"s": wall, "read_s": read_s, "launches": launches, "bytes": path.stat().st_size,
                                  "theta_top_ulps": ulps["theta_top"]}

        # (b) train-nde --data-dir on the name's stand-in written as a LESbrary file, against the stand-in itself
        spec = registry.simulation_parameters(DATA_NAME)
        raw, = _synthetic_wind_mixing_les_batch([registry.signed_momentum_flux(spec)], [spec.Qb], f=spec.f,
                                                diurnal=spec.diurnal, Nz=128, n_save=DATA_N_SAVE, dt_save=600.0)
        data_dir = tmp / "lesbrary"
        t = time.perf_counter()
        lesbrary.write_les_profiles(str(data_dir / registry.lesbrary_relative_path(DATA_NAME)), raw)
        write_s = time.perf_counter() - t
        runs = {}
        for label, extra in (("file", ["--data-dir", str(data_dir)]), ("stand-in", [])):
            out = tmp / f"nde_{label}"
            _cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            rc = cli.main(["train-nde", "--sims", DATA_NAME, "--nz", str(NZ), "--n-save", str(DATA_N_SAVE),
                           "--dt-save", "600", "--method", "split", "--n-substeps", "1", "--maxiters", "1",
                           "--curriculum", DATA_CURRICULUM, *extra, "--output", str(out)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            with open(out / "history.jsonl") as f:
                loss = json.loads(f.readline())["loss"]
            runs[label] = {"rc": rc, "s": wall, "loss": loss, "launches": _cuda.THOMAS.launches,
                           "others": sum(k.launches for k in _cuda.KERNELS.values()) - _cuda.THOMAS.launches}
        _, stages = curriculum_thomas_launches(DATA_CURRICULUM, DATA_N_SAVE + 1, 0, 1)
        expected = 3 * sum(substeps for _, substeps in stages)  # no --auto-balance: no loss-scaling pre-solve
        a, b = runs["file"], runs["stand-in"]
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        log(f"(b) {DATA_NAME}'s stand-in ({tuple(raw.T.shape)}) written in {write_s:.3f} s; train-nde on the file: "
            f"exit {a['rc']} in {a['s']:.2f} s, first loss {a['loss']!r}, thomas {a['launches']}; on the stand-in: "
            f"exit {b['rc']} in {b['s']:.2f} s, first loss {b['loss']!r}, thomas {b['launches']} (expected {expected}); "
            f"relative difference {rel:.3e} (limit {DATA_LOSS_RTOL}; bit for bit: {a['loss'] == b['loss']})")
        if (a["rc"] or b["rc"] or a["launches"] != b["launches"] or a["launches"] != expected or a["others"]
                or b["others"] or not math.isfinite(a["loss"]) or rel > DATA_LOSS_RTOL):
            raise RuntimeError(f"train-nde --data-dir: {runs} (expected thomas {expected})")
        record["train_nde_data_dir"] = {"write_s": write_s, "runs": runs, "loss_rel_diff": rel}

        # (c) a free-convection id written in the FieldDataset layout, loaded as a suite
        qb, strat = fcd._SYNTHETIC_PARAMS[DATA_FC_ID]
        raw_fc, = _synthetic_free_convection_les_batch([qb], [strat], Nz=128, n_save=DATA_N_SAVE, dt_save=600.0)
        fc_path = tmp / "fc" / f"free_convection_{DATA_FC_ID}" / "instantaneous_statistics_with_halos.jld2"
        t = time.perf_counter()
        lesbrary.write_fc_fieldset(str(fc_path), raw_fc)
        write_fc_s = time.perf_counter() - t
        t = time.perf_counter()
        got, = fcd.load_free_convection_suite([DATA_FC_ID], str(tmp / "fc"), NZ, n_save=DATA_N_SAVE)
        read_fc_s = time.perf_counter() - t
        want, = fcd.load_free_convection_suite([DATA_FC_ID], None, NZ, n_save=DATA_N_SAVE)
        carried = ("u", "v", "T", "uw", "vw", "wT", "t", "H", "g", "alpha", "u_top", "theta_top", "theta_bottom")
        equal = {f: same_bits(getattr(got, f), getattr(want, f)) for f in carried}
        log(f"(c) free_convection_{DATA_FC_ID}: written in {write_fc_s:.3f} s ({fc_path.stat().st_size} B), loaded "
            f"and coarsened in {read_fc_s:.3f} s to {tuple(got.T.shape)}; equal to the stand-in suite bit for bit: "
            f"{equal}")
        if not all(equal.values()):
            raise RuntimeError("load_free_convection_suite(data_dir=...): the file's suite is not the stand-in's")
        record["fc_fieldset"] = {"write_s": write_fc_s, "read_s": read_fc_s, "equal": True}
        log(f"card: {smi}")
    return record


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
    for run_dir in (FLAGSHIP_RUN, SHOOT16_RUN, ENS_RUN):
        if not (run_dir / "state.npz").exists():
            print(f"chip_smoke: {run_dir / 'state.npz'} is missing", file=sys.stderr)
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
        F = 3 * NZ
        # The products and the work outside them run on the same CUDA cores in f32.
        mm_flops, ew_flops = benchmarks.fused_rk4_flops(FULL_COLUMNS, BENCH_STEPS, NZ, h1, h2)
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
            f"one reciprocal per level shared by its two quotients, and a correctly rounded redo of a system's sweep "
            f"where a quotient left the fast path's exact range")
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

        # Kernel against scan over the window's first TRAIN_COMPARE_SUBSTEPS substeps (a depth cut).
        frames = TRAIN_COMPARE_SUBSTEPS // setup["config"].n_substeps + 1
        cut = dict(setup, batch=dataclasses.replace(batch, targets=batch.targets[:, :frames], t=batch.t[:frames]))
        timed_grads = []  # the setup's backend (the kernel), then scan: (loss, gradient), host ms
        for overrides in ({}, {"tridiag_backend": "scan"}):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss_grad = benchmarks.train_step_loss_and_grad(cut, **overrides)
            torch.cuda.synchronize()
            timed_grads.append((loss_grad, (time.perf_counter() - t) * 1e3))
        ((loss_k, grad_k), kernel_ms), ((loss_s, grad_s), scan_ms) = timed_grads
        log(f"one loss and gradient (no adam) over the first {frames} frames ({TRAIN_COMPARE_SUBSTEPS} of "
            f"{train['substeps']} substeps), host clock: kernel {kernel_ms:.1f} ms, tridiag_backend='scan' "
            f"{scan_ms:.1f} ms (information)")
        loss_rel = abs(float(loss_k) - float(loss_s)) / abs(float(loss_s))
        grad_rel = float((grad_k - grad_s).norm() / grad_s.norm())
        ok = bool(torch.isfinite(grad_k).all()) and loss_rel <= STEP_LOSS_RTOL and grad_rel <= STEP_GRAD_RTOL
        log(f"one step, kernel vs scan: loss {float(loss_k):.8e} vs {float(loss_s):.8e} (rel {loss_rel:.3e}, "
            f"limit {STEP_LOSS_RTOL}); gradient ({grad_k.numel()} entries) |g_k - g_s| / |g_s| = {grad_rel:.3e} "
            f"(limit {STEP_GRAD_RTOL}); max abs {float((grad_k - grad_s).abs().max()):.3e} of "
            f"max |g| {float(grad_s.abs().max()):.3e}. Reason: per-solve f32 differences between kernel and scan "
            f"through the substeps and the backward pass, amplified by the mPP tanh switch")
        if not ok:
            raise RuntimeError("kernel-backed and scan-backed steps disagree")

        prof = benchmarks.profile_train_step(setup, n_saves=2, device=dev)
        log(f"profiled step over {prof['substeps']} substeps (torch.profiler): wall {prof['wall_ms']:.1f} ms, "
            f"device busy {prof['device_busy_ms']:.2f} ms, idle share {prof['device_idle_share']:.3f}, "
            f"{prof['device_ops']} device ops ({prof['device_ops_per_substep']:.0f} per substep)")
        for key, n, ms in prof["top"]:
            log(f"  {key}: {n} x, {ms:.3f} ms")

    tbench = {}
    with phase("10 bench_tridiagonal: kernel, plain versions, torch.linalg.solve (and the shapes of phases 30, 33, 38 "
               "and 39)"):
        for n_sys in (16384, 54):
            r = benchmarks.bench_tridiagonal(n_sys, 32, device=dev)
            tbench[n_sys] = r
            log(f"{n_sys} x 32, device us per call, torch.profiler (wall us per call back to back, host work "
                f"included): "
                + ", ".join(f"{k} {r[k + '_ms'] * 1e3:.2f} ({r[k + '_wall_ms'] * 1e3:.2f})"
                            for k in ("cuda", "scan", "pcr", "library"))
                + f"; kernel in a CUDA graph of {r['repeats']} launches {r['cuda_graph_ms'] * 1e3:.2f} us each"
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
        # The shapes of phases 30, 33 and 38, measured here while the profiler still records every launch.
        kpp_tke_shapes = {f"{n_sys}x{NZ}": thomas_bench_record(benchmarks, dev, n_sys)
                          for n_sys in (3 * COL_COLUMNS, 4 * COL_COLUMNS, 3 * KPP_PLUGIN * len(benchmarks.TRAIN_FILES),
                                        GYRE_N * GYRE_N, GYRE_N * (GYRE_N + 1))}
        # The LES pressure solves of phase 39 (generate-les at 32^3, bench_les at 64^3, the les3d sources at
        # 64 x 64 x 128): equal to _thomas_scan, within the phase's limit of _thomas_pcr.
        les_shapes = {f"{n_sys}x{n}": thomas_bench_record(benchmarks, dev, n_sys, n)
                      for n_sys, n in LES_THOMAS_SHAPES}

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
        "train_step_ms": {"kernel": train["ms"]},
        "loss_and_grad_ms": {"kernel": kernel_ms, "scan": scan_ms, "substeps": TRAIN_COMPARE_SUBSTEPS},
        "train_step_vs_scan": {"kernel": {"loss_rel": loss_rel, "grad_rel": grad_rel}},
        "train_step_profile": {k: prof[k] for k in ("substeps", "wall_ms", "device_busy_ms", "device_idle_share",
                                                    "device_ops_per_substep")},
        "train_setup_s": setup_s,
        "kpp_tke_calibration_shapes": kpp_tke_shapes,
        "les_shapes": les_shapes,
        "build_s": thomas.build_seconds,
    }
    gram_record, chol_record = gp_phases(dev)
    bf16_record = bf16_phases(dev, flagship, stats["ms_median"])
    thomas_record["train_nde"] = train_nde_phase(dev, setup, train, smi)
    thomas_record["fc_forward"] = fc_forward_phase(dev, smi)
    thomas_record["train_fc_nde"] = train_fc_nde_phase(dev, smi)
    thomas_record["ensemble_step"] = ensemble_step_phase(dev, setup, train, smi)
    thomas_record["train_nde_ensemble"] = train_nde_ensemble_phase(dev, setup, smi)
    thomas_record["ensemble_uq"] = ensemble_uq_phase(dev, setup, smi)
    thomas_record["optimise_mpp"] = optimise_mpp_phase(dev, setup, smi)
    thomas_record["train_fc_nde_ensemble"] = train_fc_nde_ensemble_phase(dev, smi)
    thomas_record["kpp_tke_forward"] = column_baselines_phase(dev, smi)
    thomas_record["evaluate"] = evaluate_phase(dev, setup, smi)
    thomas_record["evaluate_fc"] = evaluate_fc_phase(dev, smi)
    thomas_record["calibrate_kpp"] = calibrate_kpp_phase(dev, smi)
    blocked_gp_phase(dev, smi)
    thomas_record["host_column"] = host_column_phase(dev, flagship, smi)
    thomas_record["train_embedded"] = train_embedded_phase(dev, setup, smi)
    thomas_record["evaluate_embedded"] = evaluate_embedded_phase(thomas_record["evaluate"], thomas_record["evaluate_fc"],
                                                                 smi)
    thomas_record["double_gyre"] = double_gyre_phase(dev, smi)
    thomas_record["les"] = les_phase(dev, smi)
    thomas_record["column_ensemble"] = column_ensemble_phase(dev, setup, smi)
    thomas_record["suite"] = suite_phase(smi)
    thomas_record["headline_report"] = headline_report_phase(dev, setup, flagship, smi)
    parallel_phase(dev, setup, smi)
    thomas_record["flagship_study"] = flagship_study_phase(dev, setup, smi)
    studies = studies_phase(dev, flagship, smi)
    record["studies"] = {k: studies[k] for k in ("forward_scaling", "fused_kernel_sweep")}
    bf16_record["studies"] = {"fused_kernel_sweep": studies["fused_kernel_sweep"]["launches"]["fused_rk4_bf16"]}
    thomas_record["fc_fair"] = studies["fc_fair"]
    gram_record["gp_at_scale"] = studies["gp_at_scale"]
    thomas_record["data_files"] = data_files_phase(dev, smi)
    record["ptxas"] = ptxas_summary(kernel.ptxas_report)
    thomas_record["ptxas"] = ptxas_summary(thomas.ptxas_report)
    print(smi, flush=True)
    print(json.dumps({"kernels": [record, thomas_record, gram_record, chol_record, bf16_record]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
