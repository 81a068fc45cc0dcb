"""The fused RK4 kernels' CUDA sources, built with g++ and run on the CPU.

``tests/cuda_host_emulation/`` stands in for the CUDA headers: each CUDA
thread of a block is a host thread, and ``__syncthreads``, the named
barriers, ``__shfl_xor_sync`` and ``mma.sync`` are emulated with
``std::barrier``, so ``csrc/fused_rk4.cu`` and ``csrc/fused_rk4_bf16.cu`` run
their own schedule, indexing and arithmetic (with ``1.0f / x`` for the
written-out reciprocal, which agrees with it for normal arguments). The
launch functions and the inline PTX are left out (``CSRC_HOST_EMULATION``).
This checks the layouts, the phase schedule and the tails without a card;
the kernels themselves are held against their plain versions on the card by
``tests/test_torch_cuda.py``. Skips where there is no ``g++``.

Tolerance: the kernels' own against their plain versions (``rtol=2e-4,
atol=2e-6``): f32 sums in other orders (and, emulated, exact products of the
bf16-rounded inputs), amplified by the stiff tendency scaling.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.closures.mlp import wind_mixing_mlp
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm
from climateparameterizations_jl_tpu_torch.ops import _cuda
from climateparameterizations_jl_tpu_torch.ops import fused_rhs as tfr
from climateparameterizations_jl_tpu_torch.train.checkpoint import load_flux_nns
from test_torch_cuda import wide_range_nns

RTOL, ATOL = 2e-4, 2e-6
DT = benchmarks.FORWARD_DT
REPO = Path(__file__).resolve().parents[1]
HARNESS = REPO / "tests" / "cuda_host_emulation"


@pytest.fixture(scope="module")
def emulators(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("fused_rk4_host")
    libs = {}
    for name, flag in (("float32", 0), ("bfloat16", 1)):
        so = out / f"emulate_{name}.so"
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-DCSRC_HOST_EMULATION",
                        f"-DEMULATE_BF16={flag}", "-I", str(HARNESS), "-I", str(_cuda.SOURCE_DIR),
                        str(HARNESS / "emulate.cpp"), "-o", str(so)], check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(str(so))
        lib.emulate_launch.argtypes = [ctypes.c_void_p] * 4 + [_cuda._Params, ctypes.c_int]
        lib.emulate_launch.restype = ctypes.c_int
        lib.emulate_mish.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.emulate_mish.restype = None
        libs[name] = lib
    return libs


def _runner(n_columns, n_steps=2, matmul_dtype="float32", Nz=32, nns=None, make=tfr.make_fused_runner_mxu):
    if nns is None:
        nns = load_flux_nns(str(REPO / "runs" / "wm_flagship_fold"), device="cpu")
    model, nns, bcs, x0 = benchmarks.make_setup(Nz, n_columns, seed=n_columns, nns=nns, device="cpu")
    kw = {"matmul_dtype": matmul_dtype} if make is tfr.make_fused_runner_mxu else {}
    return make(model, nns, bcs, DT, n_steps, n_columns, device="cpu", **kw), x0


def _generic_nns(wide: bool):
    """Flux MLPs at Nz = 16, h1 = 24, h2 = 12 (Glorot-uniform at scale 1, or of wide range)."""
    if wide:
        return wide_range_nns(16, (24, 12), seed=5, device="cpu")
    gen = torch.Generator().manual_seed(2)
    return twm.FluxNNs(*(wind_mixing_mlp(gen, 16, hidden=(24, 12), device="cpu") for _ in range(3)))


def _emulate(lib, run, x0, shape=0):
    weights, frags = run.kernel_buffers()
    x = np.ascontiguousarray(x0.numpy(), np.float32)
    out = np.full_like(x, np.nan)
    ptr = lambda a: ctypes.c_void_p(None if a is None else a.ctypes.data)  # noqa: E731
    rc = lib.emulate_launch(ptr(x), ptr(out), ptr(np.ascontiguousarray(weights)),
                            ptr(None if frags is None else np.ascontiguousarray(frags)), run.make_kernel_params(),
                            shape)
    assert rc > 0, f"emulated launch refused ({rc})"
    return torch.from_numpy(out)


def _check(lib, run, x0, shape=0):
    got = _emulate(lib, run, x0, shape)
    want = run.plain(x0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert float((want - x0).abs().max()) > 1e-4, "the state did not evolve"


@pytest.mark.parametrize("n_columns", [1, 6, 9, 11])
def test_f32_kernel_matches_plain(emulators, n_columns):
    # 4 columns per CTA: 1 column is one CTA with three empty columns; 6, 9 and 11 end
    # on a CTA with 2, 1 and 3 columns.
    run, x0 = _runner(n_columns)
    _check(emulators["float32"], run, x0)


def test_f32_kernel_v1_entry(emulators):
    run, x0 = _runner(9, make=tfr.make_fused_runner)
    _check(emulators["float32"], run, x0)


@pytest.mark.parametrize("wide", [False, True])
def test_f32_kernel_generic_widths(emulators, wide):
    # Nz = 16, h1 = 24, h2 = 12: the generic instantiation (h1 a multiple of 4 here, so
    # the padded layer-1 pitch is h1 itself; test_f32_kernel_wide_preactivations pads).
    run, x0 = _runner(11, Nz=16, nns=_generic_nns(wide))
    _check(emulators["float32"], run, x0)


@pytest.mark.parametrize("hidden", [(50, 20), (30, 7)])
def test_f32_kernel_wide_preactivations(emulators, hidden):
    # Pre-activations past +-30 on both hidden layers: every branch of the one-exp mish.
    nns = wide_range_nns(32, hidden, seed=7, device="cpu")
    run, x0 = _runner(9, nns=nns)
    z = x0 @ nns.uw.weights[0].T + nns.uw.biases[0]
    z2 = tfr.mish(z) @ nns.uw.weights[1].T + nns.uw.biases[1]
    assert min(float(z.min()), float(z2.min())) < -30 and max(float(z.max()), float(z2.max())) > 30
    _check(emulators["float32"], run, x0)


def test_f32_kernel_relu_and_zero_steps(emulators):
    nns = load_flux_nns(str(REPO / "runs" / "wm_flagship_fold"), device="cpu")
    relu = twm.FluxNNs(*[dataclasses.replace(m, activation="relu") for m in nns])
    run, x0 = _runner(9, nns=relu)
    _check(emulators["float32"], run, x0)
    run0, x0 = _runner(9, n_steps=0)
    assert torch.equal(_emulate(emulators["float32"], run0, x0), x0)


@pytest.mark.parametrize("shape", [0, 1, 2])
def test_bf16_kernel_matches_plain_every_shape(emulators, shape):
    run, x0 = _runner(17, matmul_dtype="bfloat16")
    _check(emulators["bfloat16"], run, x0, shape)


@pytest.mark.parametrize("wide", [False, True])
def test_bf16_kernel_generic_widths(emulators, wide):
    run, x0 = _runner(11, Nz=16, nns=_generic_nns(wide), matmul_dtype="bfloat16")
    _check(emulators["bfloat16"], run, x0)


def test_bf16_kernel_wide_preactivations_relu_and_zero_steps(emulators):
    nns = wide_range_nns(32, (50, 20), seed=7, device="cpu")
    run, x0 = _runner(9, nns=nns, matmul_dtype="bfloat16")
    _check(emulators["bfloat16"], run, x0)
    relu = twm.FluxNNs(*[dataclasses.replace(m, activation="relu") for m in nns])
    run, x0 = _runner(9, nns=relu, matmul_dtype="bfloat16")
    _check(emulators["bfloat16"], run, x0)
    run0, x0 = _runner(9, n_steps=0, matmul_dtype="bfloat16")
    assert torch.equal(_emulate(emulators["bfloat16"], run0, x0), x0)


def test_one_exp_mish_accuracy(emulators):
    """The kernels' activation, ``mish`` of ``csrc/fused_rk4_common.cuh`` (x (n (1 / (n + 2)))
    with n = e (e + 2), e = exp(min(x, 20)), no branch), built for the host: f32 against f64.
    The host's ``expf`` stands in for the card's (within 2 ulp by the CUDA documentation)."""
    lib, eps = emulators["float32"], np.finfo(np.float32).eps

    def mish(x):
        x = np.ascontiguousarray(x, np.float32)
        out = np.full_like(x, np.nan)
        lib.emulate_mish(x.ctypes.data, out.ctypes.data, x.size)
        return out

    x = np.linspace(-30, 30, 2_000_001, dtype=np.float32)
    m = mish(x)
    xd = x.astype(np.float64)
    ref = xd * np.tanh(np.log1p(np.exp(xd)))
    # 2.87 eps at most with numpy's f32 exp (the three-transcendental form: 1.7 eps).
    assert (np.abs(m - ref) / np.abs(ref).clip(min=1e-300)).max() <= 3.5 * eps
    # Below -87 exp is subnormal: the result is finite and tiny, as the plain version's.
    ms = mish(np.array([-87.5, -100.0, -104.0, -200.0]))
    assert np.isfinite(ms).all() and (np.abs(ms) < 1e-36).all()
    # Above the clamp the result is x to within an ulp.
    xl = np.array([20.0, 25.0, 88.0, 1e4, 3e38], np.float32)
    np.testing.assert_allclose(mish(xl), xl, rtol=eps, atol=0)
