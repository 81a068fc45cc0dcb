"""The Thomas kernel's CUDA source, ``csrc/thomas.cu``, built with g++ and run on the CPU.

``tests/cuda_host_emulation/`` stands in for the CUDA headers (a host thread
per CUDA thread, ``cp.async`` as synchronous copies) and for the written-out
reciprocal ``rcp_rn`` with the card's behaviour: ``rcp.approx.ftz`` flushes a
subnormal argument or reciprocal, so the kernel's fast-path quotient goes
wrong exactly where the card's does. The kernel runs both of its layouts
(float4 rows where N % 4 == 0 and the pointers are 16-byte aligned, scalar
rows otherwise) on systems whose quotients reach the subnormal range, and
must return ``_thomas_scan``'s numbers bit for bit: the scan divides with
IEEE division, so equality holds only if the kernel's sweep falls back to a
correctly rounded quotient wherever its fast path is not exact. The launch
function itself is left out (``CSRC_HOST_EMULATION``); the kernel is held
against ``_thomas_scan`` on the card by ``tests/test_torch_cuda.py``. Skips
where there is no ``g++``.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu_torch.ops import _cuda
from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

HARNESS = Path(__file__).resolve().parent / "cuda_host_emulation"
TINY = np.float32(2.0**-126)  # the smallest normal f32


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel for the host")
    so = tmp_path_factory.mktemp("thomas_host") / "emulate_thomas.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
                    "-DCSRC_HOST_EMULATION", "-I", str(HARNESS), "-I", str(_cuda.SOURCE_DIR),
                    str(HARNESS / "emulate_thomas.cpp"), "-o", str(so)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.emulate_thomas.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.emulate_thomas.restype = ctypes.c_int
    return lib


def run_kernel(lib, dl, d, du, b, offset: int = 0):
    """The emulated kernel on f32 ``(B, N)`` inputs; ``offset`` floats shift every row start off 16 bytes."""
    n_systems, n = b.shape
    bufs = [torch.zeros(n_systems * n + 4, dtype=torch.float32) for _ in range(5)]
    views = [buf[offset:offset + n_systems * n].view(n_systems, n) for buf in bufs]
    for v, a in zip(views, (dl, d, du, b)):
        v.copy_(a)
    used = ctypes.c_int(-1)
    rc = lib.emulate_thomas(*(ctypes.c_void_p(v.data_ptr()) for v in views), n_systems, n, ctypes.byref(used))
    assert rc == 0
    return views[4].clone(), bool(used.value)


def systems(shape, seed: int, rhs_scale=1.0):
    """Diagonally dominant f32 systems (``|dl|, |du| < 0.5 < 2 <= d``) and a right-hand side times ``rhs_scale``."""
    rng = np.random.default_rng(seed)
    dl = rng.uniform(-0.5, 0.5, shape)
    d = rng.uniform(2.0, 3.0, shape)
    du = rng.uniform(-0.5, 0.5, shape)
    b = rng.normal(size=shape) * rhs_scale
    return tuple(torch.tensor(a, dtype=torch.float32) for a in (dl, d, du, b))


def ignored_corners_zeroed(dl, d, du, b):
    """``dl[:, 0] = du[:, -1] = 0``, as ``tridiagonal_solve`` hands them to every backend.

    The kernel ignores the corners; the scan multiplies them by zero, which
    gives the same numbers except for the sign of a zero solution entry.
    """
    dl, du = dl.clone(), du.clone()
    dl[:, 0] = 0.0
    du[:, -1] = 0.0
    return dl, d, du, b


def assert_bitwise(got, want):
    g, w = got.view(torch.int32), want.view(torch.int32)
    differ = int((g != w).sum())
    assert differ == 0, f"{differ} of {got.numel()} entries differ from _thomas_scan (max abs {(got - want).abs().max()})"


def column_decay(n_systems: int, n: int, seed: int):
    """Systems like the host column's deep momentum: a right-hand side that decays from O(1) at the top
    level through the subnormal range to zero at the bottom, on implicit-diffusion diagonals."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1e-3, 5e-2, (n_systems, 1)) * np.ones((1, n))
    dl, du, d = -r, -r, 1.0 + 2.0 * r
    exponent = np.linspace(-150.0, 0.0, n)[None, :] + rng.uniform(-4.0, 4.0, (n_systems, n))
    b = rng.choice([-1.0, 1.0], (n_systems, n)) * np.exp2(exponent)
    return tuple(torch.tensor(a, dtype=torch.float32) for a in (dl, d, du, b))


@pytest.mark.parametrize("n,offset,vec", [(32, 0, True), (33, 0, False), (64, 0, True), (128, 0, True),
                                           (32, 1, False), (128, 1, False)],
                         ids=["32-float4", "33-scalar", "64-float4", "128-float4", "32-unaligned", "128-unaligned"])
@pytest.mark.parametrize("case", ["normal", "subnormal_rhs", "straddling_rhs", "column_decay"])
def test_kernel_equals_scan_bitwise(emulator, case, n, offset, vec):
    """Every layout, N = 32..128: the kernel equals the scan to the last bit, also where quotients are subnormal."""
    n_systems = 70  # three CTAs, the last one ragged
    if case == "normal":
        args = systems((n_systems, n), seed=n)
    elif case == "subnormal_rhs":
        args = systems((n_systems, n), seed=n + 1, rhs_scale=float(TINY) * 2.0**-10)
    elif case == "straddling_rhs":  # quotients on both sides of 2^-126 and of the fast path's 2^-100
        args = systems((n_systems, n), seed=n + 2, rhs_scale=float(TINY))
        args = (*args[:3], args[3] * torch.exp2(torch.linspace(-20.0, 30.0, n)).to(torch.float32))
    else:
        args = column_decay(n_systems, n, seed=n + 3)
    args = ignored_corners_zeroed(*args)
    got, used_vec = run_kernel(emulator, *args, offset=offset)
    assert used_vec == vec
    want = tri._thomas_scan(*args)
    if case != "normal":
        tiny = (want != 0) & (want.abs() < float(TINY))
        assert int(tiny.sum()) > 0, "the case must reach the subnormal range"
    assert_bitwise(got, want)


def test_subnormal_and_extreme_pivots(emulator):
    """Pivots and super-diagonals outside the fast path's ranges (subnormal, tiny, above 2^126) still give a / b
    exactly."""
    n_systems, n = 200, 32
    dl, d, du, b = systems((n_systems, n), seed=7)
    d[:10, 0] = float(TINY) * 0.5  # a subnormal first pivot, with its row scaled down to keep x finite
    du[:10, 0] = float(TINY) * 0.25
    b[:10, 0] = b[:10, 0] * 2.0**-30
    d[10:20, 5] = 2.0**127  # a pivot whose reciprocal is subnormal
    b[10:20, 5] = 2.0**120
    d[20:30] = d[20:30] * 2.0**-110  # every pivot in (2^-110, 2^-108): below the fast path's range
    dl[20:30] = dl[20:30] * 2.0**-110
    du[20:30] = du[20:30] * 2.0**-110
    b[20:30] = b[20:30] * 2.0**-120
    # A subnormal super-diagonal entry next to the last level (2^-127 to 2^-149): a subnormal cp quotient, which
    # the back-substitution multiplies by a last x near 2^44, so that its rounding shows in an x of size 2^-90
    # (the right-hand sides there); every numerator stays in the fast path's range.
    du[30:, -2] = du[30:, -2] * torch.exp2(torch.linspace(-127.0, -149.0, n_systems - 30))
    b[30:] = b[30:] * 2.0**-90
    b[30:, -1] = 2.0**45
    dl, d, du, b = ignored_corners_zeroed(dl, d, du, b)
    got, _ = run_kernel(emulator, dl, d, du, b)
    want = tri._thomas_scan(dl, d, du, b)
    assert bool(torch.isfinite(want).all())
    assert_bitwise(got, want)
