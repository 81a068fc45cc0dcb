"""The Gram kernel's CUDA source, ``csrc/gram.cu``, built with g++ and run on the CPU.

``tests/cuda_host_emulation/`` stands in for the CUDA headers (a host thread
per CUDA thread, ``std::barrier`` for ``__syncthreads``, ``cp.async`` as
synchronous copies), so the kernel runs its own tiling, swizzled shared
layout, staging ring, norms, epilogue and masks on the CPU, with the copy and
store widths that ``gram_launch`` would pick for the same pointers. The
launch function itself is left out (``CSRC_HOST_EMULATION``); the kernel is
held against ``gram_plain`` on the card by ``tests/test_torch_cuda.py``.
Skips where there is no ``g++``.

Tolerance: the JAX test's (``tests/test_gp.py::TestPallasGram``),
``rtol=2e-5, atol=2e-6``: two f32 Gram-trick evaluations summed in other
orders. A training Gram (``B is A``) is held exactly on its diagonal, where
the kernel sums the product and the row norms in one order (an ``fmaf``
chain per feature half, then the two halves added), so ``d2 = 0`` and
``K_ii = sigma``; off the diagonal at the same tolerance.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu_torch.ops import _cuda
from climateparameterizations_jl_tpu_torch.ops import gram as tgram

GRAM_RTOL, GRAM_ATOL = 2e-5, 2e-6
HARNESS = Path(__file__).resolve().parent / "cuda_host_emulation"
FAMILIES = _cuda.GRAM_FAMILIES

# (M, N, D, grid, (16-byte copies, 16-byte stores)); grid 0 is one CTA per tile.
SHAPES = {
    "37x23x12": (37, 23, 12, 0, (1, 0)),        # one ragged tile, one ragged chunk
    "130x70x130": (130, 70, 130, 0, (0, 0)),    # 2 x 2 tiles, 5 chunks through the 3-slot ring
    "1x65x1": (1, 65, 1, 0, (0, 0)),            # one row, two column tiles, one feature
    "70x44x95": (70, 44, 95, 0, (0, 1)),        # D = 95 (derivative features): 4-byte copies
    "150x100x96": (150, 100, 96, 3, (1, 1)),    # 4 tiles on 3 CTAs: the tile loop
}


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel for the host")
    so = tmp_path_factory.mktemp("gram_host") / "emulate_gram.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-DCSRC_HOST_EMULATION",
                    "-I", str(HARNESS), "-I", str(_cuda.SOURCE_DIR), str(HARNESS / "emulate_gram.cpp"),
                    "-o", str(so)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.emulate_gram.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.emulate_gram.restype = ctypes.c_int
    return lib


def _emulate(lib, A, B, hyp, family, grid=0):
    """``(K, (grid, 16-byte copies, 16-byte stores))`` of the emulated launch."""
    A, B = (np.ascontiguousarray(x, np.float32) for x in (A, B))
    K = np.full((A.shape[0], B.shape[0]), np.nan, np.float32)
    h = [np.array([v], np.float32) for v in hyp]
    used = (ctypes.c_int * 3)()
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    rc = lib.emulate_gram(ptr(A), ptr(B), *(ptr(x) for x in h), ptr(K), A.shape[0], B.shape[0], A.shape[1],
                          FAMILIES.index(family), grid, used)
    assert rc == 0
    return torch.from_numpy(K), tuple(used)


def _median_gamma(A, B):
    """``gamma`` with ``gamma^2 = median(d2) / 2``, where the entries are O(0.1-1)."""
    d2 = ((A.astype(np.float64)[:, None, :] - B.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(0.5 * np.median(d2)))


def _plain(A, B, hyp, family):
    return tgram.gram_plain(torch.tensor(A), torch.tensor(B), *(torch.tensor(v, dtype=torch.float32) for v in hyp),
                            family=family)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("case", list(SHAPES))
def test_gram_kernel_matches_plain(emulator, case, family):
    M, N, D, grid, widths = SHAPES[case]
    rng = np.random.default_rng(M + N + D)
    A = rng.normal(size=(M, D)).astype(np.float32)
    B = rng.normal(size=(N, D)).astype(np.float32)
    # The JAX test's hyperparameters, then a length scale where K is not trivial.
    for hyp in ((1.7, 0.8, 1.3), (_median_gamma(A, B), 0.8, 1.3)):
        got, used = _emulate(emulator, A, B, hyp, family, grid)
        assert used[1:] == widths and (grid == 0 or used[0] == grid)
        torch.testing.assert_close(got, _plain(A, B, hyp, family), rtol=GRAM_RTOL, atol=GRAM_ATOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_training_gram_diagonal_is_exact(emulator, family):
    # 136 rows: two row tiles and three column tiles, 16-byte copies and stores.
    X = np.random.default_rng(5).normal(size=(136, 96)).astype(np.float32)
    hyp = (_median_gamma(X, X), 0.8, 1.3)
    got, used = _emulate(emulator, X, X, hyp, family)
    assert used == (6, 1, 1)
    assert torch.equal(got.diagonal(), torch.full((136,), 0.8))  # d2 = 0 exactly: K_ii = sigma k(0)
    off = ~torch.eye(136, dtype=torch.bool)
    torch.testing.assert_close(got[off], _plain(X, X, hyp, family)[off], rtol=GRAM_RTOL, atol=GRAM_ATOL)


def test_nan_input_stays_nan(emulator):
    # The clamp at 0 keeps a NaN (as jnp.maximum does): the row of the NaN feature is NaN.
    A = np.random.default_rng(6).normal(size=(9, 8)).astype(np.float32)
    B = A[:5].copy()
    A[2, 3] = np.nan
    got, _ = _emulate(emulator, A, B, (2.0, 1.0, 1.0), "matern32")
    assert torch.isnan(got[2]).all() and torch.isfinite(got[torch.arange(9) != 2]).all()
