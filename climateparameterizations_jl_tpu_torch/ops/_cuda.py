"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each source is compiled on first use by one ``nvcc`` call into a shared
library with a plain C interface, and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library lands in ``_build/`` beside
``csrc/``, named by a hash of the source, the shared headers and the flags,
so an edited source or header rebuilds and a finished build is reused. Nothing is compiled or imported
from CUDA when this module is imported: the CPU tests import it too.

The wrapper checks device, type, shape and contiguity, allocates the output
with ``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises when the launch is refused. ``launches`` counts
the launches it made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's default place."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library(source: Path, extra_flags: tuple = ()) -> tuple[Path, str]:
    """Compile ``source`` into ``BUILD_DIR`` unless an identical build exists.

    The build key hashes the source, the headers of ``csrc/`` and the flags
    (``extra_flags``, such as ``fused_rk4_phases.py``'s ``-D``, included).
    Returns ``(library path, ptxas report)``. The report (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept beside the library.
    The library is written under a temporary name and renamed into place, so
    a build cut short leaves nothing that a later call would load.
    """
    headers = b"".join(h.read_bytes() for h in sorted(SOURCE_DIR.glob("*.cuh")))
    flags = (*NVCC_FLAGS, *extra_flags)
    key = hashlib.sha256(source.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{key}.so"
    report = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return lib, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source.name}:\n{proc.stderr}\n{proc.stdout}")
    text = (proc.stdout + proc.stderr).strip()
    report.write_text(text)
    os.replace(tmp, lib)
    return lib, text


class _Params(ctypes.Structure):
    """Mirror of ``FusedRK4Params`` in ``csrc/fused_rk4.cu`` and ``csrc/fused_rk4_bf16.cu``, field by field."""

    _fields_ = [
        ("n_columns", ctypes.c_int), ("n_steps", ctypes.c_int), ("Nz", ctypes.c_int),
        ("h1", ctypes.c_int), ("h2", ctypes.c_int), ("activation", ctypes.c_int),
        ("dt", ctypes.c_float), ("half_dt", ctypes.c_float), ("dt6", ctypes.c_float),
        ("epsdz", ctypes.c_float), ("au", ctypes.c_float), ("av", ctypes.c_float), ("aT", ctypes.c_float),
        ("n_a", ctypes.c_float), ("n_b", ctypes.c_float), ("t_a", ctypes.c_float), ("t_b", ctypes.c_float),
        ("cu", ctypes.c_float), ("cv", ctypes.c_float), ("cT", ctypes.c_float),
        ("rdu", ctypes.c_float), ("rdv", ctypes.c_float), ("rdT", ctypes.c_float),
    ]


ACTIVATION_CODES = {"mish": 0, "relu": 1}


def layer1_pitch(h1: int) -> int:
    """Each flux MLP's column pitch in the f32 kernel's ``A1``: ``h1`` rounded up to a multiple of 4."""
    return -(-h1 // 4) * 4


def pack_weights(A1, b1, A2, b2, A3, b3, Krow, w1, w2, Nz: int, h1: int, h2: int) -> np.ndarray:
    """The f32 kernel's weight buffer from the MXU-layout operands (numpy).

    ``A1 (3Nz, 3h1)`` is stored k-major with each MLP's ``h1`` neurons in a
    block of :func:`layer1_pitch` columns (zeros after them), so that four
    neurons of one MLP are one 16-byte load; the block-diagonal ``A2 (3h1,
    3h2)`` and ``A3 (3h2, 3Nz)`` (block-aligned: block ``b`` in lanes ``[b Nz,
    b Nz + Nz - 1)``) are stored as their three diagonal blocks, ``b3``
    likewise. The order is the one ``make_layout`` in ``csrc/fused_rk4.cu``
    reads.
    """
    ni, pitch = Nz - 1, layer1_pitch(h1)
    A1 = np.asarray(A1, np.float32)
    W1 = np.zeros((3 * Nz, 3 * pitch), np.float32)
    for b in range(3):
        W1[:, b * pitch:b * pitch + h1] = A1[:, b * h1:(b + 1) * h1]
    A2b = np.stack([A2[b * h1:(b + 1) * h1, b * h2:(b + 1) * h2] for b in range(3)])
    A3b = np.stack([A3[b * h2:(b + 1) * h2, b * Nz:b * Nz + ni] for b in range(3)])
    b3 = np.asarray(b3).reshape(-1)
    b3b = np.stack([b3[b * Nz:b * Nz + ni] for b in range(3)])
    parts = (W1, b1, A2b, b2, A3b, b3b, Krow, w1, w2)
    return np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in parts])


MMA_M, MMA_K = 16, 16  # mma.sync m16n8k16: the weight (A) operand is 16 x 16 per tile


def _bf16_bits(a) -> np.ndarray:
    """The bf16 bit patterns (uint16) of ``a``: rounded to nearest even, as ``.to(torch.bfloat16)`` rounds."""
    t = torch.as_tensor(a).detach().cpu()
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def mma_a_fragments(W) -> np.ndarray:
    """``mma.m16n8k16`` A-operand fragments of ``W.T`` for a right-multiply ``W (K, M)``, as bf16 bits.

    ``W.T`` is zero-padded to ``(16 MT, 16 KT)`` and cut into 16 x 16 tiles;
    the result has shape ``(MT, KT, 32, 8)``: for tile ``(mt, kt)`` and lane
    ``l`` (``g = l // 4``, ``t = l % 4``), the lane's four 32-bit registers
    ``a0..a3`` hold rows ``g, g + 8, g, g + 8`` at columns ``2t, 2t, 2t + 8,
    2t + 8`` and the next column, the lower column in the lower half
    (the PTX ISA's fragment layout for ``.bf16`` A operands).
    """
    W = _bf16_bits(W)
    K, M = W.shape
    MT, KT = -(-M // MMA_M), -(-K // MMA_K)
    A = np.zeros((MT * MMA_M, KT * MMA_K), np.uint16)
    A[:M, :K] = W.T
    tiles = A.reshape(MT, MMA_M, KT, MMA_K).transpose(0, 2, 1, 3)  # (MT, KT, 16, 16)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    rows = np.repeat(np.stack([g, g + 8, g, g + 8], 1), 2, axis=1)  # (32, 8)
    cols = np.repeat(np.stack([2 * t, 2 * t, 2 * t + 8, 2 * t + 8], 1), 2, axis=1) + np.tile([0, 1], 4)
    return np.ascontiguousarray(tiles[:, :, rows, cols])


def pack_weights_bf16(A1, b1, A2, b2, A3, b3, Krow, w1, w2, Nz: int, h1: int, h2: int):
    """The bf16 kernel's two weight buffers from the MXU-layout operands.

    Returns ``(vecs, frags)``: ``vecs`` the f32 rows ``b1, b2``, the three
    ``b3`` blocks, ``Krow, w1, w2`` (the f32 kernel's order); ``frags`` the
    bf16 bits (uint16) of the three NN products' weight fragments
    (:func:`mma_a_fragments`): ``A1 (3Nz, 3h1)`` dense, then the three
    diagonal blocks of ``A2`` and the three of ``A3`` (block ``b`` of the
    block-aligned ``A3`` in lanes ``[b Nz, b Nz + Nz - 1)``), each padded to
    whole 16 x 16 tiles. The order is the one ``make_layout`` in
    ``csrc/fused_rk4_bf16.cu`` reads.
    """
    ni = Nz - 1
    A2 = torch.as_tensor(A2)
    A3 = torch.as_tensor(A3)
    b3 = np.asarray(b3, np.float32).reshape(-1)
    b3b = np.stack([b3[b * Nz:b * Nz + ni] for b in range(3)])
    vecs = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in (b1, b2, b3b, Krow, w1, w2)])
    frags = [mma_a_fragments(A1)]
    frags += [mma_a_fragments(A2[b * h1:(b + 1) * h1, b * h2:(b + 1) * h2]) for b in range(3)]
    frags += [mma_a_fragments(A3[b * h2:(b + 1) * h2, b * Nz:b * Nz + ni]) for b in range(3)]
    return vecs, np.concatenate([f.reshape(-1) for f in frags])


def make_params(*, n_columns, n_steps, Nz, h1, h2, activation, dt, coefficients: dict) -> _Params:
    """Kernel scalars; ``coefficients`` are the folded RHS constants of ``fused_rhs._rhs_coefficients``."""
    c = coefficients
    return _Params(
        n_columns=n_columns, n_steps=n_steps, Nz=Nz, h1=h1, h2=h2, activation=ACTIVATION_CODES[activation],
        dt=dt, half_dt=0.5 * dt, dt6=dt / 6.0,
        epsdz=c["epsdz"], au=c["au"], av=c["av"], aT=c["aT"],
        n_a=c["n_a"], n_b=c["n_b"], t_a=c["t_a"], t_b=c["t_b"],
        cu=c["cu"], cv=c["cv"], cT=c["cT"],
        rdu=c["rdu"], rdv=c["rdv"], rdT=c["rdT"],
    )


class _Kernel:
    """One ``csrc/`` source: built and loaded on first use, with a launch count."""

    source: Path

    def __init__(self):
        self.extra_flags = ()  # extra nvcc flags, set before the first load
        self.launches = 0
        self.build_seconds = None
        self.ptxas_report = ""
        self.library_path = None
        self._lib = None

    def _bind(self, lib) -> None:
        """Declare ``argtypes``/``restype`` of the library's C functions."""
        raise NotImplementedError

    def load(self):
        """Build (if needed) and load the library; returns the ``ctypes`` handle."""
        if self._lib is None:
            t0 = time.perf_counter()
            path, self.ptxas_report = build_library(self.source, self.extra_flags)
            self.library_path = path
            lib = ctypes.CDLL(str(path))
            self._bind(lib)
            self._lib = lib
            self.build_seconds = time.perf_counter() - t0
        return self._lib

    def _check(self, rc: int, name: str) -> None:
        if rc != 0:
            msg = getattr(self._lib, f"{name}_error_string")(rc).decode()
            raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


class FusedRK4Kernel(_Kernel):
    """``csrc/fused_rk4.cu``: ``n_steps`` of RK4 on the wind-mixing RHS in one launch."""

    source = SOURCE_DIR / "fused_rk4.cu"

    def _bind(self, lib) -> None:
        lib.fused_rk4_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _Params, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fused_rk4_launch.restype = ctypes.c_int
        lib.fused_rk4_error_string.argtypes = [ctypes.c_int]
        lib.fused_rk4_error_string.restype = ctypes.c_char_p
        for name in ("fused_rk4_weight_count", "fused_rk4_specialized", "fused_rk4_smem_bytes"):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        for name in ("fused_rk4_columns_per_block", "fused_rk4_threads_per_block"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int

    def __call__(self, x0: torch.Tensor, weights: torch.Tensor, params: _Params) -> torch.Tensor:
        """Launch on ``x0 (n_columns, 3 Nz)``; returns the state after ``params.n_steps`` steps."""
        F = 3 * params.Nz
        if x0.device.type != "cuda" or weights.device != x0.device:
            raise ValueError(f"fused_rk4 needs x0 and weights on one CUDA device, got {x0.device} and {weights.device}")
        if x0.dtype != torch.float32 or weights.dtype != torch.float32:
            raise ValueError(f"fused_rk4 takes float32, got {x0.dtype} and {weights.dtype}")
        if x0.dim() != 2 or x0.shape != (params.n_columns, F):
            raise ValueError(f"fused_rk4 expects x0 of shape ({params.n_columns}, {F}), got {tuple(x0.shape)}")
        if not (x0.is_contiguous() and weights.is_contiguous()):
            raise ValueError("fused_rk4 takes contiguous tensors")
        lib = self.load()
        n_weights = lib.fused_rk4_weight_count(params.Nz, params.h1, params.h2)
        if weights.numel() != n_weights:
            raise ValueError(f"fused_rk4 expects {n_weights} packed weights, got {weights.numel()}")
        out = torch.empty_like(x0)
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = lib.fused_rk4_launch(
            ctypes.c_void_p(x0.data_ptr()), ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(weights.data_ptr()),
            params, _device_index(x0), ctypes.c_void_p(stream),
        )
        self._check(rc, "fused_rk4")
        self.launches += 1
        return out


class FusedRK4Bf16Kernel(_Kernel):
    """``csrc/fused_rk4_bf16.cu``: the fused RK4 trajectory with bf16 NN products on the tensor cores.

    ``shape`` picks one of the source's compiled launch shapes (columns and
    warps per CTA; :meth:`shapes`); ``None`` is its default, the one the
    runners use.
    """

    source = SOURCE_DIR / "fused_rk4_bf16.cu"

    def _bind(self, lib) -> None:
        lib.fused_rk4_bf16_launch.argtypes = [ctypes.c_void_p] * 4 + [_Params, ctypes.c_int, ctypes.c_int,
                                                                       ctypes.c_void_p]
        lib.fused_rk4_bf16_launch.restype = ctypes.c_int
        lib.fused_rk4_bf16_error_string.argtypes = [ctypes.c_int]
        lib.fused_rk4_bf16_error_string.restype = ctypes.c_char_p
        for name in ("fused_rk4_bf16_vec_count", "fused_rk4_bf16_frag_count"):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        lib.fused_rk4_bf16_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.fused_rk4_bf16_smem_bytes.restype = ctypes.c_int
        lib.fused_rk4_bf16_shape_count.argtypes = []
        lib.fused_rk4_bf16_shape_count.restype = ctypes.c_int
        for name in ("fused_rk4_bf16_shape_columns", "fused_rk4_bf16_shape_warps"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int

    def shapes(self) -> list[tuple[int, int]]:
        """``(columns, warps)`` per CTA of each compiled launch shape; the first is the default."""
        lib = self.load()
        return [(lib.fused_rk4_bf16_shape_columns(i), lib.fused_rk4_bf16_shape_warps(i))
                for i in range(lib.fused_rk4_bf16_shape_count())]

    def __call__(self, x0: torch.Tensor, vecs: torch.Tensor, frags: torch.Tensor, params: _Params,
                 shape: int | None = None) -> torch.Tensor:
        """Launch on ``x0 (n_columns, 3 Nz)``; returns the state after ``params.n_steps`` steps."""
        F = 3 * params.Nz
        args = (x0, vecs, frags)
        if x0.device.type != "cuda" or any(a.device != x0.device for a in args):
            raise ValueError(f"fused_rk4_bf16 needs x0, vecs and frags on one CUDA device, got "
                             f"{[str(a.device) for a in args]}")
        if x0.dtype != torch.float32 or vecs.dtype != torch.float32 or frags.dtype != torch.bfloat16:
            raise ValueError(f"fused_rk4_bf16 takes float32 x0 and vecs and bfloat16 frags, got "
                             f"{[a.dtype for a in args]}")
        if x0.dim() != 2 or x0.shape != (params.n_columns, F):
            raise ValueError(f"fused_rk4_bf16 expects x0 of shape ({params.n_columns}, {F}), got {tuple(x0.shape)}")
        if not all(a.is_contiguous() for a in args) or frags.data_ptr() % 16:
            raise ValueError("fused_rk4_bf16 takes contiguous tensors, frags on a 16-byte boundary")
        lib = self.load()
        dims = (params.Nz, params.h1, params.h2)
        if vecs.numel() != lib.fused_rk4_bf16_vec_count(*dims) or frags.numel() != lib.fused_rk4_bf16_frag_count(*dims):
            raise ValueError(f"fused_rk4_bf16 expects {lib.fused_rk4_bf16_vec_count(*dims)} f32 and "
                             f"{lib.fused_rk4_bf16_frag_count(*dims)} bf16 weights, got {vecs.numel()} and "
                             f"{frags.numel()}")
        n_shapes = lib.fused_rk4_bf16_shape_count()
        if shape is not None and not 0 <= shape < n_shapes:
            raise ValueError(f"fused_rk4_bf16 has launch shapes 0..{n_shapes - 1}, got {shape}")
        out = torch.empty_like(x0)
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = lib.fused_rk4_bf16_launch(
            *(ctypes.c_void_p(a.data_ptr()) for a in (x0, out, vecs, frags)),
            params, 0 if shape is None else shape, _device_index(x0), ctypes.c_void_p(stream),
        )
        self._check(rc, "fused_rk4_bf16")
        self.launches += 1
        return out


class ThomasKernel(_Kernel):
    """``csrc/thomas.cu``: batched tridiagonal solve of contiguous f32 ``(B, N)`` systems."""

    source = SOURCE_DIR / "thomas.cu"

    def _bind(self, lib) -> None:
        lib.thomas_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.thomas_launch.restype = ctypes.c_int
        lib.thomas_error_string.argtypes = [ctypes.c_int]
        lib.thomas_error_string.restype = ctypes.c_char_p
        for name in ("thomas_max_n", "thomas_systems_per_block", "thomas_threads_per_block"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.thomas_smem_bytes.argtypes = [ctypes.c_int]
        lib.thomas_smem_bytes.restype = ctypes.c_int

    def __call__(self, dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Solve on ``(B, N)`` inputs (``dl[:, 0]``, ``du[:, N-1]`` ignored); returns ``x (B, N)``."""
        args = (dl, d, du, b)
        if b.device.type != "cuda" or any(a.device != b.device for a in args):
            raise ValueError(f"thomas needs all four inputs on one CUDA device, got {[str(a.device) for a in args]}")
        if any(a.dtype != torch.float32 for a in args):
            raise ValueError(f"thomas takes float32, got {[a.dtype for a in args]}")
        if b.dim() != 2 or any(a.shape != b.shape for a in args):
            raise ValueError(f"thomas expects four (B, N) tensors of one shape, got {[tuple(a.shape) for a in args]}")
        if not all(a.is_contiguous() for a in args):
            raise ValueError("thomas takes contiguous tensors")
        lib = self.load()
        n_systems, n = b.shape
        if not 1 <= n <= lib.thomas_max_n():
            raise ValueError(f"thomas supports 1 <= N <= {lib.thomas_max_n()}, got N = {n}")
        out = torch.empty_like(b)
        if n_systems == 0:
            return out
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = lib.thomas_launch(
            *(ctypes.c_void_p(a.data_ptr()) for a in (*args, out)),
            n_systems, n, _device_index(b), ctypes.c_void_p(stream),
        )
        self._check(rc, "thomas")
        self.launches += 1
        return out


GRAM_FAMILIES = ("squared_exponential", "matern12", "matern32", "matern52", "rational_quadratic")


class GramKernel(_Kernel):
    """``csrc/gram.cu``: fused Gram matrix ``K = k(||A_i - B_j||)`` of contiguous f32 rows."""

    source = SOURCE_DIR / "gram.cu"

    def _bind(self, lib) -> None:
        lib.gram_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.gram_launch.restype = ctypes.c_int
        lib.gram_error_string.argtypes = [ctypes.c_int]
        lib.gram_error_string.restype = ctypes.c_char_p
        for name in ("gram_tile", "gram_threads_per_block"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int

    def __call__(self, A: torch.Tensor, B: torch.Tensor, params: torch.Tensor, family: str) -> torch.Tensor:
        """Launch on ``A (M, D)``, ``B (N, D)`` and ``params = (gamma, sigma, alpha)``; returns ``K (M, N)``."""
        args = (A, B, params)
        if A.device.type != "cuda" or any(a.device != A.device for a in args):
            raise ValueError(f"gram needs A, B and params on one CUDA device, got {[str(a.device) for a in args]}")
        if any(a.dtype != torch.float32 for a in args):
            raise ValueError(f"gram takes float32, got {[a.dtype for a in args]}")
        if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[1]:
            raise ValueError(f"gram expects A (M, D) and B (N, D), got {tuple(A.shape)} and {tuple(B.shape)}")
        if params.shape != (3,):
            raise ValueError(f"gram expects params (gamma, sigma, alpha) of shape (3,), got {tuple(params.shape)}")
        if not all(a.is_contiguous() for a in args):
            raise ValueError("gram takes contiguous tensors")
        if family not in GRAM_FAMILIES:
            raise ValueError(f"unknown kernel family {family!r}")
        (M, D), N = A.shape, B.shape[0]
        if M == 0 or N == 0 or D == 0:
            raise ValueError(f"gram needs M, N, D >= 1, got {M}, {N}, {D}")
        lib = self.load()
        out = torch.empty((M, N), dtype=torch.float32, device=A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.gram_launch(
            *(ctypes.c_void_p(a.data_ptr()) for a in (*args, out)),
            M, N, D, GRAM_FAMILIES.index(family), _device_index(A), ctypes.c_void_p(stream),
        )
        self._check(rc, "gram")
        self.launches += 1
        return out


class CholeskyKernel(_Kernel):
    """``csrc/cholesky.cu``: blocked Cholesky factor of a contiguous f32 ``(n, n)`` SPD matrix.

    One call launches ``cholesky_launch_count(n)`` kernels on the current
    stream, with a ``cholesky_tile()``-square scratch tile allocated here;
    ``launches`` counts every one of them.
    """

    source = SOURCE_DIR / "cholesky.cu"

    def _bind(self, lib) -> None:
        lib.cholesky_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.cholesky_launch.restype = ctypes.c_int
        lib.cholesky_error_string.argtypes = [ctypes.c_int]
        lib.cholesky_error_string.restype = ctypes.c_char_p
        for name in ("cholesky_tile", "cholesky_panel_rows_per_block", "cholesky_window"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.cholesky_launch_count.argtypes = [ctypes.c_int]
        lib.cholesky_launch_count.restype = ctypes.c_int

    def launches_per_call(self, n: int) -> int:
        return self.load().cholesky_launch_count(n)

    def __call__(self, K: torch.Tensor) -> torch.Tensor:
        """Factorize ``K (n, n)``; returns the lower factor ``L`` with a zero upper triangle."""
        if K.device.type != "cuda":
            raise ValueError(f"cholesky needs a CUDA tensor, got {K.device}")
        if K.dtype != torch.float32:
            raise ValueError(f"cholesky takes float32, got {K.dtype}")
        if K.dim() != 2 or K.shape[0] != K.shape[1] or K.shape[0] == 0:
            raise ValueError(f"cholesky expects a non-empty square matrix, got {tuple(K.shape)}")
        if not K.is_contiguous():
            raise ValueError("cholesky takes a contiguous tensor")
        lib = self.load()
        out = torch.empty_like(K)
        tile = lib.cholesky_tile()
        scratch = torch.empty((tile, tile), dtype=torch.float32, device=K.device)  # the next diagonal tile
        launched = ctypes.c_int(0)
        stream = torch.cuda.current_stream(K.device).cuda_stream
        rc = lib.cholesky_launch(*(ctypes.c_void_p(a.data_ptr()) for a in (K, out, scratch)), K.shape[0],
                                 _device_index(K), ctypes.c_void_p(stream), ctypes.byref(launched))
        self.launches += launched.value
        self._check(rc, "cholesky")
        return out


FUSED_RK4 = FusedRK4Kernel()
FUSED_RK4_BF16 = FusedRK4Bf16Kernel()
THOMAS = ThomasKernel()
GRAM = GramKernel()
CHOLESKY = CholeskyKernel()

KERNELS = {"fused_rk4": FUSED_RK4, "fused_rk4_bf16": FUSED_RK4_BF16, "thomas": THOMAS, "gram": GRAM, "cholesky": CHOLESKY}


def _timed_build(kernel: _Kernel) -> float:
    t0 = time.perf_counter()
    build_library(kernel.source, kernel.extra_flags)
    return time.perf_counter() - t0


def load_all() -> None:
    """Build every kernel at once (one ``nvcc`` per source, run side by side), then load each.

    Each kernel's ``build_seconds`` is then its own ``nvcc`` time plus its load.
    """
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        seconds = [f.result() for f in [pool.submit(_timed_build, k) for k in KERNELS.values()]]
    for k, s in zip(KERNELS.values(), seconds):
        if k._lib is None:
            k.load()
            k.build_seconds += s


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
