"""Card-only tests of the port's CUDA kernels against their plain versions.

Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false (decided inside the test). This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch, without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the JAX package's own for its fused kernel against the XLA path
(``rtol=2e-4, atol=2e-6``, ``tests/test_fused_rhs.py``): f32 with different
summation orders, amplified by the stiff tendency scaling.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.closures.mlp import MLP, wind_mixing_mlp
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm
from climateparameterizations_jl_tpu_torch.ops import _cuda
from climateparameterizations_jl_tpu_torch.ops import fused_rhs as tfr
from climateparameterizations_jl_tpu_torch.train.checkpoint import load_flux_nns

RTOL, ATOL = 2e-4, 2e-6
DT = benchmarks.FORWARD_DT
FLAGSHIP = Path(__file__).resolve().parents[1] / "runs" / "wm_flagship_fold"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _setup(dev, n_columns, trained=True, seed=0):
    nns = load_flux_nns(str(FLAGSHIP), device=dev) if trained else None
    return benchmarks.make_setup(32, n_columns, seed=seed, nns=nns, device=dev)


def wide_range_nns(Nz: int, hidden, seed: int, device) -> twm.FluxNNs:
    """Random mish flux MLPs whose hidden pre-activations span about +-30 on ``make_setup``'s states.

    They hold a kernel's activation against its plain version over the whole
    range where mish is neither 0 nor x: layer 1 maps the ``0.1 N(0, 1)``
    states to pre-activations of standard deviation about 15, layer 2 keeps
    them there (mish of those has an rms near 10.6), and layer 3 returns
    fluxes of order one. Weights and biases are normal, from a numpy generator
    seeded with ``seed``. ``tests/test_torch_fused_rk4_host.py`` uses them too.
    """
    rng = np.random.default_rng(seed)
    sizes = (3 * Nz, *hidden, Nz - 1)
    in_rms, out_std, bias_std = (0.1, 10.6, 10.6), (15.0, 15.0, 1.0), (5.0, 5.0, 0.1)

    def one():
        ws, bs = [], []
        for fan_in, fan_out, r, o, b in zip(sizes[:-1], sizes[1:], in_rms, out_std, bias_std):
            ws.append(torch.tensor(rng.normal(size=(fan_out, fan_in)) * (o / (r * math.sqrt(fan_in))),
                                   dtype=torch.float32, device=device))
            bs.append(torch.tensor(rng.normal(size=fan_out) * b, dtype=torch.float32, device=device))
        return MLP(weights=tuple(ws), biases=tuple(bs), activation="mish")

    return twm.FluxNNs(one(), one(), one())


@pytest.mark.cuda
@pytest.mark.parametrize("make", [tfr.make_fused_runner_mxu, tfr.make_fused_runner])
@pytest.mark.parametrize("n_columns", [1, 61, 1024])
def test_kernel_matches_plain(card, make, n_columns):
    model, nns, bcs, x0 = _setup(card, n_columns)
    run = make(model, nns, bcs, DT, 8, n_columns, device=card)
    before = _cuda.FUSED_RK4.launches
    got = run(x0)
    torch.cuda.synchronize()
    assert _cuda.FUSED_RK4.launches == before + 1
    want = run.plain(x0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_matches_solve_random_weights(card):
    model, nns, bcs, x0 = _setup(card, 256, trained=False, seed=3)
    got = tfr.make_fused_runner_mxu(model, nns, bcs, DT, 16, 256, device=card)(x0)
    want = twm.solve_wind_mixing_nde(model, nns, bcs, x0, 0.0, 16 * DT, 1, n_substeps=16)[-1]
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_relu(card):
    model, nns, bcs, x0 = _setup(card, 64)
    nns = twm.FluxNNs(*[dataclasses.replace(m, activation="relu") for m in nns])
    run = tfr.make_fused_runner_mxu(model, nns, bcs, DT, 8, 64, device=card)
    want = run.plain(x0)
    torch.testing.assert_close(run(x0), want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_zero_steps_returns_input(card):
    model, nns, bcs, x0 = _setup(card, 16)
    out = tfr.make_fused_runner_mxu(model, nns, bcs, DT, 0, 16, device=card)(x0)
    assert torch.equal(out, x0)


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(card):
    model, nns, bcs, x0 = _setup(card, 16)
    run = tfr.make_fused_runner_mxu(model, nns, bcs, DT, 1, 16, device=card)
    with pytest.raises(ValueError):
        run(x0[:8])
    with pytest.raises(ValueError):
        _cuda.FUSED_RK4(x0.double(), run.kernel_weights, run.kernel_params)
    with pytest.raises(ValueError):
        _cuda.FUSED_RK4(x0.t().contiguous().t(), run.kernel_weights, run.kernel_params)
    with pytest.raises(ValueError):
        _cuda.FUSED_RK4(x0, run.kernel_weights[:-1], run.kernel_params)


@pytest.mark.cuda
def test_bench_nde_forward_counts_launches(card):
    before = _cuda.FUSED_RK4.launches
    stats = benchmarks.bench_nde_forward(128, n_steps=16, repeats=2, device=card)
    assert _cuda.FUSED_RK4.launches - before == stats["calls"] == 3
    assert stats["ms_min"] > 0 and stats["column_timesteps_per_sec"] > 0


def _other_setup(dev, case, n_columns=61):
    """``(model, nns, bcs, x0)`` off the trained flagship: the generic instantiation (Nz = 16,
    h1 = 24, h2 = 12, Glorot-uniform MLPs) or MLPs whose pre-activations span about +-30."""
    if case == "generic":
        gen = torch.Generator().manual_seed(2)
        nns = twm.FluxNNs(*(wind_mixing_mlp(gen, 16, hidden=(24, 12), device=dev) for _ in range(3)))
        return benchmarks.make_setup(16, n_columns, seed=4, nns=nns, device=dev)
    Nz, hidden = (16, (24, 12)) if case == "generic_wide" else (32, (50, 20))
    nns = wide_range_nns(Nz, hidden, seed=7, device=dev)
    return benchmarks.make_setup(Nz, n_columns, seed=4, nns=nns, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["generic", "generic_wide", "flagship_wide"])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_kernel_generic_widths_and_wide_preactivations(card, case, matmul_dtype):
    model, nns, bcs, x0 = _other_setup(card, case)
    run = tfr.make_fused_runner_mxu(model, nns, bcs, DT, 8, x0.shape[0], matmul_dtype=matmul_dtype, device=card)
    got = run(x0)
    torch.cuda.synchronize()
    want = run.plain(x0)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert float((want - x0).abs().max()) > 1e-4
    lib = _cuda.FUSED_RK4.load()
    assert lib.fused_rk4_specialized(model.Nz, run.h1, run.h2) == (0 if case.startswith("generic") else 1)


# --- csrc/fused_rk4_bf16.cu against its plain version (bf16 NN products) -----
# Tolerance: the f32 kernel's. Both sides round the same inputs to bf16 to
# nearest even, so every product is exact; only the f32 sums run in other
# orders (the MMA's own accumulation included), and now and then an activation
# rounds to the other bf16 neighbour, one bf16 ulp in one input.


def _bf16_runner(dev, n_columns, n_steps=8, nns_change=None):
    model, nns, bcs, x0 = _setup(dev, n_columns)
    if nns_change:
        nns = twm.FluxNNs(*[dataclasses.replace(m, **nns_change) for m in nns])
    run = tfr.make_fused_runner_mxu(model, nns, bcs, DT, n_steps, n_columns, matmul_dtype="bfloat16", device=dev)
    return run, x0


@pytest.mark.cuda
@pytest.mark.parametrize("n_columns", [8, 61, 1024])
def test_bf16_kernel_matches_plain(card, n_columns):
    run, x0 = _bf16_runner(card, n_columns)
    before = _cuda.FUSED_RK4_BF16.launches
    got = run(x0)
    torch.cuda.synchronize()
    assert _cuda.FUSED_RK4_BF16.launches == before + 1
    torch.testing.assert_close(got, run.plain(x0), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_bf16_every_launch_shape(card):
    run, x0 = _bf16_runner(card, 61)
    want = run.plain(x0)
    shapes = _cuda.FUSED_RK4_BF16.shapes()
    assert len(shapes) >= 2 and all(c % 8 == 0 for c, _ in shapes)
    for i in range(len(shapes)):
        got = _cuda.FUSED_RK4_BF16(x0, run.kernel_weights, run.kernel_frags, run.kernel_params, shape=i)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_bf16_kernel_relu_and_zero_steps(card):
    run, x0 = _bf16_runner(card, 64, nns_change=dict(activation="relu"))
    torch.testing.assert_close(run(x0), run.plain(x0), rtol=RTOL, atol=ATOL)
    run0, x0 = _bf16_runner(card, 16, n_steps=0)
    assert torch.equal(run0(x0), x0)


@pytest.mark.cuda
def test_bf16_runner_refuses_cpu_x0_and_bad_input(card):
    run, x0 = _bf16_runner(card, 16)
    before = _cuda.FUSED_RK4_BF16.launches
    with pytest.raises(ValueError, match="runner lives on"):
        run(x0.cpu())
    k = _cuda.FUSED_RK4_BF16
    with pytest.raises(ValueError):
        k(x0.cpu(), run.kernel_weights, run.kernel_frags, run.kernel_params)
    with pytest.raises(ValueError):
        k(x0, run.kernel_weights, run.kernel_frags.float(), run.kernel_params)
    with pytest.raises(ValueError):
        k(x0, run.kernel_weights, run.kernel_frags[:-8], run.kernel_params)
    with pytest.raises(ValueError):
        k(x0.t().contiguous().t(), run.kernel_weights, run.kernel_frags, run.kernel_params)
    with pytest.raises(ValueError):
        k(x0, run.kernel_weights, run.kernel_frags, run.kernel_params, shape=len(k.shapes()))
    assert k.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, "fold"])
def test_fast_full_rhs_matches_default_on_card(card, fast):
    # The JAX suite's tolerance for the fast rk4 path against the default one (TestFastRK4).
    model, nns, bcs, x0 = _setup(card, 64)
    with torch.no_grad():
        got = twm.solve_wind_mixing_nde(model, nns, bcs, x0, 0.0, 1e-4, 3, n_substeps=4, fast_assembly=fast)
        want = twm.solve_wind_mixing_nde(model, nns, bcs, x0, 0.0, 1e-4, 3, n_substeps=4, fast_assembly=False)
    assert got.device == x0.device
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


# --- csrc/thomas.cu against its plain version, _thomas_scan -----------------
# Tolerance: the kernel runs the plain version's sweep with its roundings (no
# FMA contraction, IEEE quotients from one reciprocal per level), so on these
# normal, diagonally dominant systems it agrees bit for bit; the limits are
# the ones the earlier FMA-contracted kernel was held to, a few f32 ulps of
# the solution.
THOMAS_RTOL, THOMAS_ATOL = 1e-5, 1e-6


def _systems(dev, shape, seed, dtype=torch.float32):
    import numpy as np

    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-0.5, 0.5, shape), rng.uniform(2.0, 3.0, shape), rng.uniform(-0.5, 0.5, shape),
              rng.normal(size=shape))
    return tuple(torch.tensor(a, dtype=dtype, device=dev) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 33), (100, 1), (3, 18, 128), (3, 18, 32), (40, 256), (31, 2), (54, 31),
                                   (54, 32), (200, 64), (16384, 32)])
def test_thomas_matches_scan(card, shape):
    # Also bit for bit: the kernel runs _thomas_scan's operations with its
    # roundings, so a kernel-backed training step matches a scan-backed one.
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    args = _systems(card, shape, seed=sum(shape))
    before = _cuda.THOMAS.launches
    got = tri._thomas_cuda(*args)
    torch.cuda.synchronize()
    assert _cuda.THOMAS.launches == before + 1
    want = tri._thomas_scan(*args)
    torch.testing.assert_close(got, want, rtol=THOMAS_RTOL, atol=THOMAS_ATOL)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 256])
def test_thomas_unaligned_rows_match_scan(card, n):
    # Rows that start 4 bytes past a 16-byte boundary take the kernel's
    # 4-byte layout even where N % 4 == 0 (aligned ones take the 16-byte one).
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    args = _systems(card, (54, n), seed=n + 3)
    shifted = []
    for a in args:
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=card)
        flat[1:] = a.reshape(-1)
        shifted.append(flat[1:].view(a.shape))
    assert all(s.data_ptr() % 16 == 4 and s.is_contiguous() for s in shifted)
    got = _cuda.THOMAS(*shifted)
    want = tri._thomas_scan(*args)
    torch.testing.assert_close(got, want, rtol=THOMAS_RTOL, atol=THOMAS_ATOL)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("scale_exp", [0, -110, -136, -146])
def test_thomas_subnormal_rhs_bitwise(card, n, scale_exp):
    # Right-hand sides scaled into and through the subnormal range (2^-126 and
    # below), and solutions decaying into it: the kernel falls back to IEEE
    # division wherever its fast-path quotient is not exact, so it equals
    # _thomas_scan to the last bit (sign of zero included). The corners are
    # zeroed as tridiagonal_solve zeroes them. 4,224 systems is the LES
    # pressure solve's batch at 64^2 and 64 x 64 x 128.
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    dl, d, du, b = _systems(card, (4224, n), seed=n - scale_exp)
    dl[:, 0] = 0.0
    du[:, -1] = 0.0
    b = b * torch.exp2(torch.linspace(float(scale_exp), float(scale_exp) - 10.0, n, device=card))
    got = tri._thomas_cuda(dl, d, du, b)
    want = tri._thomas_scan(dl, d, du, b)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if scale_exp <= -136:
        assert bool(((want != 0) & (want.abs() < 2.0**-126)).any())


@pytest.mark.cuda
def test_thomas_ift_gradient_matches_scan(card):
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    args = _systems(card, (3, 18, 32), seed=5)
    grads = {}
    for backend in ("cuda", "scan"):
        leaves = [a.clone().requires_grad_(True) for a in args]
        torch.sum(torch.sin(tri.tridiagonal_solve(*leaves, backend=backend)) ** 2).backward()
        grads[backend] = [leaf.grad for leaf in leaves]
    for gk, gs in zip(grads["cuda"], grads["scan"]):
        torch.testing.assert_close(gk, gs, rtol=THOMAS_RTOL, atol=THOMAS_ATOL)


@pytest.mark.cuda
def test_thomas_dtypes_and_refusals(card):
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    args = _systems(card, (64, 32), seed=6)
    with pytest.raises(ValueError, match="f32-only"):
        tri._thomas_cuda(*(a.double() for a in args))
    half = tuple(a.half() for a in args)
    got = tri._thomas_cuda(*half)
    assert got.dtype == torch.float16
    want = tri._thomas_scan(*(a.float() for a in half)).half()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)  # one f16 rounding of the f32 result
    with pytest.raises(ValueError, match="N <= 256"):
        tri._thomas_cuda(*_systems(card, (2, 257), seed=7))
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.THOMAS(*(a.t() for a in _systems(card, (32, 32), seed=8)))
    with pytest.raises(ValueError, match="CUDA device"):
        _cuda.THOMAS(*(a.cpu() for a in args))


@pytest.mark.cuda
def test_thomas_broadcast_noncontiguous_input(card):
    # The split stepper's (nu, nu, nu/Pr) stack, expanded over the batch.
    from climateparameterizations_jl_tpu_torch.ops import tridiagonal as tri

    dl, d, du, b = _systems(card, (18, 32), seed=9)
    b3 = torch.stack([b, 2 * b, -b], dim=0)
    got = tri.tridiagonal_solve(dl, d, du.t().contiguous().t(), b3, backend="cuda")
    want = tri.tridiagonal_solve(dl, d, du, b3, backend="scan")
    torch.testing.assert_close(got, want, rtol=THOMAS_RTOL, atol=THOMAS_ATOL)


@pytest.mark.cuda
def test_fc_split_solve_on_kernel_equals_scan(card):
    # The free-convection split solver, forward and IFT gradient, kernel-backed against scan-backed:
    # the kernel runs the scan's sweep in its roundings.
    from climateparameterizations_jl_tpu_torch.closures.mlp import _leaves, free_convection_mlp
    from climateparameterizations_jl_tpu_torch.models.free_convection import solve_free_convection_nde

    model, T0 = benchmarks.fc_forward_setup(9, 32, 64, card)
    T0 = T0 + 0.05 * torch.randn(T0.shape, generator=torch.Generator().manual_seed(3)).to(card)
    out = {}
    for backend in ("cuda", "scan"):
        nn = free_convection_mlp(torch.Generator().manual_seed(0), 32, device=card)
        leaves = [p.requires_grad_(True) for p in _leaves(nn)]
        _cuda.reset_launch_counts()
        traj = solve_free_convection_nde(model, nn, T0, 0.0, 1.0 / 8, 8, n_substeps=8, method="split",
                                         tridiag_backend=backend)
        torch.mean(traj ** 2).backward()
        out[backend] = (traj.detach(), [p.grad for p in leaves], _cuda.THOMAS.launches)
    assert torch.equal(out["cuda"][0], out["scan"][0])
    for gk, gs in zip(out["cuda"][1], out["scan"][1]):
        assert torch.equal(gk, gs)
    assert out["cuda"][2] == 3 * 64 and out["scan"][2] == 0  # forward, checkpoint recompute, transposed solve


@pytest.mark.cuda
def test_bench_fc_forward_counts_launches(card):
    _cuda.reset_launch_counts()
    stats = benchmarks.bench_fc_forward(64, 32, 24, repeats=2, device=card)
    assert stats["tridiag_backend"] == "cuda" and _cuda.THOMAS.launches == 24 * stats["calls"]


# --- csrc/gram.cu against its plain version, gram_plain ---------------------
# Tolerance: the JAX test's (tests/test_gp.py::TestPallasGram), two f32
# Gram-trick evaluations summed in other orders; the inputs have no
# coincident pairs (A and B drawn apart), where the f32 cancellation of
# aa + bb - 2ab would dominate (see chip_smoke.py).
GRAM_RTOL, GRAM_ATOL = 2e-5, 2e-6
GRAM_FAMILIES = ["squared_exponential", "matern12", "matern32", "matern52", "rational_quadratic"]


def _normal(dev, shape, seed):
    import numpy as np

    return torch.tensor(np.random.default_rng(seed).normal(size=shape), dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("family", GRAM_FAMILIES)
@pytest.mark.parametrize("shape", [(37, 23, 12), (300, 257, 130), (1, 65, 1), (1024, 1024, 96), (1024, 1024, 95)])
def test_gram_matches_plain(card, family, shape):
    from climateparameterizations_jl_tpu_torch.ops import gram

    M, N, D = shape
    A, B = _normal(card, (M, D), sum(shape)), _normal(card, (N, D), sum(shape) + 1)
    before = _cuda.GRAM.launches
    got = gram.gram_cuda(A, B, 1.7, 0.8, 1.3, family=family)
    torch.cuda.synchronize()
    assert _cuda.GRAM.launches == before + 1 and got.shape == (M, N)
    torch.testing.assert_close(got, gram.gram_plain(A, B, 1.7, 0.8, 1.3, family=family), rtol=GRAM_RTOL,
                               atol=GRAM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("family", GRAM_FAMILIES)
@pytest.mark.parametrize("n,D", [(1024, 96), (300, 95)])
def test_gram_training_diagonal_is_exact(card, family, n, D):
    # B is A: the kernel sums the product and the row norms in one order, so d2 = 0
    # and K_ii = sigma exactly; off the diagonal the tolerance above, at gamma =
    # sqrt(D) (off-diagonal entries near exp(-1)). D = 95 takes the 4-byte copies.
    from climateparameterizations_jl_tpu_torch.ops import gram

    X = _normal(card, (n, D), n + D)
    hyp = (math.sqrt(D), 0.8, 1.3)
    got = gram.gram_cuda(X, X, *hyp, family=family)
    assert torch.equal(got.diagonal(), torch.full((n,), 0.8, device=card))
    off = ~torch.eye(n, dtype=torch.bool, device=card)
    torch.testing.assert_close(got[off], gram.gram_plain(X, X, *hyp, family=family)[off], rtol=GRAM_RTOL,
                               atol=GRAM_ATOL)


@pytest.mark.cuda
def test_gram_backward_matches_plain_autograd(card):
    from climateparameterizations_jl_tpu_torch.closures.gp import GPKernel

    A, B, Kbar = _normal(card, (11, 5), 1), _normal(card, (9, 5), 2), _normal(card, (11, 9), 3)
    grads = {}
    for backend in ("cuda", "plain"):
        leaves = [A.clone().requires_grad_(True), B.clone().requires_grad_(True)] + [
            torch.tensor(v, device=card, requires_grad=True) for v in (1.3, 0.9, 1.4)]
        k = GPKernel(*leaves[2:], family="rational_quadratic", backend=backend)
        torch.sum(Kbar * k.gram(leaves[0], leaves[1], None)).backward()
        grads[backend] = [leaf.grad for leaf in leaves]
    for gk, gp in zip(grads["cuda"], grads["plain"]):
        torch.testing.assert_close(gk, gp, rtol=2e-4, atol=2e-4)  # the JAX gradient test's tolerance


@pytest.mark.cuda
def test_gram_refusals(card):
    from climateparameterizations_jl_tpu_torch.closures.gp import GPKernel
    from climateparameterizations_jl_tpu_torch.ops import gram

    A = _normal(card, (8, 4), 4)
    hyp = [torch.ones((), device=card)] * 3
    with pytest.raises(ValueError, match="float32"):
        _cuda.GRAM(A.double(), A.double(), *(h.double() for h in hyp), "matern12")
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.GRAM(A.t(), A.t(), *hyp, "matern12")
    with pytest.raises(ValueError, match="CUDA device"):
        _cuda.GRAM(A.cpu(), A.cpu(), *(h.cpu() for h in hyp), "matern12")
    with pytest.raises(ValueError, match="unknown kernel family"):
        _cuda.GRAM(A, A, *hyp, "cosine")
    with pytest.raises(ValueError, match="one value each"):
        _cuda.GRAM(A, A, torch.ones(3, device=card), *hyp[1:], "matern12")
    with pytest.raises(ValueError, match="feature mismatch"):
        gram.gram_cuda(A, A[:, :3], 1.0, 1.0)
    assert gram.gram_cuda(A.double(), A.double(), 1.0, 1.0).dtype == torch.float32
    # Tensors on two devices raise; none is copied to the other device.
    with pytest.raises(ValueError, match="on one device"):
        gram.gram_cuda(A.cpu(), A, 1.0, 1.0)
    with pytest.raises(ValueError, match="on one device"):
        gram.gram_cuda(A, A.cpu(), 1.0, 1.0)
    with pytest.raises(ValueError, match="on one device"):
        gram.gram_cuda(A, A, torch.tensor(1.0), 1.0)
    before = _cuda.GRAM.launches
    one = torch.ones((), device=card)
    with pytest.raises(ValueError, match="on one device"):
        GPKernel(one, one, one, backend="cuda").gram(A.cpu(), A, None)
    assert _cuda.GRAM.launches == before


# --- csrc/cholesky.cu against cholesky_plain and torch.linalg.cholesky ------
# Tolerance: the JAX test's 5e-4 (tests/test_tridiagonal.py::TestPallasCholesky).
@pytest.mark.cuda
@pytest.mark.parametrize("n,block", [(256, 128), (256, 256), (1024, 128), (1000, 8), (33, 1), (64, 32), (96, 32),
                                     (192, 32)])
def test_cholesky_matches_plain_and_library(card, n, block):
    from climateparameterizations_jl_tpu_torch.ops import cholesky

    A = _normal(card, (n, n), n)
    K = A @ A.T + n * torch.eye(n, device=card)
    before = _cuda.CHOLESKY.launches
    L = cholesky.cholesky_cuda(K, block)
    torch.cuda.synchronize()
    # The copy, then per 64-wide block column a factor-and-panel launch and (but the last) a trailing update.
    assert _cuda.CHOLESKY.launches - before == _cuda.CHOLESKY.launches_per_call(n) == 2 * -(-n // 64)
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    torch.testing.assert_close(L, cholesky.cholesky_plain(K, block), rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(L, torch.linalg.cholesky(K), rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_cholesky_jittered_se_gram_with_subnormal_entries(card):
    # The GP path's matrix at the benchmark's gamma = 1: off-diagonal entries
    # exp(-d^2 / 2) with d^2 ~ 2 D are subnormal in f32.
    from climateparameterizations_jl_tpu_torch.closures.gp import default_jitter
    from climateparameterizations_jl_tpu_torch.ops import cholesky, gram

    x = benchmarks.gp_inputs(1024, 96, device=card)[0]
    K = gram.gram_cuda(x, x, 1.0, 1.0)
    K = K + K.max() * default_jitter(K.dtype) * torch.eye(1024, device=card)
    assert bool(((K != 0) & (K.abs() < torch.finfo(torch.float32).tiny)).any())
    L = cholesky.cholesky_cuda(K, 128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(L).all()) and float(torch.triu(L, 1).abs().max()) == 0.0
    torch.testing.assert_close(L, cholesky.cholesky_plain(K, 128), rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_cholesky_not_positive_definite_gives_nan(card):
    from climateparameterizations_jl_tpu_torch.ops import cholesky

    L = cholesky.cholesky_cuda(-torch.eye(64, device=card), 32)
    assert bool(torch.isnan(L).any())
    with pytest.raises(ValueError, match="multiple of block"):
        cholesky.cholesky_cuda(torch.eye(100, device=card), 32)


@pytest.mark.cuda
def test_gp_closure_shares_one_gram_per_stage(card):
    from climateparameterizations_jl_tpu_torch.models import gp_closure

    models = benchmarks.gp_build_three(*benchmarks.gp_inputs(128, 96, device=card), backend="cuda")
    model = benchmarks.make_setup(32, 4, device=card)[0]
    x0 = models[0].x_train[:16] + 0.1
    before = _cuda.GRAM.launches
    traj = gp_closure.solve_gp_closure(model, gp_closure.FluxGPs(*models), x0, 0.0, 1e-4, 2, n_substeps=2)
    torch.cuda.synchronize()
    assert _cuda.GRAM.launches - before == 2 * 2 * 4 and bool(torch.isfinite(traj).all())


@pytest.mark.cuda
def test_split_solve_rows_do_not_depend_on_the_cut(card):
    """The packed chain's products run in fixed row blocks on the card (``models/wind_mixing.py::_rows_product``),
    so a (16, 64) block of perturbed flagship columns solved whole equals its four (8, 32) tiles bit for bit, and
    the first block of each layer's product is the same at every row count (cuBLAS picks its GEMM kernel by the
    row count: a plain ``@`` differs between 256 and 1,024 rows)."""
    from climateparameterizations_jl_tpu_torch.train.nde import NDETrainConfig, solve_with_config

    model, nns, bcs, x0 = _setup(card, 16)
    gen = torch.Generator().manual_seed(43)
    x = (x0[:, None, :] + 0.05 * torch.randn((16, 64, x0.shape[-1]), generator=gen).to(card)).contiguous()
    config = NDETrainConfig(n_substeps=16, method="split")
    with torch.no_grad():
        whole = solve_with_config(model, nns, bcs, x, 0.0, 16 * DT, 2, config)
        cut = torch.cat([torch.cat([solve_with_config(model, nns, bcs, x[i * 8:(i + 1) * 8, j * 32:(j + 1) * 32]
                                                      .contiguous(), 0.0, 16 * DT, 2, config) for j in range(2)],
                                   dim=2) for i in range(2)], dim=1)
    assert torch.equal(cut, whole), int((cut != whole).sum())
    for A in twm.pack_flux_nns(nns).matrices:
        rows = torch.randn((16384, A.shape[0]), generator=gen).to(card)
        first = twm._rows_product(rows[:256], A)[:twm.ROW_BLOCK]
        for n in (384, 1024, 1152, 16384):
            assert torch.equal(twm._rows_product(rows[:n], A)[:twm.ROW_BLOCK], first), (tuple(A.shape), n)
