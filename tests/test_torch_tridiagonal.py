"""Port parity: the batched tridiagonal solve and implicit diffusion.

The same systems, made with a numpy seed, go through the JAX package's
``ops/tridiagonal.py`` and the port's. The JAX suite never runs the TPU
kernel ``_thomas_pallas`` on the CPU (it has no interpret-mode test), so
the reference is the JAX ``_thomas_scan``; the port's CUDA kernel is held
against the port's ``_thomas_scan`` on the card (``tests/test_torch_cuda.py``).

Tolerances: float64 on both sides (the JAX tests run with x64). The Thomas
recurrence is the same sequence of operations in both packages, so values
agree to a few ulps (``rtol=1e-12``); PCR and the dense solve are different
algorithms (``rtol=1e-8``, as the JAX suite's own tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.ops import tridiagonal as jtri
from climateparameterizations_jl_tpu_torch.ops import _cuda
from climateparameterizations_jl_tpu_torch.ops import tridiagonal as ttri


def dense_from_diags(dl, d, du):
    n = len(d)
    A = np.diag(d)
    for i in range(1, n):
        A[i, i - 1] = dl[i]
        A[i - 1, i] = du[i - 1]
    return A


def random_system(rng, n):
    d = rng.uniform(2.0, 3.0, size=n)
    dl = rng.uniform(-0.5, 0.5, size=n)
    du = rng.uniform(-0.5, 0.5, size=n)
    dl[0] = 0.0
    du[-1] = 0.0
    b = rng.normal(size=n)
    return dl, d, du, b


def batch(rng, shape, n):
    systems = [random_system(rng, n) for _ in range(int(np.prod(shape)))]
    return tuple(np.stack([s[i] for s in systems]).reshape(*shape, n) for i in range(4))


def both(arrays):
    return tuple(jnp.asarray(a) for a in arrays), tuple(torch.tensor(a) for a in arrays)


class TestThomas:
    @pytest.mark.parametrize("n", [1, 3, 32, 33, 128])
    def test_scan_matches_jax_scan(self, n):
        j, t = both(batch(np.random.default_rng(n), (2, 3), n))
        np.testing.assert_allclose(ttri._thomas_scan(*t).numpy(), np.asarray(jtri._thomas_scan(*j)), rtol=1e-12,
                                   atol=1e-14)

    @pytest.mark.parametrize("n", [3, 8, 32, 33, 100])
    def test_pcr_matches_jax(self, n):
        j, t = both(batch(np.random.default_rng(7), (4,), n))
        np.testing.assert_allclose(ttri._thomas_pcr(*t).numpy(), np.asarray(jtri._thomas_pcr(*j)), rtol=1e-10,
                                   atol=1e-13)

    @pytest.mark.parametrize("backend", ["scan", "pcr", "cuda"])
    @pytest.mark.parametrize("n", [3, 32, 33])
    def test_matches_dense_solve(self, backend, n):
        dl, d, du, b = random_system(np.random.default_rng(0), n)
        args = tuple(torch.tensor(a, dtype=torch.float32 if backend == "cuda" else torch.float64)
                     for a in (dl, d, du, b))
        x = ttri.tridiagonal_solve(*args, backend=backend)
        expected = np.linalg.solve(dense_from_diags(dl, d, du), b)
        rtol = 1e-5 if backend == "cuda" else 1e-8
        np.testing.assert_allclose(x.numpy(), expected, rtol=rtol, atol=rtol * 1e-2)

    def test_cuda_backend_on_cpu_runs_the_plain_version(self):
        # CPU tensors take the kernel's plain version, never the kernel.
        _, t = both(batch(np.random.default_rng(3), (5,), 16))
        t = tuple(a.float() for a in t)
        before = _cuda.THOMAS.launches
        x = ttri._raw_solve(*t, backend="cuda", unroll=1)
        assert _cuda.THOMAS.launches == before
        assert torch.equal(x, ttri._thomas_scan(*t))

    def test_cuda_backend_dtypes(self):
        _, t = both(batch(np.random.default_rng(4), (3,), 8))
        with pytest.raises(ValueError, match="f32-only"):
            ttri._thomas_cuda(*t)
        half = tuple(a.to(torch.bfloat16) for a in t)
        x = ttri._thomas_cuda(*half)
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x, ttri._thomas_scan(*(a.float() for a in half)).to(torch.bfloat16))

    def test_broadcast_inputs(self):
        rng = np.random.default_rng(5)
        dl, d, du, b = batch(rng, (4,), 12)
        j = jtri.tridiagonal_solve(jnp.asarray(dl[0]), jnp.asarray(d), jnp.asarray(du[0]), jnp.asarray(b))
        t = ttri.tridiagonal_solve(torch.tensor(dl[0]), torch.tensor(d), torch.tensor(du[0]), torch.tensor(b))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-14)

    def test_unknown_backend(self):
        _, t = both(batch(np.random.default_rng(6), (2,), 4))
        with pytest.raises(ValueError, match="unknown tridiagonal backend"):
            ttri.tridiagonal_solve(*t, backend="pallas")
        with pytest.raises(ValueError, match="implicit_grad"):
            ttri.tridiagonal_solve(*t, backend="cuda", implicit_grad=False)


# The card's limits for csrc/thomas.cu against _thomas_scan (tests/test_torch_cuda.py).
THOMAS_RTOL, THOMAS_ATOL = 1e-5, 1e-6
# One card-test shape per N (tests/test_torch_cuda.py), from N = 1 to the
# kernel's limit of 256.
CARD_SHAPES = {1: (100, 1), 2: (31, 2), 31: (54, 31), 32: (3, 18, 32), 33: (1000, 33), 128: (3, 18, 128),
               256: (40, 256)}


def card_systems(shape, seed):
    """The card tests' f32 systems (``tests/test_torch_cuda.py::_systems``), on the CPU."""
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-0.5, 0.5, shape), rng.uniform(2.0, 3.0, shape), rng.uniform(-0.5, 0.5, shape),
              rng.normal(size=shape))
    return tuple(torch.tensor(a, dtype=torch.float32) for a in arrays)


@pytest.mark.parametrize("n", sorted(CARD_SHAPES))
def test_pcr_within_the_card_tolerance_of_scan(n):
    # The plain "pcr" backend (parallel cyclic reduction, the log-depth
    # alternative to the sequential sweep; no kernel runs it), in f32 on the
    # card tests' own systems: its rounding stays inside the limits that
    # csrc/thomas.cu is held to against _thomas_scan. That is not enough for
    # a kernel: on the flagship training step the plain pcr backend's
    # gradient is about 1e-2 from the scan-backed step's (chip_smoke.py
    # phase 9 prints it), past the step's limit of 1e-3, so csrc/thomas.cu
    # keeps the sweep.
    shape = CARD_SHAPES[n]
    args = card_systems(shape, seed=sum(shape))
    torch.testing.assert_close(ttri._thomas_pcr(*args), ttri._thomas_scan(*args), rtol=THOMAS_RTOL,
                               atol=THOMAS_ATOL)


def _loss_jax(backend, implicit):
    def loss(dl, d, du, b):
        x = jtri.tridiagonal_solve(dl, d, du, b, backend=backend, implicit_grad=implicit)
        return jnp.sum(jnp.sin(x) * x)

    return loss


def _grads_torch(args, backend, implicit):
    leaves = [a.clone().requires_grad_(True) for a in args]
    x = ttri.tridiagonal_solve(*leaves, backend=backend, implicit_grad=implicit)
    torch.sum(torch.sin(x) * x).backward()
    return [leaf.grad for leaf in leaves]


class TestImplicitGrad:
    @pytest.mark.parametrize("backend", ["scan", "pcr"])
    @pytest.mark.parametrize("implicit", [True, False])
    def test_grads_match_jax(self, backend, implicit):
        j, t = both(batch(np.random.default_rng(11), (3,), 16))
        g_jax = jax.grad(_loss_jax(backend, implicit), argnums=(0, 1, 2, 3))(*j)
        for gt, gj in zip(_grads_torch(t, backend, implicit), g_jax):
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-9, atol=1e-12)

    def test_ift_matches_direct_autodiff(self):
        _, t = both(batch(np.random.default_rng(12), (3,), 16))
        for gi, gd in zip(_grads_torch(t, "scan", True), _grads_torch(t, "scan", False)):
            np.testing.assert_allclose(gi.numpy(), gd.numpy(), rtol=1e-8, atol=1e-12)

    def test_cuda_backend_gradient_on_cpu(self):
        # The kernel backend's IFT backward is a second solve through the same
        # backend; on CPU tensors both run the plain version.
        _, t = both(batch(np.random.default_rng(13), (3,), 16))
        t = tuple(a.float() for a in t)
        for gk, gs in zip(_grads_torch(t, "cuda", True), _grads_torch(t, "scan", True)):
            torch.testing.assert_close(gk, gs, rtol=0, atol=0)

    def test_diagonal_gradient_fd(self):
        dl, d, du, b = (torch.tensor(a) for a in random_system(np.random.default_rng(14), 8))
        dd = d.clone().requires_grad_(True)
        torch.sum(ttri.tridiagonal_solve(dl, dd, du, b) ** 2).backward()
        eps = 1e-6
        e = torch.zeros(8, dtype=torch.float64)
        e[2] = eps
        loss = lambda m: float(torch.sum(ttri.tridiagonal_solve(dl, m, du, b) ** 2))  # noqa: E731
        np.testing.assert_allclose(float(dd.grad[2]), (loss(d + e) - loss(d - e)) / (2 * eps), rtol=1e-4)

    def test_ignored_corner_entries_get_zero_cotangent(self):
        dl, d, du, b = (torch.tensor(a) for a in random_system(np.random.default_rng(15), 8))
        dl = dl.clone()
        du = du.clone()
        dl[0] = 7.0
        du[-1] = -7.0
        dl.requires_grad_(True)
        du.requires_grad_(True)
        torch.sum(ttri.tridiagonal_solve(dl, d, du, b) ** 2).backward()
        assert float(dl.grad[0]) == 0.0
        assert float(du.grad[-1]) == 0.0


class TestImplicitDiffusion:
    def test_matrix_matches_jax(self):
        nu = np.random.default_rng(20).uniform(0.0, 1e-2, size=(2, 17))
        jt = jtri.implicit_diffusion_matrix(jnp.asarray(nu), 0.3, 1 / 16)
        tt = ttri.implicit_diffusion_matrix(torch.tensor(nu), 0.3, 1 / 16)
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=0)

    @pytest.mark.parametrize("zero_boundary_faces", [False, True])
    def test_step_matches_jax_with_gradient(self, zero_boundary_faces):
        rng = np.random.default_rng(21)
        phi = rng.normal(size=(3, 4, 16))
        nu = rng.uniform(0.0, 5e-2, size=(3, 4, 17))

        def jloss(p, n):
            out = jtri.implicit_diffusion_step(p, n, 0.5, 1 / 16, zero_boundary_faces=zero_boundary_faces)
            return jnp.sum(out ** 3), out

        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(phi), jnp.asarray(nu))
        tp = torch.tensor(phi, requires_grad=True)
        tn = torch.tensor(nu, requires_grad=True)
        tout = ttri.implicit_diffusion_step(tp, tn, 0.5, 1 / 16, zero_boundary_faces=zero_boundary_faces)
        torch.sum(tout ** 3).backward()
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg[0]), rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jg[1]), rtol=1e-10, atol=1e-13)

    def test_step_conserves_with_zero_diffusivity(self):
        phi = torch.tensor(np.random.default_rng(22).normal(size=16))
        out = ttri.implicit_diffusion_step(phi, torch.zeros(17, dtype=torch.float64), 1.0, 1 / 16)
        torch.testing.assert_close(out, phi, rtol=1e-12, atol=1e-12)
