"""Port parity: the fused Gram (``ops/gram.py``) against the JAX package's.

The same f32 inputs, made with a numpy seed, go through JAX ``gram_pallas``
(interpret mode, as ``tests/test_gp.py::TestPallasGram`` runs it on the
CPU) and the port's ``gram_cuda``, which on CPU tensors runs its plain
version ``gram_plain``; the CUDA kernel is held against ``gram_plain`` on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Gradients of
``gram_cuda_diff`` are held against JAX ``gram_pallas_diff`` and against
autograd through the plain backend.

Tolerances are the JAX tests' own: values ``rtol=2e-5, atol=2e-6`` (two f32
Gram-trick evaluations with different summation orders); gradients
``rtol=2e-4, atol=2e-4`` (``TestPallasGramGradients``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures.gp import GPKernel as JGPKernel
from climateparameterizations_jl_tpu.ops import gram as jgram
from climateparameterizations_jl_tpu_torch.closures.gp import GPKernel
from climateparameterizations_jl_tpu_torch.ops import _cuda
from climateparameterizations_jl_tpu_torch.ops import gram as tgram

FAMILIES = ["squared_exponential", "matern12", "matern32", "matern52", "rational_quadratic"]
RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-4


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _kernels(family, metric, gamma=1.7, sigma=0.8, alpha=1.3):
    jk = JGPKernel(gamma=jnp.float32(gamma), sigma=jnp.float32(sigma), alpha=jnp.float32(alpha), family=family,
                   metric=metric, backend="pallas")
    tk = GPKernel(gamma=_t(gamma), sigma=_t(sigma), alpha=_t(alpha), family=family, metric=metric, backend="cuda")
    return jk, tk


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("metric", ["euclidean", "derivative"])
def test_gram_matches_jax_pallas(family, metric):
    rng = np.random.default_rng(0)
    A = rng.normal(size=(37, 12)).astype(np.float32)
    B = rng.normal(size=(23, 12)).astype(np.float32)
    z = np.linspace(-5.0, 0.0, 12)
    jk, tk = _kernels(family, metric)
    want = np.asarray(jk.gram(jnp.asarray(A), jnp.asarray(B), jnp.asarray(z)))
    got = tk.gram(_t(A), _t(B), torch.tensor(z))
    assert got.dtype == torch.float32 and got.shape == (37, 23)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # The plain backend in f32 (JAX's "xla" path) agrees as well.
    plain = GPKernel(gamma=tk.gamma, sigma=tk.sigma, alpha=tk.alpha, family=family, metric=metric)
    np.testing.assert_allclose(plain.gram(_t(A), _t(B), torch.tensor(z)).numpy(), want, rtol=RTOL, atol=ATOL)


def test_gram_large_ragged_shapes():
    # M, N straddle the TPU kernel's 256 tiles and the CUDA kernel's 64; D > 128.
    rng = np.random.default_rng(2)
    A = rng.normal(size=(300, 130)).astype(np.float32)
    B = rng.normal(size=(257, 130)).astype(np.float32)
    want = np.asarray(jgram.gram_pallas(A, B, 3.0, 1.0, 1.0, interpret=True))
    got = tgram.gram_cuda(_t(A), _t(B), 3.0, 1.0, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_gram_casts_f64_to_f32_and_validates():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(5, 4))
    got = tgram.gram_cuda(torch.tensor(A), torch.tensor(A), 1.0, 1.0)
    assert got.dtype == torch.float32
    want = np.asarray(jgram.gram_pallas(A, A, 1.0, 1.0, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="feature mismatch"):
        tgram.gram_cuda(torch.zeros(3, 4), torch.zeros(3, 5), 1.0, 1.0)
    with pytest.raises(ValueError, match="D <= 4096"):
        tgram.gram_cuda(torch.zeros(2, 4097), torch.zeros(2, 4097), 1.0, 1.0)
    with pytest.raises(ValueError, match="unknown kernel family"):
        tgram.gram_cuda(torch.zeros(2, 3), torch.zeros(2, 3), 1.0, 1.0, family="cosine")
    with pytest.raises(ValueError, match="Gram backend"):
        GPKernel(gamma=_t(1.0), sigma=_t(1.0), alpha=_t(1.0), backend="pallas")


def test_inputs_on_another_device_raise():
    # No silent copy between devices: a B or a hyperparameter tensor that is
    # not on A's device is refused ("meta" stands in for the card here).
    A = torch.ones(4, 3)
    with pytest.raises(ValueError, match="on one device"):
        tgram.gram_cuda(A, torch.ones(2, 3, device="meta"), 1.0, 1.0)
    with pytest.raises(ValueError, match="on one device"):
        tgram.gram_cuda(A, A, torch.ones((), device="meta"), 1.0)
    with pytest.raises(ValueError, match="on one device"):
        tgram.gram_cuda_diff("matern32", A, A, 1.0, 1.0, torch.ones((), device="meta"))


def test_cpu_tensors_never_launch():
    before = _cuda.GRAM.launches
    tgram.gram_cuda(torch.ones(4, 3), torch.ones(2, 3), 1.0, 1.0)
    assert _cuda.GRAM.launches == before and _cuda.GRAM._lib is None


@pytest.mark.parametrize("family", FAMILIES)
def test_vjp_matches_jax_and_autograd(family):
    rng = np.random.default_rng(7)
    A = rng.normal(size=(11, 5)).astype(np.float32)
    B = rng.normal(size=(9, 5)).astype(np.float32)
    Kbar = rng.normal(size=(11, 9)).astype(np.float32)
    hyp = (1.3, 0.9, 1.4)

    def jax_scalar(A, B, gamma, sigma, alpha):
        return jnp.sum(Kbar * jgram.gram_pallas_diff(family, A, B, gamma, sigma, alpha))

    want = jax.grad(jax_scalar, argnums=(0, 1, 2, 3, 4))(A, B, *(jnp.float32(h) for h in hyp))
    for backend in ("cuda", "plain"):
        leaves = [_t(A), _t(B), *(_t(h) for h in hyp)]
        for leaf in leaves:
            leaf.requires_grad_(True)
        k = GPKernel(gamma=leaves[2], sigma=leaves[3], alpha=leaves[4], family=family, backend=backend)
        torch.sum(_t(Kbar) * k.gram(leaves[0], leaves[1], None)).backward()
        for w, leaf, name in zip(want, leaves, ["A", "B", "gamma", "sigma", "alpha"]):
            # Autograd leaves an unused alpha (every family but rational_quadratic) without a gradient.
            got = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{backend} {name}")


@pytest.mark.parametrize("family", ["matern12", "matern32", "squared_exponential"])
def test_training_gram_feature_gradients(family):
    # A is B: the coincident-pair mask keeps matern12's floored 1/d out of
    # the f32 cancellation; the gradient matches JAX's masked backward.
    rng = np.random.default_rng(11)
    X = rng.normal(size=(10, 4)).astype(np.float32)
    Kbar = rng.normal(size=(10, 10)).astype(np.float32)
    hyp = (1.5, 0.8, 1.0)
    want = jax.grad(lambda X: jnp.sum(Kbar * jgram.gram_pallas_diff(family, X, X, *map(jnp.float32, hyp))))(X)
    x = _t(X).requires_grad_(True)
    torch.sum(_t(Kbar) * tgram.gram_cuda_diff(family, x, x, *(_t(h) for h in hyp))).backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_gradients_keep_input_dtypes():
    x = torch.randn(6, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(0), requires_grad=True)
    g = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
    s = torch.tensor(0.7, dtype=torch.float32, requires_grad=True)
    a = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    K = tgram.gram_cuda_diff("rational_quadratic", x, x, g, s, a)
    assert K.dtype == torch.float32
    K.sum().backward()
    assert (x.grad.dtype, g.grad.dtype, s.grad.dtype, a.grad.dtype) == (
        torch.float64, torch.float64, torch.float32, torch.float64)
    assert g.grad.shape == () and x.grad.shape == (6, 3)
