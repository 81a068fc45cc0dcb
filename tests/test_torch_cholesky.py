"""Port parity: the blocked Cholesky (``ops/cholesky.py``) against the JAX package's.

The same f32 SPD matrices, made with a numpy seed, go through JAX
``cholesky_pallas`` (interpret mode, as
``tests/test_tridiagonal.py::TestPallasCholesky`` runs it on the CPU) and the
port's ``cholesky_cuda``, which on CPU tensors runs its plain version
``cholesky_plain`` (the TPU kernel's blocked algorithm with the same
``block``); the CUDA kernel is held against ``cholesky_plain`` on the card.

Tolerance: the JAX test's ``rtol=atol=5e-4`` (f32 blocked factorizations
with different summation orders, against a LAPACK factor).
"""

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.ops.cholesky import cholesky_pallas
from climateparameterizations_jl_tpu_torch.ops import _cuda
from climateparameterizations_jl_tpu_torch.ops import cholesky as tchol

TOL = 5e-4


def _spd(n, seed=0):
    A = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return A @ A.T + n * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("block", [128, 256])
def test_matches_jax_pallas_and_lapack(block):
    K = _spd(256)
    want = np.asarray(cholesky_pallas(jnp.asarray(K), block=block, interpret=True))
    got = tchol.cholesky_cuda(torch.tensor(K), block=block)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsl.cholesky(K, lower=True)), rtol=TOL, atol=TOL)
    assert float(np.abs(np.triu(got.numpy(), 1)).max()) == 0.0


def test_small_blocks_and_reconstruction():
    K = _spd(48, seed=1)
    want = np.asarray(cholesky_pallas(jnp.asarray(K), block=16, interpret=True))
    got = tchol.cholesky_plain(torch.tensor(K), block=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose((got @ got.T).numpy(), K, rtol=TOL, atol=TOL * 48)


def test_rejects_bad_inputs():
    with pytest.raises(ValueError, match="multiple of block"):
        tchol.cholesky_cuda(torch.zeros(100, 100), block=128)
    with pytest.raises(ValueError, match="f32-only"):
        tchol.cholesky_cuda(torch.zeros(256, 256, dtype=torch.float64), block=128)
    with pytest.raises(ValueError, match="square"):
        tchol.cholesky_cuda(torch.zeros(128, 256), block=128)


def _jittered_se_gram(n, D, gamma, seed=0):
    """The GP path's matrix: the squared-exponential Gram of standard-normal features, f32, plus the GP fits'
    jitter ``max(K) sqrt(eps_f32)`` on the diagonal. At gamma = 1 the off-diagonal entries exp(-d^2 / 2),
    d^2 ~ 2 D, are subnormal in f32."""
    x = np.random.default_rng(seed).normal(size=(n, D))
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    K = np.exp(-d2 / (2.0 * gamma**2)).astype(np.float32)
    return K + K.max() * np.sqrt(np.finfo(np.float32).eps) * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("gamma", [1.0, float(np.sqrt(96))])
def test_jittered_se_gram_matches_jax_pallas_and_lapack(gamma):
    K = _jittered_se_gram(256, 96, gamma)
    subnormal = (K != 0) & (np.abs(K) < np.finfo(np.float32).tiny)
    assert subnormal.any() == (gamma == 1.0)
    want = np.asarray(cholesky_pallas(jnp.asarray(K), block=128, interpret=True))
    got = tchol.cholesky_cuda(torch.tensor(K), block=128)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsl.cholesky(K, lower=True)), rtol=TOL, atol=TOL)
    assert float(np.abs(np.triu(got.numpy(), 1)).max()) == 0.0


def test_not_positive_definite_gives_nan_not_an_error():
    K = -torch.eye(16)
    before = _cuda.CHOLESKY.launches
    L = tchol.cholesky_cuda(K, block=8)
    assert torch.isnan(L).any()
    assert _cuda.CHOLESKY.launches == before  # CPU tensors run the plain version
