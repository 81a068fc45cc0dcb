"""Port parity: the blocked exact-GP fit (``ops/blocked_gp.py``).

The counterpart of ``tests/test_gp.py::TestBlockedGPFit`` at its size: n =
300 training points of 12 features from a numpy seed, a block of 128 that
does not divide n (and 300 and 512), float64. The blocked fit is held to the
unblocked ``closures/gp.py::gp_fit`` and to the JAX package's blocked fit at
``RTOL = 1e-10`` (one Gram, one jitter, the same factorization blocked
another way: float64 roundoff of a kernel matrix whose condition number
is about 1e4); the tiles assembled are the unblocked Cholesky factor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures import gp as jgp
from climateparameterizations_jl_tpu.ops import blocked_gp as jbgp
from climateparameterizations_jl_tpu_torch.closures import gp as tgp
from climateparameterizations_jl_tpu_torch.ops import blocked_gp as tbgp

RTOL = 1e-10
N, D = 300, 12


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=N)
    return x, y, np.stack([y, 2.0 * y], axis=-1), np.linspace(0.0, 1.0, D)


def _kernel():
    return tgp.get_kernel(1, 0.0, device="cpu")  # squared exponential, gamma = 1, f64


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("block", [128, 300, 512], ids=["uneven", "exact", "oversize"])
def test_matches_unblocked_fit_and_jax(data, block):
    x, y, _, z = data
    xt, yt, zt = torch.tensor(x), torch.tensor(y), torch.tensor(z)
    ref = tgp.gp_fit(xt, yt, _kernel(), zt)
    model, tiles = tbgp.gp_fit_blocked(xt, yt, _kernel(), zt, block=block)
    assert model.chol is None
    _close(model.alpha, ref.alpha)
    L = torch.zeros(N, N, dtype=torch.float64)
    for (i, j), t in tiles.items():
        L[i * block: i * block + t.shape[0], j * block: j * block + t.shape[1]] = t
    _close(L, ref.chol)
    jm, _ = jbgp.gp_fit_blocked(jnp.asarray(x), jnp.asarray(y), jgp.get_kernel(1, 0.0), jnp.asarray(z), block=block)
    _close(model.alpha, jm.alpha)


def test_blocked_cho_solve_multirhs(data):
    x, _, y2, z = data
    xt, zt = torch.tensor(x), torch.tensor(z)
    tiles, jitter = tbgp.blocked_gram_cholesky(_kernel(), xt, zt, block=128)
    K = _kernel().gram(xt, xt, zt)
    assert float(jitter) == pytest.approx(float(K.max()) * tgp.default_jitter(torch.float64), rel=1e-15)
    _close(tbgp.blocked_cho_solve(tiles, torch.tensor(y2), block=128), tgp.gp_fit(xt, torch.tensor(y2), _kernel(),
                                                                                   zt).alpha)


def test_uncertainty_and_prediction_match(data):
    x, y, _, z = data
    xt, yt, zt = torch.tensor(x), torch.tensor(y), torch.tensor(z)
    ref = tgp.gp_fit(xt, yt, _kernel(), zt)
    model, tiles = tbgp.gp_fit_blocked(xt, yt, _kernel(), zt, block=128)
    xq = torch.tensor(np.random.default_rng(1).normal(size=(37, D)))
    _close(tbgp.gp_uncertainty_blocked(model, tiles, xq, block=128, query_chunk=16), tgp.gp_uncertainty(ref, xq),
           rtol=1e-7)
    _close(tgp.gp_predict(model, xq[:9]), tgp.gp_predict(ref, xq[:9]))
