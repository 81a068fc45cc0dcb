"""Port parity: ``utils/`` (the basis decomposition and the prediction helper) against the JAX package's.

The same numpy samples go through both packages in float64; every basis
kind, coefficient and reconstruction is held to ``RTOL = 1e-12`` of its
scale (the same operations; products may sum in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu import utils as jutils
from climateparameterizations_jl_tpu.utils import polynomial as jpoly
from climateparameterizations_jl_tpu_torch import utils as tutils
from climateparameterizations_jl_tpu_torch.utils import polynomial as tpoly

RTOL = 1e-12
KINDS = ("legendre", "chebyshev", "fourier")


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(float(np.abs(want).max()), 1e-300))


def _profile(n_points=41, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-256.0, 0.0, n_points))
    x[0], x[-1] = -256.0, 0.0
    f = 19.0 + 0.01 * (x + 256.0) + np.tanh((x + 40.0) / 10.0) + 1e-2 * rng.normal(size=n_points)
    return x, f


def test_exports_match_jax():
    assert tutils.__all__ == jutils.__all__


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 2, 7, 12])
@pytest.mark.parametrize("domain", [None, (-300.0, 20.0)], ids=["own_range", "wider_domain"])
def test_basis_functions_match_jax(kind, n, domain):
    x, _ = _profile()
    dom = domain if domain is not None else (float(x[0]), float(x[-1]))
    _close(tpoly.basis_functions(kind, n, x, dom), jpoly.basis_functions(kind, n, jnp.asarray(x), dom))


@pytest.mark.parametrize("kind", KINDS)
def test_quadrature_weights_match_jax(kind):
    x, _ = _profile()
    dom = (float(x[0]), float(x[-1]))
    _close(tpoly._quadrature_weights(kind, x, dom), jpoly._quadrature_weights(kind, jnp.asarray(x), dom))
    _close(tpoly._trapezoid_weights(x), jpoly._trapezoid_weights(jnp.asarray(x)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [3, 8, 16])
@pytest.mark.parametrize("domain", [None, (-300.0, 20.0)], ids=["own_range", "wider_domain"])
def test_decomposition_and_reconstruction_match_jax(kind, n, domain):
    x, f = _profile(seed=n)
    got = tutils.polynomial_decomposition(f, x, kind=kind, n=n, domain=domain)
    want = jutils.polynomial_decomposition(jnp.asarray(f), jnp.asarray(x), kind=kind, n=n, domain=domain)
    _close(got, want)
    # Reconstruct from the same (JAX) coefficients in both packages, so only the reconstruction is compared.
    x_fine = np.linspace(x[0], x[-1], 97)
    _close(tutils.reconstruct(np.array(want), x_fine, kind=kind, domain=domain or (x[0], x[-1])),
           jutils.reconstruct(want, jnp.asarray(x_fine), kind=kind, domain=domain or (x[0], x[-1])))


def test_decomposition_accepts_tensors_and_recovers_a_basis_function():
    x = torch.linspace(-1.0, 1.0, 4001, dtype=torch.float64)  # trapezoid error ~ h^2
    f = 3.0 * tpoly.basis_functions("legendre", 4, x)[3]
    coeffs = tutils.polynomial_decomposition(f, x, kind="legendre", n=6)
    assert coeffs.dtype == torch.float64
    np.testing.assert_allclose(coeffs.numpy(), [0, 0, 0, 3, 0, 0], atol=1e-4)


def test_unknown_kind_raises_as_in_jax():
    with pytest.raises(ValueError, match="unknown basis kind"):
        tpoly.basis_functions("hermite", 3, np.linspace(-1, 1, 5))
    with pytest.raises(ValueError, match="unknown basis kind"):
        jpoly.basis_functions("hermite", 3, jnp.linspace(-1, 1, 5))


@pytest.mark.parametrize("unscale", [False, True], ids=["scaled", "unscaled"])
def test_predict_matches_jax(unscale):
    rng = np.random.default_rng(3)
    x, y, w = rng.normal(size=(10, 6)), rng.normal(size=(10, 4)), rng.normal(size=(6, 4))
    unscale_j = (lambda a: 2.5 * a - 0.5) if unscale else None
    unscale_t = (lambda a: 2.5 * a - 0.5) if unscale else None
    jp, jt = jutils.predict(lambda a: jnp.tanh(a @ jnp.asarray(w)), jnp.asarray(x), y, unscale_j)
    tp, tt = tutils.predict(lambda a: torch.tanh(a @ torch.as_tensor(w)), torch.as_tensor(x), y, unscale_t)
    _close(tp, jp)
    _close(tt, jt)
