"""Port parity: the grid, the dense operators, Richardson diagnostics and the MLP variants.

Each ported function of ``core/grid.py``, ``core/operators.py``,
``physics/richardson.py`` and ``closures/mlp.py`` runs beside its JAX twin
on the same numpy inputs (a seeded generator), in float64 (the JAX tests run
with x64), with ``rtol=1e-12``: the same operations in the same order. Weights
made by the JAX initializers cross through ``bridge.from_reference``.
Mirrors ``tests/test_core_operators.py``, ``test_physics.py`` and
``test_conv_causality.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.closures import mlp as jmlp
from climateparameterizations_jl_tpu.core import grid as jgrid
from climateparameterizations_jl_tpu.core import operators as jops
from climateparameterizations_jl_tpu.physics import richardson as jri
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.closures import mlp as tmlp
from climateparameterizations_jl_tpu_torch.core import grid as tgrid
from climateparameterizations_jl_tpu_torch.core import operators as tops
from climateparameterizations_jl_tpu_torch.physics import richardson as tri

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-14 * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("Nz,H", [(32, 256.0), (7, 100.0)])
def test_column_grid_matches_jax(Nz, H):
    t, j = tgrid.ColumnGrid(Nz, H), jgrid.ColumnGrid(Nz, H)
    assert (t.dz, t.dz_hat) == (j.dz, j.dz_hat)
    _close(t.zc, j.zc, 0)
    _close(t.zf, j.zf, 0)
    assert t.zf[0] == -H and t.zf[-1] == 0.0
    _close(t.zc, 0.5 * (t.zf[:-1] + t.zf[1:]).numpy(), 1e-15)


@pytest.mark.parametrize("N", [1, 8, 33])
def test_dense_operator_matrices_match_jax(N):
    dz = 1.0 / N
    _close(tops.D_center_matrix(N, dz), jops.D_center_matrix(N, dz), 0)
    _close(tops.D_face_matrix(N, dz), jops.D_face_matrix(N, dz), 0)
    # The stencils are the matrices' products.
    rng = np.random.default_rng(N)
    w, c = rng.normal(size=(4, N + 1)), rng.normal(size=(4, N))
    _close(tops.d_face_to_center(torch.tensor(w), dz), w @ jops.D_center_matrix(N, dz).T)
    _close(tops.d_center_to_face(torch.tensor(c), dz), c @ jops.D_face_matrix(N, dz).T)


def test_cell_to_cell_derivative_matches_jax():
    c = np.random.default_rng(3).normal(size=(5, 3, 16))
    _close(tops.cell_to_cell_derivative(torch.tensor(c), 1.0 / 16),
           jops.cell_to_cell_derivative(jnp.asarray(c), 1.0 / 16))


def test_richardson_functions_match_jax():
    rng = np.random.default_rng(5)
    dudz, dvdz, dTdz = rng.normal(size=(3, 4, 9))
    _close(tri.local_richardson(*map(torch.tensor, (dudz, dvdz, dTdz)), 9.81, 2e-4),
           jri.local_richardson(*map(jnp.asarray, (dudz, dvdz, dTdz)), 9.81, 2e-4))
    u, v, T = rng.normal(size=(3, 2, 6, 16))
    consts = dict(H=128.0, g=9.81, alpha=2e-4, sigma_u=0.05, sigma_v=0.04, sigma_T=0.5)
    for eps in (0.0, 1e-7):
        got = tri.richardson_profile(*map(torch.tensor, (u, v, T)), eps=eps, **consts)
        want = jri.richardson_profile(*map(jnp.asarray, (u, v, T)), eps=eps, **consts)
        _close(got, want)
    # eps = 0: the zero boundary faces are 0 / 0, sanitized to 0 on both sides.
    assert float(tri.richardson_profile(*map(torch.tensor, (u, v, T)), **consts)[..., 0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sanitize_richardson_matches_jax(dtype):
    Ri = np.array([np.nan, np.inf, -np.inf, 0.3, -2.0, 1e12], dtype)
    got = tri.sanitize_richardson(torch.tensor(Ri))
    want = jri.sanitize_richardson(jnp.asarray(Ri))
    assert got.dtype == torch.from_numpy(np.array(want)).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.array([0.0, 1e10, -1e10, 0.3, -2.0, 1e12], dtype))


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_free_convection_mlp_matches_jax(activation):
    jnn = _f64(jmlp.free_convection_mlp(jax.random.PRNGKey(1), Nz=8, activation=activation))
    tnn = from_reference(jnn, "cpu", torch.float64)
    assert tnn.sizes == jnn.sizes == (8, 32, 32, 7)
    x = np.random.default_rng(1).normal(size=(3, 5, 8))
    _close(tmlp.apply_closure(tnn, torch.tensor(x)), jmlp.apply_closure(jnn, jnp.asarray(x)))
    # The port's initializer: the same shapes and Glorot bounds from a torch.Generator.
    own = tmlp.free_convection_mlp(torch.Generator().manual_seed(0), Nz=8, activation=activation, device="cpu")
    assert own.sizes == tnn.sizes and own.activation == activation
    for W in own.weights:
        assert float(W.abs().max()) <= np.sqrt(6.0 / sum(W.shape))


@pytest.mark.parametrize("width", [1, 2, 5])
def test_conv_mlp_matches_jax(width):
    jnn = _f64(jmlp.free_convection_conv_mlp(jax.random.PRNGKey(width), Nz=12, conv_width=width))
    # A non-zero conv bias, so the bias path is compared too.
    jnn = dataclasses.replace(jnn, conv_bias=jnp.asarray(0.03, jnp.float64))
    tnn = from_reference(jnn, "cpu", torch.float64)
    assert isinstance(tnn, tmlp.ConvMLP) and tnn.width == width
    x = np.random.default_rng(width).normal(size=(4, 12))
    _close(tmlp.conv_mlp_apply(tnn, torch.tensor(x)), jmlp.conv_mlp_apply(jnn, jnp.asarray(x)))
    _close(tmlp.apply_closure(tnn, torch.tensor(x[0])), jmlp.apply_closure(jnn, jnp.asarray(x[0])))
    own = tmlp.free_convection_conv_mlp(torch.Generator().manual_seed(0), Nz=12, conv_width=width, device="cpu")
    assert own.mlp.sizes == jnn.mlp.sizes and own.kernel.shape == (width,) and own.conv_bias.shape == ()


@pytest.mark.parametrize("conv", [False, True])
def test_destructure_matches_jax(conv):
    key = jax.random.PRNGKey(7)
    jnn = _f64(jmlp.free_convection_conv_mlp(key, Nz=6, conv_width=2) if conv else jmlp.free_convection_mlp(key, Nz=6))
    tnn = from_reference(jnn, "cpu", torch.float64)
    jflat, jrebuild = jmlp.destructure(jnn)
    tflat, trebuild = tmlp.destructure(tnn)
    _close(tflat, jflat, 0)
    v = np.random.default_rng(2).normal(size=tflat.shape)
    x = np.random.default_rng(3).normal(size=(2, 6))
    _close(tmlp.apply_closure(trebuild(torch.tensor(v)), torch.tensor(x)),
           jmlp.apply_closure(jrebuild(jnp.asarray(v)), jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(7, 7), (7, 12), (31, 96), (1, 3)])
def test_spatial_causality_mask_matches_jax(shape):
    np.testing.assert_array_equal(tmlp.spatial_causality_mask(shape).numpy(),
                                  np.asarray(jmlp.spatial_causality_mask(shape)))


@pytest.mark.parametrize("conv", [False, True])
def test_causality_penalty_and_hard_mask_match_jax(conv):
    key = jax.random.PRNGKey(11)
    jnn = _f64(jmlp.free_convection_conv_mlp(key, Nz=8, conv_width=3) if conv else jmlp.free_convection_mlp(key, Nz=8))
    tnn = from_reference(jnn, "cpu", torch.float64)
    _close(tmlp.spatial_causality_penalty(tnn), jmlp.spatial_causality_penalty(jnn))
    jm, tm = jmlp.apply_spatial_causality_mask(jnn), tmlp.apply_spatial_causality_mask(tnn)
    assert type(tm) is type(tnn)
    _close(tmlp.destructure(tm)[0], jmlp.destructure(jm)[0], 0)
    assert float(tmlp.spatial_causality_penalty(tm)) == 0.0
    # Lower-triangular through every layer: output face i reads inputs j <= i only.
    if not conv:
        x = torch.tensor(np.random.default_rng(0).normal(size=8), requires_grad=True)
        y = tmlp.apply_closure(tm, x)
        jac = torch.stack([torch.autograd.grad(y[i], x, retain_graph=True)[0] for i in range(y.shape[0])])
        assert float(jac.triu(1).abs().max()) == 0.0
