"""Port parity: WENO5 upwind advection (``core/advection.py``).

Numpy fields from a seed, smooth and with fronts, go through both packages
in float64; face values and fluxes agree within ``RTOL = 1e-12`` of their
scale (the same elementwise operations; the WENO-Z weights divide by
``beta + eps`` with eps 1e-15, so a front's last digit may differ). The
float32 run is held to ``F32_RTOL = 1e-5``: eps becomes 1e-8 and the two
packages round the weight quotients in their own orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.core import advection as jadv
from climateparameterizations_jl_tpu_torch.core import advection as tadv

RTOL, F32_RTOL = 1e-12, 1e-5


def _field(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, shape[-1])
    smooth = np.sin(2 * np.pi * x) + 0.3 * np.cos(6 * np.pi * x)
    front = np.where(x > 0.55, 1.0, -0.5)
    return smooth + front + 0.05 * rng.standard_normal(shape)


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("boundary", ["edge", "periodic"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_face_values_and_fluxes_match_jax(boundary, axis):
    q = np.moveaxis(_field((5, 4, 17)), -1, axis)
    qj = jnp.asarray(q)
    n = q.shape[axis]
    faces = list(q.shape)
    faces[axis] = n - 1 if boundary == "edge" else n
    u = np.random.default_rng(1).standard_normal(faces)
    for got, want in zip(tadv.weno5_face_values(torch.tensor(q), axis, boundary),
                         jadv.weno5_face_values(qj, axis, boundary)):
        _close(got, want, RTOL)
    _close(tadv.weno5_advective_flux(torch.tensor(u), torch.tensor(q), axis, boundary),
           jadv.weno5_advective_flux(jnp.asarray(u), qj, axis, boundary), RTOL)


def test_float32_fluxes_match_jax():
    q, u = _field((6, 33)).astype(np.float32), np.random.default_rng(2).standard_normal((6, 32)).astype(np.float32)
    _close(tadv.weno5_advective_flux(torch.tensor(u), torch.tensor(q), -1, "edge"),
           jadv.weno5_advective_flux(jnp.asarray(u), jnp.asarray(q), -1, "edge"), F32_RTOL)


def test_reconstruction_exact_for_constants_and_linear_data():
    qL, qR = tadv.weno5_face_values(torch.full((16,), 3.5, dtype=torch.float64), boundary="periodic")
    assert torch.allclose(qL, torch.tensor(3.5, dtype=torch.float64), rtol=1e-14)
    assert torch.allclose(qR, torch.tensor(3.5, dtype=torch.float64), rtol=1e-14)
    qL, _ = tadv.weno5_face_values(torch.arange(16, dtype=torch.float64), boundary="edge")
    assert torch.allclose(qL[2:-2], torch.arange(15, dtype=torch.float64)[2:-2] + 0.5, atol=1e-10)
    with pytest.raises(ValueError, match="unknown boundary"):
        tadv.weno5_face_values(torch.zeros(8), boundary="reflect")
