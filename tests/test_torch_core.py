"""Port parity: core operators, scalings, Richardson number and mPP.

The same numpy inputs (from a seed) go through the JAX package's function
and its twin in ``climateparameterizations_jl_tpu_torch`` on the CPU. The
JAX side gets explicit f32 arrays (``tests/conftest.py`` turns x64 on).
Tolerances: the twins run the same f32 elementwise operations, so they
agree to a few ulps (XLA may fuse a multiply-add or reorder a product);
``RTOL = 1e-6`` is about 8 ulps of f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climateparameterizations_jl_tpu.core import constants as jconst
from climateparameterizations_jl_tpu.core import filters as jfilt
from climateparameterizations_jl_tpu.core import operators as jops
from climateparameterizations_jl_tpu.core.scalings import ZeroMeanUnitVarianceScaling as JScaling
from climateparameterizations_jl_tpu.physics import mpp as jmpp
from climateparameterizations_jl_tpu.physics.richardson import local_richardson_scaled as j_ri
from climateparameterizations_jl_tpu_torch.core import constants as tconst
from climateparameterizations_jl_tpu_torch.core import filters as tfilt
from climateparameterizations_jl_tpu_torch.core import operators as tops
from climateparameterizations_jl_tpu_torch.core.scalings import ZeroMeanUnitVarianceScaling as TScaling
from climateparameterizations_jl_tpu_torch.physics import mpp as tmpp
from climateparameterizations_jl_tpu_torch.physics.richardson import local_richardson_scaled as t_ri

RTOL = 1e-6


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jnp.float32), torch.tensor(a)


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [(33,), (4, 33), (2, 3, 17)])
def test_d_face_to_center(shape):
    j, t = _pair(np.random.default_rng(0).normal(size=shape))
    _close(tops.d_face_to_center(t, 1.0 / 32), jops.d_face_to_center(j, 1.0 / 32))


@pytest.mark.parametrize("shape", [(32,), (4, 32), (2, 3, 16)])
def test_d_center_to_face(shape):
    j, t = _pair(np.random.default_rng(1).normal(size=shape))
    got = tops.d_center_to_face(t, 1.0 / 32)
    assert got.shape[-1] == shape[-1] + 1
    _close(got, jops.d_center_to_face(j, 1.0 / 32))


@pytest.mark.parametrize("bc_shape", [(), (3,), (3, 3)])
def test_pad_faces_left_aligned_broadcast(bc_shape):
    # (S, E, Nz-1) interiors with S == E: a (S,) BC must attach to the
    # simulation axis (left-aligned), which right-aligned broadcasting gets wrong.
    rng = np.random.default_rng(2)
    ji, ti = _pair(rng.normal(size=(3, 3, 7)))
    jb, tb = _pair(rng.normal(size=bc_shape))
    jt, tt = _pair(rng.normal(size=bc_shape))
    got = tops.pad_faces(ti, tb, tt)
    _close(got, jops.pad_faces(ji, jb, jt))
    if bc_shape == (3,):
        np.testing.assert_array_equal(got[:, 1, 0].numpy(), tb.numpy())


def test_scaling_scale_unscale():
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng.normal(size=(5, 8)) * 3 + 2)
    js, ts = JScaling(jnp.float32(19.0), jnp.float32(0.5)), TScaling(torch.tensor(19.0), torch.tensor(0.5))
    _close(ts.scale(tx), js.scale(jx))
    _close(ts.unscale(tx), js.unscale(jx))
    _close(ts(tx), js(jx))


@pytest.mark.parametrize("constant", [False, True])
def test_scaling_fit(constant):
    data = np.full((40,), 2.5) if constant else np.random.default_rng(4).normal(size=(40,)) * 2 + 1
    jd, td = _pair(data)
    js, ts = JScaling.fit(jd), TScaling.fit(td)
    np.testing.assert_allclose(float(ts.mu), float(js.mu), rtol=1e-6)
    np.testing.assert_allclose(float(ts.sigma), float(js.sigma), rtol=1e-5)


def test_local_richardson_scaled():
    rng = np.random.default_rng(5)
    (jdu, tdu), (jdv, tdv), (jdT, tdT) = (_pair(rng.normal(size=(6, 33)) + 1e-7) for _ in range(3))
    consts = (256.0, 9.80665, 2e-4, 0.05, 0.05, 0.5)
    jc = [jnp.float32(c) for c in consts]
    tc = [torch.tensor(c) for c in consts]
    _close(t_ri(tdu, tdv, tdT, *tc), j_ri(jdu, jdv, jdT, *jc), rtol=4 * RTOL)


def test_tanh_step():
    j, t = _pair(np.linspace(-5, 5, 41))
    _close(tmpp.tanh_step(t), jmpp.tanh_step(j), atol=1e-7)


@pytest.mark.parametrize("scale", [0.1, 1.0, 100.0])
def test_mpp_diffusivity(scale):
    j, t = _pair(np.random.default_rng(6).normal(size=(4, 33)) * scale)
    jp = jmpp.MPPParameters.default(jnp.float32)
    tp = tmpp.MPPParameters.default(torch.float32, device="cpu")
    np.testing.assert_array_equal(tp.as_vector().numpy(), np.asarray(jp.as_vector()))
    # 1 - tanh(x) cancels near saturation: one f32 ulp of tanh (6e-8) times
    # nu_minus (0.1) is 6e-9 absolute.
    _close(tmpp.mpp_diffusivity(t, tp), jmpp.mpp_diffusivity(j, jp), atol=1e-8)


def test_mpp_vector_roundtrip():
    v = torch.tensor([1e-4, 0.2, 0.3, 0.8, 1.1])
    p = tmpp.MPPParameters.from_vector(v)
    np.testing.assert_array_equal(p.as_vector().numpy(), v.numpy())


def test_diurnal_cycle():
    t = np.linspace(0.0, 2 * 86400.0, 17)
    np.testing.assert_allclose(tconst.diurnal_cycle(torch.tensor(t)).numpy(),
                               np.asarray(jconst.diurnal_cycle(jnp.asarray(t))), atol=1e-12)


@pytest.mark.parametrize("width", [3, 5])
def test_smoothing_filter(width):
    np.testing.assert_array_equal(tfilt.smoothing_filter_matrix(12, width), jfilt.smoothing_filter_matrix(12, width))
    j, t = _pair(np.random.default_rng(7).normal(size=(3, 12)))
    _close(tfilt.smoothing_filter(t, width), jfilt.smoothing_filter(j, width), atol=1e-7)
