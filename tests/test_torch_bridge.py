"""Port parity: parameters carried over from the JAX package, and checkpoints.

``bridge.from_reference`` turns the JAX package's objects into the port's
through numpy; the port's checkpoint reader loads the repo's npz layout
without JAX. Arrays must cross unchanged (bit for bit); the RHS built from
them agrees to the f32 roundoff of its largest tendencies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from climateparameterizations_jl_tpu.closures.mlp import wind_mixing_mlp
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from climateparameterizations_jl_tpu_torch import benchmarks as tbench
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.closures.mlp import MLP
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm
from climateparameterizations_jl_tpu_torch.train import checkpoint as tckpt

FLAGSHIP = "runs/wm_flagship_fold"


def _jax_skeleton():
    return jwm.FluxNNs(*[wind_mixing_mlp(k, 32) for k in jax.random.split(jax.random.PRNGKey(0), 3)])


def test_make_setup_carries_over():
    model, nns, bcs, _ = graft._make_setup(Nz=32, n_columns=1)
    tm, tn, tb = (from_reference(o, "cpu") for o in (model, nns, bcs))
    assert isinstance(tm, twm.WindMixingModel) and isinstance(tn, twm.FluxNNs) and isinstance(tb, twm.BoundaryConditions)
    assert (tm.Nz, tm.use_mpp, tm.zero_weights, tm.diurnal) == (model.Nz, model.use_mpp, model.zero_weights, model.diurnal)
    assert float(tm.scalings.T.mu) == float(model.scalings.T.mu) and float(tm.mpp.Pr) == float(model.mpp.Pr)
    for jm, tmlp in zip(nns, tn):
        assert tmlp.activation == jm.activation
        for a, b in zip(tmlp.weights + tmlp.biases, jm.weights + jm.biases):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_same_rhs_in_both_packages():
    model, nns, bcs, x0 = graft._make_setup(Nz=32, n_columns=8)
    tm, tn, tb = (from_reference(o, "cpu") for o in (model, nns, bcs))
    want = np.asarray(jwm.wind_mixing_rhs(model, nns, bcs, x0, 0.0))
    got = twm.wind_mixing_rhs(tm, tn, tb, torch.tensor(np.asarray(x0)), 0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=16 * np.finfo(np.float32).eps * np.abs(want).max())


def test_port_setup_matches_graft_constants():
    model, _, bcs, _ = graft._make_setup(Nz=32, n_columns=1)
    tm, _, tb, x0 = tbench.make_setup(32, 4, device="cpu")
    ref_m, ref_b = from_reference(model, "cpu"), from_reference(bcs, "cpu")
    from climateparameterizations_jl_tpu_torch.ops.fused_rhs import _scalar_constants

    assert _scalar_constants(tm, tb) == _scalar_constants(ref_m, ref_b)
    assert x0.shape == (4, 96) and x0.dtype == torch.float32


def test_checkpoint_reader_matches_jax_loader():
    j_nns, j_meta = j_load_checkpoint(FLAGSHIP, _jax_skeleton())
    t_nns = tckpt.load_flux_nns(FLAGSHIP, device="cpu")
    for jm, tmlp in zip(j_nns, t_nns):
        assert tmlp.activation == "mish" and tmlp.sizes == (96, 50, 20, 31)
        for a, b in zip(tmlp.weights + tmlp.biases, jm.weights + jm.biases):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    skeleton = from_reference(_jax_skeleton(), "cpu")
    state, meta = tckpt.load_checkpoint(FLAGSHIP, skeleton)
    assert meta == j_meta
    np.testing.assert_array_equal(state.wT.biases[2].numpy(), np.asarray(j_nns.wT.biases[2]))


def test_checkpoint_reader_reports_missing_leaf(tmp_path):
    np.savez(tmp_path / "state.npz", **{".uw/.weights/[0]": np.zeros((2, 3), np.float32)})
    skeleton = twm.FluxNNs(MLP((torch.zeros(2, 3),), (torch.zeros(2),), "relu"), None, None)
    with pytest.raises(KeyError, match="biases"):
        tckpt.load_checkpoint(str(tmp_path), skeleton)


def test_bridge_rejects_non_numeric_leaves():
    with pytest.raises(TypeError):
        from_reference(np.array(["a"]), "cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_bridge_casts_to_f32(dtype):
    got = from_reference(jnp.asarray([1.5, 2.5], dtype), "cpu")
    assert got.dtype == torch.float32 and got.tolist() == [1.5, 2.5]
