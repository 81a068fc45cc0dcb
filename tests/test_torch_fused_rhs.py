"""Port parity: the fused RK4 runners and their host-side constant builders.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
``tests/test_fused_rhs.py`` does; the port's runners run the kernel's plain
version (``_multistep_plain``) for CPU tensors. The CUDA kernel itself is
held against the plain version by ``tests/test_torch_cuda.py`` (card only).

Tolerances: the constant builders are numpy in both packages and must
agree to the bit. Trajectories use the JAX package's own tolerance for its
fused kernel against the XLA path (``rtol=2e-4, atol=2e-6``): f32 with
different summation orders, amplified by the stiff tendency scaling.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from climateparameterizations_jl_tpu.closures.mlp import wind_mixing_mlp
from climateparameterizations_jl_tpu.models import timestepper as jts
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.ops import fused_rhs as jfr
from climateparameterizations_jl_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.models import wind_mixing as twm
from climateparameterizations_jl_tpu_torch.ops import _cuda
from climateparameterizations_jl_tpu_torch.ops import fused_rhs as tfr

RTOL, ATOL = 2e-4, 2e-6
DT = 1e-5


def _setup(n_columns=64, Nz=32, trained=False):
    model, nns, bcs, _ = graft._make_setup(Nz=Nz, n_columns=1)
    if trained:
        skeleton = jwm.FluxNNs(*[wind_mixing_mlp(k, Nz) for k in jax.random.split(jax.random.PRNGKey(0), 3)])
        nns, _ = j_load_checkpoint("runs/wm_flagship_fold", skeleton)
        nns = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), nns)
    x0 = np.random.default_rng(n_columns).normal(size=(n_columns, 3 * Nz)).astype(np.float32) * 0.1
    j = (model, nns, bcs, jnp.asarray(x0, jnp.float32))
    t = (from_reference(model, "cpu"), from_reference(nns, "cpu"), from_reference(bcs, "cpu"), torch.tensor(x0))
    return j, t


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("pad_to_block", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_block_weights_bitwise(pad_to_block, dtype):
    (jm, jn, jb, _), (tm, tn, tb, _) = _setup(trained=True)
    jw, jdims = jfr._pack_block_weights(jn, 32, dtype, pad_to_block)
    tw, tdims = tfr._pack_block_weights(tn, 32, dtype, pad_to_block)
    assert tdims == jdims
    for a, b in zip(tw, jw):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_bcs", [False, True])
def test_scalar_constants_bitwise(with_bcs):
    (jm, _, jb, _), (tm, _, tb, _) = _setup()
    assert tfr._scalar_constants(tm, tb if with_bcs else None) == jfr._scalar_constants(jm, jb if with_bcs else None)


@pytest.mark.parametrize("Nz", [16, 32])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_assembly_builders_bitwise(Nz, dtype):
    (jm, _, jb, _), (tm, _, tb, _) = _setup(Nz=Nz)
    consts = jfr._scalar_constants(jm, jb)
    for a, b in zip(tfr._assembly_constants(consts, Nz, dtype), jfr._assembly_constants(consts, Nz, dtype)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tfr.fold_divergence_constants(consts, Nz, dtype), jfr.fold_divergence_constants(consts, Nz, dtype)):
        np.testing.assert_array_equal(a, b)
    R = tfr.tendency_coefficients(*consts[15:16], consts[14], *consts[6:9], *consts[1:4])
    assert R == jfr.tendency_coefficients(*consts[15:16], consts[14], *consts[6:9], *consts[1:4])
    np.testing.assert_array_equal(tfr.divergence_matrix(*R, Nz, dtype), jfr.divergence_matrix(*R, Nz, dtype))
    bots, tops = (0.1, -0.2, 0.3), (0.4, 0.0, -0.6)
    np.testing.assert_array_equal(tfr.bc_tendency_row(*R, bots, tops, Nz), jfr.bc_tendency_row(*R, bots, tops, Nz))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("trained", [False, True])
def test_make_fast_rhs(fold, trained):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup(n_columns=8, trained=trained)
    got = tfr.make_fast_rhs(tm, tn, tb, fold_divergence=fold, device="cpu")(tx, 0.0)
    # Same assembly in both packages: agrees to the f32 roundoff of the
    # largest tendencies (~1e2 to 1e4).
    want_jax = jfr.make_fast_rhs(jm, jn, jb, fold_divergence=fold)(jx, 0.0)
    scale = float(np.abs(np.asarray(want_jax)).max())
    _close(got, want_jax, rtol=1e-5, atol=16 * np.finfo(np.float32).eps * scale)
    # Against the per-variable RHS: the JAX package's tolerance for the same
    # comparison (tests/test_fused_rhs.py), scaled to the largest tendency.
    want_port = twm.wind_mixing_rhs(tm, tn, tb, tx, 0.0)
    _close(got, want_port, rtol=1e-3, atol=1e-4 * max(1.0, scale / 1e2))


def test_make_fast_rhs_unbatched():
    (_, _, _, _), (tm, tn, tb, tx) = _setup(n_columns=2)
    got = tfr.make_fast_rhs(tm, tn, tb, device="cpu")(tx[0], 0.0)
    assert got.shape == (96,)


@pytest.mark.parametrize("trained", [False, True])
def test_multistep_plain_matches_pallas_mxu(trained):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup(trained=trained)
    want = jfr.fused_wind_mixing_multistep_mxu(jm, jn, jb, jx, DT, 8, interpret=True)
    got = tfr.fused_wind_mixing_multistep_mxu(tm, tn, tb, tx, DT, 8, device="cpu")
    _close(got, want)
    assert float((got - tx).abs().max()) > 1e-5


def test_multistep_plain_matches_pallas_v1():
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup()
    want = jfr.fused_wind_mixing_multistep(jm, jn, jb, jx, DT, 8, interpret=True)
    got = tfr.fused_wind_mixing_multistep(tm, tn, tb, tx, DT, 8, device="cpu")
    _close(got, want)


def test_runners_agree_with_port_solve():
    (_, _, _, _), (tm, tn, tb, tx) = _setup(n_columns=16, trained=True)
    want = twm.solve_wind_mixing_nde(tm, tn, tb, tx, 0.0, 8 * DT, 1, n_substeps=8)[-1]
    for make in (tfr.make_fused_runner_mxu, tfr.make_fused_runner):
        _close(make(tm, tn, tb, DT, 8, 16, device="cpu")(tx), want)


@pytest.mark.parametrize("make", [tfr.make_fused_runner_mxu, tfr.make_fused_runner])
def test_column_block_does_not_change_result(make):
    (_, _, _, _), (tm, tn, tb, tx) = _setup(n_columns=48)
    a = make(tm, tn, tb, DT, 4, 48, column_block=16, device="cpu")(tx)
    b = make(tm, tn, tb, DT, 4, 48, column_block=48, device="cpu")(tx)
    assert torch.equal(a, b)


@pytest.mark.parametrize("change", [
    dict(diurnal=True), dict(use_mpp=False), dict(zero_weights=False), dict(smooth_NN=True), dict(smooth_Ri=True),
])
def test_rejects_what_jax_rejects(change):
    (jm, jn, jb, _), (tm, tn, tb, _) = _setup(n_columns=4)
    jm, tm = dataclasses.replace(jm, **change), dataclasses.replace(tm, **change)
    with pytest.raises(AssertionError):
        jfr.make_fused_runner_mxu(jm, jn, jb, DT, 1, 4, interpret=True)
    for make in (tfr.make_fused_runner_mxu, tfr.make_fused_runner):
        with pytest.raises(ValueError):
            make(tm, tn, tb, DT, 1, 4, device="cpu")
    with pytest.raises(ValueError):
        tfr.make_fast_rhs(tm, tn, tb, device="cpu")


def test_rejects_other_activation():
    (jm, jn, jb, _), (tm, tn, tb, _) = _setup(n_columns=4)
    jn = jwm.FluxNNs(*[dataclasses.replace(m, activation="tanh") for m in jn])
    tn = twm.FluxNNs(*[dataclasses.replace(m, activation="tanh") for m in tn])
    with pytest.raises(NotImplementedError):
        jfr.make_fused_runner_mxu(jm, jn, jb, DT, 1, 4, interpret=True)
    with pytest.raises(NotImplementedError):
        tfr.make_fused_runner_mxu(tm, tn, tb, DT, 1, 4, device="cpu")


def test_bf16_not_ported_and_bad_input_rejected():
    # The name dates from before the bf16 variant was ported: bf16 now runs
    # (the plain version on the CPU); other matmul dtypes and bad shapes are
    # still refused.
    (_, _, _, _), (tm, tn, tb, tx) = _setup(n_columns=4)
    run16 = tfr.make_fused_runner_mxu(tm, tn, tb, DT, 1, 4, matmul_dtype="bfloat16", device="cpu")
    assert run16.matmul_dtype == torch.bfloat16 and run16.operands[0].dtype == torch.bfloat16
    assert run16(tx).dtype == torch.float32
    with pytest.raises(ValueError):
        tfr.make_fused_runner_mxu(tm, tn, tb, DT, 1, 4, matmul_dtype="float16", device="cpu")
    run = tfr.make_fused_runner_mxu(tm, tn, tb, DT, 1, 4, device="cpu")
    with pytest.raises(ValueError):
        run(tx[:3])
    assert run(tx.numpy()).shape == (4, 96)


# bf16 NN products. The port's plain version and JAX's Pallas kernel (interpret
# mode) round the same f32 inputs to bf16 to nearest even, so the products are
# exact on both sides and only the f32 sums run in other orders (now and then
# an activation lands on the other side of a bf16 rounding midpoint, one bf16
# ulp in one input): they are held to the f32 tolerance above, far inside the
# bf16 one. Against the f32 trajectory both are held to the JAX test's own
# bf16 tolerance (tests/test_fused_rhs.py::test_bf16_matmuls_close).
BF16_RTOL, BF16_ATOL = 3e-2, 3e-3


def _xla_rk4(jm, jn, jb, jx, n_steps):
    def run(x):
        rhs = lambda x, t: jwm.wind_mixing_rhs(jm, jn, jb, x, t)  # noqa: E731

        def body(x, i):
            return jts.rk4_step(rhs, x, i * DT, jnp.float32(DT)), None

        return jax.lax.scan(body, x, jnp.arange(n_steps, dtype=jnp.float32))[0]

    return jax.jit(run)(jx)


@pytest.mark.parametrize("trained", [False, True])
def test_bf16_plain_matches_pallas_bf16(trained):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = _setup(n_columns=16, trained=trained)
    want = jfr.fused_wind_mixing_multistep_mxu(jm, jn, jb, jx, DT, 4, matmul_dtype="bfloat16", interpret=True)
    got = tfr.fused_wind_mixing_multistep_mxu(tm, tn, tb, tx, DT, 4, matmul_dtype="bfloat16", device="cpu")
    _close(got, want)
    reference = _xla_rk4(jm, jn, jb, jx, 4)
    _close(got, reference, rtol=BF16_RTOL, atol=BF16_ATOL)
    _close(want, reference, rtol=BF16_RTOL, atol=BF16_ATOL)
    if trained:  # the trained fluxes are large enough for bf16 to show against f32
        f32 = tfr.fused_wind_mixing_multistep_mxu(tm, tn, tb, tx, DT, 4, device="cpu")
        assert float((got - f32).abs().max()) > 1e-6


def test_mxu_rhs_follows_f64_state():
    (jm, jn, jb, _), (tm, tn, tb, _) = _setup(trained=True)
    consts = tfr._scalar_constants(tm, tb)
    (A1, b1, A2, b2, A3, b3), _ = tfr._pack_block_weights(tn, 32, np.float64, pad_to_block=True)
    ops = (A1, b1, A2, b2, A3, b3, *tfr._assembly_constants(consts, 32, np.float64))
    x = np.random.default_rng(5).normal(size=(3, 96)) * 0.1
    got = tfr._make_mxu_rhs(consts, 32, "mish", matmul_dtype=None)(torch.tensor(x), *map(torch.tensor, ops))
    assert got.dtype == torch.float64
    want = jfr._make_mxu_rhs(consts, 32, "mish", None)(jnp.asarray(x), *map(jnp.asarray, ops))
    assert want.dtype == jnp.float64
    # The same f64 operations in both packages: f64 roundoff of tendencies ~1e4.
    _close(got, want, rtol=1e-12, atol=1e-9)


def test_bf16_fragment_layout():
    """``mma_a_fragments`` against the PTX ISA's A-fragment layout for m16n8k16 .bf16: lane ``l``
    (``g = l // 4``, ``t = l % 4``) holds element ``i`` of its 8 at row ``g + 8 ((i // 2) % 2)``,
    column ``2 t + i % 2 + 8 (i // 4)`` of the tile."""
    W = torch.tensor(np.random.default_rng(3).normal(size=(50, 20)), dtype=torch.float32)
    frags = _cuda.mma_a_fragments(W)
    assert frags.shape == (2, 4, 32, 8) and frags.dtype == np.uint16
    A = np.zeros((32, 64), np.uint16)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(8):
            A[g + 8 * ((i // 2) % 2) + 16 * np.arange(2)[:, None],
              2 * t + i % 2 + 8 * (i // 4) + 16 * np.arange(4)[None, :]] = frags[:, :, lane, i]
    np.testing.assert_array_equal(A[:20, :50], W.T.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16))
    assert not A[20:].any() and not A[:, 50:].any()


def test_bf16_kernel_buffers():
    (_, _, _, _), (tm, tn, tb, _) = _setup(n_columns=4, trained=True)
    run = tfr.make_fused_runner_mxu(tm, tn, tb, DT, 1, 4, matmul_dtype="bfloat16", device="cpu")
    A1, b1, A2, b2, A3, b3, _Dr, Krow, w1, w2 = run.operands
    vecs, frags = _cuda.pack_weights_bf16(A1, b1, A2, b2, A3, b3, Krow, w1, w2, 32, 50, 20)
    assert vecs.dtype == np.float32 and vecs.size == 150 + 60 + 93 + 3 * 96
    # A1: 10 m-tiles (150 neurons) x 6 k-tiles; A2 blocks 2 x 4; A3 blocks 2 x 2; 256 bf16 per tile.
    assert frags.dtype == np.uint16 and frags.size == 256 * (10 * 6 + 3 * 2 * 4 + 3 * 2 * 2)
    # The weights are rounded to bf16 once, by the runner, to nearest even.
    np.testing.assert_array_equal(A1[:, :50].float().numpy(), tn.uw.weights[0].T.to(torch.bfloat16).float().numpy())
    tail = frags[256 * (60 + 24):].reshape(3, 2, 2, 32, 8)  # A3's blocks: (block, mt, kt, lane, 8)
    np.testing.assert_array_equal(tail[1, 0, 0, 0, 0:2].view(np.int16),
                                  tn.vw.weights[2][0, 0:2].to(torch.bfloat16).view(torch.int16).numpy())


def test_kernel_weight_buffer_layout():
    (_, _, _, _), (tm, tn, tb, _) = _setup(n_columns=4, trained=True)
    (A1, b1, A2, b2, A3, b3), (h1, h2, ni) = tfr._pack_block_weights(tn, 32, pad_to_block=True)
    Dr, Krow, w1, w2 = tfr._assembly_constants(tfr._scalar_constants(tm, tb), 32)
    buf = _cuda.pack_weights(A1, b1, A2, b2, A3, b3, Krow, w1, w2, 32, h1, h2)
    # A1 k-major, each MLP's 50 neurons in a block of 52 columns (zeros after them).
    assert _cuda.layer1_pitch(h1) == 52
    assert buf.dtype == np.float32 and buf.size == 96 * 156 + 150 + 3 * 50 * 20 + 60 + 3 * 20 * 31 + 93 + 3 * 96
    W1 = buf[:96 * 156].reshape(96, 3, 52)
    np.testing.assert_array_equal(W1[:, 1, :50], tn.vw.weights[0].numpy().T)
    assert not W1[:, :, 50:].any()
    o = 96 * 156 + 150
    np.testing.assert_array_equal(buf[o:o + 1000].reshape(50, 20), tn.uw.weights[1].numpy().T)
    o += 3 * 50 * 20 + 60
    np.testing.assert_array_equal(buf[o + 620:o + 1240].reshape(20, 31), tn.vw.weights[2].numpy().T)
    np.testing.assert_array_equal(buf[o + 1860 + 62:o + 1860 + 93], tn.wT.biases[2].numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    (_, _, _, _), (tm, tn, tb, tx) = _setup(n_columns=4)
    run = tfr.make_fused_runner_mxu(tm, tn, tb, DT, 1, 4, device="cpu")
    params = _cuda.make_params(n_columns=4, n_steps=1, Nz=32, h1=50, h2=20, activation="mish", dt=DT,
                               coefficients=tfr._rhs_coefficients(run.consts, 32))
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.FUSED_RK4(tx, torch.zeros(10), params)
    assert _cuda.FUSED_RK4.launches == 0



def test_bf16_kernel_wrapper_refuses_cpu_tensors():
    (_, _, _, _), (tm, tn, tb, tx) = _setup(n_columns=4)
    run = tfr.make_fused_runner_mxu(tm, tn, tb, DT, 1, 4, matmul_dtype="bfloat16", device="cpu")
    params = _cuda.make_params(n_columns=4, n_steps=1, Nz=32, h1=50, h2=20, activation="mish", dt=DT,
                               coefficients=tfr._rhs_coefficients(run.consts, 32))
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.FUSED_RK4_BF16(tx, torch.zeros(10), torch.zeros(8, dtype=torch.bfloat16), params)
    assert _cuda.FUSED_RK4_BF16.launches == 0
