"""Port parity: the forward-scaling study (``studies/forward_scaling.py``) against its port.

The routes of ``benchmarks.bench_nde_forward`` are held against the JAX
package's on the same inputs (the flagship setup of
``__graft_entry__._make_setup`` with the trained MLPs of
``runs/wm_flagship_fold``, handed over through ``bridge.from_reference``),
at 32 columns x 8 RK4 steps: the JAX scan over the packed RHS (``packed``)
and over ``make_fast_rhs`` (``fast``, ``fold``), against the port's kernel
route (its plain version on the CPU) and its eager loops.

Tolerances: the JAX package's own for its fused kernel against the XLA path
(``RTOL = 2e-4``, ``ATOL = 2e-6``; f32 with other summation orders,
amplified by the stiff tendency scaling), as ``tests/test_torch_fused_rhs.py``.
``chunk_columns`` is held to one whole run bit for bit. The study's rows
must carry every key the JAX script writes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from climateparameterizations_jl_tpu import benchmarks as jbench
from climateparameterizations_jl_tpu.closures.mlp import wind_mixing_mlp
from climateparameterizations_jl_tpu.models import timestepper as jts
from climateparameterizations_jl_tpu.models import wind_mixing as jwm
from climateparameterizations_jl_tpu.ops import fused_rhs as jfr
from climateparameterizations_jl_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.bridge import from_reference
from climateparameterizations_jl_tpu_torch.studies import forward_scaling as tfs
from studies import forward_scaling as jfs

RTOL, ATOL = 2e-4, 2e-6
DT = 1e-5
N_COLUMNS, N_STEPS = 32, 8


@pytest.fixture(scope="module")
def setup():
    model, _, bcs, _ = graft._make_setup(Nz=32, n_columns=1)
    skeleton = jwm.FluxNNs(*[wind_mixing_mlp(k, 32) for k in jax.random.split(jax.random.PRNGKey(0), 3)])
    nns, _ = j_load_checkpoint("runs/wm_flagship_fold", skeleton)
    nns = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), nns)
    x0 = np.random.default_rng(3).normal(size=(N_COLUMNS, 96)).astype(np.float32) * 0.1
    j = (model, nns, bcs, jnp.asarray(x0))
    t = (from_reference(model, "cpu"), from_reference(nns, "cpu"), from_reference(bcs, "cpu"), torch.tensor(x0))
    return j, t


def _jax_route(jm, jn, jb, jx, rhs_variant, chunk=None, unroll=4):
    """The final state of the JAX package's ``bench_nde_forward`` route (its ``run``, without the timing)."""
    if rhs_variant == "packed":
        packed = jwm.pack_flux_nns(jn)
        rhs = lambda x, t: jwm.wind_mixing_rhs(jm, packed, jb, x, t)  # noqa: E731
    else:
        rhs = jfr.make_fast_rhs(jm, jn, jb, fold_divergence=rhs_variant == "fold")

    def evolve(x):
        def body(x, i):
            return jts.rk4_step(rhs, x, i * DT, jnp.float32(DT)), None

        return jax.lax.scan(body, x, jnp.arange(N_STEPS, dtype=jnp.float32), unroll=unroll)[0]

    if chunk is not None:
        return jax.jit(lambda x: jax.lax.map(evolve, x.reshape(-1, chunk, x.shape[-1])).reshape(x.shape))(jx)
    return jax.jit(evolve)(jx)


@pytest.mark.parametrize("rhs_variant", benchmarks.FORWARD_VARIANTS)
def test_routes_match_jax(setup, rhs_variant):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = setup
    run, launches, weights = benchmarks.nde_forward_route(tm, tn, tb, N_STEPS, N_COLUMNS, rhs_variant, device="cpu")
    got = run(tx)
    want = _jax_route(jm, jn, jb, jx, rhs_variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert float((got - tx).abs().max()) > 1e-5  # the state moved
    assert (launches, weights) == ((1, 0) if rhs_variant == "packed" else (0, 0))  # no kernel weights on the CPU


@pytest.mark.parametrize("rhs_variant", benchmarks.FORWARD_VARIANTS)
def test_chunk_columns_equal_bit_for_bit(setup, rhs_variant):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = setup
    whole = benchmarks.nde_forward_route(tm, tn, tb, N_STEPS, N_COLUMNS, rhs_variant, device="cpu")[0](tx)
    run, launches, _ = benchmarks.nde_forward_route(tm, tn, tb, N_STEPS, N_COLUMNS, rhs_variant, chunk_columns=8,
                                                    device="cpu")
    assert torch.equal(run(tx), whole)
    assert launches == (4 if rhs_variant == "packed" else 0)
    # JAX's lax.map over the same chunks, within the route tolerance.
    np.testing.assert_allclose(run(tx).numpy(), np.asarray(_jax_route(jm, jn, jb, jx, rhs_variant, chunk=8)),
                               rtol=RTOL, atol=ATOL)


def test_route_rejects_what_jax_rejects(setup):
    _, (tm, tn, tb, tx) = setup
    with pytest.raises(ValueError, match="must divide"):
        benchmarks.nde_forward_route(tm, tn, tb, N_STEPS, N_COLUMNS, chunk_columns=5, device="cpu")
    with pytest.raises(ValueError, match="rhs_variant"):
        benchmarks.nde_forward_route(tm, tn, tb, N_STEPS, N_COLUMNS, "xla", device="cpu")
    with pytest.raises(ValueError, match="f32 products"):
        benchmarks.nde_forward_route(tm, tn, tb, N_STEPS, N_COLUMNS, "fold", matmul_dtype="bfloat16", device="cpu")


@pytest.mark.parametrize("n,chunk", [(1024, None), (1024, 512), (1024, 1024), (1024, 300), (131072, 32768)])
def test_effective_chunk_is_the_jax_rule(n, chunk):
    want = chunk if chunk and n > chunk and n % chunk == 0 else None
    assert tfs.effective_chunk(n, chunk) == want


def test_rows_carry_every_jax_key(monkeypatch, tmp_path):
    """The JAX script's rows (its benchmark stood in for: only the keys are compared) against the port's on the CPU."""
    def fake(**kw):
        return {"median_s": 1.0, "column_timesteps_per_sec": 1.0, "mfu_pct": 0.0, "achieved_tflops": 0.0}

    monkeypatch.setattr(jbench, "bench_nde_forward", fake)
    jfs.main(["--columns", "16,32", "--n-steps", "4", "--chunk-columns", "16", "--out", str(tmp_path / "j.jsonl")])
    jrows = [json.loads(line) for line in (tmp_path / "j.jsonl").read_text().splitlines()]
    rows = tfs.main(["--device", "cpu", "--columns", "16,32", "--n-steps", "4", "--chunk-columns", "16",
                     "--rhs-variant", "fold", "--out", str(tmp_path / "t.jsonl")])
    assert len(rows) == len(jrows) == 2
    assert [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()] == rows
    for row, jrow in zip(rows, jrows):
        assert set(jrow) <= set(row)
        assert {k: row[k] for k in ("n_columns", "unroll", "n_steps", "chunk_columns")} == {
            k: jrow[k] for k in ("n_columns", "unroll", "n_steps", "chunk_columns")}
        assert row["median_s"] > 0 and row["mfu_pct"] > 0 and row["achieved_tflops"] > 0
    assert rows[1]["chunk_columns"] == 16 and rows[0]["chunk_columns"] is None
