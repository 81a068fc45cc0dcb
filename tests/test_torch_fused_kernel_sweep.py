"""Port parity: the fused-kernel sweep (``studies/fused_kernel_sweep.py``) against its port.

Every route of the port's sweep (``fused_kernel_sweep.routes``, on the CPU:
the CUDA routes run their kernels' plain versions) is held against the JAX
script's route on the same inputs, at 16 columns x 4 RK4 steps with the
trained MLPs of ``runs/wm_flagship_fold`` (handed over through
``bridge.from_reference``): the XLA scans over the packed RHS and over
``make_fast_rhs`` (unfolded and folded), and the Pallas kernels in interpret
mode (v1, MXU in f32 and bf16, ``loop_unroll=4``, the single-step hybrid).
The JAX routes whose knob changes nothing on the port (the scan unroll, the
v1 entry point, ``loop_unroll=4``) are held to the state of the port's route
they alias.

Tolerances: the JAX package's own for its fused kernel against the XLA path
(``RTOL = 2e-4``, ``ATOL = 2e-6``), as ``tests/test_torch_fused_rhs.py``;
the bf16 route against JAX's bf16 kernel to the same limits (both round the
same f32 inputs to bf16; see that file). The sweep's rows must carry every
key the JAX script writes; the JAX script runs with ``--out`` in a temporary
directory and its timing stood in for (only its rows' keys are compared).
"""

import json
import sys

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
from climateparameterizations_jl_tpu_torch.studies import fused_kernel_sweep as tks
from studies import fused_kernel_sweep as jks

RTOL, ATOL = 2e-4, 2e-6
DT = 1e-5
C, S = 16, 4


@pytest.fixture(scope="module")
def setup():
    model, _, bcs, _ = graft._make_setup(Nz=32, n_columns=1)
    skeleton = jwm.FluxNNs(*[wind_mixing_mlp(k, 32) for k in jax.random.split(jax.random.PRNGKey(0), 3)])
    nns, _ = j_load_checkpoint("runs/wm_flagship_fold", skeleton)
    nns = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), nns)
    x0 = np.random.default_rng(5).normal(size=(C, 96)).astype(np.float32) * 0.1
    j = (model, nns, bcs, jnp.asarray(x0))
    t = (from_reference(model, "cpu"), from_reference(nns, "cpu"), from_reference(bcs, "cpu"), torch.tensor(x0))
    return j, t


def _jax_scan(rhs, jx, unroll):
    def run(x):
        def body(x, i):
            return jts.rk4_step(rhs, x, i * DT, jnp.float32(DT)), None

        return jax.lax.scan(body, x, jnp.arange(S, dtype=jnp.float32), unroll=unroll)[0]

    return jax.jit(run)(jx)


def _jax_states(jm, jn, jb, jx) -> dict:
    """The final state of each of the JAX script's routes, keyed by the port's config name on the CPU."""
    packed = jwm.pack_flux_nns(jn)
    out = {}
    for label, rhs in (("packed", lambda x, t: jwm.wind_mixing_rhs(jm, packed, jb, x, t)),
                       ("fast-rhs (mxu twin)", jfr.make_fast_rhs(jm, jn, jb)),
                       ("fast-rhs fold-divergence", jfr.make_fast_rhs(jm, jn, jb, fold_divergence=True))):
        for u in tks.UNROLLS:
            out[f"plain rk4 {label} unroll={u}"] = _jax_scan(rhs, jx, u)
    out["cuda v1 fused_rk4 plain"] = jfr.make_fused_runner(jm, jn, jb, DT, S, C, column_block=C, interpret=True)(jx)
    out["cuda mxu fused_rk4 plain float32"] = jfr.make_fused_runner_mxu(jm, jn, jb, DT, S, C, column_block=C,
                                                                       interpret=True)(jx)
    out["cuda mxu fused_rk4_bf16 plain bfloat16"] = jfr.make_fused_runner_mxu(
        jm, jn, jb, DT, S, C, column_block=C, matmul_dtype="bfloat16", interpret=True)(jx)
    out["cuda mxu fused_rk4 plain float32 loop_unroll=4"] = jfr.make_fused_runner_mxu(
        jm, jn, jb, DT, S, C, column_block=C, interpret=True, loop_unroll=4)(jx)
    step1 = jfr.make_fused_runner_mxu(jm, jn, jb, DT, 1, C, column_block=C, interpret=True)
    out["cuda mxu fused_rk4 plain single-step x loop"] = jax.lax.scan(lambda x, _: (step1(x), None), jx, None,
                                                                      length=S)[0]
    return out


def test_every_route_matches_its_jax_route(setup):
    (jm, jn, jb, jx), (tm, tn, tb, tx) = setup
    want = _jax_states(jm, jn, jb, jx)
    routes = tks.routes(tm, tn, tb, DT, S, C, torch.device("cpu"))
    assert [name for name, _, _, _ in routes] == list(want)  # one to one, in the JAX script's order
    aliases = {name: alias_of for name, _, _, alias_of in routes if alias_of is not None}
    assert aliases == {**{f"plain rk4 {label} unroll={u}": f"plain rk4 {label} unroll=1"
                          for label in ("packed", "fast-rhs (mxu twin)", "fast-rhs fold-divergence") for u in (4, 8)},
                       "cuda v1 fused_rk4 plain": "cuda mxu fused_rk4 plain float32",
                       "cuda mxu fused_rk4 plain float32 loop_unroll=4": "cuda mxu fused_rk4 plain float32"}
    got = {name: run(tx) for name, run, _, alias_of in routes if alias_of is None}
    for name, run, kernel, alias_of in routes:
        # An alias's JAX route is held to the port's state of the route it names.
        np.testing.assert_allclose(got[alias_of or name].numpy(), np.asarray(want[name]), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        assert (run is None) == (alias_of is not None)
        assert (kernel is None) == name.startswith("plain rk4")
    assert float((got["plain rk4 packed unroll=1"] - tx).abs().max()) > 1e-5


def test_rows_carry_every_jax_key(monkeypatch, tmp_path):
    jout, tout = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    stats = {"median_s": 1.0}
    monkeypatch.setattr(jks, "_bench_xla", lambda *a, **k: stats)
    monkeypatch.setattr(jks, "_bench_pallas", lambda *a, **k: stats)
    monkeypatch.setattr(sys, "argv", ["fused_kernel_sweep.py", "--quick", "--platform", "cpu", "--out", str(jout)])
    jks.main()
    jrows = [json.loads(line) for line in jout.read_text().splitlines()]
    rows = tks.sweep(64, 4, torch.device("cpu"), tout, iters=1, warmup=0)
    assert [json.loads(line) for line in tout.read_text().splitlines()] == rows
    assert len(rows) == len(jrows) == 14  # at 256 columns the JAX script's block sweep has one block per route
    for row, jrow in zip(rows, jrows):
        assert set(jrow) <= set(row)
        assert (row["n_columns"], row["n_steps"], row["platform"]) == (64, 4, "cpu")
        assert (jrow["n_columns"], jrow["n_steps"], jrow["platform"]) == (256, 16, "cpu")  # --quick
        assert row["median_s"] > 0 and row["col_ts_per_sec"] > 0
        # The routes agree with the f32 kernel's plain version within the route tolerance.
        assert row["max_abs_vs_f32_kernel"] <= ATOL + RTOL
    # Each distinct computation is timed once; an alias carries its route's numbers.
    by_name = {row["config"]: row for row in rows}
    assert sum(row["alias_of"] is None for row in rows) == 6
    for row in rows:
        if row["alias_of"] is not None:
            assert row["median_s"] == by_name[row["alias_of"]]["median_s"]


def test_default_out_is_a_new_file():
    assert tks.DEFAULT_OUT.name == "fused_sweep_port.jsonl"
    assert tks.DEFAULT_OUT != jks.__file__.replace("fused_kernel_sweep.py", "fused_sweep_results.jsonl")
