"""The port's ``utils/profiling.py`` on the CPU: timing stats, the section timer, the trace, the roofline columns.

``attach_roofline`` is held to the bounds ``PERF.md`` section 6 states from
its counts: the fused RK4 kernel at 1,024 x 1,024 (2.642 ms, operations),
the Gram kernel at 1,024 x 1,024 x 96 (3.011 us, operations) and the
Thomas kernel at 16,384 x 32 (3.13 us, bytes), each on the H100's
published peaks. The JAX module's ``TestProbeAlgebra`` has no twin here: it
tests ``xla_cost``, XLA's cost model, which PyTorch does not have.
"""

import json
import time

import pytest
import torch

from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.utils import profiling


@pytest.mark.parametrize("pipelined", [False, True])
def test_time_fn_keys_on_the_cpu(pipelined):
    calls = []
    stats = profiling.time_fn(lambda a, b=1: calls.append(a + b) or torch.ones(4).sum(), 2, b=3, iters=4, warmup=1,
                              pipelined=pipelined)
    assert calls == [5] * 6  # first call, warm-up, four timed
    want = {"compile_s", "median_s", "min_s", "mean_s", "iters"} | ({"pipelined"} if pipelined else set())
    assert set(stats) == want and stats["iters"] == 4
    assert 0.0 <= stats["min_s"] <= stats["median_s"] and stats["mean_s"] >= stats["min_s"]


def test_timer_accumulates_sections():
    timer = profiling.Timer()
    for _ in range(3):
        with timer("a"):
            time.sleep(0.001)
    with pytest.raises(ValueError), timer("b"):
        raise ValueError
    report = timer.report()
    assert report["a"]["count"] == 3 and report["b"]["count"] == 1
    assert report["a"]["total_s"] >= 0.003 and report["a"]["mean_s"] == pytest.approx(report["a"]["total_s"] / 3)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t"), device="cpu"):
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def _bound_ms(flops, n_bytes, seconds=1.0):
    return profiling.attach_roofline({"median_s": seconds}, flops=flops, bytes=n_bytes)


def test_roofline_reproduces_the_fused_rk4_bound():
    mm, other = benchmarks.fused_rk4_flops(1024, 1024, 32, 50, 20)
    assert mm == pytest.approx(1.6156e11, rel=1e-4) and other == pytest.approx(1.5464e10, rel=1e-4)
    row = profiling.attach_roofline({"ms_median": 11.82}, flops=mm + other, bytes=4 * 2 * 1024 * 96)
    assert row["bound_ms"] == pytest.approx(2.642, abs=5e-4) and row["bound_by"] == "operations"
    assert row["share_of_bound"] == pytest.approx(2.642 / 11.82, rel=1e-3)
    assert row["mfu_pct"] == pytest.approx(100 * 2.642 / 11.82, rel=1e-3)


def test_roofline_reproduces_the_gram_and_thomas_bounds():
    M = N = 1024
    D = 96
    gram = _bound_ms(2 * M * N * D + 2 * (M + N) * D, 4 * (M * D + N * D + M * N))
    assert gram["bound_ms"] * 1e3 == pytest.approx(3.011, abs=5e-4) and gram["bound_by"] == "operations"
    B, n = 16384, 32
    thomas = _bound_ms(8 * B * n, 5 * B * n * 4, seconds=4.956e-6)
    assert thomas["bound_ms"] * 1e3 == pytest.approx(3.13, abs=5e-3) and thomas["bound_by"] == "bytes"
    assert thomas["share_of_bound"] == pytest.approx(3.130 / 4.956, rel=1e-3)
    assert thomas["hbm_gbps"] == pytest.approx(5 * B * n * 4 / 4.956e-6 / 1e9)
    assert thomas["arithmetic_intensity"] == pytest.approx(8 / 20)


def test_roofline_columns_and_timed_roofline():
    row = profiling.timed_roofline(lambda: torch.ones(8).sum(), flops=1e6, bytes=1e3, iters=3, repeats=2)
    assert {"achieved_tflops", "mfu_pct", "hbm_gbps", "hbm_util_pct", "arithmetic_intensity", "bound_ms", "bound_by",
            "share_of_bound", "nvidia_smi", "repeat_median_s", "max_s"} <= set(row)
    assert len(row["repeat_median_s"]) == 2 and row["min_s"] <= row["median_s"] <= row["max_s"]
    bf16 = profiling.attach_roofline({"median_s": 1.0}, flops=989e12, bytes=0.0, peak_flops=profiling.PEAK_BF16_FLOPS)
    assert bf16["mfu_pct"] == pytest.approx(100.0) and bf16["bound_ms"] == pytest.approx(1e3)
