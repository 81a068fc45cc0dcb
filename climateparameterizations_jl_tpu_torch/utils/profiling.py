"""Timing, roofline and profiler helpers: the port's observability layer.

Port of the JAX package's ``utils/profiling.py`` in PyTorch's idiom:
:func:`time_fn` synchronizes the card where JAX blocks on its result,
:func:`trace` records a ``torch.profiler`` Chrome trace, and the roofline
columns of :func:`attach_roofline` take the work the caller counted (FLOPs
and the bytes each input read once and each output written once) against
the H100 SXM's published peaks. XLA's cost model, which the JAX package
reads (``xla_cost`` and the trip-count probe), has no PyTorch counterpart,
so nothing here estimates the work.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import statistics
import subprocess
import time

import torch

# NVIDIA H100 SXM (700 W) data sheet: f32 on the CUDA cores, dense bf16 on the
# tensor cores, HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _synchronize():
    """Wait for the card's queued work, where this process has used a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 10, warmup: int = 2, pipelined: bool = False, **kwargs) -> dict:
    """Wall-clock ``fn(*args, **kwargs)``: the first call, then per-iteration stats.

    The first call is timed alone as ``compile_s`` (kernel builds and
    first-use work happen there); then ``warmup`` untimed calls and
    ``iters`` timed ones, each followed by a synchronization of the card
    (``median_s``, ``min_s``, ``mean_s``). ``pipelined=True`` issues the
    ``iters`` calls back to back and synchronizes once, reporting
    total / iters as every stat: the steady-state rate of a loop that does
    not wait on each call.
    """
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _synchronize()
    compile_s = time.perf_counter() - t0

    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()

    if pipelined:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        _synchronize()
        per_iter = (time.perf_counter() - t0) / iters
        return {"compile_s": compile_s, "median_s": per_iter, "min_s": per_iter, "mean_s": per_iter,
                "iters": iters, "pipelined": True}

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    return {"compile_s": compile_s, "median_s": times[n // 2], "min_s": times[0], "mean_s": sum(times) / n,
            "iters": n}


def nvidia_smi() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them.

    ``None`` where ``nvidia-smi`` is not installed (a host without a card).
    """
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def attach_roofline(stats: dict, *, flops: float, bytes: float, peak_flops: float = PEAK_F32_FLOPS,
                    peak_bytes: float = PEAK_HBM_BYTES, seconds: float | None = None) -> dict:
    """Add roofline columns for counted work to a stats dict, in place.

    ``flops`` and ``bytes`` are the work of one timed call, counted by the
    caller; ``seconds`` its time, by default the stats' ``median_s`` (else
    ``ms_median`` / 1e3). Adds the JAX package's columns
    ``achieved_tflops``, ``mfu_pct`` (against ``peak_flops``),
    ``hbm_gbps``, ``hbm_util_pct`` (against ``peak_bytes``) and
    ``arithmetic_intensity``, and ``bound_ms``: the larger of the two
    times the work needs at the peaks, ``bound_by`` which one, and
    ``share_of_bound``. ``nvidia_smi`` is the card's name and power limit.
    """
    if seconds is None:
        seconds = stats["median_s"] if "median_s" in stats else stats["ms_median"] * 1e-3
    t_ops, t_bytes = flops / peak_flops, bytes / peak_bytes
    stats.update({
        "flops": float(flops), "bytes": float(bytes), "peak_flops": peak_flops, "peak_bytes_per_s": peak_bytes,
        "achieved_tflops": flops / seconds / 1e12,
        "mfu_pct": 100.0 * flops / seconds / peak_flops,
        "hbm_gbps": bytes / seconds / 1e9,
        "hbm_util_pct": 100.0 * bytes / seconds / peak_bytes,
        "arithmetic_intensity": flops / max(bytes, 1.0),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "share_of_bound": max(t_ops, t_bytes) / seconds,
        "nvidia_smi": nvidia_smi(),
    })
    return stats


def timed_roofline(fn, *args, flops: float, bytes: float, iters: int = 5, pipelined: bool = True, repeats: int = 1,
                   peak_flops: float = PEAK_F32_FLOPS) -> dict:
    """:func:`time_fn` and :func:`attach_roofline` in one call.

    ``repeats > 1`` times the block of ``iters`` calls that many times and
    reports the per-repeat medians in ``repeat_median_s``, with
    ``median_s`` / ``min_s`` / ``max_s`` taken across them.
    """
    stats = time_fn(fn, *args, iters=iters, pipelined=pipelined)
    if repeats > 1:
        vals = [stats["median_s"]]
        for _ in range(repeats - 1):
            vals.append(time_fn(fn, *args, iters=iters, warmup=0, pipelined=pipelined)["median_s"])
        stats["repeat_median_s"] = vals
        stats["median_s"] = float(statistics.median(vals))
        stats["min_s"] = float(min(vals))
        stats["max_s"] = float(max(vals))
    return attach_roofline(stats, flops=flops, bytes=bytes, peak_flops=peak_flops)


class Timer:
    """Accumulating named-section wall timer for training loops.

    >>> timer = Timer()
    >>> with timer("data"):
    ...     batch = next(it)
    >>> timer.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            name: {"total_s": total, "count": self.counts[name], "mean_s": total / self.counts[name]}
            for name, total in self.totals.items()
        }


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """``torch.profiler`` over the block, written to ``log_dir/trace.json`` (Chrome trace format).

    Records the host, and the card where ``device`` is a CUDA device (by
    default, where a card is present). Open the file in Perfetto or
    ``chrome://tracing``.
    """
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda" if device is not None else torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
