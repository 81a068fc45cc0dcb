#!/usr/bin/env python3
"""Time a kernel of two trees in turns, on one card.

    python3 bench_turns.py --parent DIR [--mode forward|gram|thomas] [--pairs 8] [--out FILE]

``DIR`` holds another tree's ``climateparameterizations_jl_tpu_torch``
package (for example the parent commit, from ``git archive <commit>
climateparameterizations_jl_tpu_torch | tar -x -C DIR``); the other side is
the tree this script lies in. Each side runs in a worker process of its own
that imports its tree's package, builds its kernels and then answers
requests, one case at a time:

- ``forward`` (the default): ``benchmarks.bench_nde_forward`` (1,024
  columns x 1,024 RK4 steps, Nz = 32, the trained ``runs/wm_flagship_fold``
  MLPs; one warm-up, 5 timed calls, CUDA events) with f32 and then with bf16
  NN products; compared by the median ms.
- ``gram``: ``ops/gram.py::gram_cuda`` at 1,024 x 1,024 x 96 (standard
  normal rows from a ``torch.Generator`` seeded 0, gamma = sigma = alpha = 1
  as f32 tensors on the card), squared exponential and then matern12: the
  device time of the kernel ``gram_kernel`` alone, by its name in a
  ``torch.profiler`` trace of ``GRAM_CALLS`` calls (mean us per recorded
  launch), the other device ops of a call, and the wall us per call back to
  back (CUDA events); compared by the kernel's us.
- ``thomas``: the Thomas kernel ``csrc/thomas.cu`` through ``_cuda.THOMAS``
  on contiguous f32 ``(B, N)`` systems (``THOMAS_SHAPES``: 16,384 x 32 and
  9,216 x 32 of the training and gyre paths, 4,224 x 64 and 4,224 x 128 of
  the LES pressure solve; diagonally dominant, from a numpy generator seeded
  0, as ``benchmarks.bench_tridiagonal``): the kernel's device time by its
  name in a ``torch.profiler`` trace of ``THOMAS_CALLS`` calls (mean us per
  recorded launch), its us per launch in a CUDA graph of ``THOMAS_CALLS``
  launches, and the wall us per call back to back; compared by the
  kernel's us.

The workers run one at a time; the side that runs first alternates from pair
to pair. It prints the card's name and power limit, one JSON line per pair
and case, and a summary (the median of each side's numbers, and the pairs
the change won); ``--out FILE`` also writes them all to ``FILE`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
THOMAS_SHAPES = {"16384x32": (16384, 32), "9216x32": (9216, 32), "4224x64": (4224, 64), "4224x128": (4224, 128)}
CASES = {"forward": ("float32", "bfloat16"), "gram": ("squared_exponential", "matern12"),
         "thomas": tuple(THOMAS_SHAPES)}
METRIC = {"forward": "ms_median", "gram": "kernel_us", "thomas": "kernel_us"}
GRAM_SHAPE = (1024, 1024, 96)
GRAM_CALLS = 200
THOMAS_CALLS = 200


def forward_worker(tree: str):
    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_flux_nns

    import torch

    dev = torch.device("cuda", 0)
    nns = load_flux_nns(str(HERE / "runs" / "wm_flagship_fold"), device=dev)
    for k in (_cuda.FUSED_RK4, _cuda.FUSED_RK4_BF16):
        k.load()
        print(f"[{tree}] {k.source.name}:\n{k.ptxas_report}", file=sys.stderr, flush=True)

    def run(dtype: str) -> dict:
        r = benchmarks.bench_nde_forward(1024, 32, 1024, 5, nns=nns, device=dev, matmul_dtype=dtype)
        return {"ms_median": r["ms_median"], "ms": r["ms"]}

    return run


def gram_worker(tree: str):
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import gram

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    M, N, D = GRAM_SHAPE
    gen = torch.Generator().manual_seed(0)
    A = torch.randn(M, D, generator=gen).to(dev)
    B = torch.randn(N, D, generator=gen).to(dev)
    hyp = [torch.tensor(1.0, device=dev) for _ in range(3)]
    _cuda.GRAM.load()
    print(f"[{tree}] gram.cu:\n{_cuda.GRAM.ptxas_report}", file=sys.stderr, flush=True)

    def run(family: str) -> dict:
        call = lambda: gram.gram_cuda(A, B, *hyp, family=family)  # noqa: E731
        for _ in range(10):
            call()
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAM_CALLS):
            call()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(GRAM_CALLS):
                call()
            torch.cuda.synchronize(dev)
        on_dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        mine = [e for e in on_dev if "gram_kernel" in e.key]
        recorded = sum(e.count for e in mine)  # the trace misses a launch now and then
        if recorded == 0:
            raise RuntimeError(f"no gram_kernel launch in the profile: {[(e.key, e.count) for e in on_dev]}")
        others = [e for e in on_dev if "gram_kernel" not in e.key]
        return {"kernel_us": sum(e.self_device_time_total for e in mine) / recorded,
                "other_device_us": sum(e.self_device_time_total for e in others) / GRAM_CALLS,
                "other_ops": sum(e.count for e in others) / GRAM_CALLS,
                "wall_us": start.elapsed_time(end) * 1e3 / GRAM_CALLS}

    return run


def _profiled_kernel(call, name: str, calls: int, dev) -> dict:
    """``call`` timed three ways: the kernel ``name``'s mean device us per launch the profiler recorded over
    ``calls`` calls, the us per call in a CUDA graph of ``calls`` calls, and the wall us per call back to back."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        call()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    end.synchronize()
    wall_us = start.elapsed_time(end) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize(dev)
    mine = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and name in e.key]
    recorded = sum(e.count for e in mine)
    if recorded == 0:
        raise RuntimeError(f"no {name} launch in the profile")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    graph.replay()
    torch.cuda.synchronize(dev)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return {"kernel_us": sum(e.self_device_time_total for e in mine) / recorded, "recorded": recorded,
            "graph_us": start.elapsed_time(end) * 1e3 / calls, "wall_us": wall_us}


def thomas_worker(tree: str):
    from climateparameterizations_jl_tpu_torch.ops import _cuda

    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    _cuda.THOMAS.load()
    print(f"[{tree}] thomas.cu:\n{_cuda.THOMAS.ptxas_report}", file=sys.stderr, flush=True)
    systems = {}
    for case, (n_systems, n) in THOMAS_SHAPES.items():
        rng = np.random.default_rng(0)
        f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        systems[case] = (f(rng.normal(size=(n_systems, n)) * 0.1), f(1.0 + np.abs(rng.normal(size=(n_systems, n)))),
                         f(rng.normal(size=(n_systems, n)) * 0.1), f(rng.normal(size=(n_systems, n))))

    def run(case: str) -> dict:
        args = systems[case]
        return _profiled_kernel(lambda: _cuda.THOMAS(*args), "thomas_kernel", THOMAS_CALLS, dev)

    return run


def worker(tree: str, mode: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    run = {"forward": forward_worker, "gram": gram_worker, "thomas": thomas_worker}[mode](tree)
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        print(json.dumps(run(line.strip())), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory holding the other tree's package")
    ap.add_argument("--mode", choices=sorted(CASES), default="forward")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--out", help="also write the runs and the summary to this JSON file")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.mode)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("bench_turns: needs a CUDA card and --parent", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sides = {"parent": args.parent, "change": str(HERE)}
    metric = METRIC[args.mode]
    procs = {}
    for name, tree in sides.items():
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", tree, "--mode", args.mode]
        procs[name] = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        for name, p in procs.items():
            if json.loads(p.stdout.readline()).get("ready") is not True:
                raise RuntimeError(f"worker {name} did not start")
        runs = []
        names = list(sides)
        for i in range(args.pairs):
            order = names if i % 2 == 0 else names[::-1]
            for case in CASES[args.mode]:
                row = {"pair": i, "case": case, "order": order}
                for name in order:
                    procs[name].stdin.write(case + "\n")
                    procs[name].stdin.flush()
                    row[name] = json.loads(procs[name].stdout.readline())
                runs.append(row)
                print(json.dumps(row), flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)
    summary = {}
    for case in CASES[args.mode]:
        rows = [r for r in runs if r["case"] == case]
        summary[case] = {f"{name} {key}": statistics.median(r[name][key] for r in rows)
                         for name in sides for key in rows[0][name] if not isinstance(rows[0][name][key], list)}
        summary[case]["change_won_vs_parent"] = sum(r["change"][metric] < r["parent"][metric] for r in rows)
        summary[case]["pairs"] = len(rows)
    if args.out:
        out = {"device": smi, "mode": args.mode, "metric": metric, "sides": sides, "runs": runs,
               "summary": summary, "when": time.strftime("%Y-%m-%d %H:%M:%S")}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
