#!/usr/bin/env python3
"""Time the fused RK4 forward solve of two trees in turns, on one card.

    python3 bench_turns.py --parent DIR [--pairs 8] [--out FILE]

``DIR`` holds another tree's ``climateparameterizations_jl_tpu_torch``
package (for example the parent commit, from ``git archive <commit>
climateparameterizations_jl_tpu_torch | tar -x -C DIR``); the other side is
the tree this script lies in. Each side runs in a worker process of its own
that imports its tree's package, builds its kernels and then, on each
request, runs ``benchmarks.bench_nde_forward`` (1,024 columns x 1,024 RK4
steps, Nz = 32, the trained ``runs/wm_flagship_fold`` MLPs; one warm-up, 5
timed calls, CUDA events) with f32 and then with bf16 NN products. The
workers run one at a time; the side that runs first alternates from pair
to pair. It prints the card's name and power limit, one JSON line per
pair and a summary (the median of each side's medians, and the pairs the
change won); ``--out FILE`` also writes them all to ``FILE`` as JSON.
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
DTYPES = ("float32", "bfloat16")


def worker(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_flux_nns

    import torch

    dev = torch.device("cuda", 0)
    nns = load_flux_nns(str(HERE / "runs" / "wm_flagship_fold"), device=dev)
    for k in (_cuda.FUSED_RK4, _cuda.FUSED_RK4_BF16):
        k.load()
        print(f"[{tree}] {k.source.name}:\n{k.ptxas_report}", file=sys.stderr, flush=True)
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        dtype = line.strip()
        r = benchmarks.bench_nde_forward(1024, 32, 1024, 5, nns=nns, device=dev, matmul_dtype=dtype)
        print(json.dumps({"ms_median": r["ms_median"], "ms": r["ms"]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory holding the other tree's package")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--out", help="also write the runs and the summary to this JSON file")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("bench_turns: needs a CUDA card and --parent", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sides = {"parent": args.parent, "change": str(HERE)}
    procs = {}
    for name, tree in sides.items():
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", tree]
        procs[name] = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        for name, p in procs.items():
            if json.loads(p.stdout.readline()).get("ready") is not True:
                raise RuntimeError(f"worker {name} did not start")
        runs = []
        names = list(sides)
        for i in range(args.pairs):
            order = names if i % 2 == 0 else names[::-1]
            for dtype in DTYPES:
                row = {"pair": i, "dtype": dtype, "order": order}
                for name in order:
                    procs[name].stdin.write(dtype + "\n")
                    procs[name].stdin.flush()
                    row[name] = json.loads(procs[name].stdout.readline())["ms_median"]
                runs.append(row)
                print(json.dumps(row), flush=True)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)
    summary = {}
    for dtype in DTYPES:
        rows = [r for r in runs if r["dtype"] == dtype]
        summary[dtype] = {name: statistics.median(r[name] for r in rows) for name in sides}
        summary[dtype]["change_won_vs_parent"] = sum(r["change"] < r["parent"] for r in rows)
        summary[dtype]["pairs"] = len(rows)
    if args.out:
        out = {"device": smi, "sides": sides, "runs": runs,
               "summary": summary, "when": time.strftime("%Y-%m-%d %H:%M:%S")}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
