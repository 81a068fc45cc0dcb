#!/usr/bin/env python3
"""Where the Gram kernel's time goes on one card: its own device time against D.

    python3 gram_phases.py [--out FILE]

Times ``csrc/gram.cu`` (``gram_kernel`` by its name in a ``torch.profiler``
trace, 200 launches through ``ops/gram.py::gram_cuda``) at M = N = 1,024,
squared exponential and matern12, for D = 4, 32, 64, 96, 192 and 384
(standard-normal rows from a ``torch.Generator`` seeded 0; gamma = sigma =
alpha = 1 as f32 tensors on the card). The kernel stages 32 features per
chunk, so a least-squares line through D >= 32 splits the time into a cost
per chunk (the product and its staging) and a fixed cost per launch (the
launch, the first chunk's copies, the epilogue and the stores). Beside it, as
yardsticks of the launch and of writing K, the device time of
``Tensor.fill_`` on 4 bytes and on the 4 MB of a 1,024 x 1,024 f32 K. Prints
the card's name and power limit and one JSON object; ``--out FILE`` also
writes it to ``FILE``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

DS = (4, 32, 64, 96, 192, 384)
M = N = 1024
CALLS = 200
FAMILIES = ("squared_exponential", "matern12")


def device_us(fn, key: str, calls: int = CALLS) -> float:
    """Mean device time (us) of the kernels named like ``key`` per call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and key in e.key]
    count = sum(e.count for e in events)
    if count == 0:
        raise RuntimeError(f"no device op named like {key!r} in the profile")
    return sum(e.self_device_time_total for e in events) / count


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gram_phases: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops import gram

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    hyp = [torch.tensor(1.0, device=dev) for _ in range(3)]
    gen = torch.Generator().manual_seed(0)
    times = {fam: {} for fam in FAMILIES}
    for D in DS:
        A = torch.randn(M, D, generator=gen).to(dev)
        B = torch.randn(N, D, generator=gen).to(dev)
        for fam in FAMILIES:
            times[fam][D] = device_us(lambda: gram.gram_cuda(A, B, *hyp, family=fam), "gram_kernel")
    fits = {}
    for fam in FAMILIES:
        xs = [-(-D // 32) for D in DS if D >= 32]
        ys = [times[fam][D] for D in DS if D >= 32]
        n, sx, sy = len(xs), sum(xs), sum(ys)
        slope = (n * sum(x * y for x, y in zip(xs, ys)) - sx * sy) / (n * sum(x * x for x in xs) - sx * sx)
        fits[fam] = {"us_per_chunk": slope, "us_fixed": (sy - slope * sx) / n}
    small, big = torch.empty(1, device=dev), torch.empty(M, N, device=dev)
    out = {
        "device": smi,
        "shape": {"M": M, "N": N, "D": list(DS)},
        "grid": _cuda.GRAM.grid(M, N, dev),
        "kernel_us": {fam: {str(D): t for D, t in ts.items()} for fam, ts in times.items()},
        "fit_over_chunks": fits,
        "fill_4_bytes_us": device_us(lambda: small.fill_(1.0), "Fill"),
        "fill_4_MB_us": device_us(lambda: big.fill_(1.0), "Fill"),
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
