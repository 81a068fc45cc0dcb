"""Forward-throughput scaling sweep on the port: column batches through the fused RK4 kernel.

Port of ``studies/forward_scaling.py``. It measures the headline
wind-mixing forward path (``benchmarks.bench_nde_forward``: the flagship
configuration, 1,024 RK4 steps, Nz = 32) across column batches, to find
where the launch-bound regime hands over to the compute-bound one and how
far one card scales.

- ``--rhs-variant packed``: the fused runner, i.e. the f32 kernel
  ``csrc/fused_rk4.cu``, one launch per run (per column chunk with
  ``--chunk-columns``: columns are independent, so the chunks' result equals
  one launch bit for bit);
- ``fast`` / ``fold``: a plain RK4 loop over ``ops/fused_rhs.py::make_fast_rhs``
  (the divergence as a matmul, or folded into the last layer), the
  counterpart of the JAX package's XLA scan over the same twin.

``--unrolls`` (the JAX scan unroll) is accepted and recorded: neither the
kernel nor the eager loop has a scan to unroll. Each configuration is one
measurement (CUDA events, one warm-up and ``--repeats`` timed runs, 5); ``mfu_pct`` and
``achieved_tflops`` count ``benchmarks.fused_rk4_flops`` against the card's
f32 peak (``utils/profiling.py::attach_roofline``). With ``--device cpu`` the
same routes run on the CPU (the kernel's plain version), timed on the host
clock (one warm-up and ``--repeats`` runs). A configuration that runs out of card memory is recorded as an error
row; any other failure ends the run.

    python -m climateparameterizations_jl_tpu_torch.studies.forward_scaling --out scaling.jsonl
    python -m climateparameterizations_jl_tpu_torch.studies.forward_scaling --rhs-variant fold
    python -m climateparameterizations_jl_tpu_torch.studies.forward_scaling --device cpu --columns 64 --n-steps 8
"""

from __future__ import annotations

import argparse
import json

import torch

from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.utils.profiling import attach_roofline, nvidia_smi

REPEATS = 5


def effective_chunk(n_columns: int, chunk_columns: int | None) -> int | None:
    """The chunk actually used: only one that divides ``n_columns`` and splits it (the JAX script's rule)."""
    if chunk_columns and n_columns > chunk_columns and n_columns % chunk_columns == 0:
        return chunk_columns
    return None


def measure(n_columns: int, n_steps: int, unroll: int, chunk: int | None, rhs_variant: str, device,
            repeats: int = REPEATS) -> dict:
    """One configuration's stats (``benchmarks.nde_forward_stats``: ``bench_nde_forward``'s measurement, on the
    host clock off the card) with the roofline columns."""
    stats = benchmarks.nde_forward_stats(n_columns, 32, n_steps, repeats, None, 0, device, unroll=unroll,
                                         chunk_columns=chunk, rhs_variant=rhs_variant)
    return attach_roofline(stats, flops=stats["matmul_flops"] + stats["other_flops"], bytes=stats["bytes"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--columns", default="1024,4096,16384,32768,65536,131072")
    ap.add_argument("--unrolls", default="4", help="the JAX scan unroll: accepted and recorded, changes nothing")
    ap.add_argument("--n-steps", type=int, default=1024)
    ap.add_argument("--chunk-columns", type=int, default=None,
                    help="one kernel launch per column chunk (used only where it divides the batch and splits it)")
    ap.add_argument("--rhs-variant", default="packed", choices=list(benchmarks.FORWARD_VARIANTS),
                    help="packed = the fused f32 kernel (the headline path); fast = a plain RK4 loop over the "
                         "matmul-assembly twin; fold = fast with the divergence matmul precomposed away")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' runs on the CPU)")
    ap.add_argument("--repeats", type=int, default=REPEATS, help="timed runs per configuration, after one warm-up")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = nvidia_smi() if device.type == "cuda" else None
    if card:
        print(card, flush=True)

    rows = []
    for unroll in (int(u) for u in args.unrolls.split(",")):
        for n in (int(c) for c in args.columns.split(",")):
            chunk = effective_chunk(n, args.chunk_columns)
            try:
                stats = measure(n, args.n_steps, unroll, chunk, args.rhs_variant, device, args.repeats)
            except torch.cuda.OutOfMemoryError as e:  # one huge configuration must not eat the sweep
                torch.cuda.empty_cache()
                print(json.dumps({"n_columns": n, "unroll": unroll, "chunk_columns": chunk,
                                  "error": f"{type(e).__name__}: {e}"}), flush=True)
                continue
            row = {
                "n_columns": n,
                "unroll": unroll,
                "n_steps": args.n_steps,
                "chunk_columns": chunk,
                "rhs_variant": args.rhs_variant,
                "median_s": stats["median_s"],
                "col_ts_per_s": stats["column_timesteps_per_sec"],
                "mfu_pct": stats.get("mfu_pct"),
                "achieved_tflops": stats.get("achieved_tflops"),
                "launches": stats.get("launches", 0),
                "device": str(device),
                "card": card,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")

    if rows:
        best = max(rows, key=lambda r: r["col_ts_per_s"])
        print(f"best: {best['col_ts_per_s']:.3e} col-ts/s at {best['n_columns']} cols, unroll={best['unroll']}")
    return rows


if __name__ == "__main__":
    main()
