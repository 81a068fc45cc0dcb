"""Forward-throughput sweep on the port: plain RK4 loops against the fused RK4 kernels at large batch.

Port of ``studies/fused_kernel_sweep.py``. The JAX script sweeps XLA scans
and Pallas kernels across column blocks; the port maps its routes one to one
onto its own, and sweeps the CUDA launch shapes where the JAX script swept
Pallas column blocks (the port's runners ignore ``column_block``):

1. "xla packed unroll=u" -> a plain RK4 loop over the packed-MLP RHS
   (``models/wind_mixing.py::wind_mixing_rhs``);
2. "xla fast-rhs" and "fold-divergence" -> the same loop over
   ``ops/fused_rhs.py::make_fast_rhs`` (without or with the divergence
   folded into the last layer);
3. "pallas v1 cb=" -> ``make_fused_runner``, the f32 kernel ``csrc/fused_rk4.cu``
   behind the v1 entry point;
4. "pallas mxu cb= dtype" -> ``make_fused_runner_mxu`` in f32 (``fused_rk4.cu``,
   its one launch shape) and bf16 (``csrc/fused_rk4_bf16.cu`` at each launch
   shape of ``FusedRK4Bf16Kernel.shapes()``); "loop_unroll=4" is accepted by
   the runner and changes nothing;
5. the "single-step x scan" hybrid -> a Python loop of one-step launches.

Each distinct computation is timed once. A JAX configuration whose knob
changes nothing on the port is an alias of the route that computes it: the
scan unroll of the plain loops (an eager loop has no scan; ``unroll=4`` and
``8`` are aliases of ``unroll=1``), and the v1 entry point and
``loop_unroll=4``, which launch the f32 kernel with the MXU route's operands
(aliases of the f32 MXU route). An alias's row carries ``alias_of`` and its
route's numbers; every other row has ``alias_of`` null. Each route is timed
as the JAX script times it (``utils/profiling.py::time_fn``: five calls back
to back after the first and two warm-ups, one synchronization), and each
row carries its final state's largest distance from the f32 kernel's
(``max_abs_vs_f32_kernel``). On the card every CUDA route launches its
kernel; with ``--device cpu`` the kernels' plain versions run in their
place. Rows are appended to ``--out`` (by default ``fused_sweep_port.jsonl``
at the repository root, never the JAX script's results file). A
configuration that runs out of card memory is reported and skipped; any
other failure ends the run.

    python -m climateparameterizations_jl_tpu_torch.studies.fused_kernel_sweep
    python -m climateparameterizations_jl_tpu_torch.studies.fused_kernel_sweep --device cpu --quick --out /tmp/s.jsonl
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from climateparameterizations_jl_tpu_torch import benchmarks
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.utils.profiling import time_fn

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "fused_sweep_port.jsonl"
UNROLLS = (1, 4, 8)


def _shape_label(kernel) -> str:
    return "plain" if kernel is None else f"{kernel[0]}x{kernel[1]}"


def routes(model, nns, bcs, dt: float, n_steps: int, n_columns: int, device) -> list:
    """``[(config name, run(x0) -> final state, kernel name or None, alias_of)]`` of every route, in the JAX
    script's order; an alias has ``run`` None and names the route that computes it.

    The CUDA routes' names carry the kernel and its launch shape (columns x
    warps per CTA); on the CPU the shape reads ``plain``: the kernel's plain
    version runs there.
    """
    from climateparameterizations_jl_tpu_torch.models.wind_mixing import pack_flux_nns, wind_mixing_rhs
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops.fused_rhs import make_fused_runner_mxu

    def route(n, variant="packed"):
        return benchmarks.nde_forward_route(model, nns, bcs, n, n_columns, variant, dt=dt, device=device)[0]

    on_card = device.type == "cuda"
    out = []
    packed = pack_flux_nns(nns)
    for label, run in (("packed", benchmarks.rk4_loop(lambda x, t: wind_mixing_rhs(model, packed, bcs, x, t),
                                                      n_steps, dt)),
                       ("fast-rhs (mxu twin)", route(n_steps, "fast")),
                       ("fast-rhs fold-divergence", route(n_steps, "fold"))):
        first = f"plain rk4 {label} unroll={UNROLLS[0]}"
        out.append((first, run, None, None))
        out += [(f"plain rk4 {label} unroll={u}", None, None, first) for u in UNROLLS[1:]]

    f32_shape = None
    if on_card:
        lib = _cuda.FUSED_RK4.load()
        f32_shape = (lib.fused_rk4_columns_per_block(), lib.fused_rk4_threads_per_block() // 32)
    f32 = _shape_label(f32_shape)
    mxu = f"cuda mxu fused_rk4 {f32} float32"
    out.append((f"cuda v1 fused_rk4 {f32}", None, "fused_rk4", mxu))
    out.append((mxu, route(n_steps), "fused_rk4", None))
    bf16 = make_fused_runner_mxu(model, nns, bcs, dt, n_steps, n_columns, matmul_dtype="bfloat16", device=device)
    if on_card:
        for i, shape in enumerate(_cuda.FUSED_RK4_BF16.shapes()):
            def launch(x0, i=i):
                return _cuda.FUSED_RK4_BF16(x0.contiguous(), bf16.kernel_weights, bf16.kernel_frags,
                                            bf16.kernel_params, shape=i)

            out.append((f"cuda mxu fused_rk4_bf16 {_shape_label(shape)} bfloat16", launch, "fused_rk4_bf16", None))
    else:
        out.append(("cuda mxu fused_rk4_bf16 plain bfloat16", bf16, "fused_rk4_bf16", None))
    out.append((f"{mxu} loop_unroll=4", None, "fused_rk4", mxu))
    step1 = route(1)

    def hybrid(x):
        for _ in range(n_steps):
            x = step1(x)
        return x

    out.append((f"cuda mxu fused_rk4 {f32} single-step x loop", hybrid, "fused_rk4", None))
    return out


def sweep(n_columns: int, n_steps: int, device, out_path=None, iters: int = 5, warmup: int = 2, nns=None,
          states: dict | None = None) -> list:
    """Time every route on the flagship setup (``benchmarks.make_setup``, Nz = 32, dt = 1e-5; its random MLPs
    unless ``nns`` is given); returns the rows. ``states``, where given, receives each timed route's final state
    by name."""
    model, nns, bcs, x0 = benchmarks.make_setup(32, n_columns, nns=nns, device=device)
    every = routes(model, nns, bcs, benchmarks.FORWARD_DT, n_steps, n_columns, device)
    measured = {}
    for name, run, _, alias_of in every:
        if alias_of is not None:
            continue
        try:
            state = run(x0)
            stats = time_fn(run, x0, iters=iters, warmup=warmup, pipelined=True)
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            print(f"{name}: FAILED {type(e).__name__}: {str(e)[:120]}", flush=True)
            continue
        measured[name] = (stats["median_s"], state)
        print(f"{name:52s} {n_columns * n_steps / stats['median_s']:12.3e} col-ts/s  "
              f"({stats['median_s'] * 1e3:8.2f} ms)", flush=True)
    rows = [{"config": name, "n_columns": n_columns, "n_steps": n_steps, "platform": device.type, "kernel": kernel,
             "alias_of": alias_of} for name, _, kernel, alias_of in every if (alias_of or name) in measured]
    for row in rows:
        if row["alias_of"] is not None:
            print(f"{row['config']:52s} = {row['alias_of']}", flush=True)
    reference = next(state for name, (_, state) in measured.items()
                     if name.startswith("cuda mxu fused_rk4 ") and name.endswith(" float32"))
    for row in rows:
        median_s, state = measured[row["alias_of"] or row["config"]]
        row.update(median_s=median_s, col_ts_per_sec=n_columns * n_steps / median_s,
                   max_abs_vs_f32_kernel=float((state - reference).abs().max()))
        if states is not None and row["alias_of"] is None:
            states[row["config"]] = state
        if out_path:
            with open(out_path, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n-columns", type=int, default=16384)
    p.add_argument("--n-steps", type=int, default=512)
    p.add_argument("--out", default=str(DEFAULT_OUT), help="append one JSON line per configuration here")
    p.add_argument("--quick", action="store_true", help="tiny shapes for a smoke run")
    p.add_argument("--platform", default=None, help="the JAX script's platform flag: accepted, recorded, unused "
                                                    "(--device picks the device)")
    p.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    if args.quick:
        args.n_columns, args.n_steps = 256, 16
    device = resolve_device(args.device)
    rows = sweep(args.n_columns, args.n_steps, device, args.out)
    best = max((r for r in rows if r["alias_of"] is None), key=lambda r: r["col_ts_per_sec"])
    print("\nbest:", json.dumps(best))
    return rows


if __name__ == "__main__":
    main()
