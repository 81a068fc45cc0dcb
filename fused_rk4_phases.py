#!/usr/bin/env python3
"""Where the fused RK4 kernels spend an RHS evaluation, by phase, on one card.

    python3 fused_rk4_phases.py [--steps 256] [--probes]

Builds ``csrc/fused_rk4.cu`` and ``csrc/fused_rk4_bf16.cu`` with
``-DFUSED_RK4_PHASE_CLOCKS`` (a separate build: thread 0 of CTA 0 sums the
``clock64()`` cycles between the phase boundaries of its stage loop), runs
each once at 1,024 columns x ``--steps`` RK4 steps with the trained flagship
MLPs (after a warm-up), and prints the cycles per RHS evaluation of each
phase, their sum against the launch's CUDA-event time, and the card's name,
power limit and SM clock. A phase that ends in a barrier includes the wait
for the slowest thread the barrier covers. The marks themselves cost a few
shared-memory accesses per phase, so the sum runs above the launch's time.

``--probes`` also builds and runs ``PROBES`` (one ``nvcc``): what the SM
sustains with 18 warps of 32 threads for warp FFMAs alone, and how many SM
cycles one warp-wide shared-memory access of each kind holds the SM's
shared-memory pipe (the kernels' designs count these).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

PHASES = {
    "fused_rk4": ("layer-1 partials", "nu", "CTA barrier", "reduce + mish (group)", "layer 2 (group)",
                  "layer 3 + mPP (group)", "RK4 update (group)", "CTA barrier"),
    "fused_rk4_bf16": ("layer-1 tiles + mish", "nu", "CTA barrier", "-", "layer 2 + mish (group)",
                       "layer 3 + mPP (group)", "RK4 update (group)", "CTA barrier"),
}


PROBES = r"""
#include <cstdio>
#include <cuda_runtime.h>
// 18 warps per SM (one CTA of 576 threads on each of 132 SMs); clock64 on thread 0 of CTA 0.
__global__ void __launch_bounds__(576, 1) ffma(float* out, long long* cyc) {
  float a[16];
  for (int j = 0; j < 16; ++j) a[j] = threadIdx.x * 0.001f + j;
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < 512; ++it)
#pragma unroll
    for (int j = 0; j < 16; ++j) a[j] = fmaf(a[j], 1.0001f, 0.5f);
  if (threadIdx.x == 0 && blockIdx.x == 0) cyc[0] = clock64() - t0;
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += a[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// 64 accesses per iteration, lane l at base + l * stride floats, width W floats; store if ST.
template <int W, bool ST>
__global__ void __launch_bounds__(576, 1) smem(float* out, long long* cyc, int stride) {
  __shared__ __align__(16) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = i * 1e-6f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc = 0.f;
  const long long t0 = clock64();
  for (int it = 0; it < 50; ++it) {
#pragma unroll 8
    for (int j = 0; j < 64; ++j) {
      float* p = sm + ((j * 37 + warp * 11) & 15) * 256 + lane * stride;
      if constexpr (ST) {
        if constexpr (W == 4) *reinterpret_cast<float4*>(p) = make_float4(acc, acc, acc, acc);
        else *p = acc;
        acc += 1.f;
      } else if constexpr (W == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);  // every component used: one 16-byte load
        acc += (v.x + v.y) + (v.z + v.w);
      } else {
        acc += *p;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == 0) cyc[0] = clock64() - t0;
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc + sm[threadIdx.x];
}
int main() {
  float* out; long long* cyc; long long h;
  cudaMalloc(&out, 132 * 576 * 4); cudaMalloc(&cyc, 8);
  ffma<<<132, 576>>>(out, cyc); ffma<<<132, 576>>>(out, cyc); cudaDeviceSynchronize();
  cudaMemcpy(&h, cyc, 8, cudaMemcpyDeviceToHost);
  printf("warp FFMAs per SM cycle, 18 warps of 16 independent chains: %.3f\n", 18.0 * 512 * 16 / h);
  const double n = 64.0 * 50 * 18;
  auto run = [&](const char* what, int stride, void (*k)(float*, long long*, int)) {
    k<<<132, 576>>>(out, cyc, stride); k<<<132, 576>>>(out, cyc, stride); cudaDeviceSynchronize();
    cudaMemcpy(&h, cyc, 8, cudaMemcpyDeviceToHost);
    printf("%s, lane stride %d floats: %.2f SM cycles per warp access (%s)\n", what, stride, h / n,
           cudaGetErrorString(cudaGetLastError()));
  };
  run("4-byte load", 1, smem<1, false>);
  run("16-byte load", 4, smem<4, false>);
  run("16-byte load", 0, smem<4, false>);
  run("16-byte load", 8, smem<4, false>);
  run("4-byte store", 1, smem<1, true>);
  run("16-byte store", 4, smem<4, true>);
  run("16-byte store", 16, smem<4, true>);
  return 0;
}
"""


def run_probes(nvcc: str, build_dir: Path) -> str:
    """Build and run PROBES; returns what they print."""
    build_dir.mkdir(parents=True, exist_ok=True)
    src, exe = build_dir / "smem_probes.cu", build_dir / "smem_probes"
    src.write_text(PROBES)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    return subprocess.run([str(exe)], check=True, capture_output=True, text=True, timeout=300).stdout


def main() -> int:
    import torch

    from climateparameterizations_jl_tpu_torch import benchmarks
    from climateparameterizations_jl_tpu_torch.ops import _cuda
    from climateparameterizations_jl_tpu_torch.ops.fused_rhs import make_fused_runner_mxu
    from climateparameterizations_jl_tpu_torch.train.checkpoint import load_flux_nns

    if not torch.cuda.is_available():
        print("fused_rk4_phases: needs a CUDA card", file=sys.stderr)
        return 2
    steps = int(sys.argv[sys.argv.index("--steps") + 1]) if "--steps" in sys.argv else 256
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    nns = load_flux_nns("runs/wm_flagship_fold", device=dev)
    model, nns, bcs, x0 = benchmarks.make_setup(32, 1024, seed=0, nns=nns, device=dev)
    result = {"device": smi, "steps": steps}
    for name, kernel, dtype in (("fused_rk4", _cuda.FUSED_RK4, "float32"),
                                ("fused_rk4_bf16", _cuda.FUSED_RK4_BF16, "bfloat16")):
        kernel.extra_flags = ("-DFUSED_RK4_PHASE_CLOCKS",)
        lib = kernel.load()
        read = getattr(lib, f"{name}_phase_clocks")
        read.argtypes = [ctypes.c_void_p]
        read.restype = ctypes.c_int
        run = make_fused_runner_mxu(model, nns, bcs, benchmarks.FORWARD_DT, steps, 1024, matmul_dtype=dtype,
                                    device=dev)
        run(x0)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(x0)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        clocks = (ctypes.c_ulonglong * 8)()
        if read(ctypes.addressof(clocks)) != 0:
            raise RuntimeError(f"{name}: reading the phase clocks failed")
        sm_mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        n_rhs = 4 * steps
        per_rhs = [c / n_rhs for c in clocks]
        total = sum(per_rhs)
        print(f"{name}: {ms:.3f} ms for 1024 x {steps} (CUDA events), {ms * 1e3 / n_rhs:.3f} us per RHS; "
              f"phase cycles per RHS (thread 0 of CTA 0) sum {total:.0f}; SM clock now {sm_mhz} MHz", flush=True)
        for label, c in zip(PHASES[name], per_rhs):
            if label != "-":
                print(f"  {label:24s} {c:8.1f} cycles  {c / total:6.1%}", flush=True)
        result[name] = {"ms": ms, "us_per_rhs": ms * 1e3 / n_rhs, "cycles_per_rhs": dict(zip(PHASES[name], per_rhs)),
                        "sm_mhz_after": sm_mhz}
    if "--probes" in sys.argv:
        text = run_probes(_cuda.find_nvcc(), _cuda.BUILD_DIR)
        print(text, end="", flush=True)
        result["probes"] = text.strip().splitlines()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
