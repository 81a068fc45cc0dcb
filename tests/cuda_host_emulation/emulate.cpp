// Runs one fused RK4 kernel of csrc/ on the CPU, block after block (see
// cuda_runtime.h here). Built by tests/test_torch_fused_rk4_host.py:
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -DCSRC_HOST_EMULATION -DEMULATE_BF16=0|1
//       -I tests/cuda_host_emulation -I <csrc> tests/cuda_host_emulation/emulate.cpp
#include "cuda_runtime.h"

// A kernel's `extern __shared__` array names a variable of the source's anonymous
// namespace; it is defined here, one buffer for the one block that runs at a time.
#if EMULATE_BF16
#include "cuda_bf16.h"
#include "fused_rk4_bf16.cu"
namespace {
__attribute__((aligned(16))) unsigned char smem[1 << 18];
#else
#include "fused_rk4.cu"
namespace {
__attribute__((aligned(16))) float smem[1 << 16];
#endif

struct Launch {
  const float* x0;
  float* out;
  const float* weights;
  const void* frags;
  FusedRK4Params p;
  int shape;
};

template <class Kernel>
void run_grid(const Launch& a, int columns_per_block, int threads, Kernel kernel) {
  struct Arg {
    const Launch* a;
    Kernel* k;
  } arg{&a, &kernel};
  const int grid = (a.p.n_columns + columns_per_block - 1) / columns_per_block;
  for (int b = 0; b < grid; ++b) {
    host_emulation_run_block(threads, b, [](void* v) { (*static_cast<Arg*>(v)->k)(*static_cast<Arg*>(v)->a); },
                             &arg);
  }
}

}  // namespace

extern "C" {

// Returns the shared memory the launch would ask for, in bytes, or -1 when it is
// larger than the emulation's buffer (nothing runs then).
int emulate_launch(const float* x0, float* out, const float* weights, const void* frags, FusedRK4Params p,
                   int shape) {
  const Launch a{x0, out, weights, frags, p, shape};
  if (p.n_columns <= 0) return 0;
#if EMULATE_BF16
  const int bytes = fused_rk4_bf16_smem_bytes(p.Nz, p.h1, p.h2, shape);
  if (bytes > (int)sizeof(smem)) return -1;
  const uint4* f = static_cast<const uint4*>(frags);
  auto run = [&](auto tc, auto warps) {
    constexpr int TCv = decltype(tc)::value, Wv = decltype(warps)::value;
    if (is_flagship(a.p.Nz, a.p.h1, a.p.h2))
      run_grid(a, TCv, Wv * 32, [f](const Launch& l) {
        fused_rk4_bf16_kernel<TCv, Wv, 32, 50, 20>(l.x0, l.out, l.weights, f, l.p);
      });
    else
      run_grid(a, TCv, Wv * 32, [f](const Launch& l) {
        fused_rk4_bf16_kernel<TCv, Wv, 0, 0, 0>(l.x0, l.out, l.weights, f, l.p);
      });
  };
  switch (shape) {
    case 0: run(std::integral_constant<int, SHAPE_COLUMNS[0]>{}, std::integral_constant<int, SHAPE_WARPS[0]>{}); break;
    case 1: run(std::integral_constant<int, SHAPE_COLUMNS[1]>{}, std::integral_constant<int, SHAPE_WARPS[1]>{}); break;
    case 2: run(std::integral_constant<int, SHAPE_COLUMNS[2]>{}, std::integral_constant<int, SHAPE_WARPS[2]>{}); break;
    default: return -2;
  }
#else
  if (shape != 0) return -2;  // one launch shape
  const int bytes = fused_rk4_smem_bytes(p.Nz, p.h1, p.h2);
  if (bytes > (int)sizeof(smem)) return -1;
  if (is_flagship(p.Nz, p.h1, p.h2))
    run_grid(a, Shape::TC, Shape::THREADS, [](const Launch& l) { fused_rk4_kernel<32, 50, 20>(l.x0, l.out, l.weights, l.p); });
  else
    run_grid(a, Shape::TC, Shape::THREADS, [](const Launch& l) { fused_rk4_kernel<0, 0, 0>(l.x0, l.out, l.weights, l.p); });
#endif
  return bytes;
}

// The kernels' activation (fused_rk4_common.cuh::mish) on n values.
void emulate_mish(const float* x, float* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = mish(x[i]);
}

}  // extern "C"
