// Runs csrc/gram.cu on the CPU, block after block (see cuda_runtime.h here).
// Built by tests/test_torch_gram_host.py:
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -DCSRC_HOST_EMULATION
//       -I tests/cuda_host_emulation -I <csrc> tests/cuda_host_emulation/emulate_gram.cpp
#include "cuda_runtime.h"

#include "gram.cu"

// The kernel's `extern __shared__` array names a variable of the source's
// anonymous namespace; it is defined here, one buffer for the one block that
// runs at a time.
namespace {
__attribute__((aligned(16))) float smem[SMEM_FLOATS];

struct Launch {
  const float *A, *B, *gamma, *sigma, *alpha;
  float* K;
  int M, N, D, family;
  GramShape shape;
};

void run_block(void* v) {
  const Launch& l = *static_cast<const Launch*>(v);
  const int c = l.shape.vec_copy, s = l.shape.vec_store;
  switch (l.family) {
    case SQUARED_EXPONENTIAL: gram_kernel<SQUARED_EXPONENTIAL>(l.A, l.B, l.gamma, l.sigma, l.alpha, l.K, l.M, l.N, l.D, c, s); break;
    case MATERN12: gram_kernel<MATERN12>(l.A, l.B, l.gamma, l.sigma, l.alpha, l.K, l.M, l.N, l.D, c, s); break;
    case MATERN32: gram_kernel<MATERN32>(l.A, l.B, l.gamma, l.sigma, l.alpha, l.K, l.M, l.N, l.D, c, s); break;
    case MATERN52: gram_kernel<MATERN52>(l.A, l.B, l.gamma, l.sigma, l.alpha, l.K, l.M, l.N, l.D, c, s); break;
    default: gram_kernel<RATIONAL_QUADRATIC>(l.A, l.B, l.gamma, l.sigma, l.alpha, l.K, l.M, l.N, l.D, c, s); break;
  }
}

}  // namespace

extern "C" {

// Runs a launch of `grid` CTAs (all tiles when `grid` is 0 or more than the
// tiles) with the copy and store widths gram_launch would pick for these
// pointers. Writes {grid, vec_copy, vec_store} to `used`; returns 0, or -1
// for an unknown family.
int emulate_gram(const float* A, const float* B, const float* gamma, const float* sigma, const float* alpha, float* K,
                 int M, int N, int D, int family, int grid, int* used) {
  if (family < 0 || family > RATIONAL_QUADRATIC) return -1;
  Launch l{A, B, gamma, sigma, alpha, K, M, N, D, family, gram_shape(A, B, K, M, N, D)};
  if (grid <= 0 || grid > l.shape.tiles) grid = (int)l.shape.tiles;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) host_emulation_run_block(THREADS, b, run_block, &l);
  used[0] = grid;
  used[1] = l.shape.vec_copy;
  used[2] = l.shape.vec_store;
  return 0;
}

}  // extern "C"
