// Runs csrc/thomas.cu on the CPU, block after block (see cuda_runtime.h here).
// Built by tests/test_torch_thomas_host.py:
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread -DCSRC_HOST_EMULATION
//       -I tests/cuda_host_emulation -I <csrc> tests/cuda_host_emulation/emulate_thomas.cpp
#include "cuda_runtime.h"

#include "thomas.cu"

// The kernel's `extern __shared__` array names a variable of the source's
// anonymous namespace; it is defined here, one buffer for the one block that
// runs at a time, sized for N = MAX_N in the float4 layout (the larger one).
namespace {
__attribute__((aligned(16))) float smem[4 * SYSTEMS_PER_BLOCK * 4 * ((MAX_N / 4) | 1)];

struct Launch {
  const float *dl, *d, *du, *b;
  float* x;
  long long n_systems;
  int n;
  bool vec;
};

void run_block(void* v) {
  const Launch& l = *static_cast<const Launch*>(v);
  if (l.vec) {
    thomas_kernel<true>(l.dl, l.d, l.du, l.b, l.x, l.n_systems, l.n);
  } else {
    thomas_kernel<false>(l.dl, l.d, l.du, l.b, l.x, l.n_systems, l.n);
  }
}

}  // namespace

extern "C" {

// Solves `n_systems` systems of N = `n` levels with the layout thomas_launch
// would pick for these pointers; writes it to `vec_used` (1: float4). Returns
// 0, or -1 for N outside 1..MAX_N.
int emulate_thomas(const float* dl, const float* d, const float* du, const float* b, float* x, long long n_systems,
                   int n, int* vec_used) {
  if (n < 1 || n > MAX_N || n_systems < 1) return -1;
  const bool vec = n % 4 == 0 && ((unsigned long long)dl | (unsigned long long)d | (unsigned long long)du |
                                  (unsigned long long)b | (unsigned long long)x) % 16 == 0;
  Launch l{dl, d, du, b, x, n_systems, n, vec};
  const long long blocks = (n_systems + SYSTEMS_PER_BLOCK - 1) / SYSTEMS_PER_BLOCK;
  gridDim.x = (unsigned)blocks;
  for (long long blk = 0; blk < blocks; ++blk) host_emulation_run_block(THREADS_PER_BLOCK, (int)blk, run_block, &l);
  *vec_used = vec;
  return 0;
}

}  // extern "C"
