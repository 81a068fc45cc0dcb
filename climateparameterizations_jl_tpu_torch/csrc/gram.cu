// Fused GP Gram matrix: K[i, j] = k(||A_i - B_j||) for one stationary kernel family.
//
// Replaces the Pallas TPU kernel of climateparameterizations_jl_tpu/ops/gram.py:
// gram_pallas (pallas_call at :125, body _gram_kernel :65, epilogue
// _epilogue :45). Inputs are A (M, D) and B (N, D) as contiguous f32 rows
// and the three hyperparameters (gamma, sigma, alpha) as a 3-float device
// array; the output is K (M, N) f32. The wrapper (ops/_cuda.py) casts to
// f32, checks shapes and refuses D > 4096 as the TPU wrapper does.
//
// What bounds it on an H100: operations. The product A B^T takes 2 M N D
// flops on the CUDA cores (f32 FMAs, no TF32), against 4 (M D + N D + M N)
// bytes: at 1,024 x 1,024 x 96 that is 2.01e8 flop = 3.0 us at 67 TFLOP/s,
// above the 4.98 MB / 3.35 TB/s = 1.49 us of traffic.
//
// Design (simple first):
//   - One CTA of 256 threads per 64 x 64 output tile, each thread holding a
//     4 x 4 block of accumulators at rows ty + 16 i and columns tx + 16 j,
//     so that a half-warp writes 16 neighbouring outputs of one row.
//   - The feature axis is walked in chunks of 16, staged transposed through
//     shared memory (rows padded by one float). Both operands of a chunk
//     are read from device memory once per tile.
//   - The row norms |a|^2 and |b|^2 are summed by 128 of the threads from
//     the same staged chunks: no second pass over A or B.
//   - d2 = max(aa + bb - 2 ab, 0) and the family's epilogue run in
//     registers; the distance matrix never reaches device memory, and each
//     finished tile is written once.
//   - The family is a template parameter (one instantiation each, chosen by
//     a switch on the host). gamma, sigma and alpha are read from device
//     memory, not passed by value: during ML-II they are tensors on the
//     card with autograd history, and reading them on the host would
//     synchronise every call. One build serves every hyperparameter point.
//   - Ragged M, N and D are masked (zero features add nothing to the dot
//     product or the norms), not padded by copies.
//   - IEEE division, expf/logf/sqrtf without fast math, as the plain
//     version computes them.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int SUB = 16;  // threads along each tile edge; TILE / SUB = 4 outputs each

static_assert(TILE == 4 * SUB && THREADS == SUB * SUB, "4 x 4 outputs per thread");
static_assert(2 * TILE <= THREADS, "one thread per row norm");

enum Family { SQUARED_EXPONENTIAL = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3, RATIONAL_QUADRATIC = 4 };

// The TPU kernel's _epilogue, operation for operation (left to right, as
// Python evaluates it).
template <int FAMILY>
__device__ __forceinline__ float epilogue(float d2, float gamma, float sigma, float alpha) {
  if (FAMILY == SQUARED_EXPONENTIAL) return sigma * expf(-d2 / (2.0f * gamma * gamma));
  const float d = sqrtf(d2);
  if (FAMILY == MATERN12) return sigma * expf(-d / gamma);
  if (FAMILY == MATERN32) {
    const float c = 1.7320508075688772f * d / gamma;
    return sigma * (1.0f + c) * expf(-c);
  }
  if (FAMILY == MATERN52) {
    const float c = 2.23606797749979f * d / gamma;
    const float h = 5.0f * d2 / (3.0f * gamma * gamma);
    return sigma * (1.0f + c + h) * expf(-c);
  }
  const float base = 1.0f + d2 / (2.0f * alpha * gamma * gamma);
  return sigma * expf(-alpha * logf(base));
}

template <int FAMILY>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ params,
            float* __restrict__ K, int M, int N, int D) {
  __shared__ float As[BK][TILE + 1];
  __shared__ float Bs[BK][TILE + 1];
  __shared__ float a_norm[TILE];
  __shared__ float b_norm[TILE];

  const int tid = threadIdx.x;
  const int tx = tid % SUB;
  const int ty = tid / SUB;
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;  // threads [0, 64): |A row m0 + tid|^2; [64, 128): |B row n0 + tid - 64|^2

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = tid; e < TILE * BK; e += THREADS) {
      const int r = e / BK;
      const int k = e % BK;
      const int gk = k0 + k;
      const int gm = m0 + r;
      const int gn = n0 + r;
      As[k][r] = (gm < M && gk < D) ? A[(long long)gm * D + gk] : 0.0f;
      Bs[k][r] = (gn < N && gk < D) ? B[(long long)gn * D + gk] : 0.0f;
    }
    __syncthreads();
    if (tid < TILE) {
#pragma unroll
      for (int k = 0; k < BK; ++k) norm = fmaf(As[k][tid], As[k][tid], norm);
    } else if (tid < 2 * TILE) {
#pragma unroll
      for (int k = 0; k < BK; ++k) norm = fmaf(Bs[k][tid - TILE], Bs[k][tid - TILE], norm);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + SUB * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + SUB * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < TILE) {
    a_norm[tid] = norm;
  } else if (tid < 2 * TILE) {
    b_norm[tid - TILE] = norm;
  }
  __syncthreads();

  const float gamma = params[0];
  const float sigma = params[1];
  const float alpha = params[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + SUB * i;
    if (row >= M) continue;
    const float aa = a_norm[ty + SUB * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + SUB * j;
      if (col >= N) continue;
      float d2 = aa + b_norm[tx + SUB * j] - 2.0f * acc[i][j];
      d2 = d2 < 0.0f ? 0.0f : d2;  // not fmaxf: a NaN stays NaN, as jnp.maximum keeps it
      K[(long long)row * N + col] = epilogue<FAMILY>(d2, gamma, sigma, alpha);
    }
  }
}

}  // namespace

extern "C" {

int gram_tile() { return TILE; }

int gram_threads_per_block() { return THREADS; }

const char* gram_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches on `stream` (a cudaStream_t) of device `device`; does not
// synchronise. `family` is the index in Family. Returns a cudaError_t: 0
// when the launch was accepted.
int gram_launch(const float* A, const float* B, const float* params, float* K, int M, int N, int D, int family,
                int device, void* stream) {
  if (M < 1 || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const long long grid_y = (M + TILE - 1) / TILE;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((N + TILE - 1) / TILE), (unsigned int)grid_y);
  cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case SQUARED_EXPONENTIAL: gram_kernel<SQUARED_EXPONENTIAL><<<grid, THREADS, 0, s>>>(A, B, params, K, M, N, D); break;
    case MATERN12: gram_kernel<MATERN12><<<grid, THREADS, 0, s>>>(A, B, params, K, M, N, D); break;
    case MATERN32: gram_kernel<MATERN32><<<grid, THREADS, 0, s>>>(A, B, params, K, M, N, D); break;
    case MATERN52: gram_kernel<MATERN52><<<grid, THREADS, 0, s>>>(A, B, params, K, M, N, D); break;
    case RATIONAL_QUADRATIC: gram_kernel<RATIONAL_QUADRATIC><<<grid, THREADS, 0, s>>>(A, B, params, K, M, N, D); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
