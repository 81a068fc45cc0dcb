// Blocked right-looking Cholesky factor of an SPD f32 matrix: K = L L^T.
//
// Replaces the Pallas TPU kernel of climateparameterizations_jl_tpu/ops/cholesky.py:
// cholesky_pallas (pallas_call at :122, body _cholesky_kernel :86, helpers
// _chol_unblocked :50 and _tri_inv_lower :70). Input K (n, n) contiguous
// f32; output L (n, n) f32, lower triangular with an exactly zero upper
// triangle. The wrapper (ops/_cuda.py, ops/cholesky.py) keeps the TPU
// wrapper's contract: square, f32, n a multiple of its `block`.
//
// What bounds it on an H100: operations, barely. The factorization takes
// n^3 / 3 flops (3.58e8 at n = 1,024: 5.3 us at 67 TFLOP/s) against 8 n^2
// bytes (8.4 MB: 2.5 us). In practice it is latency: the n / T diagonal
// factorizations form a sequential chain, each a dependent loop of T
// square roots and divisions inside one CTA, and every step is a launch.
//
// Design (simple first). The TPU kernel keeps the whole matrix in VMEM and
// works in one launch; one SM holds at most 227 KB, so this is a
// multi-CTA blocked design over tiles of T = 32 (T divides every `block`
// the wrapper accepts, and ragged edges are masked anyway):
//   0. tril_copy: L = tril(K) in one pass (the upper triangle is written
//      zero once and never touched again).
//   for each block column j0 = 0, T, 2T, ...:
//   1. diag_factor: one CTA of T x T threads factors the T x T diagonal
//      tile in shared memory (unblocked, right-looking: per column one
//      square root, a scaled column and a rank-1 update of the lower part,
//      two barriers per column). Rows past n are padded with the identity.
//   2. panel_solve: the rows below solve X L_jj^T = P. One warp per row,
//      lane c holding column c, forward substitution with warp shuffles
//      against the diagonal tile kept in shared memory; 32 rows per CTA.
//   3. trailing_update: A_ij -= L_i L_j^T over the lower-triangular 32 x 32
//      tiles of the trailing matrix, each CTA staging its two 32 x 32 panel
//      slabs in shared memory (the kernel's own tiled product; no library
//      call).
// That is 3 ceil(n / T) - 1 launches per factorization (cholesky_launch_count),
// all on the caller's stream, with no host synchronisation between them.
// A matrix that is not positive definite yields NaNs (square root of a
// negative pivot), as the TPU kernel does; nothing raises.

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;  // tile edge; one warp spans a tile row
constexpr int PANEL_THREADS = 256;
constexpr int PANEL_ROWS = 32;  // rows per panel CTA: 8 warps x 4 rows
constexpr int UPDATE_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(T == 32, "panel_solve maps one lane to one tile column");
static_assert(PANEL_ROWS % (PANEL_THREADS / 32) == 0, "whole rows per warp");
static_assert((T * T) % UPDATE_THREADS == 0, "whole outputs per thread");

__global__ void tril_copy_kernel(const float* __restrict__ K, float* __restrict__ L, int n) {
  const long long total = (long long)n * n;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / n;
    const long long j = e - i * n;
    L[e] = j <= i ? K[e] : 0.0f;
  }
}

__global__ void __launch_bounds__(T * T) diag_factor_kernel(float* __restrict__ L, int n, int j0) {
  __shared__ float s[T][T + 1];
  const int r = threadIdx.x / T;
  const int c = threadIdx.x % T;
  const int t = min(T, n - j0);
  if (r < t && c < t) {
    s[r][c] = c <= r ? L[(long long)(j0 + r) * n + j0 + c] : 0.0f;
  } else {
    s[r][c] = r == c ? 1.0f : 0.0f;
  }
  __syncthreads();
  for (int k = 0; k < T; ++k) {
    // Every thread reads what it needs of column k before any thread
    // writes; lr and lc are computed by the same operations the column's
    // owner uses, so the stored column and the update agree bit for bit.
    const float p = sqrtf(s[k][k]);
    const float lr = s[r][k] / p;
    const float lc = s[c][k] / p;
    __syncthreads();
    if (r >= k) {
      if (c == k) {
        s[r][k] = r == k ? p : lr;
      } else if (c > k && c <= r) {
        s[r][c] -= lr * lc;
      }
    }
    __syncthreads();
  }
  if (r < t && c <= r) L[(long long)(j0 + r) * n + j0 + c] = s[r][c];
}

__global__ void __launch_bounds__(PANEL_THREADS) panel_solve_kernel(float* __restrict__ L, int n, int j0) {
  __shared__ float d[T][T + 1];
  for (int e = threadIdx.x; e < T * T; e += PANEL_THREADS) {
    const int r = e / T;
    const int c = e % T;
    d[r][c] = c <= r ? L[(long long)(j0 + r) * n + j0 + c] : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int rows_per_warp = PANEL_ROWS / (PANEL_THREADS / 32);
  const int first = j0 + T + blockIdx.x * PANEL_ROWS + warp * rows_per_warp;
  for (int q = 0; q < rows_per_warp; ++q) {
    const int row = first + q;
    if (row >= n) break;  // uniform across the warp: every lane takes part in each shuffle
    float* out = L + (long long)row * n + j0;
    float p = out[lane];
    for (int c = 0; c < T; ++c) {
      const float x = __shfl_sync(FULL_MASK, p, c) / d[c][c];
      if (lane == c) {
        p = x;
      } else if (lane > c) {
        p -= x * d[lane][c];
      }
    }
    out[lane] = p;
  }
}

__global__ void __launch_bounds__(UPDATE_THREADS) trailing_update_kernel(float* __restrict__ L, int n, int j0) {
  __shared__ float pi[T][T + 1];
  __shared__ float pj[T][T + 1];
  // blockIdx.x enumerates the lower-triangular tiles (I, J), J <= I, row by row.
  const int b = blockIdx.x;
  int I = (int)((sqrtf(8.0f * (float)b + 1.0f) - 1.0f) * 0.5f);
  while ((I + 1) * (I + 2) / 2 <= b) ++I;
  while (I * (I + 1) / 2 > b) --I;
  const int J = b - I * (I + 1) / 2;
  const int i0 = j0 + T + I * T;
  const int l0 = j0 + T + J * T;
  for (int e = threadIdx.x; e < T * T; e += UPDATE_THREADS) {
    const int r = e / T;
    const int c = e % T;
    pi[r][c] = i0 + r < n ? L[(long long)(i0 + r) * n + j0 + c] : 0.0f;
    pj[r][c] = l0 + r < n ? L[(long long)(l0 + r) * n + j0 + c] : 0.0f;
  }
  __syncthreads();
  constexpr int per_thread = T * T / UPDATE_THREADS;
  constexpr int row_step = UPDATE_THREADS / T;
  const int lc = threadIdx.x % T;
  const int r0 = threadIdx.x / T;
  float acc[per_thread];
#pragma unroll
  for (int q = 0; q < per_thread; ++q) acc[q] = 0.0f;
#pragma unroll 8
  for (int c = 0; c < T; ++c) {
    const float bj = pj[lc][c];
#pragma unroll
    for (int q = 0; q < per_thread; ++q) acc[q] = fmaf(pi[r0 + row_step * q][c], bj, acc[q]);
  }
  const int l = l0 + lc;
#pragma unroll
  for (int q = 0; q < per_thread; ++q) {
    const int i = i0 + r0 + row_step * q;
    if (i < n && l <= i) L[(long long)i * n + l] -= acc[q];
  }
}

}  // namespace

extern "C" {

int cholesky_tile() { return T; }

// Kernel launches of one factorization of an (n, n) matrix.
int cholesky_launch_count(int n) {
  const int nb = (n + T - 1) / T;
  return 3 * nb - 1;
}

const char* cholesky_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Factorizes K into L (distinct buffers) on `stream` (a cudaStream_t) of
// device `device`; does not synchronise. `*launched` receives the number
// of kernels launched. Returns a cudaError_t: 0 when every launch was
// accepted.
int cholesky_launch(const float* K, float* L, int n, int device, void* stream, int* launched) {
  *launched = 0;
  if (n < 1 || n > 46340) return (int)cudaErrorInvalidValue;  // n * n fits an int index per row
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)n * n;
  const long long copy_blocks = (total + 255) / 256;
  tril_copy_kernel<<<(unsigned int)(copy_blocks < 65535 ? copy_blocks : 65535), 256, 0, s>>>(K, L, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  for (int j0 = 0; j0 < n; j0 += T) {
    diag_factor_kernel<<<1, T * T, 0, s>>>(L, n, j0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launched;
    const int rows = n - j0 - T;
    if (rows <= 0) break;
    panel_solve_kernel<<<(rows + PANEL_ROWS - 1) / PANEL_ROWS, PANEL_THREADS, 0, s>>>(L, n, j0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launched;
    const int tiles = (rows + T - 1) / T;
    trailing_update_kernel<<<tiles * (tiles + 1) / 2, UPDATE_THREADS, 0, s>>>(L, n, j0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

}  // extern "C"
