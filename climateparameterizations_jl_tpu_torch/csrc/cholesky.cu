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
// bytes (8.4 MB: 2.5 us). In practice it is latency: a chain of n dependent
// pivots, T of them in each of the n / T block columns, and two launches
// per block column.
//
// Design. The TPU kernel keeps the whole matrix in VMEM and works in one
// launch; one SM holds at most 227 KB, so this is a multi-CTA blocked
// design over tiles of T = 64 (ragged edges masked, so any n works):
//   0. tril_copy: L = tril(K), one CTA per row (the upper triangle is
//      written zero once and never touched again).
//   for each block column j0 = 0, T, 2T, ...:
//   1. factor_panel: every CTA stages the T x T diagonal tile, which the
//      previous trailing update left final in the scratch tile W (for the
//      first block column: K itself), and its 64 panel rows below it in
//      shared memory (cp.async): a 128-row tall panel, one row per thread.
//      It factors the tall panel right-looking in windows of 8 columns.
//      Every thread holds the window's 8 x 8 diagonal block and its own
//      row's 8 entries in registers and factors the block itself, so the
//      pivot chain (a square root, a division, a multiplication and an FMA
//      per pivot) has no shuffle and no barrier in it. Then each row below
//      the window applies the window's rank-8 update to its entries right
//      of it (float4 reads of the window's columns, the same address on
//      every lane). Two barriers per window. The diagonal tile is factored
//      by every CTA (64^3 / 3 FMAs, cheap); CTA 0 writes it into L, where no
//      CTA of this launch reads (all read W), so no CTA can see it half
//      written. Rows past n in the last tile are identity rows.
//   2. trailing_update: A_IJ -= L_I L_J^T over the lower-triangular T x T
//      tiles of the trailing matrix, 256 threads per tile, each with a
//      4 x 4 register block, both T x T panel slabs staged in shared
//      memory (cp.async; row pitch 68 floats: 16-byte aligned float4 reads
//      without bank conflicts). f32 FMAs on the CUDA cores: the jittered
//      Grams' condition numbers (up to about 1 / jitter) leave no room for
//      TF32. The tile (0, 0), the next diagonal tile, goes to W, not L.
// That is 2 ceil(n / T) launches per factorization (cholesky_launch_count),
// all on the caller's stream, with no host synchronisation between them.
//
// Every loop body is kept small. On an H100, hot code that is long and
// straight (a fully unrolled 64-column factorization in registers, about
// 9,000 instructions, each run once) waits on instruction fetch: a first
// design of factor_panel written that way was several times slower.
//
// One reciprocal per pivot: inv = 1 / sqrtf(pivot), an IEEE division of a
// normal number, and every entry of the column is multiplied by it (both
// by sqrt_rn and rcp_rn of device_common.cuh: sqrtf and 1.0f / x without
// their slow-path branch). An IEEE division whose operand is subnormal
// takes the division routine's slow path; a multiplication runs subnormals
// (the off-diagonal entries of the GP path's squared-exponential Gram) at
// full rate. No fast math and no
// flush to zero: the plain versions keep IEEE semantics.
//
// A matrix that is not positive definite yields NaNs (square root of a
// negative pivot), as the TPU kernel does; nothing raises.

#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int T = 64;  // tile edge
constexpr int WIN = 8;  // columns per window of factor_panel
constexpr int PANEL_ROWS = 64;  // panel rows per factor_panel CTA
constexpr int PANEL_THREADS = T + PANEL_ROWS;  // one thread per row of the tall panel
constexpr int UPDATE_THREADS = 256;
constexpr int PITCH = T + 4;  // shared-memory row pitch (floats): 16-byte rows, float4 access without bank conflicts
constexpr int COPY_THREADS = 256;

static_assert(T % WIN == 0 && WIN % 4 == 0, "whole windows of float4 columns");
static_assert(UPDATE_THREADS == (T / 4) * (T / 4), "a 4 x 4 register block per thread");

__global__ void __launch_bounds__(COPY_THREADS) tril_copy_kernel(const float* __restrict__ K, float* __restrict__ L, int n) {
  const long long row = (long long)blockIdx.x * n;
  for (int c = threadIdx.x; c < n; c += COPY_THREADS) L[row + c] = c <= (int)blockIdx.x ? K[row + c] : 0.0f;
}

// `tile` points at the diagonal tile's (0, 0) entry, rows `tile_ld` apart.
// VEC: n, tile_ld and the pointers allow 16-byte copies and stores.
template <bool VEC>
__global__ void __launch_bounds__(PANEL_THREADS)
factor_panel_kernel(float* __restrict__ L, const float* __restrict__ tile, int tile_ld, int n, int j0) {
  __shared__ __align__(16) float S[PANEL_THREADS * PITCH];  // rows 0..T-1: the tile; T..: the panel rows
  const int tid = threadIdx.x;
  const int t = min(T, n - j0);  // valid edge of the diagonal tile
  const int p0 = j0 + T + blockIdx.x * PANEL_ROWS;  // first panel row of this CTA
  const int prows = max(0, min(PANEL_ROWS, n - p0));

  // Stage the tile and the panel rows (all T columns valid: panel rows exist
  // only below a full tile), from clamped, valid addresses. What the copy
  // brings above the tile's diagonal and in panel rows past n is never
  // written out and never read into a stored entry.
  if (VEC) {  // t is then a multiple of 4
#pragma unroll 4
    for (int e = tid; e < T * T / 4; e += PANEL_THREADS) {
      const int r = e / (T / 4), c = e % (T / 4) * 4;
      copy_async16(S + r * PITCH + c, tile + (long long)min(r, t - 1) * tile_ld + min(c, t - 4));
      copy_async16(S + (T + r) * PITCH + c, L + (long long)min(p0 + r, n - 1) * n + j0 + c);
    }
  } else {
#pragma unroll 8
    for (int e = tid; e < T * T; e += PANEL_THREADS) {
      const int r = e / T, c = e % T;
      copy_async(S + r * PITCH + c, tile + (long long)min(r, t - 1) * tile_ld + min(c, t - 1));
      copy_async(S + (T + r) * PITCH + c, L + (long long)min(p0 + r, n - 1) * n + j0 + c);
    }
  }
  copy_async_wait();
  __syncthreads();
  float* own = S + tid * PITCH;  // this thread's row of the tall panel
  if (t < T) {  // the last, ragged tile: identity rows past n (uniform branch)
    if (tid >= t && tid < T) {
      for (int c = 0; c < T; ++c) own[c] = c == tid ? 1.0f : 0.0f;
    }
    __syncthreads();
  }

#pragma unroll 1
  for (int w0 = 0; w0 < T; w0 += WIN) {
    // The window's diagonal block (lower triangle) and this row's entries.
    float a[WIN][WIN], x[WIN];
#pragma unroll
    for (int r = 0; r < WIN; ++r) {
#pragma unroll
      for (int c = 0; c <= r; c += 4) {
        const float4 v = ld4(S + (w0 + r) * PITCH + w0 + c);  // the same address on every lane: a broadcast
        a[r][c] = v.x, a[r][c + 1] = v.y, a[r][c + 2] = v.z, a[r][c + 3] = v.w;
      }
    }
#pragma unroll
    for (int c = 0; c < WIN; c += 4) {
      const float4 v = ld4(own + w0 + c);
      x[c] = v.x, x[c + 1] = v.y, x[c + 2] = v.z, x[c + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < WIN; ++k) {
      // One reciprocal per pivot, an IEEE division of a normal number;
      // every other entry of the column is multiplied by it.
      const float s = sqrt_rn(a[k][k]);
      const float inv = rcp_rn(s);
      a[k][k] = s;
#pragma unroll
      for (int i = k + 1; i < WIN; ++i) a[i][k] *= inv;
      const float xl = x[k] * inv;
      x[k] = xl;
#pragma unroll
      for (int c = k + 1; c < WIN; ++c) {
#pragma unroll
        for (int i = c; i < WIN; ++i) a[i][c] = fmaf(-a[i][k], a[c][k], a[i][c]);
        x[c] = fmaf(-xl, a[c][k], x[c]);
      }
    }
    // Rows below the window keep its columns of L; the pivot rows are
    // written after the barrier, once every thread has read them.
    const bool below = tid >= w0 + WIN;
    if (below) {
#pragma unroll
      for (int c = 0; c < WIN; c += 4) st4(own + w0 + c, make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]));
    }
    __syncthreads();
    // Each pivot row's thread writes the block's row (zero right of the diagonal).
#pragma unroll
    for (int r = 0; r < WIN; ++r) {
      if (tid == w0 + r) {
#pragma unroll
        for (int c = 0; c < WIN; c += 4) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = c + q <= r ? a[r][c + q <= r ? c + q : 0] : 0.0f;
          st4(own + w0 + c, make_float4(v[0], v[1], v[2], v[3]));
        }
      }
    }
    if (below) {
      // Rank-WIN update of the entries right of the window: own[c] -= x . L[c][window],
      // for tile rows only on and left of the diagonal (rounded up to whole float4s).
      const int end = tid < T ? min(T, (tid / 4 + 1) * 4) : T;
#pragma unroll 1
      for (int c0 = w0 + WIN; c0 < end; c0 += 4) {
        const float4 o = ld4(own + c0);
        float out[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* lrow = S + (c0 + cc) * PITCH + w0;
#pragma unroll
          for (int k = 0; k < WIN; k += 4) {
            const float4 l = ld4(lrow + k);
            out[cc] = fmaf(-x[k], l.x, out[cc]);
            out[cc] = fmaf(-x[k + 1], l.y, out[cc]);
            out[cc] = fmaf(-x[k + 2], l.z, out[cc]);
            out[cc] = fmaf(-x[k + 3], l.w, out[cc]);
          }
        }
        st4(own + c0, make_float4(out[0], out[1], out[2], out[3]));
      }
    }
    __syncthreads();
  }

  // The factored tile (CTA 0, lower triangle; S holds zeros right of its
  // diagonal, and so does L) and the solved panel rows.
  if (VEC) {
#pragma unroll 4
    for (int e = tid; e < T * T / 4; e += PANEL_THREADS) {
      const int r = e / (T / 4), c = e % (T / 4) * 4;
      if (blockIdx.x == 0 && r < t && c <= r) st4(L + (long long)(j0 + r) * n + j0 + c, ld4(S + r * PITCH + c));
      if (r < prows) st4(L + (long long)(p0 + r) * n + j0 + c, ld4(S + (T + r) * PITCH + c));
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < T * T; e += PANEL_THREADS) {
      const int r = e / T, c = e % T;
      if (blockIdx.x == 0 && r < t && c <= r) L[(long long)(j0 + r) * n + j0 + c] = S[r * PITCH + c];
      if (r < prows) L[(long long)(p0 + r) * n + j0 + c] = S[(T + r) * PITCH + c];
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(UPDATE_THREADS)
trailing_update_kernel(float* __restrict__ L, float* __restrict__ W, int n, int j0) {
  __shared__ __align__(16) float si[T * PITCH];
  __shared__ __align__(16) float sj[T * PITCH];
  // blockIdx.x enumerates the lower-triangular tiles (I, J), J <= I, row by row.
  const int b = blockIdx.x;
  int I = (int)((sqrtf(8.0f * (float)b + 1.0f) - 1.0f) * 0.5f);
  while ((I + 1) * (I + 2) / 2 <= b) ++I;
  while (I * (I + 1) / 2 > b) --I;
  const int J = b - I * (I + 1) / 2;
  const int i0 = j0 + T + I * T;
  const int l0 = j0 + T + J * T;
  // The two panel slabs, rows i0.. and l0.. of block column j0 (all T
  // columns valid: a trailing tile exists only right of a full tile), from
  // clamped addresses; rows past n only feed outputs that are not stored.
  if (VEC) {
#pragma unroll
    for (int e = threadIdx.x; e < T * T / 4; e += UPDATE_THREADS) {
      const int r = e / (T / 4), c = e % (T / 4) * 4;
      copy_async16(si + r * PITCH + c, L + (long long)min(i0 + r, n - 1) * n + j0 + c);
      copy_async16(sj + r * PITCH + c, L + (long long)min(l0 + r, n - 1) * n + j0 + c);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < T * T; e += UPDATE_THREADS) {
      const int r = e / T, c = e % T;
      copy_async(si + r * PITCH + c, L + (long long)min(i0 + r, n - 1) * n + j0 + c);
      copy_async(sj + r * PITCH + c, L + (long long)min(l0 + r, n - 1) * n + j0 + c);
    }
  }
  copy_async_wait();
  __syncthreads();
  // Thread (ty, tx) owns rows ty + 16 a and columns tx + 16 q (a, q < 4): in
  // a warp the si reads are broadcasts and the sj reads of 8 neighbouring
  // threads fall in 8 distinct 4-bank groups.
  const int ty = threadIdx.x / (T / 4);
  const int tx = threadIdx.x % (T / 4);
  float acc[4][4] = {};
#pragma unroll 1
  for (int k = 0; k < T; k += 4) {
    float4 ai[4], bj[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) ai[a] = ld4(si + (ty + 16 * a) * PITCH + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) bj[q] = ld4(sj + (tx + 16 * q) * PITCH + k);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[a][q] = fmaf(ai[a].x, bj[q].x, acc[a][q]);
        acc[a][q] = fmaf(ai[a].y, bj[q].y, acc[a][q]);
        acc[a][q] = fmaf(ai[a].z, bj[q].z, acc[a][q]);
        acc[a][q] = fmaf(ai[a].w, bj[q].w, acc[a][q]);
      }
    }
  }
  // The next diagonal tile (b = 0) goes to W: the next factor_panel reads it
  // there while it writes the factored tile into L.
  float* dst = b == 0 ? W : L + (long long)i0 * n + l0;
  const int ld = b == 0 ? T : n;
  float old[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int q = 0; q < 4; ++q) old[a][q] = L[(long long)min(i0 + ty + 16 * a, n - 1) * n + min(l0 + tx + 16 * q, n - 1)];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = tx + 16 * q;
      if (i0 + r < n && l0 + c <= i0 + r) dst[r * ld + c] = old[a][q] - acc[a][q];
    }
  }
}

}  // namespace

extern "C" {

int cholesky_tile() { return T; }

int cholesky_panel_rows_per_block() { return PANEL_ROWS; }

int cholesky_window() { return WIN; }

// Kernel launches of one factorization of an (n, n) matrix: the copy, then
// per block column a factor_panel and (except the last) a trailing update.
int cholesky_launch_count(int n) {
  const int nb = (n + T - 1) / T;
  return 2 * nb;
}

const char* cholesky_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Factorizes K into L (distinct buffers) on `stream` (a cudaStream_t) of
// device `device`, with W a scratch buffer of T x T floats (cholesky_tile());
// does not synchronise. `*launched` receives the number
// of kernels launched. Returns a cudaError_t: 0 when every launch was
// accepted.
int cholesky_launch(const float* K, float* L, float* W, int n, int device, void* stream, int* launched) {
  *launched = 0;
  if (n < 1 || n > 46340) return (int)cudaErrorInvalidValue;  // n * n fits an int index per row
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = n % 4 == 0 && ((unsigned long long)K | (unsigned long long)L | (unsigned long long)W) % 16 == 0;
  tril_copy_kernel<<<n, COPY_THREADS, 0, s>>>(K, L, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  for (int j0 = 0; j0 < n; j0 += T) {
    const int rows = n - j0 - T;  // rows below the diagonal tile
    const int panel_blocks = rows > 0 ? (rows + PANEL_ROWS - 1) / PANEL_ROWS : 1;
    const float* tile = j0 == 0 ? K : W;
    if (vec) {
      factor_panel_kernel<true><<<panel_blocks, PANEL_THREADS, 0, s>>>(L, tile, j0 == 0 ? n : T, n, j0);
    } else {
      factor_panel_kernel<false><<<panel_blocks, PANEL_THREADS, 0, s>>>(L, tile, j0 == 0 ? n : T, n, j0);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launched;
    if (rows <= 0) break;
    const int tiles = (rows + T - 1) / T;
    if (vec) {
      trailing_update_kernel<true><<<tiles * (tiles + 1) / 2, UPDATE_THREADS, 0, s>>>(L, W, n, j0);
    } else {
      trailing_update_kernel<false><<<tiles * (tiles + 1) / 2, UPDATE_THREADS, 0, s>>>(L, W, n, j0);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launched;
  }
  return 0;
}

}  // extern "C"
