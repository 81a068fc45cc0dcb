// Fused GP Gram matrix: K[i, j] = k(||A_i - B_j||) for one stationary kernel family.
//
// Replaces the Pallas TPU kernel of climateparameterizations_jl_tpu/ops/gram.py:
// gram_pallas (pallas_call at :125, body _gram_kernel :65, epilogue
// _epilogue :45). Inputs are A (M, D) and B (N, D) as contiguous f32 rows
// and the hyperparameters gamma, sigma and alpha, each one float in device
// memory; the output is K (M, N) f32. The wrapper (ops/_cuda.py) checks
// device, type, shape and contiguity; ops/gram.py refuses D > 4096 as the
// TPU wrapper does.
//
// What bounds it on an H100: operations. The product A B^T takes 2 M N D
// flops on the CUDA cores (f32 FMAs, no TF32), against 4 (M D + N D + M N)
// bytes: at 1,024 x 1,024 x 96 that is 2.01e8 flop = 3.0 us at 67 TFLOP/s,
// above the 4.98 MB / 3.35 TB/s = 1.49 us of traffic. On this card a
// warp-wide shared-memory load holds the SM's shared-memory pipe about 2
// cycles (4 bytes a lane) or 4 cycles (16 bytes), and the SM retires about
// 2.7 warp FFMAs per cycle, so the design counts shared-memory instructions
// per FMA. In one wave of one tile per SM the kernel takes one CTA's time:
// on an H100 about 0.9 us of launch, 1.1 us until the first chunk has
// landed, the product at about two thirds of the issue rate (both the FMA
// and the shared-memory pipe busy), then the epilogue and the stores.
//
// Design:
//   - Register blocking. A CTA computes a 128 x 64 tile of K with 256
//     threads in two halves of 4 warps. Thread t of either half holds the
//     8 x 8 partial outputs of rows ty + 16 i and columns 4 tx + 32 jj + q
//     (ty < 16, tx < 8, i < 8, jj < 2, q < 4) over its half of the
//     features: the first 16 of every staged chunk of 32, or the last 16.
//     For every 4 features it reads 8 float4 of A and 8 of B from shared
//     memory for 256 FMAs: one 16-byte load per 16 FMAs. The two halves put
//     two warps on each scheduler, so that one hides the other's latency
//     (with one warp per scheduler, 4 warps of 8 x 8 over all features,
//     nothing hid the shared loads and the epilogue); 8 warps of 8 x 4 would
//     issue 1.5 times the shared loads per FMA.
//   - At the end the halves swap the partial sums of four rows through the
//     (then idle) staging ring and each adds its own: every thread finishes
//     4 x 8 outputs, so the epilogue runs on all 8 warps.
//   - Shared layout: rows as in device memory, 32 features (128 bytes) a
//     row, the 16-byte groups of row r XOR-swizzled by (r / 4) % 8 (swz).
//     A quarter warp then reads either one address (A's rows, shared by the
//     8 threads of a row group) or 8 different bank groups (B's columns
//     4 tx + ..., and the norm rows), with no padding.
//   - Staging by cp.async into a ring of STAGES chunks of BK = 32 features
//     (72 KB of dynamic shared memory), so that chunk c's FMAs overlap the
//     copies of chunks c + 1 and c + 2; at D <= 96 the whole slab of a tile
//     is in flight at once. 16-byte copies where D % 4 == 0 and A and B are
//     16-byte aligned, 4-byte copies otherwise. Features past D and rows
//     past M or N are zero-filled in shared memory: zeros add nothing to a
//     dot product or a norm.
//   - Row norms |a|^2 and |b|^2 from the staged chunks, spread over all
//     threads (in each half one A row each, and one B row each in its first
//     two warps), over the same feature halves with fmaf in the product's
//     order, then summed half 0 + half 1 as the products are. Where
//     A_i == B_j (the diagonal of a training Gram, B is A) the product and
//     both norms are the same two fmaf chains and the same sum, so
//     d2 = aa + bb - 2 ab is exactly 0 there.
//   - One even wave: the grid is at most the SM count times the CTAs that
//     fit on an SM, and each CTA walks tiles blockIdx.x, + gridDim.x, ...;
//     at 1,024 x 1,024 that is 128 tiles on 132 SMs, one tile each.
//   - Epilogue in registers: d2 = max(aa + bb - 2 ab, 0) with NaN kept, then
//     the family (a template parameter). Its divisors (2 gamma^2, gamma,
//     ...) are inverted once per thread with IEEE rounding and each element
//     multiplies; the exponential and the square root are one special-
//     function instruction each (ex2.approx, sqrt.approx: sqrtf's slow-path
//     branch per element serialised the unrolled epilogue). K is written
//     once, 16 bytes at a time where N % 4 == 0, the ragged edge masked.
//   - gamma, sigma and alpha are read from device memory, not passed by
//     value: during ML-II they are tensors on the card with autograd
//     history, and reading them on the host would synchronise every call.

#include <cuda_runtime.h>

#include "device_common.cuh"

namespace {

constexpr int HALF = 128;  // threads per feature half: 16 x 8 threads of 8 x 8 outputs
constexpr int THREADS = 2 * HALF;
constexpr int BM = 128;  // rows of A (of K) per tile
constexpr int BN = 64;   // rows of B (columns of K) per tile
constexpr int BK = 32;   // features per staged chunk: one 128-byte shared row
constexpr int STAGES = 3;
constexpr int SLOT = (BM + BN) * BK;  // floats per ring slot
constexpr int SMEM_FLOATS = STAGES * SLOT + 2 * (BM + BN);  // the ring, then each half's partial norms
constexpr int SMEM_BYTES = SMEM_FLOATS * (int)sizeof(float);
constexpr int MAX_DEVICES = 64;

static_assert(BM == 16 * 8 && BN == 8 * 8, "16 x 8 threads of 8 x 8 outputs per half");
static_assert(BK == 32, "the swizzle permutes the 8 16-byte groups of a 128-byte row");
static_assert(THREADS * 32 <= STAGES * SLOT, "the swap of partial sums fits in the ring");
static_assert(THREADS % 32 == 0 && BN % (THREADS / 8) == 0, "whole row steps when staging");

enum Family { SQUARED_EXPONENTIAL = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3, RATIONAL_QUADRATIC = 4 };

// Float offset of feature k (< BK) of staged row r.
__device__ __forceinline__ int swz(int r, int k) { return r * BK + ((((k >> 2) ^ (r >> 2)) & 7) << 2) + (k & 3); }

// Features [k0, k0 + BK) of rows [r0, r0 + R) of X (n_rows, D) into the staged rows S, zero past n_rows and D.
// 16-byte copies: thread tid takes features k .. k + 3 (k = 4 (tid % 8)) of rows tid / 8 + 32 n, all in one
// swizzle class. 4-byte copies: feature tid % 32 of rows tid / 32 + 8 n.
template <int R>
__device__ __forceinline__ void stage_rows(float* S, const float* __restrict__ X, int r0, int n_rows, int k0, int D,
                                           int vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int r = tid >> 3, k = (tid & 7) << 2;
    const bool k_ok = k0 + k < D;
    const float* src = X + (long long)(r0 + r) * D + k0 + k;
    float* dst = S + swz(r, k);
#pragma unroll
    for (int n = 0; n < R / (THREADS / 8); ++n) {
      float* d = dst + n * (THREADS / 8) * BK;
      if (k_ok && r0 + r + n * (THREADS / 8) < n_rows) {
        copy_async16(d, src + (long long)n * (THREADS / 8) * D);
      } else {
        st4(d, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
      }
    }
  } else {
    const int r = tid >> 5, k = tid & 31;
    const bool k_ok = k0 + k < D;
#pragma unroll 4
    for (int n = 0; n < R / (THREADS / 32); ++n) {
      const int rr = r + n * (THREADS / 32);
      float* d = S + swz(rr, k);
      if (k_ok && r0 + rr < n_rows) {
        copy_async(d, X + (long long)(r0 + rr) * D + k0 + k);
      } else {
        *d = 0.0f;
      }
    }
  }
}

// The TPU kernel's _epilogue, sigma k(d2), with its divisors inverted once
// (IEEE rounding) and e^-x computed as 2^(-x log2 e), the square root as
// sqrt.approx: one special-function instruction each, within a few f32 ulps
// (the tolerances against the plain version are 2e-5 relative), and exact
// at d2 = 0, so a training Gram's diagonal is sigma. Rational quadratic
// keeps logf.
constexpr float LOG2E = 1.4426950408889634f;

template <int FAMILY>
struct Epilogue {
  float sigma, alpha, c1, c2;

  __device__ __forceinline__ Epilogue(float gamma, float sigma_, float alpha_) : sigma(sigma_), alpha(alpha_), c2(0.0f) {
    if (FAMILY == SQUARED_EXPONENTIAL) c1 = __fdiv_rn(LOG2E, 2.0f * gamma * gamma);
    if (FAMILY == MATERN12) c1 = __fdiv_rn(LOG2E, gamma);
    if (FAMILY == MATERN32) c1 = __fdiv_rn(1.7320508075688772f, gamma);
    if (FAMILY == MATERN52) {
      c1 = __fdiv_rn(2.23606797749979f, gamma);
      c2 = __fdiv_rn(5.0f, 3.0f * gamma * gamma);
    }
    if (FAMILY == RATIONAL_QUADRATIC) c1 = __fdiv_rn(1.0f, 2.0f * alpha * gamma * gamma);
  }

  __device__ __forceinline__ float operator()(float d2) const {
    if (FAMILY == SQUARED_EXPONENTIAL) return sigma * exp2_approx(-d2 * c1);
    if (FAMILY == RATIONAL_QUADRATIC) return sigma * exp2_approx(-alpha * LOG2E * logf(1.0f + d2 * c1));
    const float d = sqrt_approx(d2);
    if (FAMILY == MATERN12) return sigma * exp2_approx(-d * c1);
    const float c = d * c1;
    if (FAMILY == MATERN32) return sigma * (1.0f + c) * exp2_approx(-c * LOG2E);
    return sigma * (1.0f + c + d2 * c2) * exp2_approx(-c * LOG2E);
  }
};

__device__ __forceinline__ float lane_of(const float4& v, int q) { return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w; }

template <int FAMILY>
__global__ void __launch_bounds__(THREADS, 1)
gram_kernel(const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ gamma,
            const float* __restrict__ sigma, const float* __restrict__ alpha, float* __restrict__ K, int M, int N,
            int D, int vec_copy, int vec_store) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int h = tid / HALF;                          // features 16 h .. 16 h + 15 of every chunk
  const int t = tid % HALF;
  const int tx = lane & 7;                           // columns 4 tx + 32 jj + q
  const int ty = ((t >> 5) << 2) + (lane >> 3);      // rows ty + 16 i
  // The row whose partial norm this thread sums (of A; of B too in the first
  // two warps of a half): a quarter warp takes rows of 8 swizzle classes.
  const int rn = 4 * tx + (ty & 3) + 32 * (ty >> 2);
  const bool b_norm_thread = ty < 8;
  // Swizzled group offsets: row ty + 16 i is in class (ty / 4) ^ 4 (i & 1),
  // columns 4 tx + 32 jj + q and row rn in class tx.
  const int sa = (ty >> 2) << 2, sb = tx << 2;
  float* a_part = smem + STAGES * SLOT;  // [half][BM]
  float* b_part = a_part + 2 * BM;       // [half][BN]
  const int tiles_n = (N + BN - 1) / BN;
  const int n_tiles = ((M + BM - 1) / BM) * tiles_n;
  const int n_chunks = (D + BK - 1) / BK;
  const Epilogue<FAMILY> ep(*gamma, *sigma, *alpha);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    float na = 0.0f, nb = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_chunks) {
        stage_rows<BM>(smem + s * SLOT, A, m0, M, s * BK, D, vec_copy);
        stage_rows<BN>(smem + s * SLOT + BM * BK, B, n0, N, s * BK, D, vec_copy);
      }
      copy_async_commit();
    }
    int slot = 0;
    for (int c = 0; c < n_chunks; ++c) {
      copy_async_wait_group<STAGES - 2>();  // this thread's copies of chunk c have landed
      __syncthreads();                      // everyone's have, and chunk c - 1 is read
      const int next = c + STAGES - 1, next_slot = slot == 0 ? STAGES - 1 : slot - 1;
      if (next < n_chunks) {
        stage_rows<BM>(smem + next_slot * SLOT, A, m0, M, next * BK, D, vec_copy);
        stage_rows<BN>(smem + next_slot * SLOT + BM * BK, B, n0, N, next * BK, D, vec_copy);
      }
      copy_async_commit();
      const float* As = smem + slot * SLOT;
      const float* Bs = As + BM * BK;
      slot = slot == STAGES - 1 ? 0 : slot + 1;

#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = ld4(As + rn * BK + ((16 * h + 4 * g) ^ sb));
        na = fmaf(v.x, v.x, na);
        na = fmaf(v.y, v.y, na);
        na = fmaf(v.z, v.z, na);
        na = fmaf(v.w, v.w, na);
      }
      if (b_norm_thread) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 v = ld4(Bs + rn * BK + ((16 * h + 4 * g) ^ sb));
          nb = fmaf(v.x, v.x, nb);
          nb = fmaf(v.y, v.y, nb);
          nb = fmaf(v.z, v.z, nb);
          nb = fmaf(v.w, v.w, nb);
        }
      }

      const float* a_row = As + ty * BK;      // row ty + 16 i at + 16 i BK
      const float* b_col = Bs + 4 * tx * BK;  // column 4 tx + 32 jj + q at + (32 jj + q) BK
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int ga = (16 * h + 4 * g) ^ sa;  // even i; odd i: ga ^ 16
        const float* pb = b_col + ((16 * h + 4 * g) ^ sb);
        float4 a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ld4(a_row + 16 * i * BK + (i & 1 ? ga ^ 16 : ga));
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ld4(pb + (32 * (j >> 2) + (j & 3)) * BK);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
    }

    // Half h finishes rows ty + 16 (4 h + i), i < 4: it sends its partial
    // sums of the other four rows to thread t of the other half, float4 m
    // at xch[half][m][t] (consecutive threads, consecutive 16 bytes).
    a_part[h * BM + rn] = na;
    if (b_norm_thread) b_part[h * BN + rn] = nb;
    __syncthreads();  // the ring is read: it holds the swap now
    float* xch = smem;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = h ? acc[i][4 * jj + q] : acc[4 + i][4 * jj + q];
        st4(xch + (((1 - h) * 8 + 2 * i + jj) * HALF + t) * 4, make_float4(v[0], v[1], v[2], v[3]));
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * (4 * h + i);
      const int row = m0 + r;
      const float aa = a_part[r] + a_part[BM + r];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = n0 + 4 * tx + 32 * jj;
        const float4 other = ld4(xch + ((h * 8 + 2 * i + jj) * HALF + t) * 4);
        const float4 b0 = ld4(b_part + 4 * tx + 32 * jj), b1 = ld4(b_part + BN + 4 * tx + 32 * jj);
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ab = (h ? acc[4 + i][4 * jj + q] : acc[i][4 * jj + q]) + lane_of(other, q);
          float d2 = aa + (lane_of(b0, q) + lane_of(b1, q)) - 2.0f * ab;
          d2 = d2 < 0.0f ? 0.0f : d2;  // not fmaxf: a NaN stays NaN, as jnp.maximum keeps it
          v[q] = ep(d2);
        }
        if (row >= M || col >= N) continue;
        float* out = K + (long long)row * N + col;
        if (vec_store && col + 3 < N) {
          st4(out, make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col + q < N) out[q] = v[q];
        }
      }
    }
    __syncthreads();  // the next tile reuses the ring and the partial norms
  }
}

// The copy and store widths and the tile count of a launch on these pointers and sizes.
struct GramShape {
  int vec_copy, vec_store;
  long long tiles;
};

GramShape gram_shape(const float* A, const float* B, const float* K, int M, int N, int D) {
  const unsigned long long a = (unsigned long long)A, b = (unsigned long long)B, k = (unsigned long long)K;
  return {D % 4 == 0 && (a | b) % 16 == 0, N % 4 == 0 && k % 16 == 0,
          (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN)};
}

#ifndef CSRC_HOST_EMULATION

// Raises the kernel's shared-memory limit on `device` (the current device)
// once, and returns the most CTAs that run at once there: SMs x CTAs per SM.
template <int FAMILY>
cudaError_t wave_size(int device, int* ctas) {
  static int cached[MAX_DEVICES];  // 0 until the first launch on that device
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(gram_kernel<FAMILY>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_kernel<FAMILY>, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[device] = sms * per_sm;
  }
  *ctas = cached[device];
  return cudaSuccess;
}

template <int FAMILY>
cudaError_t launch(const float* A, const float* B, const float* gamma, const float* sigma, const float* alpha, float* K,
                   int M, int N, int D, int device, cudaStream_t stream) {
  const GramShape s = gram_shape(A, B, K, M, N, D);
  int ctas = 0;
  const cudaError_t err = wave_size<FAMILY>(device, &ctas);
  if (err != cudaSuccess) return err;
  const int grid = (int)(s.tiles < ctas ? s.tiles : ctas);
  gram_kernel<FAMILY><<<grid, THREADS, SMEM_BYTES, stream>>>(A, B, gamma, sigma, alpha, K, M, N, D, s.vec_copy,
                                                            s.vec_store);
  return cudaGetLastError();
}

#endif  // CSRC_HOST_EMULATION

}  // namespace

#ifndef CSRC_HOST_EMULATION

extern "C" {

int gram_tile_rows() { return BM; }

int gram_tile_cols() { return BN; }

int gram_threads_per_block() { return THREADS; }

int gram_smem_bytes() { return SMEM_BYTES; }

const char* gram_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The grid of a launch at M x N on `device`: min(tiles, SMs x CTAs per SM);
// a negative cudaError_t when the device refuses the configuration.
int gram_grid(int M, int N, int device) {
  if (M < 1 || N < 1) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  int ctas = 0;
  if (err == cudaSuccess) err = wave_size<SQUARED_EXPONENTIAL>(device, &ctas);
  if (err != cudaSuccess) return -(int)err;
  const long long tiles = gram_shape(nullptr, nullptr, nullptr, M, N, 4).tiles;
  return (int)(tiles < ctas ? tiles : ctas);
}

// Launches on `stream` (a cudaStream_t) of device `device`; does not
// synchronise. `family` is the index in Family. Returns a cudaError_t: 0
// when the launch was accepted.
int gram_launch(const float* A, const float* B, const float* gamma, const float* sigma, const float* alpha, float* K,
                int M, int N, int D, int family, int device, void* stream) {
  if (M < 1 || N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (gram_shape(A, B, K, M, N, D).tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case SQUARED_EXPONENTIAL: return (int)launch<SQUARED_EXPONENTIAL>(A, B, gamma, sigma, alpha, K, M, N, D, device, s);
    case MATERN12: return (int)launch<MATERN12>(A, B, gamma, sigma, alpha, K, M, N, D, device, s);
    case MATERN32: return (int)launch<MATERN32>(A, B, gamma, sigma, alpha, K, M, N, D, device, s);
    case MATERN52: return (int)launch<MATERN52>(A, B, gamma, sigma, alpha, K, M, N, D, device, s);
    case RATIONAL_QUADRATIC: return (int)launch<RATIONAL_QUADRATIC>(A, B, gamma, sigma, alpha, K, M, N, D, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

#endif  // CSRC_HOST_EMULATION
