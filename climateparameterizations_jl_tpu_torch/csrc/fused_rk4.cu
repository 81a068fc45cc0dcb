// Fused wind-mixing RHS + multi-step RK4: one launch runs a whole trajectory.
//
// Replaces the two Pallas TPU kernels of
// climateparameterizations_jl_tpu/ops/fused_rhs.py:
//   - _compiled_multistep_mxu (pallas_call at :535, body _make_kernel_mxu :499
//     over _make_mxu_rhs :399), entry make_fused_runner_mxu;
//   - _compiled_multistep (pallas_call at :257, body _make_kernel :172),
//     entry make_fused_runner.
// Both compute n_steps of RK4 on the full wind-mixing right-hand side; the
// Python runners in ops/fused_rhs.py feed this kernel the same operands.
//
// What bounds it on an H100 (SXM, 700 W): by the count, operations on the CUDA cores.
// Per column and RK4 step the three packed flux MLPs cost 4 x 2 x (96*150 + 3*50*20 +
// 3*20*31) = 154,080 f32 FLOP of matmul and the work outside them about 14,700 more
// (chip_smoke.py::nonmatmul_flops_per_column_step), against 786 KB of state moved per
// trajectory of 1,024 columns. The products stay IEEE f32 FMAs (no TF32, no tensor cores);
// only the order of the sums differs from the plain version. In practice the shared-memory
// instructions bound it: on the H100 a warp-wide 16-byte shared load or store occupies the
// SM's shared-memory pipe about 4 cycles (3 when all lanes read one address), a 4-byte one
// about 2, while the SM retires about 2.7 warp FMAs per cycle (fused_rk4_phases.py
// --probes). So the design counts shared-memory instructions, not bytes.
//
// Design:
//   - All n_steps inside the kernel: x is read once and written once. A CTA holds its copy
//     of the f32 weights in dynamic shared memory with the stage state, the RK4
//     accumulator and every activation, feature-major ([feature][column]) so that 4
//     columns are one float4. The launch shape (Shape below): 4 columns and 9 warps per
//     CTA, two CTAs per SM (256 CTAs for 1,024 columns, 112,128 B of shared memory each),
//     so 18 warps per SM, which leaves 96 registers per thread.
//   - Layer 1 (75 % of the FMAs) runs on every warp, register-blocked: a thread owns 4
//     neurons x 4 columns (16 accumulators) over one chunk of K. A1 is stored k-major with
//     each MLP's neurons padded to a multiple of 4, so per k one float4 of state (the same
//     address across the warp) and one float4 of weights feed 16 FMAs; the flagship
//     instantiation holds the first 8 weight rows of the thread's chunk in registers. K =
//     3 Nz is split into S chunks (S = 7 at the flagship widths: 273 of 288 threads); the partial sums go to shared memory, laid out so that adjacent lanes
//     write adjacent 16 bytes. The threads from the last one down take the face viscosity
//     nu, which depends only on the stage input.
//   - After one CTA-wide barrier the three flux MLPs are independent (A2, A3 are
//     block-diagonal, and the divergence stencil of variable b reads only MLP b's fluxes):
//     the third b of the warps runs MLP b's reduction + bias + mish, layer 2, layer 3 with
//     the mPP term, and the tendency + RK4 update of lanes [b Nz, (b+1) Nz), synchronised
//     by the named barrier 1 + b. Layers 2 and 3 give each unit of one neuron x 4 columns
//     4 (layer 2) or 2 (layer 3) lanes that split K and add up by a shuffle reduce-scatter,
//     so each lane finishes 1 or 2 outputs; the flagship instantiation holds layer 2's
//     weights in registers. So an RHS costs two CTA-wide barriers and three named ones.
//   - mish in one expf and one reciprocal, without a branch; the Richardson number by the
//     written-out reciprocal rcp_rn (fused_rk4_common.cuh).
//   - One build serves every model: the kernel is a template on (Nz, h1, h2),
//     instantiated for the flagship widths (32, 50, 20) and generically (0 = read from
//     the parameters). Loop bounds are uniform across the CTA or the group, so
//     every thread reaches every barrier.
//   - Scalars come in by value (FusedRK4Params).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "fused_rk4_common.cuh"

namespace {

constexpr int KS2 = 4, KS3 = 2;  // lanes that split K in layers 2 and 3
constexpr unsigned FULL_MASK = 0xffffffffu;

// Registers of the flagship instantiation: the first REG1_ROWS rows of each thread's
// layer-1 chunk, and its layer-2 weights, stay in registers for the whole launch (18 warps
// per SM leave 96 registers per thread; all 14 rows spill). Layer 3's weights stay in
// shared memory: in registers, with fewer layer-1 rows, they ran slower on the H100.
constexpr int REG1_ROWS = 8;

// The launch shape: 4 columns and 9 warps per CTA, two CTAs per SM. The warps of the two
// CTAs interleave one CTA's layer 1 (throughput-bound) with the other's group phases
// (latency-bound); one CTA of 8 columns x 18 warps per SM ran slower on the H100 (PERF.md).
struct Shape {
  static constexpr int TC = 4;             // columns per CTA
  static constexpr int NCG = TC / 4;       // column groups of 4
  static constexpr int THREADS = 32 * 9;
  static constexpr int GT = THREADS / 3;   // threads per flux-MLP group
  static constexpr int BLOCKS = 2;         // CTAs per SM
  static_assert(TC % 4 == 0 && THREADS % 96 == 0, "4-column groups and three warp groups");
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float4 f4(float a, float b, float c, float d) { return make_float4(a, b, c, d); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }

// Offsets (in floats) of each operand and work array inside shared memory. The operands
// come in the order ops/_cuda.py::pack_weights writes (n_weights floats), except that W1
// has KP rows here, zero past F, as the state has: a layer-1 chunk reads whole rows and
// needs no bound.
struct Layout {
  int F, ni, H1P, NP1, NG1;  // 3Nz, Nz-1, h1 padded to 4, 3 H1P, NP1 / 4
  int S, chunk, KP;          // layer-1 K chunks, their length, state rows (S chunk, zero past F)
  int A1P, A2P;              // rows per group of a1 and a2 (whole K chunks of layers 2 and 3, zero past h)
  int W1, b1, W2, b2, W3, b3, Krow, w1, w2, n_weights;
  int x, xa, xb, acc, part, a1, a2, flux, nu, n_smem;
};

__host__ __device__ constexpr Layout make_layout(int Nz, int h1, int h2) {
  Layout L{};
  L.F = 3 * Nz;
  L.ni = Nz - 1;
  L.H1P = round4(h1);
  L.NP1 = 3 * L.H1P;
  L.NG1 = L.NP1 / 4;
  const int units = Shape::NCG * L.NG1;  // (column group, neuron group) pairs of layer 1
  L.S = Shape::THREADS / units < 1 ? 1 : (Shape::THREADS / units > L.F ? L.F : Shape::THREADS / units);
  L.chunk = (L.F + L.S - 1) / L.S;
  L.KP = L.S * L.chunk;
  L.A1P = KS2 * ((h1 + KS2 - 1) / KS2);
  L.A2P = KS3 * ((h2 + KS3 - 1) / KS3);
  int o = 0;
  L.W1 = o;   o += L.KP * L.NP1;       // [k][b H1P + j], zero in the padding and past row F
  L.b1 = o;   o += 3 * h1;
  L.W2 = o;   o += 3 * h1 * h2;        // block b: [k][n], k < h1, n < h2
  L.b2 = o;   o += 3 * h2;
  L.W3 = o;   o += 3 * h2 * L.ni;      // block b: [k][j], k < h2, j < Nz - 1
  L.b3 = o;   o += 3 * L.ni;
  L.Krow = o; o += L.F;
  L.w1 = o;   o += L.F;
  L.w2 = o;   o += L.F;
  L.n_weights = o - (L.KP - L.F) * L.NP1;
  o = round4(o);  // 16-byte alignment for the vector accesses below
  L.x = o;    o += L.F * Shape::TC;
  L.xa = o;   o += L.KP * Shape::TC;
  L.xb = o;   o += L.KP * Shape::TC;
  L.acc = o;  o += L.F * Shape::TC;
  L.part = o; o += L.S * Shape::NCG * L.NP1 * 4;  // [chunk][column group][neuron % 4][neuron / 4][4 columns]
  L.a1 = o;   o += 3 * L.A1P * Shape::TC;
  L.a2 = o;   o += 3 * L.A2P * Shape::TC;
  L.flux = o; o += L.F * Shape::TC;
  L.nu = o;   o += L.ni * Shape::TC;
  L.n_smem = o;
  return L;
}


// Layer-1 unit u = (kc, cg, ng): neurons 4 ng..4 ng+3 (padded numbering) x columns
// 4 cg..4 cg+3, summed over k in chunk kc.
struct Unit1 {
  int kc, cg, ng;
};
__device__ __forceinline__ Unit1 layer1_unit(int u, const Layout& L) {
  const int per_chunk = Shape::NCG * L.NG1;
  const int kc = u / per_chunk;
  const int r = u - kc * per_chunk;
  const int cg = r / L.NG1;
  return Unit1{kc, cg, r - cg * L.NG1};
}

__device__ __forceinline__ void fma4x4(float (&a)[4][4], const float4& w, const float4& v) {
  const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i][0] = fmaf(v.x, wv[i], a[i][0]);
    a[i][1] = fmaf(v.y, wv[i], a[i][1]);
    a[i][2] = fmaf(v.z, wv[i], a[i][2]);
    a[i][3] = fmaf(v.w, wv[i], a[i][3]);
  }
}

__device__ __forceinline__ void store_partials(float* __restrict__ part, const float (&a)[4][4], const Unit1& t,
                                               const Layout& L) {
  // Adjacent lanes (adjacent ng) write adjacent 16 bytes: no bank conflict.
  float* pp = part + ((t.kc * Shape::NCG + t.cg) * 4 * L.NG1 + t.ng) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) st4(pp + i * L.NG1 * 4, make_float4(a[i][0], a[i][1], a[i][2], a[i][3]));
}

// Layer-1 partial sums with the weights read from shared memory (the generic widths).
__device__ __forceinline__ void layer1_partials(const float* __restrict__ xs, const float* __restrict__ W1,
                                                float* __restrict__ part, const Layout& L, int tid) {
  for (int u = tid; u < L.S * Shape::NCG * L.NG1; u += Shape::THREADS) {
    const Unit1 t = layer1_unit(u, L);
    const int k0 = t.kc * L.chunk;
    float a[4][4] = {};
    const float* wp = W1 + k0 * L.NP1 + 4 * t.ng;
    const float* xp = xs + k0 * Shape::TC + 4 * t.cg;
#pragma unroll 4
    for (int k = 0; k < L.chunk; ++k) fma4x4(a, ld4(wp + k * L.NP1), ld4(xp + k * Shape::TC));
    store_partials(part, a, t, L);
  }
}

// Reduce-scatter of 4 column sums over the KS lanes of a unit (adjacent lanes): on
// return lane kl holds the sums of columns kl (4 / KS) .. kl (4 / KS) + 4 / KS - 1 in
// a[0 .. 4 / KS - 1]. Every lane of the warp calls it.
template <int KS>
__device__ __forceinline__ void reduce_scatter(float (&a)[4], int kl) {
  if constexpr (KS == 4) {
    const bool hi = kl & 2;
    const float s0 = hi ? a[0] : a[2], s1 = hi ? a[1] : a[3];
    float k0 = hi ? a[2] : a[0], k1 = hi ? a[3] : a[1];
    k0 += __shfl_xor_sync(FULL_MASK, s0, 2);
    k1 += __shfl_xor_sync(FULL_MASK, s1, 2);
    const bool lo = kl & 1;
    const float s = lo ? k0 : k1;
    a[0] = (lo ? k1 : k0) + __shfl_xor_sync(FULL_MASK, s, 1);
  } else if constexpr (KS == 2) {
    const bool lo = kl & 1;
    const float s0 = lo ? a[0] : a[2], s1 = lo ? a[1] : a[3];
    const float k0 = lo ? a[2] : a[0], k1 = lo ? a[3] : a[1];
    a[0] = k0 + __shfl_xor_sync(FULL_MASK, s0, 1);
    a[1] = k1 + __shfl_xor_sync(FULL_MASK, s1, 1);
  }
}

// Row k of a layer's input holds feature row_feature(k, RP): the feature itself (RP = 0), or
// for layer 2 (RP = h1 padded to 4, over 4) the i-major order of the reduction's stores,
// row i RP + q = neuron 4 q + i, so that those stores do not conflict.
__device__ __forceinline__ int row_feature(int k, int RP) { return RP ? 4 * (k % RP) + k / RP : k; }

// One block of a block-diagonal layer for the group's MLP: y[n][c] = sum_k in[k][c] W[f(k)][n]
// for n < N, c < TC, over the KR rows k of `in` (whole K chunks, zero where f(k) = row_feature
// is K or more), feature-major in and out. A unit is (column group cg, neuron n) with KS
// lanes, lane kl adding over its chunk of rows; they add up by reduce_scatter and
// epi(n, c0, a) takes the lane's 4 / KS columns c0.. in a[0..]. Every thread of the group
// runs the same number of rounds. With CH > 0 (the widths of their own instantiation: one
// round, chunks of CH rows) the lane's weights come from wr, loaded once by group_weights;
// with CH = 0 from W in shared memory.
template <int KS>
struct GroupUnit {
  int kl, cg, n;
  bool active;
  __device__ __forceinline__ GroupUnit(int gt, int r, int N) {
    const int u = gt / KS + r * (Shape::GT / KS);
    kl = gt % KS;
    active = u < Shape::NCG * N;
    cg = u % Shape::NCG;  // the fastest index: adjacent lanes, adjacent columns
    n = active ? u / Shape::NCG : 0;
  }
};

template <int KS, int CH>
__device__ __forceinline__ void group_weights(float (&wr)[CH], const float* __restrict__ W, int K, int N, int RP,
                                              int gt) {
  const GroupUnit<KS> g(gt, 0, N);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int f = row_feature(g.kl * CH + i, RP);
    wr[i] = g.active && f < K ? W[f * N + g.n] : 0.0f;
  }
}

template <int KS, int CH, class Epi>
__device__ __forceinline__ void group_layer(const float* __restrict__ in, const float* __restrict__ W,
                                            const float (&wr)[CH > 0 ? CH : 1], int K, int KR, int N, int RP, int gt,
                                            Epi epi) {
  constexpr int UPR = Shape::GT / KS;  // units per round
  const int rounds = CH > 0 ? 1 : (Shape::NCG * N + UPR - 1) / UPR;
  const int kch = CH > 0 ? CH : KR / KS;
  for (int r = 0; r < rounds; ++r) {
    const GroupUnit<KS> g(gt, r, N);
    const int k0 = g.kl * kch;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* ip = in + k0 * Shape::TC + 4 * g.cg;
#pragma unroll 4
    for (int k = 0; k < kch; ++k) {
      float w;
      if constexpr (CH > 0) {
        w = wr[k];
      } else {
        const int f = row_feature(k0 + k, RP);
        w = g.active && f < K ? W[f * N + g.n] : 0.0f;
      }
      const float4 v = ld4(ip + k * Shape::TC);
      a[0] = fmaf(v.x, w, a[0]);
      a[1] = fmaf(v.y, w, a[1]);
      a[2] = fmaf(v.z, w, a[2]);
      a[3] = fmaf(v.w, w, a[3]);
    }
    reduce_scatter<KS>(a, g.kl);
    if (g.active) epi(g.n, 4 * g.cg + g.kl * (4 / KS), a);
  }
}

// NZ, H1, H2: the widths of this instantiation, or 0 to read them from
// the parameters (the flagship widths have their own, with this thread's layer-1 weights
// in registers for the whole launch and constant index arithmetic).
template <int NZ, int H1, int H2>
__global__ void __launch_bounds__(Shape::THREADS, Shape::BLOCKS)
fused_rk4_kernel(const float* __restrict__ x0, float* __restrict__ out, const float* __restrict__ weights,
                 const FusedRK4Params p) {
  constexpr int TC = Shape::TC, THREADS = Shape::THREADS, GT = Shape::GT, NCG = Shape::NCG;
  extern __shared__ __align__(16) float smem[];
  const int Nz = NZ ? NZ : p.Nz;
  const int h1 = H1 ? H1 : p.h1;
  const int h2 = H2 ? H2 : p.h2;
  const Layout L = make_layout(Nz, h1, h2);
  const int F = L.F, ni = L.ni;
  const int tid = threadIdx.x;
  const int grp = tid / GT, gt = tid - grp * GT;  // flux MLP / variable block of this thread's group
  const int col0 = blockIdx.x * TC;

  // Weights, then zero in W1's rows past F and in every work array (the padding rows are
  // read, never written).
  const int w1_end = L.F * L.NP1, w1_pad = (L.KP - L.F) * L.NP1;
  for (int i = tid; i < L.n_weights; i += THREADS) smem[i < w1_end ? i : i + w1_pad] = weights[i];
  for (int i = w1_end + tid; i < w1_end + w1_pad; i += THREADS) smem[i] = 0.0f;
  for (int i = L.x + tid; i < L.n_smem; i += THREADS) smem[i] = 0.0f;
  __syncthreads();
  float* x = smem + L.x;
  float* acc = smem + L.acc;
  float* part = smem + L.part;
  float* flux = smem + L.flux;
  float* nu = smem + L.nu;
  const float* W1 = smem + L.W1;
  // The group's own blocks of the weights and activations.
  const float* b1 = smem + L.b1 + grp * h1;
  const float* W2 = smem + L.W2 + grp * h1 * h2;
  const float* b2 = smem + L.b2 + grp * h2;
  const float* W3 = smem + L.W3 + grp * h2 * ni;
  const float* b3 = smem + L.b3 + grp * ni;
  const float* Krow = smem + L.Krow;
  const float* w1 = smem + L.w1;
  const float* w2 = smem + L.w2;
  float* a1g = smem + L.a1 + grp * L.A1P * TC;
  float* a2g = smem + L.a2 + grp * L.A2P * TC;

  // The flagship instantiation has one layer-1 unit per thread (units <= THREADS), CH1
  // rows of 4 neurons, and holds the first REG1 of those rows in registers for the whole
  // launch (one 16-byte shared-memory load per 16 FMAs there, two elsewhere).
  constexpr bool kRegs = NZ != 0;
  constexpr Layout LC = make_layout(kRegs ? NZ : 1, kRegs ? H1 : 1, kRegs ? H2 : 1);
  constexpr int CH1 = kRegs ? LC.chunk : 1;
  constexpr int REG1 = REG1_ROWS < CH1 ? REG1_ROWS : CH1;
  static_assert(!kRegs || LC.S * NCG * LC.NG1 <= THREADS, "the register path takes one layer-1 unit per thread");
  float4 w1r[REG1 > 0 ? REG1 : 1];
  // Layer 2's weights too: one round, chunks of CH2 rows.
  constexpr int CH2 = kRegs ? LC.A1P / KS2 : 0;
  static_assert(CH2 == 0 || NCG * H2 <= GT / KS2, "the register path takes one round of layer 2");
  float w2r[CH2 > 0 ? CH2 : 1], w3r[1];
  const Unit1 u1 = layer1_unit(tid, L);
  const bool has_unit1 = tid < L.S * NCG * L.NG1;
  if constexpr (kRegs) {
#pragma unroll
    for (int kk = 0; kk < REG1; ++kk) {
      const int k = u1.kc * CH1 + kk;
      w1r[kk] = has_unit1 ? ld4(W1 + k * L.NP1 + 4 * u1.ng) : f4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if constexpr (CH2 > 0) group_weights<KS2, CH2>(w2r, W2, h1, h2, L.H1P / 4, gt);
  }

  // Load the tile transposed to [feature][column]; columns past the end are
  // zero (finite through every phase) and never written back.
  for (int item = tid; item < F * TC; item += THREADS) {
    const int c = item / F;
    const int l = item - c * F;
    const int col = col0 + c;
    const float v = col < p.n_columns ? x0[(size_t)col * F + l] : 0.0f;
    x[l * TC + c] = v;
    smem[L.xa + l * TC + c] = v;
  }
  __syncthreads();

  const float coef = flux_coefficient(grp, p);
  const float rdz = tendency_coefficient(grp, p);
  PHASE_CLOCKS_START
  float* xs = smem + L.xa;  // stage input being evaluated
  float* xn = smem + L.xb;  // next stage input
  for (int step = 0; step < p.n_steps; ++step) {
    for (int s = 0; s < 4; ++s) {
      // Every warp: layer-1 partial sums; nu from the last thread down.
      if constexpr (kRegs) {
        if (has_unit1) {
          float a[4][4] = {};
          const float* xp = xs + u1.kc * CH1 * TC + 4 * u1.cg;
          const float* wp = W1 + u1.kc * CH1 * L.NP1 + 4 * u1.ng;
#pragma unroll
          for (int kk = 0; kk < CH1; ++kk)
            fma4x4(a, kk < REG1 ? w1r[kk < REG1 ? kk : 0] : ld4(wp + kk * L.NP1), ld4(xp + kk * TC));
          store_partials(part, a, u1, L);
        }
      } else {
        layer1_partials(xs, W1, part, L, tid);
      }
      PHASE_MARK(0);
      for (int item = THREADS - 1 - tid; item < ni * TC; item += THREADS) {
        const int j = item / TC;
        const int c = item - j * TC;
        nu[item] = face_nu(xs[(j + 1) * TC + c] - xs[j * TC + c],
                           xs[(Nz + j + 1) * TC + c] - xs[(Nz + j) * TC + c],
                           xs[(2 * Nz + j + 1) * TC + c] - xs[(2 * Nz + j) * TC + c], p);
      }
      PHASE_MARK(1);
      __syncthreads();
      PHASE_MARK(2);

      // Group grp from here to the end of the stage: a1 = act(sum of partials + b1).
      // Item t: column group t % NCG, neuron 4 q + i of the MLP (q < H1P / 4, i < 4)
      // with t / NCG = i H1P / 4 + q, stored to row t / NCG of a1 (row_feature's order):
      // adjacent lanes read and write adjacent 16 bytes.
      const int ngm = L.H1P / 4;
      for (int t = gt; t < NCG * L.H1P; t += GT) {
        const int cg = t % NCG, r = t / NCG;
        const int i = r / ngm, q = r - i * ngm;
        const int j = 4 * q + i;
        if (j >= h1) continue;
        const float* pp = part + ((cg * 4 + i) * L.NG1 + grp * ngm + q) * 4;
        float4 y = ld4(pp);
        for (int kc = 1; kc < L.S; ++kc) {
          const float4 q4 = ld4(pp + kc * NCG * L.NP1 * 4);
          y.x += q4.x;
          y.y += q4.y;
          y.z += q4.z;
          y.w += q4.w;
        }
        st4(a1g + r * TC + 4 * cg, activate4(y, b1[j], p.activation));
      }
      group_sync(1 + grp, GT);
      PHASE_MARK(3);
      // a2 = act(a1 @ A2_grp + b2).
      group_layer<KS2, CH2>(a1g, W2, w2r, h1, L.A1P, h2, ngm, gt, [&](int n, int c, const float(&y)[4]) {
        a2g[n * TC + c] = activate(y[0] + b2[n], p.activation);
      });
      group_sync(1 + grp, GT);
      PHASE_MARK(4);
      // Total interior face fluxes = a2 @ A3_grp + b3 - mPP.
      group_layer<KS3, 0>(a2g, W3, w3r, h2, L.A2P, ni, 0, gt, [&](int j, int c, const float(&y)[4]) {
        const int l = grp * Nz + j;
        const float2 xl = ld2(xs + l * TC + c), xu = ld2(xs + (l + 1) * TC + c), nv = ld2(nu + j * TC + c);
        st2(flux + l * TC + c, make_float2((y[0] + b3[j]) - coef * (nv.x * (xu.x - xl.x)),
                                           (y[1] + b3[j]) - coef * (nv.y * (xu.y - xl.y))));
      });
      group_sync(1 + grp, GT);
      PHASE_MARK(5);
      // Tendency (divergence stencil + Coriolis + Krow) and the RK4 update of
      // this stage on the group's lanes, 4 columns per item.
      for (int i = gt; i < NCG * Nz; i += GT) {
        const int cg = i % NCG;  // adjacent lanes, adjacent 16 bytes
        const int k = i / NCG;
        const int l = grp * Nz + k;
        const int lp = l + Nz < F ? l + Nz : l + Nz - F;  // roll(x, -Nz)
        const int lm = l >= Nz ? l - Nz : l - Nz + F;     // roll(x, +Nz)
        const int o = l * TC + 4 * cg;
        const float4 fk = k <= Nz - 2 ? ld4(flux + o) : f4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 fkm1 = k >= 1 ? ld4(flux + o - TC) : f4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 xp = ld4(xs + lp * TC + 4 * cg);
        const float4 xm = ld4(xs + lm * TC + 4 * cg);
        const float4 xv = ld4(x + o);
        float4 av = ld4(acc + o);
        const float wa = w1[l], wb = w2[l], kr = Krow[l];
        float4 xnew;
        xnew.x = rk4_update(s, xv.x, rdz * (fkm1.x - fk.x) + (wa * xp.x + wb * xm.x) + kr, av.x, p);
        xnew.y = rk4_update(s, xv.y, rdz * (fkm1.y - fk.y) + (wa * xp.y + wb * xm.y) + kr, av.y, p);
        xnew.z = rk4_update(s, xv.z, rdz * (fkm1.z - fk.z) + (wa * xp.z + wb * xm.z) + kr, av.z, p);
        xnew.w = rk4_update(s, xv.w, rdz * (fkm1.w - fk.w) + (wa * xp.w + wb * xm.w) + kr, av.w, p);
        if (s < 3) st4(acc + o, av);
        else st4(x + o, xnew);
        st4(xn + o, xnew);
      }
      PHASE_MARK(6);
      __syncthreads();
      PHASE_MARK(7);
      float* t = xs;
      xs = xn;
      xn = t;
    }
  }

  PHASE_CLOCKS_STORE
  for (int item = tid; item < F * TC; item += THREADS) {
    const int c = item / F;
    const int l = item - c * F;
    const int col = col0 + c;
    if (col < p.n_columns) out[(size_t)col * F + l] = x[l * TC + c];
  }
}

bool is_flagship(int Nz, int h1, int h2) { return Nz == 32 && h1 == 50 && h2 == 20; }

int smem_bytes(int Nz, int h1, int h2) { return make_layout(Nz, h1, h2).n_smem * (int)sizeof(float); }

#ifndef CSRC_HOST_EMULATION
template <int NZ, int H1, int H2>
cudaError_t launch_widths(const float* x0, float* out, const float* weights, const FusedRK4Params& p, int smem,
                          cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(fused_rk4_kernel<NZ, H1, H2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (p.n_columns + Shape::TC - 1) / Shape::TC;
  fused_rk4_kernel<NZ, H1, H2><<<grid, Shape::THREADS, smem, stream>>>(x0, out, weights, p);
  return cudaGetLastError();
}
#endif

}  // namespace

extern "C" {

int fused_rk4_columns_per_block() { return Shape::TC; }

int fused_rk4_threads_per_block() { return Shape::THREADS; }

int fused_rk4_smem_bytes(int Nz, int h1, int h2) { return smem_bytes(Nz, h1, h2); }

int fused_rk4_weight_count(int Nz, int h1, int h2) { return make_layout(Nz, h1, h2).n_weights; }

// 1 where the widths have their own instantiation, 0 where the generic one runs.
int fused_rk4_specialized(int Nz, int h1, int h2) { return is_flagship(Nz, h1, h2) ? 1 : 0; }

#if defined(FUSED_RK4_PHASE_CLOCKS) && !defined(CSRC_HOST_EMULATION)
// Phase cycles of the last launch (thread 0 of CTA 0): layer-1 partials, nu, the CTA
// barrier, reduction + mish, layer 2, layer 3, the RK4 update, the CTA barrier.
int fused_rk4_phase_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks));
}
#endif

#ifndef CSRC_HOST_EMULATION
const char* fused_rk4_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches on `stream` (a cudaStream_t) of device `device`; does not synchronise.
// Returns a cudaError_t: 0 when the launch was accepted.
int fused_rk4_launch(const float* x0, float* out, const float* weights, FusedRK4Params p, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.n_columns <= 0) return (int)cudaSuccess;
  const int smem = smem_bytes(p.Nz, p.h1, p.h2);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_flagship(p.Nz, p.h1, p.h2)) return (int)launch_widths<32, 50, 20>(x0, out, weights, p, smem, st);
  return (int)launch_widths<0, 0, 0>(x0, out, weights, p, smem, st);
}
#endif

}  // extern "C"
