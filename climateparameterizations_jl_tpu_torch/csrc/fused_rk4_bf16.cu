// Fused wind-mixing RHS + multi-step RK4 with bf16 NN products on the tensor cores.
//
// Replaces the Pallas TPU kernel climateparameterizations_jl_tpu/ops/fused_rhs.py:535
// (_compiled_multistep_mxu) with matmul_dtype="bfloat16": body _make_kernel_mxu (:499)
// over _make_mxu_rhs(matmul_dtype=jnp.bfloat16) (:399, the cast at :448-454), entry
// make_fused_runner_mxu(..., matmul_dtype="bfloat16") (:547, weights cast at :572-580).
// It computes what that kernel computes: n_steps of RK4 on the full right-hand side in
// one launch, the state read once and written once. Each of the three NN products rounds
// both of its inputs to bf16 (to nearest even, as astype and .to(torch.bfloat16) round)
// and accumulates in f32; everything else is f32 on the CUDA cores, with the activation
// and the face viscosity of fused_rk4.cu (fused_rk4_common.cuh; fused_rk4.cu stays the
// f32 kernel).
//
// What bounds it on an H100 (SXM, 700 W): operations, of two kinds on two units.
//   - Tensor cores: the three NN products, 4 x 2 x (96*150 + 3*50*20 + 3*20*31) =
//     154,080 FLOP per column-step at the flagship widths, 1.6156e11 FLOP for 1,024
//     columns x 1,024 steps: 0.163 ms at 989 TFLOP/s (bf16, dense).
//   - CUDA cores: the work outside the products, counted from the function (the plain
//     version's arithmetic) per column and RHS evaluation (an FMA is 2, an
//     expf/log1pf/tanhf or a division 1): the face
//     viscosity 18 per face, bias adds, mish 7 per activation, the mPP term 4 per face
//     flux, the divergence stencil + Coriolis + BC row 7 per lane, and 13 per lane and
//     step for RK4. At the flagship widths 14,748 FLOP per column-step, 1.55e10 for the
//     trajectory: 0.231 ms at 67 TFLOP/s (f32). Counting a transcendental as one
//     operation makes this a lower bound. (chip_smoke.py computes both from the shapes.)
//   So the element-wise f32 work, not the tensor cores, bounds this kernel by the count.
//   In practice it is the chain of dependent phases per RHS (products, mish, barriers) and
//   the shared-memory instructions that feed them (fused_rk4.cu says what they cost).
//
// Design:
//   - One CTA per tile of TC columns (8 or 16), WARPS warps (a multiple of 3), all
//     n_steps inside the kernel. In every product the weights are the MMA's A operand
//     (M = output neurons, 16 per tile) and the columns its N side (8 per tile), K = input
//     features: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. So 8 columns fill a
//     whole MMA and 1,024 columns give 128 CTAs for the 132 SMs. The compiled launch
//     shapes are SHAPE_COLUMNS x SHAPE_WARPS below; the first is the default, the
//     fastest in the sweep of chip_smoke.py phase 20 (PERF.md).
//   - Per RHS evaluation: every warp takes a share of layer 1 (one 16-neuron m-tile per
//     warp, its k-tiles in two independent MMA chains, the bias + mish + bf16 round in
//     registers) or of the face viscosity nu (from the last thread down; nu depends only
//     on the stage input). After one CTA-wide barrier the three flux MLPs are
//     independent (A2 and A3 are block-diagonal, and the divergence stencil of variable b
//     reads only MLP b's fluxes): the warps of group b = warp / (WARPS / 3) run MLP b's
//     layer 2, layer 3 with the mPP term, and the tendency + RK4 update of lanes
//     [b Nz, (b+1) Nz) over all of the group's threads, synchronised by the named barrier
//     1 + b. So an RHS costs two CTA-wide barriers and two named ones.
//   - mish in one expf and one reciprocal, without a branch, the Richardson number by the
//     written-out reciprocal rcp_rn (fused_rk4_common.cuh).
//   - A2 and A3 are used as their three diagonal blocks, each a product of its own; K
//     and M are zero-padded to whole 16 x 16 tiles (150 -> 160 neurons for layer 1,
//     50 -> 64 and 20 -> 32 per block), which gives the same sums as the dense packed
//     matrices with their zeros.
//   - Weight fragments are arranged on the host (ops/_cuda.py::mma_a_fragments) in
//     per-lane register order, staged in shared memory once per CTA, and re-read from
//     shared memory (one 16-byte load per MMA) at every use (held in registers on a
//     12-warp shape they ran no faster on the H100).
//   - The products' inputs live in bf16 [column][feature] buffers whose row pitch is 4
//     (mod 8) words, so the 32-bit B-fragment loads of a warp hit 32 different banks.
//     The state, its RK4 accumulator, the face fluxes and nu are f32 [column][lane].
//   - The kernel is a template on the launch shape and on (Nz, h1, h2): the flagship
//     widths have their own instantiation (constant index arithmetic; the RK4 update on 4
//     adjacent lanes per item, 16-byte accesses), any other width the generic one.
//   - Every loop bound is uniform across the CTA (phase 1) or the group (the rest), so
//     every thread reaches every barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "fused_rk4_common.cuh"

namespace {

// Launch shapes (columns, warps per CTA); index 0 is the default.
constexpr int N_SHAPES = 3;
constexpr int SHAPE_COLUMNS[N_SHAPES] = {8, 8, 16};
constexpr int SHAPE_WARPS[N_SHAPES] = {18, 12, 18};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Tile counts, buffer offsets and shared-memory layout for one model width.
struct Layout {
  int F, ni;
  int KT1, MT1, KT2, MT2, KT3, MT3;     // k- and m-tiles of products 1-3 (2 and 3: per block)
  int K2p, K3p;                         // padded K per block of products 2 and 3
  int fA1, fA2, fA3, n_frag;            // weight fragments, in 16-byte units (8 bf16)
  int b1, b2, b3, Krow, w1, w2, n_vec;  // f32 rows, in floats (the packed buffer's order)
  int sKrow, sw1, sw2, n_svec;          // Krow, w1, w2 in shared memory, from a 16-byte boundary
  int FP, NP, PB1, PB2, PB3;            // row pitches: f32 state/flux, nu; bf16 inputs of products 1-3
  int s_frag, s_vec, s_x, s_xa, s_xb, s_acc, s_flux, s_nu, s_in1, s_in2, s_in3, n_smem;  // bytes
};

__host__ __device__ inline Layout make_layout(int Nz, int h1, int h2, int tc) {
  Layout L;
  L.F = 3 * Nz;
  L.ni = Nz - 1;
  L.KT1 = cdiv(L.F, 16);
  L.MT1 = cdiv(3 * h1, 16);
  L.KT2 = cdiv(h1, 16);
  L.MT2 = cdiv(h2, 16);
  L.KT3 = cdiv(h2, 16);
  L.MT3 = cdiv(L.ni, 16);
  L.K2p = 16 * L.KT2;
  L.K3p = 16 * L.KT3;
  int o = 0;
  L.fA1 = o;  o += L.MT1 * L.KT1 * 32;
  L.fA2 = o;  o += 3 * L.MT2 * L.KT2 * 32;
  L.fA3 = o;  o += 3 * L.MT3 * L.KT3 * 32;
  L.n_frag = o;
  o = 0;
  L.b1 = o;   o += 3 * h1;
  L.b2 = o;   o += 3 * h2;
  L.b3 = o;   o += 3 * L.ni;
  L.Krow = o; o += L.F;
  L.w1 = o;   o += L.F;
  L.w2 = o;   o += L.F;
  L.n_vec = o;
  L.sKrow = (L.Krow + 3) & ~3;
  L.sw1 = L.sKrow + L.F;
  L.sw2 = L.sw1 + L.F;
  L.n_svec = L.sw2 + L.F;
  L.FP = 8 * cdiv(L.F, 8) + 4;
  L.NP = 8 * cdiv(L.ni, 8) + 4;
  L.PB1 = 16 * L.KT1 + 8;
  L.PB2 = 3 * L.K2p + 8;
  L.PB3 = 3 * L.K3p + 8;
  o = 0;  // every region below starts on a 16-byte boundary
  L.s_frag = o; o += 16 * L.n_frag;
  L.s_vec = o;  o += 4 * ((L.n_svec + 3) & ~3);
  L.s_x = o;    o += 4 * tc * L.FP;
  L.s_xa = o;   o += 4 * tc * L.FP;
  L.s_xb = o;   o += 4 * tc * L.FP;
  L.s_acc = o;  o += 4 * tc * L.FP;
  L.s_flux = o; o += 4 * tc * L.FP;
  L.s_nu = o;   o += 4 * tc * L.NP;
  L.s_in1 = o;  o += 2 * tc * L.PB1;
  L.s_in2 = o;  o += 2 * tc * L.PB2;
  L.s_in3 = o;  o += 2 * tc * L.PB3;
  L.n_smem = o;
  return L;
}

// d += A (16 x 16, bf16) . B (16 x 8, bf16), f32 accumulators.
#ifndef CSRC_HOST_EMULATION
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}
#endif

// Two floats rounded to bf16 (to nearest even), the first in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// One 16-neuron x 8-column output tile over KT k-tiles, in two independent MMA chains
// (even and odd k-tiles) added at the end. `frag` is the m-tile's first k-tile of weight
// fragments; `in` points at this lane's column row of the input buffer, at the product's
// first feature plus 2 (lane % 4). On return d[2h + e] holds neuron (lane / 4) + 8 h of
// the tile, column 2 (lane % 4) + e.
__device__ __forceinline__ void tile_product(float (&d)[4], const uint4* __restrict__ frag, int KT,
                                             const __nv_bfloat16* __restrict__ in, int lane) {
  float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  int kt = 0;
  for (; kt + 1 < KT; kt += 2) {
    const uint4 a0 = frag[kt * 32 + lane];
    const uint4 a1 = frag[(kt + 1) * 32 + lane];
    const __nv_bfloat16* i0 = in + 16 * kt;
    mma_bf16(d, a0, *reinterpret_cast<const uint32_t*>(i0), *reinterpret_cast<const uint32_t*>(i0 + 8));
    mma_bf16(e, a1, *reinterpret_cast<const uint32_t*>(i0 + 16), *reinterpret_cast<const uint32_t*>(i0 + 24));
  }
  if (kt < KT) {
    const __nv_bfloat16* i0 = in + 16 * kt;
    mma_bf16(d, frag[kt * 32 + lane], *reinterpret_cast<const uint32_t*>(i0),
             *reinterpret_cast<const uint32_t*>(i0 + 8));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += e[i];
}

// NZ, H1, H2: the widths of this instantiation, or 0 to read them from the parameters
// (the flagship widths have their own, so that its index arithmetic is constant).
template <int TC, int WARPS, int NZ, int H1, int H2>
__global__ void __launch_bounds__(WARPS * 32, 1)
fused_rk4_bf16_kernel(const float* __restrict__ x0, float* __restrict__ out, const float* __restrict__ vecs,
                      const uint4* __restrict__ frags, const FusedRK4Params p) {
  static_assert(TC % 8 == 0, "columns per CTA must be a multiple of the MMA's N = 8");
  static_assert(WARPS % 3 == 0, "warps per CTA must split into the three flux-MLP groups");
  constexpr int THREADS = WARPS * 32;
  constexpr int GW = WARPS / 3;  // warps per group
  constexpr int GT = GW * 32;
  constexpr int NT = TC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Nz = NZ ? NZ : p.Nz, h1 = H1 ? H1 : p.h1, h2 = H2 ? H2 : p.h2;
  const Layout L = make_layout(Nz, h1, h2, TC);
  const int F = L.F, ni = L.ni;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = warp / GW, gw = warp - grp * GW, gt = tid - grp * GT;  // flux MLP / variable block
  const int col0 = blockIdx.x * TC;

  uint4* fr = reinterpret_cast<uint4*>(smem + L.s_frag);
  float* vec = reinterpret_cast<float*>(smem + L.s_vec);
  float* x = reinterpret_cast<float*>(smem + L.s_x);
  float* acc = reinterpret_cast<float*>(smem + L.s_acc);
  float* flux = reinterpret_cast<float*>(smem + L.s_flux);
  float* nu = reinterpret_cast<float*>(smem + L.s_nu);
  __nv_bfloat16* in1 = reinterpret_cast<__nv_bfloat16*>(smem + L.s_in1);
  __nv_bfloat16* in2 = reinterpret_cast<__nv_bfloat16*>(smem + L.s_in2);
  __nv_bfloat16* in3 = reinterpret_cast<__nv_bfloat16*>(smem + L.s_in3);

  for (int i = tid; i < L.n_frag; i += THREADS) fr[i] = frags[i];
  for (int i = tid; i < L.n_vec; i += THREADS) vec[i < L.Krow ? i : i - L.Krow + L.sKrow] = vecs[i];
  // The bf16 input buffers start at zero: their K padding is never written.
  for (int i = tid; i < (L.n_smem - L.s_in1) / 4; i += THREADS) reinterpret_cast<uint32_t*>(smem + L.s_in1)[i] = 0u;
  __syncthreads();

  float* xs = reinterpret_cast<float*>(smem + L.s_xa);  // stage input being evaluated
  float* xn = reinterpret_cast<float*>(smem + L.s_xb);  // next stage input
  // Columns past the end are zero (finite through every phase) and never written back.
  for (int item = tid; item < TC * F; item += THREADS) {
    const int c = item / F;
    const int l = item - c * F;
    const int col = col0 + c;
    const float v = col < p.n_columns ? x0[(size_t)col * F + l] : 0.0f;
    x[c * L.FP + l] = v;
    xs[c * L.FP + l] = v;
    in1[c * L.PB1 + l] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // The group's own blocks of the biases.
  const float* b2 = vec + L.b2 + grp * h2;
  const float* b3 = vec + L.b3 + grp * ni;
  const float coef = flux_coefficient(grp, p);
  const float rdz = tendency_coefficient(grp, p);
  PHASE_CLOCKS_START
  for (int step = 0; step < p.n_steps; ++step) {
    for (int s = 0; s < 4; ++s) {
      // Every warp: a1 = act(bf16(xs) @ bf16(A1) + b1), rounded to bf16 into in2 (each
      // MLP's h1 neurons in their own 16-aligned block of K2p features); nu from the last
      // thread down.
      for (int u = warp; u < L.MT1 * NT; u += WARPS) {
        const int mt = u / NT, nt = u - mt * NT;
        float d[4];
        tile_product(d, fr + L.fA1 + mt * L.KT1 * 32, L.KT1, in1 + (nt * 8 + g) * L.PB1 + 2 * t4, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m < 3 * h1) {
            const int blk = (m >= h1) + (m >= 2 * h1);
            const float bias = vec[L.b1 + m];
            const int k = blk * L.K2p + m - blk * h1;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = nt * 8 + 2 * t4 + e;
              in2[c * L.PB2 + k] = __float2bfloat16_rn(activate(d[2 * h + e] + bias, p.activation));
            }
          }
        }
      }
      PHASE_MARK(0);
      for (int item = THREADS - 1 - tid; item < ni * TC; item += THREADS) {
        const int c = item / ni;
        const int j = item - c * ni;
        const float* xr = xs + c * L.FP;
        nu[c * L.NP + j] = face_nu(xr[j + 1] - xr[j], xr[Nz + j + 1] - xr[Nz + j],
                                   xr[2 * Nz + j + 1] - xr[2 * Nz + j], p);
      }
      PHASE_MARK(1);
      __syncthreads();
      PHASE_MARK(2);

      // Group grp from here to the end of the stage: a2 = act(a1 @ A2_grp + b2) into in3.
      for (int u = gw; u < L.MT2 * NT; u += GW) {
        const int mt = u / NT, nt = u - mt * NT;
        float d[4];
        tile_product(d, fr + L.fA2 + (grp * L.MT2 + mt) * L.KT2 * 32, L.KT2,
                     in2 + (nt * 8 + g) * L.PB2 + grp * L.K2p + 2 * t4, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m < h2) {
            const float bias = b2[m];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = nt * 8 + 2 * t4 + e;
              in3[c * L.PB3 + grp * L.K3p + m] = __float2bfloat16_rn(activate(d[2 * h + e] + bias, p.activation));
            }
          }
        }
      }
      group_sync(1 + grp, GT);
      PHASE_MARK(4);
      // Total interior face fluxes = a2 @ A3_grp + b3 - mPP.
      for (int u = gw; u < L.MT3 * NT; u += GW) {
        const int mt = u / NT, nt = u - mt * NT;
        float d[4];
        tile_product(d, fr + L.fA3 + (grp * L.MT3 + mt) * L.KT3 * 32, L.KT3,
                     in3 + (nt * 8 + g) * L.PB3 + grp * L.K3p + 2 * t4, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = mt * 16 + g + 8 * h;
          if (j < ni) {
            const float bias = b3[j];
            const int l = grp * Nz + j;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = nt * 8 + 2 * t4 + e;
              const float* xr = xs + c * L.FP;
              flux[c * L.FP + l] = (d[2 * h + e] + bias) - coef * (nu[c * L.NP + j] * (xr[l + 1] - xr[l]));
            }
          }
        }
      }
      group_sync(1 + grp, GT);
      PHASE_MARK(5);
      // Tendency (divergence stencil + Coriolis + Krow) and the RK4 update of this stage
      // on the group's lanes; the next stage input also goes to in1 as bf16. With Nz a
      // multiple of 4 (the flagship instantiation) an item is 4 adjacent lanes of one
      // column: 16-byte accesses, adjacent items on adjacent 16 bytes.
      if constexpr (NZ != 0 && NZ % 4 == 0) {
        constexpr int NQ = NZ / 4;
        for (int item = gt; item < TC * NQ; item += GT) {
          const int c = item / NQ;
          const int k = 4 * (item - c * NQ);
          const int l = grp * NZ + k;
          const int i = c * L.FP + l;
          const int lp = l + NZ < F ? l + NZ : l + NZ - F;  // roll(x, -Nz)
          const int lm = l >= NZ ? l - NZ : l - NZ + F;     // roll(x, +Nz)
          const float* xr = xs + c * L.FP;
          float4 fk = ld4(flux + i);
          if (k + 3 == NZ - 1) fk.w = 0.0f;  // no interior face above the top lane
          const float fkm = k >= 1 ? flux[i - 1] : 0.0f;
          const float4 xp = ld4(xr + lp), xm = ld4(xr + lm), xv = ld4(x + i);
          const float4 wa = ld4(vec + L.sw1 + l), wb = ld4(vec + L.sw2 + l), kr = ld4(vec + L.sKrow + l);
          float4 av = ld4(acc + i), xnew;
          xnew.x = rk4_update(s, xv.x, rdz * (fkm - fk.x) + (wa.x * xp.x + wb.x * xm.x) + kr.x, av.x, p);
          xnew.y = rk4_update(s, xv.y, rdz * (fk.x - fk.y) + (wa.y * xp.y + wb.y * xm.y) + kr.y, av.y, p);
          xnew.z = rk4_update(s, xv.z, rdz * (fk.y - fk.z) + (wa.z * xp.z + wb.z * xm.z) + kr.z, av.z, p);
          xnew.w = rk4_update(s, xv.w, rdz * (fk.z - fk.w) + (wa.w * xp.w + wb.w * xm.w) + kr.w, av.w, p);
          if (s < 3) st4(acc + i, av);
          else st4(x + i, xnew);
          st4(xn + i, xnew);
          *reinterpret_cast<uint2*>(in1 + c * L.PB1 + l) =
              make_uint2(bf16_pair(xnew.x, xnew.y), bf16_pair(xnew.z, xnew.w));
        }
      } else {
        for (int item = gt; item < TC * Nz; item += GT) {
          const int c = item / Nz;
          const int k = item - c * Nz;
          const int l = grp * Nz + k;
          const int i = c * L.FP + l;
          const float fk = k <= Nz - 2 ? flux[i] : 0.0f;
          const float fkm1 = k >= 1 ? flux[i - 1] : 0.0f;
          const int lp = l + Nz < F ? l + Nz : l + Nz - F;  // roll(x, -Nz)
          const int lm = l >= Nz ? l - Nz : l - Nz + F;     // roll(x, +Nz)
          const float* xr = xs + c * L.FP;
          const float cor = vec[L.sw1 + l] * xr[lp] + vec[L.sw2 + l] * xr[lm];
          const float tend = rdz * (fkm1 - fk) + cor + vec[L.sKrow + l];
          float a = acc[i];
          const float xnew = rk4_update(s, x[i], tend, a, p);
          if (s < 3) acc[i] = a;
          else x[i] = xnew;
          xn[i] = xnew;
          in1[c * L.PB1 + l] = __float2bfloat16_rn(xnew);
        }
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
  for (int item = tid; item < TC * F; item += THREADS) {
    const int c = item / F;
    const int l = item - c * F;
    const int col = col0 + c;
    if (col < p.n_columns) out[(size_t)col * F + l] = x[c * L.FP + l];
  }
}

bool is_flagship(int Nz, int h1, int h2) { return Nz == 32 && h1 == 50 && h2 == 20; }

#ifndef CSRC_HOST_EMULATION
template <int TC, int WARPS>
cudaError_t launch_shape(const float* x0, float* out, const float* vecs, const uint4* frags,
                         const FusedRK4Params& p, cudaStream_t stream) {
  const int smem = make_layout(p.Nz, p.h1, p.h2, TC).n_smem;
  const bool flagship = is_flagship(p.Nz, p.h1, p.h2);
  const void* kernel = flagship ? (const void*)fused_rk4_bf16_kernel<TC, WARPS, 32, 50, 20>
                                : (const void*)fused_rk4_bf16_kernel<TC, WARPS, 0, 0, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (p.n_columns + TC - 1) / TC;
  if (flagship)
    fused_rk4_bf16_kernel<TC, WARPS, 32, 50, 20><<<grid, WARPS * 32, smem, stream>>>(x0, out, vecs, frags, p);
  else
    fused_rk4_bf16_kernel<TC, WARPS, 0, 0, 0><<<grid, WARPS * 32, smem, stream>>>(x0, out, vecs, frags, p);
  return cudaGetLastError();
}
#endif

}  // namespace

extern "C" {

int fused_rk4_bf16_shape_count() { return N_SHAPES; }

int fused_rk4_bf16_shape_columns(int shape) { return SHAPE_COLUMNS[shape]; }

int fused_rk4_bf16_shape_warps(int shape) { return SHAPE_WARPS[shape]; }

int fused_rk4_bf16_smem_bytes(int Nz, int h1, int h2, int shape) {
  return make_layout(Nz, h1, h2, SHAPE_COLUMNS[shape]).n_smem;
}

int fused_rk4_bf16_vec_count(int Nz, int h1, int h2) { return make_layout(Nz, h1, h2, 8).n_vec; }

// In bf16 elements (8 per 16-byte fragment unit).
int fused_rk4_bf16_frag_count(int Nz, int h1, int h2) { return 8 * make_layout(Nz, h1, h2, 8).n_frag; }

#if defined(FUSED_RK4_PHASE_CLOCKS) && !defined(CSRC_HOST_EMULATION)
// Phase cycles of the last launch (thread 0 of CTA 0): layer-1 tiles, nu, the CTA barrier,
// (unused), layer 2, layer 3, the RK4 update, the CTA barrier.
int fused_rk4_bf16_phase_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks));
}
#endif

#ifndef CSRC_HOST_EMULATION
const char* fused_rk4_bf16_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches launch shape `shape` on `stream` (a cudaStream_t) of device `device`; does not
// synchronise. Returns a cudaError_t: 0 when the launch was accepted.
int fused_rk4_bf16_launch(const float* x0, float* out, const float* vecs, const void* frags, FusedRK4Params p,
                          int shape, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.n_columns <= 0) return (int)cudaSuccess;
  const uint4* f = static_cast<const uint4*>(frags);
  cudaStream_t st = (cudaStream_t)stream;
  switch (shape) {
    case 0: return (int)launch_shape<SHAPE_COLUMNS[0], SHAPE_WARPS[0]>(x0, out, vecs, f, p, st);
    case 1: return (int)launch_shape<SHAPE_COLUMNS[1], SHAPE_WARPS[1]>(x0, out, vecs, f, p, st);
    case 2: return (int)launch_shape<SHAPE_COLUMNS[2], SHAPE_WARPS[2]>(x0, out, vecs, f, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

}  // extern "C"
