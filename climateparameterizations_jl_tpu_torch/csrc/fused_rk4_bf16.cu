// Fused wind-mixing RHS + multi-step RK4 with bf16 NN products on the tensor cores.
//
// Replaces the Pallas TPU kernel climateparameterizations_jl_tpu/ops/fused_rhs.py:535
// (_compiled_multistep_mxu) with matmul_dtype="bfloat16": body _make_kernel_mxu (:499)
// over _make_mxu_rhs(matmul_dtype=jnp.bfloat16) (:399, the cast at :448-454), entry
// make_fused_runner_mxu(..., matmul_dtype="bfloat16") (:547, weights cast at :572-580).
// It computes what that kernel computes: n_steps of RK4 on the full right-hand side in
// one launch, the state read once and written once. Each of the three NN products rounds
// both of its inputs to bf16 (to nearest even, as astype and .to(torch.bfloat16) round)
// and accumulates in f32; everything else is f32 on the CUDA cores with full-precision
// expf/log1pf/tanhf, as in fused_rk4.cu (which stays the f32 kernel).
//
// What bounds it on an H100 (SXM, 700 W): operations, of two kinds on two units.
//   - Tensor cores: the three NN products, 4 x 2 x (96*150 + 3*50*20 + 3*20*31) =
//     154,080 FLOP per column-step at the flagship widths, 1.6156e11 FLOP for 1,024
//     columns x 1,024 steps: 0.163 ms at 989 TFLOP/s (bf16, dense).
//   - CUDA cores: the work outside the products, counted from this source per column
//     and RHS evaluation (an FMA is 2, an expf/log1pf/tanhf or a division 1): the face
//     viscosity 18 per face, bias adds, mish 7 per activation, the mPP term 4 per face
//     flux, the divergence stencil + Coriolis + BC row 7 per lane, and 13 per lane and
//     step for RK4. At the flagship widths 14,748 FLOP per column-step, 1.55e10 for the
//     trajectory: 0.231 ms at 67 TFLOP/s (f32). Counting a transcendental as one
//     operation makes this a lower bound. (chip_smoke.py computes both from the shapes.)
//   So the element-wise f32 work, not the tensor cores, bounds this kernel, and mish
//   (210 activations per RHS, three transcendentals each) is most of it.
//
// Design:
//   - One CTA per tile of TC columns (8 or 16), WARPS warps, all n_steps inside the
//     kernel. In every product the weights are the MMA's A operand (M = output neurons,
//     16 per tile) and the columns its N side (8 per tile), K = input features:
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. So 8 columns fill a whole
//     MMA and 1,024 columns give 128 CTAs for the 132 SMs, where 16 columns on the
//     M side would give 64 (wgmma's 64-row tiles would give 16). The compiled launch
//     shapes are SHAPE_COLUMNS x SHAPE_WARPS below; the first is the default, the
//     fastest in the sweep of chip_smoke.py phase 20 (PERF.md).
//   - A2 and A3 are used as their three diagonal blocks, each a product of its own; K
//     and M are zero-padded to whole 16 x 16 tiles (150 -> 160 neurons for layer 1,
//     50 -> 64 and 20 -> 32 per block), which gives the same sums as the dense packed
//     matrices with their zeros.
//   - Weight fragments are arranged on the host (ops/_cuda.py::mma_a_fragments) in
//     per-lane register order, staged in shared memory once per CTA, and re-read from
//     shared memory (one 16-byte load per MMA) at every use rather than held in
//     registers for the trajectory: the tile counts are runtime values, so one build
//     serves every model width, as fused_rk4.cu does.
//   - The products' inputs live in bf16 [column][feature] buffers whose row pitch is 4
//     (mod 8) words, so the 32-bit B-fragment loads of a warp hit 32 different banks.
//     The state, its RK4 accumulator, the face fluxes and nu are f32 [column][lane].
//   - Each product's epilogue runs in registers: bias, activation, the round to bf16
//     into the next product's input buffer; the last product's epilogue forms the
//     total interior face flux (NN minus the mPP down-gradient term).
//   - Four phases per RHS evaluation, separated by __syncthreads(); every loop bound
//     is uniform across the block, so every thread reaches every barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// Must match ops/_cuda.py::_Params field by field (the same struct as fused_rk4.cu).
struct FusedRK4Params {
  int n_columns;
  int n_steps;
  int Nz;
  int h1;
  int h2;
  int activation;  // 0 = mish, 1 = relu
  float dt, half_dt, dt6;
  float epsdz, au, av, aT;  // Ri on raw differences
  float n_a, n_b, t_a, t_b;  // nu = n_a + n_b tanh(t_a Ri + t_b)
  float cu, cv, cT;          // mPP flux coefficients (1/dz folded in)
  float rdu, rdv, rdT;       // tendency coefficients R_b / dz
};

namespace {

// Launch shapes (columns, warps per CTA); index 0 is the default.
constexpr int N_SHAPES = 4;
constexpr int SHAPE_COLUMNS[N_SHAPES] = {8, 8, 16, 16};
constexpr int SHAPE_WARPS[N_SHAPES] = {10, 5, 10, 5};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Tile counts, buffer offsets and shared-memory layout for one model width.
struct Layout {
  int F, ni;
  int KT1, MT1, KT2, MT2, KT3, MT3;     // k- and m-tiles of products 1-3 (2 and 3: per block)
  int K2p, K3p;                         // padded K per block of products 2 and 3
  int fA1, fA2, fA3, n_frag;            // weight fragments, in 16-byte units (8 bf16)
  int b1, b2, b3, Krow, w1, w2, n_vec;  // f32 rows, in floats
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
  L.FP = 8 * cdiv(L.F, 8) + 4;
  L.NP = 8 * cdiv(L.ni, 8) + 4;
  L.PB1 = 16 * L.KT1 + 8;
  L.PB2 = 3 * L.K2p + 8;
  L.PB3 = 3 * L.K3p + 8;
  o = 0;  // every region below starts on a 16-byte boundary
  L.s_frag = o; o += 16 * L.n_frag;
  L.s_vec = o;  o += 4 * ((L.n_vec + 3) & ~3);
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

__device__ __forceinline__ float activate(float x, int kind) {
  if (kind == 1) return fmaxf(x, 0.0f);
  const float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

// d += A (16 x 16, bf16) . B (16 x 8, bf16), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One 16-neuron x 8-column output tile over KT k-tiles. `frag` is the m-tile's first
// k-tile of weight fragments; `in` points at this lane's column row of the input
// buffer, at the product's first feature plus 2 (lane % 4). On return d[2h + e] holds
// neuron (lane / 4) + 8 h of the tile, column 2 (lane % 4) + e.
__device__ __forceinline__ void tile_product(float (&d)[4], const uint4* __restrict__ frag, int KT,
                                             const __nv_bfloat16* __restrict__ in, int lane) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  for (int kt = 0; kt < KT; ++kt) {
    const uint4 a = frag[kt * 32 + lane];
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(in + 16 * kt);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(in + 16 * kt + 8);
    mma_bf16(d, a, b0, b1);
  }
}

// mPP face viscosity at interior face j of column c (raw differences d = x[k+1] - x[k]).
__device__ __forceinline__ void face_nu(const float* __restrict__ xs, float* __restrict__ nu,
                                        const FusedRK4Params& p, const Layout& L, int tc, int thread,
                                        int stride) {
  const int Nz = p.Nz, ni = L.ni;
  for (int item = thread; item < ni * tc; item += stride) {
    const int c = item / ni;
    const int j = item - c * ni;
    const float* xr = xs + c * L.FP;
    const float du = xr[j + 1] - xr[j];
    const float dv = xr[Nz + j + 1] - xr[Nz + j];
    const float dT = xr[2 * Nz + j + 1] - xr[2 * Nz + j];
    const float eu = du + p.epsdz;
    const float ev = dv + p.epsdz;
    const float eT = dT + p.epsdz;
    const float Ri = p.aT * eT / (p.au * eu * eu + p.av * ev * ev);
    nu[c * L.NP + j] = p.n_a + p.n_b * tanhf(p.t_a * Ri + p.t_b);
  }
}

template <int TC, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
fused_rk4_bf16_kernel(const float* __restrict__ x0, float* __restrict__ out, const float* __restrict__ vecs,
                      const uint4* __restrict__ frags, const FusedRK4Params p) {
  static_assert(TC % 8 == 0, "columns per CTA must be a multiple of the MMA's N = 8");
  constexpr int THREADS = WARPS * 32;
  constexpr int NT = TC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(p.Nz, p.h1, p.h2, TC);
  const int F = L.F, Nz = p.Nz, ni = L.ni, h1 = p.h1, h2 = p.h2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
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
  for (int i = tid; i < L.n_vec; i += THREADS) vec[i] = vecs[i];
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

  for (int step = 0; step < p.n_steps; ++step) {
    for (int s = 0; s < 4; ++s) {
      // Phase 1: a1 = act(bf16(xs) @ bf16(A1) + b1), rounded to bf16 into in2, each
      // MLP's h1 neurons in their own 16-aligned block of K2p features.
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
      __syncthreads();
      // Phase 2: a2 = act(a1 @ blockdiag(A2) + b2) into in3, and the face viscosity
      // (threads from the last one down take the nu items: the first warps have the
      // product's tiles).
      for (int u = warp; u < 3 * L.MT2 * NT; u += WARPS) {
        const int blk = u / (L.MT2 * NT), r = u - blk * L.MT2 * NT;
        const int mt = r / NT, nt = r - mt * NT;
        float d[4];
        tile_product(d, fr + L.fA2 + (blk * L.MT2 + mt) * L.KT2 * 32, L.KT2,
                     in2 + (nt * 8 + g) * L.PB2 + blk * L.K2p + 2 * t4, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          if (m < h2) {
            const float bias = vec[L.b2 + blk * h2 + m];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = nt * 8 + 2 * t4 + e;
              in3[c * L.PB3 + blk * L.K3p + m] = __float2bfloat16_rn(activate(d[2 * h + e] + bias, p.activation));
            }
          }
        }
      }
      face_nu(xs, nu, p, L, TC, THREADS - 1 - tid, THREADS);
      __syncthreads();
      // Phase 3: total interior face fluxes = a2 @ blockdiag(A3) + b3 - mPP.
      for (int u = warp; u < 3 * L.MT3 * NT; u += WARPS) {
        const int blk = u / (L.MT3 * NT), r = u - blk * L.MT3 * NT;
        const int mt = r / NT, nt = r - mt * NT;
        float d[4];
        tile_product(d, fr + L.fA3 + (blk * L.MT3 + mt) * L.KT3 * 32, L.KT3,
                     in3 + (nt * 8 + g) * L.PB3 + blk * L.K3p + 2 * t4, lane);
        const float coef = blk == 0 ? p.cu : (blk == 1 ? p.cv : p.cT);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = mt * 16 + g + 8 * h;
          if (j < ni) {
            const float bias = vec[L.b3 + blk * ni + j];
            const int l = blk * Nz + j;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = nt * 8 + 2 * t4 + e;
              const float* xr = xs + c * L.FP;
              const float dd = xr[l + 1] - xr[l];
              flux[c * L.FP + l] = (d[2 * h + e] + bias) - coef * (nu[c * L.NP + j] * dd);
            }
          }
        }
      }
      __syncthreads();
      // Phase 4: tendency (divergence stencil + Coriolis + Krow) and the RK4 update of
      // this stage; the next stage input also goes to in1 as bf16.
      for (int item = tid; item < TC * F; item += THREADS) {
        const int c = item / F;
        const int l = item - c * F;
        const int blk = l / Nz;
        const int k = l - blk * Nz;
        const float rdz = blk == 0 ? p.rdu : (blk == 1 ? p.rdv : p.rdT);
        const int i = c * L.FP + l;
        const float fk = k <= Nz - 2 ? flux[i] : 0.0f;
        const float fkm1 = k >= 1 ? flux[i - 1] : 0.0f;
        const int lp = l + Nz < F ? l + Nz : l + Nz - F;  // roll(x, -Nz)
        const int lm = l >= Nz ? l - Nz : l - Nz + F;     // roll(x, +Nz)
        const float* xr = xs + c * L.FP;
        const float cor = vec[L.w1 + l] * xr[lp] + vec[L.w2 + l] * xr[lm];
        const float tend = rdz * (fkm1 - fk) + cor + vec[L.Krow + l];
        const float xv = x[i];
        float xnew;
        if (s == 0) {
          acc[i] = tend;
          xnew = xv + p.half_dt * tend;
        } else if (s == 1) {
          acc[i] += 2.0f * tend;
          xnew = xv + p.half_dt * tend;
        } else if (s == 2) {
          acc[i] += 2.0f * tend;
          xnew = xv + p.dt * tend;
        } else {
          xnew = xv + p.dt6 * (acc[i] + tend);
          x[i] = xnew;
        }
        xn[i] = xnew;
        in1[c * L.PB1 + l] = __float2bfloat16_rn(xnew);
      }
      __syncthreads();
      float* t = xs;
      xs = xn;
      xn = t;
    }
  }

  for (int item = tid; item < TC * F; item += THREADS) {
    const int c = item / F;
    const int l = item - c * F;
    const int col = col0 + c;
    if (col < p.n_columns) out[(size_t)col * F + l] = x[c * L.FP + l];
  }
}

template <int TC, int WARPS>
cudaError_t launch_shape(const float* x0, float* out, const float* vecs, const uint4* frags,
                         const FusedRK4Params& p, cudaStream_t stream) {
  const int smem = make_layout(p.Nz, p.h1, p.h2, TC).n_smem;
  cudaError_t err = cudaFuncSetAttribute(fused_rk4_bf16_kernel<TC, WARPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (p.n_columns + TC - 1) / TC;
  fused_rk4_bf16_kernel<TC, WARPS><<<grid, WARPS * 32, smem, stream>>>(x0, out, vecs, frags, p);
  return cudaGetLastError();
}

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
    case 3: return (int)launch_shape<SHAPE_COLUMNS[3], SHAPE_WARPS[3]>(x0, out, vecs, f, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
