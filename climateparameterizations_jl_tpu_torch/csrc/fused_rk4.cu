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
// What bounds it on an H100: operations. Per column and RK4 step the three
// packed flux MLPs cost 4 x 2 x (96*150 + 3*50*20 + 3*20*31) = 154,080 f32
// FLOP of matmul alone, against 786 KB of state moved per trajectory of
// 1,024 columns, so the roofline is the f32 FMA rate of the CUDA cores.
// This first version keeps everything on chip and does not use the tensor
// cores (f32 throughout).
//
// Design:
//   - One CTA per tile of TC = 4 columns, all n_steps inside the kernel:
//     x is read once and written once per column. 1,024 columns give 256
//     CTAs of 5 warps, two per SM of the card's 132 (about 90 KB of shared
//     memory each). A launch-shape sweep on the H100 (700 W) measured
//     20.97 ms at 1,024 x 1,024 for this shape against 22.67 ms for 8
//     columns and 10 warps per CTA, 25.15 ms for 4 columns and 10 warps, and
//     28.03 ms for 8 columns and 20 warps: more warps per SM did not help,
//     fewer instructions per FMA did (PERF.md, Findings).
//   - Weights in dynamic shared memory: A1 (3Nz x 3h1) dense, A2 and A3 as
//     their three diagonal blocks (not the zero-padded packed matrices), then
//     the bias, Krow, w1 and w2 rows. The stage state, the RK4 accumulator
//     and every activation live in shared memory too, feature-major
//     ([feature][column]) so that a thread reads its columns as one vector.
//   - Each dense layer gives a thread one output neuron for CPT columns and
//     keeps CPT accumulators in registers (one shared-memory weight load per
//     CPT FMAs).
//   - The divergence matrix Dr is bidiagonal within each variable block, so
//     the tendency is a two-point stencil R_b/dz (F[k-1] - F[k]) rather than
//     a 96x96 matmul; Coriolis is the w1/w2 rows on the +-Nz lanes.
//   - Scalars come in by value (FusedRK4Params), so one build serves every
//     model and nothing is compiled per configuration.
//   - Four phases per RHS evaluation, separated by __syncthreads(); every
//     loop bound is uniform across the block, so every thread reaches every
//     barrier.
//   - Full-precision expf/log1pf/tanhf (no fast math); softplus is
//     max(x, 0) + log1p(exp(-|x|)), as jax.nn.softplus.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// Launch shape: columns per CTA, threads per CTA, and columns per thread in
// each of the three dense layers.
constexpr int TC = 4;
constexpr int THREADS = 160;  // 5 warps: the 150 layer-1 work items fit in one pass
constexpr int CPT[3] = {4, 2, 2};
constexpr int MIN_BLOCKS = 2;  // CTAs per SM the register budget must allow (256 CTAs on 132 SMs)
static_assert(TC % CPT[0] == 0 && TC % CPT[1] == 0 && TC % CPT[2] == 0, "CPT must divide TC");

}  // namespace

// Must match ops/_cuda.py::_Params field by field.
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

// Offsets (in floats) of each operand inside the packed weight buffer, and of
// each work array inside shared memory. The weight buffer's order is the one
// ops/_cuda.py::pack_weights writes.
struct Layout {
  int F, ni, H1, H2;  // 3Nz, Nz-1, 3h1, 3h2
  int A1, b1, A2, b2, A3, b3, Krow, w1, w2, n_weights;
  int x, xa, xb, acc, a1, a2, flux, nu, n_smem;
};

__host__ __device__ inline Layout make_layout(int Nz, int h1, int h2) {
  Layout L;
  L.F = 3 * Nz;
  L.ni = Nz - 1;
  L.H1 = 3 * h1;
  L.H2 = 3 * h2;
  int o = 0;
  L.A1 = o;   o += L.F * L.H1;
  L.b1 = o;   o += L.H1;
  L.A2 = o;   o += 3 * h1 * h2;
  L.b2 = o;   o += L.H2;
  L.A3 = o;   o += 3 * h2 * L.ni;
  L.b3 = o;   o += 3 * L.ni;
  L.Krow = o; o += L.F;
  L.w1 = o;   o += L.F;
  L.w2 = o;   o += L.F;
  L.n_weights = o;
  o = (o + 3) & ~3;  // 16-byte alignment for the vector loads below
  L.x = o;    o += L.F * TC;
  L.xa = o;   o += L.F * TC;
  L.xb = o;   o += L.F * TC;
  L.acc = o;  o += L.F * TC;
  L.a1 = o;   o += L.H1 * TC;
  L.a2 = o;   o += L.H2 * TC;
  L.flux = o; o += L.F * TC;
  L.nu = o;   o += L.ni * TC;
  L.n_smem = o;
  return L;
}

__device__ __forceinline__ float activate(float x, int kind) {
  if (kind == 1) return fmaxf(x, 0.0f);
  const float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

// Block-diagonal dense layer on feature-major arrays.
//   y[blk, j, c] = b[blk*N + j] + sum_k in[(blk*K + k)*TC + c] * W[(blk*K + k)*N + j]
// for blk < nblk, j < N, c < TC. A work item is one (blk, j) and CPT columns.
// EPI == 0: out[(blk*N + j)*TC + c] = act(y).
// EPI == 1: out[(blk*Nz + j)*TC + c] = y - c_blk * nu[j] * (xs[blk*Nz + j + 1] - xs[blk*Nz + j]),
//           the total interior face flux (NN minus mPP downgradient).
template <int CPT, int EPI>
__device__ __forceinline__ void dense_layer(const float* __restrict__ in, const float* __restrict__ W,
                                            const float* __restrict__ b, float* __restrict__ out,
                                            int nblk, int K, int N, int act_kind,
                                            const float* __restrict__ xs, const float* __restrict__ nu,
                                            const FusedRK4Params& p) {
  constexpr int NCG = TC / CPT;
  const int rows = nblk * N;
  const int n_items = rows * NCG;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int cg = item / rows;
    const int r = item - cg * rows;
    const int blk = r / N;
    const int j = r - blk * N;
    const int c0 = cg * CPT;
    float acc[CPT];
    const float bias = b[r];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[cc] = bias;
    const float* inp = in + (blk * K) * TC + c0;
    const float* w = W + (size_t)blk * K * N + j;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float wk = w[k * N];
      if constexpr (CPT == 4) {
        const float4 v = *reinterpret_cast<const float4*>(inp + k * TC);
        acc[0] = fmaf(v.x, wk, acc[0]);
        acc[1] = fmaf(v.y, wk, acc[1]);
        acc[2] = fmaf(v.z, wk, acc[2]);
        acc[3] = fmaf(v.w, wk, acc[3]);
      } else if constexpr (CPT == 2) {
        const float2 v = *reinterpret_cast<const float2*>(inp + k * TC);
        acc[0] = fmaf(v.x, wk, acc[0]);
        acc[1] = fmaf(v.y, wk, acc[1]);
      } else {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[cc] = fmaf(inp[k * TC + cc], wk, acc[cc]);
      }
    }
    if constexpr (EPI == 0) {
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) out[r * TC + c0 + cc] = activate(acc[cc], act_kind);
    } else {
      const int Nz = p.Nz;
      const float coef = blk == 0 ? p.cu : (blk == 1 ? p.cv : p.cT);
      const int lane = blk * Nz + j;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const int c = c0 + cc;
        const float d = xs[(lane + 1) * TC + c] - xs[lane * TC + c];
        out[lane * TC + c] = acc[cc] - coef * (nu[j * TC + c] * d);
      }
    }
  }
}

// mPP face viscosity at interior face j (raw differences d = x[k+1] - x[k]).
__device__ __forceinline__ void face_nu(const float* __restrict__ xs, float* __restrict__ nu,
                                        const FusedRK4Params& p, int ni, int thread, int stride) {
  const int Nz = p.Nz;
  for (int item = thread; item < ni * TC; item += stride) {
    const int j = item / TC;
    const int c = item - j * TC;
    const float du = xs[(j + 1) * TC + c] - xs[j * TC + c];
    const float dv = xs[(Nz + j + 1) * TC + c] - xs[(Nz + j) * TC + c];
    const float dT = xs[(2 * Nz + j + 1) * TC + c] - xs[(2 * Nz + j) * TC + c];
    const float eu = du + p.epsdz;
    const float ev = dv + p.epsdz;
    const float eT = dT + p.epsdz;
    const float Ri = p.aT * eT / (p.au * eu * eu + p.av * ev * ev);
    nu[item] = p.n_a + p.n_b * tanhf(p.t_a * Ri + p.t_b);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_rk4_kernel(const float* __restrict__ x0, float* __restrict__ out,
                 const float* __restrict__ weights, const FusedRK4Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(p.Nz, p.h1, p.h2);
  const int F = L.F, Nz = p.Nz;
  const int col0 = blockIdx.x * TC;
  const int tid = threadIdx.x;

  for (int i = tid; i < L.n_weights; i += blockDim.x) smem[i] = weights[i];
  float* x = smem + L.x;
  float* acc = smem + L.acc;
  float* a1 = smem + L.a1;
  float* a2 = smem + L.a2;
  float* flux = smem + L.flux;
  float* nu = smem + L.nu;
  const float* A1 = smem + L.A1;
  const float* b1 = smem + L.b1;
  const float* A2 = smem + L.A2;
  const float* b2 = smem + L.b2;
  const float* A3 = smem + L.A3;
  const float* b3 = smem + L.b3;
  const float* Krow = smem + L.Krow;
  const float* w1 = smem + L.w1;
  const float* w2 = smem + L.w2;

  // Load the tile transposed to [feature][column]; columns past the end are
  // zero (finite through every phase) and never written back.
  for (int item = tid; item < F * TC; item += blockDim.x) {
    const int l = item % F;
    const int c = item / F;
    const int col = col0 + c;
    const float v = col < p.n_columns ? x0[(size_t)col * F + l] : 0.0f;
    x[l * TC + c] = v;
    smem[L.xa + l * TC + c] = v;
  }
  __syncthreads();

  float* xs = smem + L.xa;   // stage input being evaluated
  float* xn = smem + L.xb;   // next stage input
  for (int step = 0; step < p.n_steps; ++step) {
    for (int s = 0; s < 4; ++s) {
      // Phase 1: a1 = act(xs @ A1 + b1).
      dense_layer<CPT[0], 0>(xs, A1, b1, a1, 1, F, L.H1, p.activation, nullptr, nullptr, p);
      __syncthreads();
      // Phase 2: a2 = act(a1 @ blockdiag(A2) + b2), and the face viscosity
      // (threads with the fewest layer-2 items take the first nu items).
      dense_layer<CPT[1], 0>(a1, A2, b2, a2, 3, p.h1, p.h2, p.activation, nullptr, nullptr, p);
      face_nu(xs, nu, p, L.ni, blockDim.x - 1 - tid, blockDim.x);
      __syncthreads();
      // Phase 3: total interior face fluxes = a2 @ blockdiag(A3) + b3 - mPP.
      dense_layer<CPT[2], 1>(a2, A3, b3, flux, 3, p.h2, L.ni, p.activation, xs, nu, p);
      __syncthreads();
      // Phase 4: tendency (divergence stencil + Coriolis + Krow) and the RK4
      // update of this stage.
      for (int item = tid; item < F * TC; item += blockDim.x) {
        const int l = item / TC;
        const int c = item - l * TC;
        const int blk = l / Nz;
        const int k = l - blk * Nz;
        const float rdz = blk == 0 ? p.rdu : (blk == 1 ? p.rdv : p.rdT);
        const float fk = k <= Nz - 2 ? flux[item] : 0.0f;
        const float fkm1 = k >= 1 ? flux[item - TC] : 0.0f;
        const int lp = l + Nz < F ? l + Nz : l + Nz - F;   // roll(x, -Nz)
        const int lm = l >= Nz ? l - Nz : l - Nz + F;      // roll(x, +Nz)
        const float cor = w1[l] * xs[lp * TC + c] + w2[l] * xs[lm * TC + c];
        const float tend = rdz * (fkm1 - fk) + cor + Krow[l];
        const float xv = x[item];
        if (s == 0) {
          acc[item] = tend;
          xn[item] = xv + p.half_dt * tend;
        } else if (s == 1) {
          acc[item] += 2.0f * tend;
          xn[item] = xv + p.half_dt * tend;
        } else if (s == 2) {
          acc[item] += 2.0f * tend;
          xn[item] = xv + p.dt * tend;
        } else {
          const float xnew = xv + p.dt6 * (acc[item] + tend);
          x[item] = xnew;
          xn[item] = xnew;
        }
      }
      __syncthreads();
      float* t = xs;
      xs = xn;
      xn = t;
    }
  }

  for (int item = tid; item < F * TC; item += blockDim.x) {
    const int l = item % F;
    const int c = item / F;
    const int col = col0 + c;
    if (col < p.n_columns) out[(size_t)col * F + l] = x[l * TC + c];
  }
}

}  // namespace

extern "C" {

int fused_rk4_columns_per_block() { return TC; }

int fused_rk4_threads_per_block() { return THREADS; }

int fused_rk4_smem_bytes(int Nz, int h1, int h2) {
  return make_layout(Nz, h1, h2).n_smem * (int)sizeof(float);
}

int fused_rk4_weight_count(int Nz, int h1, int h2) { return make_layout(Nz, h1, h2).n_weights; }

const char* fused_rk4_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches on `stream` (a cudaStream_t) of device `device`; does not
// synchronise. Returns a cudaError_t: 0 when the launch was accepted.
int fused_rk4_launch(const float* x0, float* out, const float* weights, FusedRK4Params p, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p.n_columns <= 0) return (int)cudaSuccess;
  const int smem = fused_rk4_smem_bytes(p.Nz, p.h1, p.h2);
  err = cudaFuncSetAttribute(fused_rk4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (p.n_columns + TC - 1) / TC;
  fused_rk4_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(x0, out, weights, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
