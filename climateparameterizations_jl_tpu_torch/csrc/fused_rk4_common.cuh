// What csrc/fused_rk4.cu and csrc/fused_rk4_bf16.cu share: the scalar parameters, the
// activation, the face viscosity and the named barriers of the three flux-MLP groups.
#pragma once

#include <float.h>
#include <math.h>

#include "device_common.cuh"

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

// mish(x) = x tanh(softplus(x)) in one expf and one reciprocal: with e = exp(x) and
// n = e (e + 2), tanh(log(1 + e)) = n / (n + 2). The exponent is clamped at 20, so n stays
// below 2.4e17 and n + 2 is a normal number in [2, 2.4e17], where rcp_rn is exact to the
// rounding; above 20, n (1 / (n + 2)) rounds to within an ulp of 1 and the result to within
// an ulp of x, as mish rounds there in f32. There is no branch, so the activations of one
// thread overlap. Below x = -87, e is subnormal or zero and so is the result (|mish| <
// 1e-36, as in the plain version). Over [-30, 30] in f32 against an f64 reference it is
// within about 3 f32 eps of mish (relative;
// tests/test_torch_fused_rk4_host.py::test_one_exp_mish_accuracy).
__device__ __forceinline__ float mish(float x) {
  const float e = expf(fminf(x, 20.0f));
  const float n = e * (e + 2.0f);
  return x * (n * rcp_rn(n + 2.0f));
}

__device__ __forceinline__ float activate(float x, int kind) { return kind == 1 ? fmaxf(x, 0.0f) : mish(x); }

// act(y + bias) on 4 values, the activation chosen once for all 4.
__device__ __forceinline__ float4 activate4(float4 y, float bias, int kind) {
  if (kind == 1)
    return make_float4(fmaxf(y.x + bias, 0.0f), fmaxf(y.y + bias, 0.0f), fmaxf(y.z + bias, 0.0f),
                       fmaxf(y.w + bias, 0.0f));
  return make_float4(mish(y.x + bias), mish(y.y + bias), mish(y.z + bias), mish(y.w + bias));
}

// mPP face viscosity from the raw differences d = x[k+1] - x[k] of u, v and T at one face:
// nu = n_a + n_b tanh(t_a Ri + t_b), Ri = aT (dT + eps dz) / (au (du + eps dz)^2 + av (dv + eps dz)^2).
// The denominator is a sum of non-negative terms; it is raised to FLT_MIN so that rcp_rn
// sees a normal number (a zero denominator then gives |Ri| ~ 1e38, tanh = +-1, as the
// plain version's infinite Ri does). tanhf stays: the one-expf form 1 - 2 / (exp(2 y) + 1)
// ran no faster on the H100 (bench_turns.py, PERF.md).
__device__ __forceinline__ float face_nu(float du, float dv, float dT, const FusedRK4Params& p) {
  const float eu = du + p.epsdz;
  const float ev = dv + p.epsdz;
  const float eT = dT + p.epsdz;
  const float den = fmaxf(p.au * eu * eu + p.av * ev * ev, FLT_MIN);
  const float Ri = p.aT * eT * rcp_rn(den);
  return p.n_a + p.n_b * tanhf(p.t_a * Ri + p.t_b);
}

__device__ __forceinline__ float flux_coefficient(int blk, const FusedRK4Params& p) {
  return blk == 0 ? p.cu : (blk == 1 ? p.cv : p.cT);
}

__device__ __forceinline__ float tendency_coefficient(int blk, const FusedRK4Params& p) {
  return blk == 0 ? p.rdu : (blk == 1 ? p.rdv : p.rdT);
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `n` threads, a multiple of 32: every
// thread of the group reaches it, with loop bounds that are uniform across the group.
#ifndef CSRC_HOST_EMULATION
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
#endif

// One RK4 stage on a value: `acc` collects k1 + 2 k2 + 2 k3 in the plain version's order;
// returns the next stage input (after stage 3, the new state).
__device__ __forceinline__ float rk4_update(int s, float xv, float tend, float& acc, const FusedRK4Params& p) {
  if (s == 0) {
    acc = tend;
    return xv + p.half_dt * tend;
  }
  if (s == 1) {
    acc += 2.0f * tend;
    return xv + p.half_dt * tend;
  }
  if (s == 2) {
    acc += 2.0f * tend;
    return xv + p.dt * tend;
  }
  return xv + p.dt6 * (acc + tend);
}

// Phase clocks: built with -DFUSED_RK4_PHASE_CLOCKS, thread 0 of CTA 0 sums the clock64()
// cycles between the phase boundaries of the stage loop (PHASE_MARK(i) ends phase i) in
// shared memory (so that the other threads spend no registers on them) and stores them to
// phase_clocks, which fused_rk4_phase_clocks / fused_rk4_bf16_phase_clocks copy out
// (fused_rk4_phases.py). Without the flag the marks compile to nothing.
constexpr int N_PHASE_CLOCKS = 8;
#if defined(FUSED_RK4_PHASE_CLOCKS) && !defined(CSRC_HOST_EMULATION)
__device__ unsigned long long phase_clocks[N_PHASE_CLOCKS];
#define PHASE_CLOCKS_START                                              \
  __shared__ long long clk_[N_PHASE_CLOCKS + 1];                        \
  const bool clocked_ = blockIdx.x == 0 && threadIdx.x == 0;           \
  if (clocked_) {                                                       \
    for (int i_ = 0; i_ < N_PHASE_CLOCKS; ++i_) clk_[i_] = 0;           \
    clk_[N_PHASE_CLOCKS] = clock64();                                   \
  }
#define PHASE_MARK(i)                                  \
  do {                                                 \
    if (clocked_) {                                    \
      const long long t_ = clock64();                  \
      clk_[i] += t_ - clk_[N_PHASE_CLOCKS];            \
      clk_[N_PHASE_CLOCKS] = t_;                       \
    }                                                  \
  } while (0)
#define PHASE_CLOCKS_STORE \
  if (clocked_)            \
    for (int i_ = 0; i_ < N_PHASE_CLOCKS; ++i_) phase_clocks[i_] = clk_[i_];
#else
#define PHASE_CLOCKS_START
#define PHASE_MARK(i) \
  do {                \
  } while (0)
#define PHASE_CLOCKS_STORE
#endif
