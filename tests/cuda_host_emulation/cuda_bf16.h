// Host stand-in for cuda_bf16.h (see cuda_runtime.h here): the bf16 type, its
// round-to-nearest-even conversion, and mma.sync m16n8k16 .bf16 with f32
// accumulation, emulated across the 32 lanes of a warp.
#pragma once

#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t bits;
};

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return __nv_bfloat16{uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{uint16_t(u >> 16)};
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.bits; }

inline float host_bf16_to_float(uint16_t b) {
  const uint32_t u = uint32_t(b) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// The PTX ISA's fragment layouts for m16n8k16 (g = lane / 4, t = lane % 4): A registers
// a0..a3 hold rows g, g + 8, g, g + 8 at columns 2t, 2t, 2t + 8, 2t + 8 (and the next
// column in the upper half); B registers b0, b1 hold rows 2t and 2t + 8 (and the next)
// of column g; d0..d3 are D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
inline void mma_bf16(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  host_sync.mma_a[32 * w + lane] = a;
  host_sync.mma_b[64 * w + 2 * lane] = b0;
  host_sync.mma_b[64 * w + 2 * lane + 1] = b1;
  host_sync.warp[w]->arrive_and_wait();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, tt = l % 4;
    const uint4 r = host_sync.mma_a[32 * w + l];
    const uint32_t regs[4] = {r.x, r.y, r.z, r.w};
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i % 2), col = 2 * tt + 8 * (i / 2);
      A[row][col] = host_bf16_to_float(uint16_t(regs[i] & 0xffffu));
      A[row][col + 1] = host_bf16_to_float(uint16_t(regs[i] >> 16));
    }
    for (int i = 0; i < 2; ++i) {
      const uint32_t v = host_sync.mma_b[64 * w + 2 * l + i];
      B[2 * tt + 8 * i][g] = host_bf16_to_float(uint16_t(v & 0xffffu));
      B[2 * tt + 8 * i + 1][g] = host_bf16_to_float(uint16_t(v >> 16));
    }
  }
  host_sync.warp[w]->arrive_and_wait();
  const int g = lane / 4, tt = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * tt + (i % 2);
    float s = d[i];
    for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
    d[i] = s;
  }
}
