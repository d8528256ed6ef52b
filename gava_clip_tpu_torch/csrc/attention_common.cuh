// Helpers shared by the training attention kernels (packed_attention_bwd.cu,
// streaming_attention.cu, streaming_attention_bwd.cu): bf16 tensor-core
// fragments for mma.sync m16n8k16 loaded from a packed (L, H*64) matrix,
// bf16 pairs, and the store of a 16 x 64 accumulator.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 = (row g,     k 2t, 2t+1), a1 = (row g + 8, k 2t, 2t+1),
//                           a2 = (row g, k 2t+8, 2t+9),   a3 = (row g + 8, k 2t+8, 2t+9)
//   B (16 x 8, "col"):      b0 = (k 2t, 2t+1; n g),       b1 = (k 2t+8, 2t+9; n g)
//   C (16 x 8):             c0, c1 = (row g; n 2t, 2t+1), c2, c3 = (row g + 8; n 2t, 2t+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kTile = 64;          // rows of a block tile, 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kHD = 64;            // head dim the kernels are built for
constexpr int kLDS = kHD + 8;      // padded shared row: fewer bank conflicts
constexpr int kKD = kHD / 16;      // k-steps of a product over the head dim
constexpr int kNF = kTile / 8;     // 8-column fragments across a 64-wide tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;  // masked score: exp2 of it is exactly 0

// two bf16 values in one register, `lo` (the lower column / k index) in the
// low half, as the mma fragments expect
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float lo_f(uint32_t x) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(x & 0xffffu)));
}

__device__ __forceinline__ float hi_f(uint32_t x) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(x >> 16)));
}

// Rows r0 and r1 = r0 + 8 of one head as the A fragments of a product over
// the head dim (t = lane % 4); rows >= L are zeros.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kKD][4],
                                             const __nv_bfloat16* src, int r0,
                                             int r1, int L, long long stride,
                                             int t) {
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk) {
    const int col = kk * 16 + t * 2;
    const __nv_bfloat16* p0 = src + r0 * stride + col;
    const __nv_bfloat16* p1 = src + r1 * stride + col;
    a[kk][0] = r0 < L ? ld2(p0) : 0u;
    a[kk][1] = r1 < L ? ld2(p1) : 0u;
    a[kk][2] = r0 < L ? ld2(p0 + 8) : 0u;
    a[kk][3] = r1 < L ? ld2(p1 + 8) : 0u;
  }
}

// Store a 16 x 64 fp32 accumulator (times `mul`) as bf16 rows r0, r1 < L.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long stride,
                                           const float (&acc)[kHD / 8][4],
                                           int r0, int r1, int L, int t,
                                           float mul0, float mul1) {
#pragma unroll
  for (int d = 0; d < kHD / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(dst + r0 * stride + col) =
          pack2f(acc[d][0] * mul0, acc[d][1] * mul0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(dst + r1 * stride + col) =
          pack2f(acc[d][2] * mul1, acc[d][3] * mul1);
  }
}

}  // namespace attn
