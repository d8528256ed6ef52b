// Helpers shared by the training attention kernels (packed_attention_bwd.cu,
// streaming_attention.cu, streaming_attention_bwd.cu): bf16 tensor-core
// fragments for mma.sync m16n8k16 and 64-row tiles of a packed (L, H*64)
// matrix staged through shared memory.
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

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Rows [row0, row0 + 64) of one head (64 columns starting at `src`) into a
// padded shared tile; rows >= L are zeros and are never read from memory.
// `stride` is the row stride in elements.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int L, long long stride) {
  constexpr int VPR = kHD / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += kThreads) {
    const int r = idx / VPR, cv = (idx % VPR) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L)
      x = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + cv);
    *reinterpret_cast<uint4*>(dst + r * kLDS + cv) = x;
  }
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

// c[n] += A (16 x 64, fragments `a`) x tile^T: entry (row, j) is the dot of
// A's row with row n * 8 + j of the shared tile (scores against keys, or the
// transposed scores against query rows).
__device__ __forceinline__ void mma_a_tile_t(float (&c)[kNF][4],
                                             const uint32_t (&a)[kKD][4],
                                             const __nv_bfloat16* tile, int g,
                                             int t) {
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      const __nv_bfloat16* p = tile + (n * 8 + g) * kLDS + kk * 16 + t * 2;
      mma_16816(c[n], a[kk], ld2(p), ld2(p + 8));
    }
  }
}

// acc[d] += P (16 x 64, fragments `p` over the tile's 64 rows) x tile
// (64 rows x 64 head columns).
__device__ __forceinline__ void mma_p_tile(float (&acc)[kHD / 8][4],
                                           const uint32_t (&p)[kTile / 16][4],
                                           const __nv_bfloat16* tile, int g,
                                           int t) {
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
#pragma unroll
    for (int d = 0; d < kHD / 8; ++d) {
      const __nv_bfloat16* vp = tile + (kc * 16 + t * 2) * kLDS + d * 8 + g;
      mma_16816(acc[d], p[kc], pack2(vp[0], vp[kLDS]),
                pack2(vp[8 * kLDS], vp[9 * kLDS]));
    }
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
