// The fragment helpers of the one-block-per-(row, head) attention backwards
// (packed_attention_bwd.cuh: B6b, B8; attention_bwd.cuh: B7's one-launch
// backward; fused_extras.cu takes its cp.async copies too): cp.async
// copies (tf32_frags.cuh) of padded 64-column tiles, ldmatrix fragments
// (.trans for the operands whose k index runs down the rows), mma.sync
// m16n8k16 bf16 -> fp32 chains over a tile, the one-instruction exp2 and
// the bf16 pair conversion.

#pragma once

#include "attention_common.cuh"
#include "tf32_frags.cuh"

namespace afrag {

using attn::kKD;
using attn::kLDS;
using tf32::cp_async16;
using tf32::cp_commit;
using tf32::cp_wait_all;
using tf32::smem_u32;

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// mma.sync m16n8k16 bf16 -> fp32, free for the compiler to schedule (a
// register-only instruction)
__device__ __forceinline__ void mma_nv(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, one MUFU instruction (at most 2 ulp from 2^x). The .ftz form flushes
// a result below 2^-126 to 0 where the plain version's exp2 (and exp2f, as
// the forward kernels call it) keeps a subnormal: an e that small (a score
// 126 powers of two below the largest) adds nothing a bf16 gradient can
// hold, and the flush saves the subnormal handling on every score entry
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16(lo) | bf16(hi) << 16, round to nearest even, one instruction
__device__ __forceinline__ uint32_t cvt_pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// rows [row0, row0 + ROWS) of one head (64 columns at `src`) into a padded
// shared tile, asynchronously, by a block of THREADS; rows >= L become zeros
template <int ROWS, int THREADS>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int L, long long stride) {
  for (int idx = threadIdx.x; idx < ROWS * 8; idx += THREADS) {
    const int r = idx >> 3, cv = (idx & 7) * 8;
    const bool ok = row0 + r < L;
    cp_async16(dst + r * kLDS + cv, ok ? src + (row0 + r) * stride + cv : src, ok);
  }
}

// A fragments (16 rows from `row0` x 64 columns) of a shared tile
__device__ __forceinline__ void a_frags(uint32_t (&a)[kKD][4], const __nv_bfloat16* tile,
                                        int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk)
    ldsm(a[kk], tile + (row0 + (lane & 15)) * kLDS + kk * 16 + (lane >> 4) * 8);
}

// s[i] += A x rows n8[i] .. n8[i] + 7 of a shared tile^T for the fragments
// with use[i] (constant after unrolling where the callers can make it so):
// NG independent mma chains
template <int NG>
__device__ __forceinline__ void mma_rows_tn(float (&s)[NG][4], const uint32_t (&a)[kKD][4],
                                            const __nv_bfloat16* tile, const int (&n8)[NG],
                                            const bool (&use)[NG], int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      if (use[i]) {
        uint32_t b[4];
        ldsm(b, tile + (n8[i] + (lane & 7)) * kLDS + (lane >> 3) * 8 + half * 32);
        mma_nv(s[i], a[2 * half], b[0], b[1]);
        mma_nv(s[i], a[2 * half + 1], b[2], b[3]);
      }
    }
  }
}

// acc[j] += P (16 x 16 chunk `kc` of the tile's rows, fragment `p`) x tile
// rows kc * 16 .. + 15, columns col0 + j * 8 (j < 2 * NP)
template <int NP>
__device__ __forceinline__ void mma_chunk(float (&acc)[2 * NP][4], const uint32_t (&p)[4],
                                          const __nv_bfloat16* tile, int kc, int col0,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    uint32_t b[4];
    ldsm_t(b, tile + (kc * 16 + (lane & 15)) * kLDS + col0 + (2 * j + (lane >> 4)) * 8);
    mma_nv(acc[2 * j], p, b[0], b[1]);
    mma_nv(acc[2 * j + 1], p, b[2], b[3]);
  }
}

}  // namespace afrag
