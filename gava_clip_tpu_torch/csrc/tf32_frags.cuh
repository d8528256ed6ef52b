// The fp32 tensor-core steps shared by the float32 attention kernels
// (attention_f32.cu) and the fused prompt extras (fused_extras.cu), and the
// cp.async copies that those and the bf16 attention kernels
// (attention_frags.cuh) issue. One named device function per PTX
// instruction: the CPU emulation of attention_f32.cu
// (tests/test_torch_attention_f32.py) supplies a C++ version of each.
//
// 3xTF32: an fp32 product a * b on the TF32 tensor cores as lo_a hi_b +
// hi_a lo_b + hi_a hi_b in the fp32 accumulator, each operand split once
// into hi = tf32(x) and lo = x - hi (split below); the lo_a lo_b term,
// 2^-22 of the product, is dropped. fp32 accuracy at three TF32 products a
// product; an operand that is a TF32 value already (a bf16 value, a small
// integer) has lo = 0 and takes one product less.

#pragma once

#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// every copy this thread issued has landed (the block's barrier after it
// makes them visible to the other threads)
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32 rounds, but in two integer instructions: the conversion
// instruction runs at a quarter of their rate, and every warp splits every
// operand value it reads), lo = x - hi exactly in fp32; the tensor core reads
// lo's top 19 bits, 2^-22 of x from lo's own (0 where x is TF32 already)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, mma.sync m16n8k8 TF32 -> fp32 (the tensor core reads the top 19
// bits of each operand register). Fragments, g = lane / 4, t = lane % 4:
// a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t,
// column g), b1 (t + 4, g); d0 (row g, column 2t), d1 (g, 2t + 1), d2 (g + 8,
// 2t), d3 (g + 8, 2t + 1). A register-only instruction: free for the
// compiler to schedule. The products are exact; their sum with d is
// truncated, not rounded to nearest, so a long chain of mma into one
// accumulator drifts by about an ulp of it a step.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b: mma_tf32 with a zero accumulator (a fresh sum, no register to
// clear)
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

}  // namespace tf32
