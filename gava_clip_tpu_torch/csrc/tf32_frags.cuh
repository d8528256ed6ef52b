// The fp32 tensor-core steps shared by the float32 attention kernels
// (attention_f32.cu, which also takes its int8 score product from mma_s8),
// the fused prompt extras (fused_extras.cu) and the float32 weight-only GEMM
// (w8_matmul_f32.cu: wgmma m64n128k8 TF32 and its fences), and the cp.async
// copies that those and the bf16 attention kernels (attention_frags.cuh)
// issue. One named device function per PTX instruction: the CPU emulation of
// attention_f32.cu and w8_matmul_f32.cu (tests/test_torch_attention_f32.py)
// supplies a C++ version of each.
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

// every copy this thread issued but its last committed group has landed
__device__ __forceinline__ void cp_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

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

// d += a b, mma.sync m16n8k32 s8 x s8 -> s32, exact. Four int8 a register,
// the lowest byte first. Fragments, g = lane / 4, t = lane % 4: a0 (row g, k
// 4t..4t + 3), a1 (g + 8, 4t..), a2 (g, 16 + 4t..), a3 (g + 8, 16 + 4t..);
// b0 (k 4t..4t + 3, column g), b1 (k 16 + 4t.., g); d as mma_tf32's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// this thread's writes to shared memory made visible to the async proxy,
// which wgmma reads its shared-memory operands through (before the barrier
// that hands them over)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// before a warpgroup's first wgmma that reads registers written since its
// last one (the A fragments, a reused accumulator)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// every wgmma group this warpgroup committed is done
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the wgmma descriptor of a k-major TF32 operand without swizzle: core
// matrices of 8 rows x 16 bytes (4 values of k), lbo bytes apart along k,
// sbo bytes apart along the rows (8-row groups)
__device__ __forceinline__ uint64_t desc_k(const void* p, uint32_t lbo, uint32_t sbo) {
  return ((smem_u32(p) & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (+)= a b, wgmma m64n128k8 TF32 -> fp32 of a warpgroup, asynchronous until
// wgmma_commit and wgmma_wait_all: A (64 x 8) from registers, warp w of the
// warpgroup its rows 16 w + the m16n8k8 A fragment (a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4)); B (8 x 128) k-major in shared
// memory by descriptor; d[4 j + i] the m16n8 accumulator fragment of
// columns 8 j. As with mma_tf32, the products are exact and their sum with d
// is truncated. The _z form starts a fresh sum (scale-d 0).
#define TF32_WGMMA_D64                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define TF32_WGMMA_OUT(c)                                                             \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),    \
      c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), \
      c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), \
      c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), \
      c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), \
      c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), \
      c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), \
      c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define TF32_RW(x) "+f"(x)
#define TF32_W(x) "=f"(x)

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TF32_WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : TF32_WGMMA_OUT(TF32_RW)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_z(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TF32_WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : TF32_WGMMA_OUT(TF32_W)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

// hold the compiler to these registers' values from here on (an empty
// statement that it must take to read and write them): after
// wgmma_wait_all, the accumulator an asynchronous wgmma wrote
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#undef TF32_WGMMA_D64
#undef TF32_WGMMA_OUT
#undef TF32_RW
#undef TF32_W

}  // namespace tf32
