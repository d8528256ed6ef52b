// Pieces shared by the w8a8 kernels for Hopper (sm_90a): fp32 row
// LayerNorm, per-row int8 quant, the int8 mma.sync step of the attention
// kernel's int8 scores and the `acc * xs * s + b (+ r)` epilogue.
//
// Bit-level semantics, held against the plain PyTorch versions in
// ops/int8_matmul.py and ops/flash_attention.py:
//   * built WITHOUT --use_fast_math: divisions and sqrt are IEEE;
//   * row quant: xs = max(absmax, 1e-6) * fp32(1/127), inv = 1 / xs (an IEEE
//     division), code = rint(x * inv) rounded half to even, no clip (|code|
//     <= 127 by construction);
//   * every multiply and add of the LayerNorm, the quant, QuickGELU
//     (w8a8_mlp.cu) and the epilogue is written with the __fmul_rn /
//     __fadd_rn intrinsics, which
//     the compiler never contracts into an FMA: the results are the same
//     fp32 roundings as the plain version's separate ops. The only
//     differences left are the ORDER of the LayerNorm row sums (a warp
//     butterfly here, torch's reduction there) and, in the attention
//     kernel, of the fp32 mma sums; both move a value by an fp32 ulp and so
//     flip an int8 code only where it sits on a rounding tie;
//   * the int8 products are exact: mma.sync m16n8k32 or wgmma, s8 x s8 -> s32.
// The GEMM kernels (w8a8_matmul.cu, w8a8_qkv.cu, w8a8_mlp.cu,
// attention_out_int8.cu, mega_layer.cu) run wgmma on TMA-fed tiles
// (w8a8_wgmma.cuh).
//
// Rows of up to kMaxRowPerLane * 32 = 1,024 values are held in a warp's
// registers (quant_row_to); a longer row (a text MLP's fc2 takes 2,048)
// is read again for each pass instead (quant_row_long, and quant_row_long8
// with no LayerNorm): its sums, absmax and codes are the same operations in
// the same order (the absmax and codes of a row without LayerNorm are the
// same bits in any order), so the same bits.
//
// The rows are bf16 or fp32 (the element type T of the row functions); only
// the load differs, and after it the same fp32 arithmetic runs. A 16-byte
// load holds 8 bf16 or 4 fp32 values: the eight-value chunks of the
// vector forms are one load of bf16 or two of fp32, so they need every row
// 16-byte aligned, which takes K % 8 == 0 in bf16 and K % 4 == 0 in fp32
// (kVecK<T>). An fp32 row with K % 8 == 4 ends in a half chunk, whose
// second load is not made and whose values past K are zero and take no
// part in the sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w8a8 {

constexpr int kMaxRowPerLane = 32;       // register rows: K <= 32 * 32
constexpr float kInv127 = 0x1.020408p-7f;  // fp32(1/127)

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// values of T in one 16-byte load: the K of a row read by such loads is a
// multiple of it
template <class T>
constexpr int kVecK = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// v stored as the output's type: rounded to bf16, or as it is
__device__ __forceinline__ void store_as(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }
__device__ __forceinline__ void store_as(float* y, float v) { *y = v; }

// values c0 .. c0 + 7 of a row (c0 a multiple of 8, c0 < K, the row 16-byte
// aligned and K % kVecK<T> == 0): one 16-byte load of bf16, two of fp32 (the
// second only where c0 + 4 < K; zeros past K)
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ src, int c0, int,
                                      float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src + c0);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ src, int c0, int K,
                                      float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src + c0);
  const float4 b = c0 + 4 < K ? *reinterpret_cast<const float4*>(src + c0 + 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// row scale of the quant from the row's absmax
__device__ __forceinline__ float quant_scale(float absmax) {
  return __fmul_rn(fmaxf(absmax, 1e-6f), kInv127);
}

__device__ __forceinline__ int8_t quant_code(float x, float inv) {
  return static_cast<int8_t>(__float2int_rn(__fmul_rn(x, inv)));
}

// One warp, a row of K > 1,024 values: quant_row_to's arithmetic, each
// pass reading the row again (from L1 / L2) instead of from registers: the
// LayerNorm's two sums, the absmax of the (normalised) values, the codes.
// Lane `lane` sums columns lane, lane + 32, ... in that order, as the
// register form does for a row it does not read 8 values a load.
template <class T, class Store>
__device__ __noinline__ float quant_row_long(const T* __restrict__ src, int K,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta, int Kp,
                                             Store store, int lane) {
  float mean = 0.f, rstd = 0.f;
  if (gamma != nullptr) {
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s = __fadd_rn(s, to_f32(src[c]));
    mean = __fdiv_rn(warp_sum(s), static_cast<float>(K));
    float q = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = __fadd_rn(to_f32(src[c]), -mean);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
    rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), static_cast<float>(K)), 1e-5f));
  }
  auto value = [&](int c) {
    const float x = to_f32(src[c]);
    return gamma == nullptr
               ? x
               : __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(x, -mean), rstd), gamma[c]), beta[c]);
  };
  float m = 0.f;
  for (int c = lane; c < K; c += 32) m = fmaxf(m, fabsf(value(c)));  // absmax over the row
  const float xs = quant_scale(warp_max(m));
  const float inv = __fdiv_rn(1.0f, xs);
  for (int c = lane; c < Kp; c += 32)
    store(c, c < K ? quant_code(value(c), inv) : static_cast<int8_t>(0));
  return xs;
}

// One warp, a row of K > 1,024 values with no LayerNorm, K % kVecK<T> == 0
// at a 16-byte aligned address: the absmax and the codes (the same bits in
// any order: a max, and one rounding a value) from 16-byte loads, eight
// values a lane (load8), reading the row twice; codes c0 .. c0 + 7 go to
// store8(c0, codes).
template <class T, class Store8>
__device__ __noinline__ float quant_row_long8(const T* __restrict__ src, int K, int Kp,
                                              Store8 store8, int lane) {
  float m = 0.f;
  for (int c0 = 8 * lane; c0 < K; c0 += 256) {
    float v[8];
    load8(src, c0, K, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  const float xs = quant_scale(warp_max(m));
  const float inv = __fdiv_rn(1.0f, xs);
  for (int c0 = 8 * lane; c0 < Kp; c0 += 256) {
    uint32_t q[2] = {0u, 0u};   // zero codes past K
    if (c0 < K) {
      float v[8];
      load8(src, c0, K, v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        q[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(quant_code(v[j], inv)))
                    << (8 * (j % 4));
    }
    store8(c0, make_uint2(q[0], q[1]));
  }
  return xs;
}

// One warp: row `src` of K bf16 or fp32 values -> [LayerNorm ->] int8
// codes, code c (0 <= c < Kp, zero from K on) handed to store(c, code), or
// eight at a time, codes c0 .. c0 + 7 (c0 a multiple of 8) packed into a
// uint2, to store8(c0, codes); returns xs. LayerNorm (when gamma != nullptr): fp32,
// mean and two-pass biased variance over K, ((x - mean) * rsqrt(var +
// 1e-5)) * gamma + beta. Rows longer than 1,024 values take
// quant_row_long8 (no LayerNorm, 16-byte loads) or quant_row_long. A row of
// a multiple of kVecK<T> values at 16-byte aligned addresses is read in
// chunks of 8 values (load8: lane `lane` holds columns 8 * (lane + 32 i) ..
// + 7, and sums them in that order); other rows a value a load (columns
// lane + 32 i).
template <class T, class Store, class Store8>
__device__ __forceinline__ float quant_row_to(const T* __restrict__ src, int K,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, int Kp,
                                              Store store, Store8 store8, int lane) {
  if (Kp > kMaxRowPerLane * 32) {
    if (gamma == nullptr && K % kVecK<T> == 0 && aligned16(src))
      return quant_row_long8(src, K, Kp, store8, lane);
    return quant_row_long(src, K, gamma, beta, Kp, store, lane);
  }
  if (K % kVecK<T> == 0 && aligned16(src) &&
      (gamma == nullptr || (aligned16(gamma) && aligned16(beta)))) {
    constexpr int kChunks = kMaxRowPerLane / 8;   // of eight values each
    float v[kChunks][8];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c0 = 8 * (lane + 32 * i);
      if (c0 < K) {
        load8(src, c0, K, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = 0.f;   // zeros past K
      }
    }
    if (gamma != nullptr) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s = __fadd_rn(s, v[i][j]);
      const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(K));
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)   // a half chunk ends an fp32 row
          if (kVecK<T> == 8 ? 8 * (lane + 32 * i) < K : 8 * (lane + 32 * i) + j < K) {
            const float d = __fadd_rn(v[i][j], -mean);
            q = __fadd_rn(q, __fmul_rn(d, d));
          }
      const float rs = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), static_cast<float>(K)), 1e-5f));
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c0 = 8 * (lane + 32 * i);
        if (c0 < K) {
          // the second half of gamma and beta only where it lies inside K
          const float4* g4 = reinterpret_cast<const float4*>(gamma + c0);
          const float4* b4 = reinterpret_cast<const float4*>(beta + c0);
          const bool two = kVecK<T> == 8 || c0 + 4 < K;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 ga = g4[0], gb = two ? g4[1] : z, ba = b4[0], bb = two ? b4[1] : z;
          const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
          const float bv[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(v[i][j], -mean), rs), gv[j]),
                                bv[j]);
        }
      }
    }
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[i][j]));
    const float xs = quant_scale(warp_max(m));
    const float inv = __fdiv_rn(1.0f, xs);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c0 = 8 * (lane + 32 * i);
      if (c0 < Kp) {
        uint32_t w[2] = {0u, 0u};   // zero codes past K
        if (c0 < K)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(quant_code(v[i][j], inv)))
                        << (8 * (j % 4));
        store8(c0, make_uint2(w[0], w[1]));
      }
    }
    return xs;
  }
  float v[kMaxRowPerLane];
#pragma unroll
  for (int i = 0; i < kMaxRowPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < K ? to_f32(src[c]) : 0.f;
  }
  if (gamma != nullptr) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowPerLane; ++i) s = __fadd_rn(s, v[i]);
    const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(K));
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowPerLane; ++i) {
      const float d = __fadd_rn(v[i], -mean);
      if (lane + 32 * i < K) q = __fadd_rn(q, __fmul_rn(d, d));
    }
    const float inv = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), static_cast<float>(K)), 1e-5f));
#pragma unroll
    for (int i = 0; i < kMaxRowPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < K)
        v[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fadd_rn(v[i], -mean), inv), gamma[c]),
                         beta[c]);
    }
  }
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxRowPerLane; ++i) m = fmaxf(m, fabsf(v[i]));
  const float xs = quant_scale(warp_max(m));
  const float inv = __fdiv_rn(1.0f, xs);
#pragma unroll
  for (int i = 0; i < kMaxRowPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < Kp) store(c, c < K ? quant_code(v[i], inv) : static_cast<int8_t>(0));
  }
  return xs;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y = ((float)acc * xs) * s + b [+ r]
__device__ __forceinline__ float epilogue(int acc, float xs, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), s), b);
}


}  // namespace w8a8

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
