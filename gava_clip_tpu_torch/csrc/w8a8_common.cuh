// Pieces shared by the w8a8 kernels for Hopper (sm_90a): fp32 row
// LayerNorm, per-row int8 quant, the int8 mma.sync tile loop of
// w8a8_matmul.cu and the `acc * xs * s + b (+ r)` epilogue.
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
//
// The GEMM core of w8a8_matmul.cu (gemm_direct): a block holds its rows'
// int8 codes in shared memory for the whole K (row-major, k contiguous);
// every warp multiplies all of them by its own columns, loading the "col" B
// fragments of mma from a k-contiguous copy of the weight (W^T (N, K), made
// once per weight by the Python wrapper) straight into registers, a few
// k-steps ahead. No warp shares a weight fragment with another, so nothing
// is staged through shared memory and the loop has no barrier; each
// fragment feeds MT mma. The fused kernels (w8a8_qkv.cu, w8a8_mlp.cu,
// attention_out_int8.cu) run wgmma on TMA-fed tiles instead
// (w8a8_wgmma.cuh).
//
// Rows of up to kMaxRowPerLane * 32 = 1,024 values are held in a warp's
// registers (quant_row_bf16); a longer row (a text MLP's fc2 takes 2,048)
// is read again for each pass instead (quant_row_long): its sums, absmax
// and codes are the same operations in the same order, so the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w8a8 {

constexpr int kThreads = 256;            // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;                  // code rows are zero-padded to this
constexpr int kMaxRowPerLane = 32;       // register rows: K <= 32 * 32
constexpr float kInv127 = 0x1.020408p-7f;  // fp32(1/127)

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// bytes per row of an int8 code tile for K columns (zero-filled past K up
// to a multiple of kBK): a multiple of 128 plus 64, so that the 16-byte
// A loads of rows g and g+1 in one quarter-warp fall on disjoint banks
__host__ __device__ constexpr int codes_stride(int K) {
  return round_up(K, 128) + 64;
}

__host__ __device__ __forceinline__ bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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

// One warp, a row of K > 1,024 values: quant_row_bf16's arithmetic, each
// pass reading the row again (from L1 / L2) instead of from registers: the
// LayerNorm's two sums, the absmax of the (normalised) values, the codes.
// Lane `lane` sums columns lane, lane + 32, ... in that order, as the
// register form does for a row it does not read 8 values a load.
template <class Store>
__device__ __noinline__ float quant_row_long(const __nv_bfloat16* __restrict__ src, int K,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta, int Kp,
                                             Store store, int lane) {
  float mean = 0.f, rstd = 0.f;
  if (gamma != nullptr) {
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s = __fadd_rn(s, __bfloat162float(src[c]));
    mean = __fdiv_rn(warp_sum(s), static_cast<float>(K));
    float q = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = __fadd_rn(__bfloat162float(src[c]), -mean);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
    rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), static_cast<float>(K)), 1e-5f));
  }
  auto value = [&](int c) {
    const float x = __bfloat162float(src[c]);
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

// One warp: row `src` of K bf16 values -> [LayerNorm ->] int8 codes, code
// c (0 <= c < Kp, zero from K on) handed to store(c, code), or eight at a
// time, codes c0 .. c0 + 7 (c0 a multiple of 8) packed into a uint2, to
// store8(c0, codes); returns xs. LayerNorm (when gamma != nullptr): fp32,
// mean and two-pass biased variance over K, ((x - mean) * rsqrt(var +
// 1e-5)) * gamma + beta. Rows longer than 1,024 values take
// quant_row_long. A row of a multiple of 8 values at 16-byte aligned
// addresses is read 8 values a load (lane `lane` holds columns 8 * (lane +
// 32 i) .. + 7, and sums them in that order); other rows a value a load
// (columns lane + 32 i).
template <class Store, class Store8>
__device__ __forceinline__ float quant_row_to(const __nv_bfloat16* __restrict__ src, int K,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, int Kp,
                                              Store store, Store8 store8, int lane) {
  if (Kp > kMaxRowPerLane * 32) return quant_row_long(src, K, gamma, beta, Kp, store, lane);
  if (K % 8 == 0 && aligned16(src) &&
      (gamma == nullptr || (aligned16(gamma) && aligned16(beta)))) {
    constexpr int kChunks = kMaxRowPerLane / 8;   // of eight values each
    float v[kChunks][8];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c0 = 8 * (lane + 32 * i);
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);   // zeros past K
      if (c0 < K) raw = *reinterpret_cast<const uint4*>(src + c0);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[i][2 * j] = __uint_as_float(w[j] << 16);
        v[i][2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
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
        if (8 * (lane + 32 * i) < K)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = __fadd_rn(v[i][j], -mean);
            q = __fadd_rn(q, __fmul_rn(d, d));
          }
      const float rs = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), static_cast<float>(K)), 1e-5f));
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c0 = 8 * (lane + 32 * i);
        if (c0 < K) {
          const float4* g4 = reinterpret_cast<const float4*>(gamma + c0);
          const float4* b4 = reinterpret_cast<const float4*>(beta + c0);
          const float4 ga = g4[0], gb = g4[1], ba = b4[0], bb = b4[1];
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
    v[i] = c < K ? __bfloat162float(src[c]) : 0.f;
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

// quant_row_to into `dst` (round_up(K, kBK) bytes, 8-byte aligned, the
// tail zeroed)
__device__ __forceinline__ float quant_row_bf16(const __nv_bfloat16* __restrict__ src,
                                                int K, const float* __restrict__ gamma,
                                                const float* __restrict__ beta,
                                                int8_t* dst, int lane) {
  return quant_row_to(
      src, K, gamma, beta, round_up(K, kBK), [dst](int c, int8_t code) { dst[c] = code; },
      [dst](int c0, uint2 codes) { *reinterpret_cast<uint2*>(dst + c0) = codes; }, lane);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One 4-byte B fragment register straight from device memory: W^T (N, K)
// int8 with k contiguous, column n, k .. k+3 (zeros past K or N). vec:
// W^T 4-byte aligned and K % 4 == 0.
__device__ __forceinline__ uint32_t ldg_wt(const int8_t* __restrict__ Wt, int n, int k, int K,
                                           int N, bool vec) {
  if (n >= N || k >= K) return 0u;
  const int8_t* p = Wt + static_cast<long long>(n) * K + k;
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
  return v;
}

// acc = codes[rows m_base.. of this warp] @ W[:, n_base : n_base + NT*8],
// the B fragments loaded by each warp from W^T (N, K) in device memory
// (L2), a few k-steps ahead in a register ring, with no barrier: the warps
// of a block share no weight fragment (each owns its columns and all the
// block's rows), so staging through shared memory would buy no reuse. The
// codes must be zero past K up to a multiple of kBK.
//
// The loop is bound by instruction issue, so the full-tile case (fast: K
// a multiple of 64, W^T 16-byte aligned; all NT*8 columns < N) loads 16
// bytes per thread at a time: thread (g, t) takes bytes 16t .. 16t+15 of a
// 64-wide k block for its A rows and its B column, and feeds them to two
// m16n8k32 steps as k = 16t+0..3 and 16t+4..7 (first step), 16t+8..11 and
// 16t+12..15 (second). That is a permutation of k applied to A and B alike,
// and the int32 sums are exact, so the result is the same bits as the
// plain product. Other tiles take 4-byte loads with bounds checks.
constexpr int kPrefetch = 2;  // 64-wide k blocks in flight per warp

template <int MT, int NT>
__device__ __forceinline__ void gemm_direct(int (&acc)[MT][NT][4], const int8_t* as, int sa,
                                            int m_base, const int8_t* __restrict__ Wt, int K,
                                            int N, int n_base, bool fast) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  if (fast && n_base + NT * 8 <= N) {
    const uint4* wp[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wp[j] = reinterpret_cast<const uint4*>(
          Wt + static_cast<long long>(n_base + j * 8 + g) * K + 16 * t);
    const int8_t* ap = as + (m_base + g) * sa + 16 * t;
    uint4 ring[kPrefetch][NT];
#pragma unroll
    for (int p = 0; p < kPrefetch; ++p)
      if (p * 64 < K)
#pragma unroll
        for (int j = 0; j < NT; ++j) ring[p][j] = __ldg(wp[j] + 4 * p);
    for (int k0 = 0; k0 < K; k0 += 64 * kPrefetch) {
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p) {
        const int kb = k0 + 64 * p;
        if (kb < K) {
          uint4 lo[MT], hi[MT];  // rows g and g + 8 of each m16 tile
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            lo[i] = *reinterpret_cast<const uint4*>(ap + i * 16 * sa + kb);
            hi[i] = *reinterpret_cast<const uint4*>(ap + (i * 16 + 8) * sa + kb);
          }
          const bool more = kb + 64 * kPrefetch < K;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint4 b = ring[p][j];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const uint32_t a0[4] = {lo[i].x, hi[i].x, lo[i].y, hi[i].y};
              const uint32_t a1[4] = {lo[i].z, hi[i].z, lo[i].w, hi[i].w};
              mma_s8(acc[i][j], a0, b.x, b.y);
              mma_s8(acc[i][j], a1, b.z, b.w);
            }
            if (more) ring[p][j] = __ldg(wp[j] + (kb >> 4) + 4 * kPrefetch);
          }
        }
      }
    }
    return;
  }
  const bool v4 = K % 4 == 0 && aligned4(Wt);
  const int8_t* ap = as + (m_base + g) * sa + t * 4;
  for (int kk = 0; kk < round_up(K, 32); kk += 32) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int8_t* q = ap + i * 16 * sa + kk;
      a[i][0] = lds32(q);
      a[i][1] = lds32(q + 8 * sa);
      a[i][2] = lds32(q + 16);
      a[i][3] = lds32(q + 8 * sa + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n_base + j * 8 + g, k = kk + t * 4;
      const uint32_t b0 = ldg_wt(Wt, n, k, K, N, v4), b1 = ldg_wt(Wt, n, k + 16, K, N, v4);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
  }
}

// y = ((float)acc * xs) * s + b [+ r]
__device__ __forceinline__ float epilogue(int acc, float xs, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), s), b);
}


}  // namespace w8a8

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
