// Weight-only int8 GEMM (w8 serving mode) in float32 for Hopper (sm_90a):
// the fp32 form of csrc/w8_matmul.cu.
//
// Replaces, for float32 activations, the TPU kernel
// gava_clip_tpu/ops/int8_matmul.py: _kernel (:54, reached through
// int8_matmul's pl.pallas_call at :82), which dequantizes the weight to the
// activation's dtype and emits it:
//
//   x (M, K) fp32; W (K, N) int8; scale (N) fp32:
//     w[k][n] = (float)W[k][n] * scale[n]      one fp32 product (exact from
//                                              int8), no cast after it
//     y       = sum_k x[m][k] * w[k][n]        fp32, stored as fp32
//
// The bf16 form feeds bf16 register fragments to wgmma, so an fp32 row
// cannot go through it. Here every product runs on the tensor cores as
// 3xTF32: each fp32 operand split into hi = tf32(v) and lo = v - hi
// (tf32_frags.cuh's split), the product taken as lo_x hi_w + hi_x lo_w +
// hi_x hi_w (lo_x lo_w, 2^-22 of it, dropped), within 2^-20 of the exact
// product (tests/test_torch_attention_f32.py holds that against numpy). One
// TF32 product alone rounds each operand to a 10-bit mantissa (~5e-4
// relative), which an fp32 run must not see. The three products of each k8
// step go into a fresh accumulator (wgmma with scale-d 0, then two into it)
// and are added to the running sum in fp32, to nearest: the tensor core
// truncates the sum it accumulates, which over a chain of steps into one
// accumulator drifts by about an ulp of it a step (utils/kernel_variants.py
// f32b9_chained: 2.07-3.54 x 2^-19 of sum |x| |w| on an H100, past
// chip_smoke's W8_F32_REL).
//
// What bounds it on an H100 SXM (data-sheet figures, not measured): at fc1
// of the w8 evaluation (M = 25216, K = 768, N = 3072) 119 GFLOP, three TF32
// products each: 0.721 ms at 495 TFLOP/s (1.78 ms as fp32 FMA at 67),
// against 390 MB of x, W and y (0.116 ms at 3.35 TB/s): operations. Only
// wgmma approaches the TF32 rate on this card (8 warps of mma.sync m16n8k8
// on the same pre-split planes ran far below it), so the products are wgmma
// m64n128k8 TF32 (tf32_frags.cuh), and what is left is to keep the
// splitting and dequantization off their path.
//
// Design. A block computes 128 rows of x by 128 columns of y in k steps of
// 32 (half a tile of the w8 kernel layout, ops/int8_matmul.w8_kernel_layout:
// 128 x 64 int8, 8,192 contiguous bytes, the same weight leaf 'q_t' as the
// bf16 form), with three warpgroups:
//   * a converter warpgroup issues each step's copies by cp.async two steps
//     ahead into one of three raw stages (the x tile, 128 x 32 fp32 in rows
//     padded to 36 floats, and the half weight tile, 4,096 bytes), and
//     during step ks dequantizes step ks + 1's weight bytes (one fp32
//     product with the column's scale), splits them and writes w's hi and
//     lo planes in wgmma's k-major core matrices (8 rows x 4 values of k,
//     unswizzled) into the other of two plane sets;
//   * two product warpgroups, 64 rows of x each by all 128 columns: each
//     warp loads the A fragments of its 16 rows from the raw x stage and
//     splits them in registers (no other warp reads those values, so each
//     x value is split once a block, as each weight is), then per k8 step
//     issues the three wgmma with B from w's planes by descriptor, waits,
//     and adds the step's sum into its 64 running sums.
// One barrier a step hands the planes over. Each operand value is split
// once a block and the products' loop is fragment loads, splits of x,
// wgmma and the adds. 133,120 bytes of shared memory, one block an SM.
//
// Ragged shapes: rows of x past M and k past K load as zeros, outputs past M
// or N are not stored; the layout holds W^T zero-padded to whole tiles. x's
// rows must be 16-byte aligned with K a multiple of 4 (the Python wrapper
// copies them zero-padded otherwise).
// Launches on the caller's stream, no sync, no allocation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_frags.cuh"

namespace {

constexpr int kBM = 128;                   // rows of x a block: two warpgroups of 64
constexpr int kBN = 128;                   // columns of y a block: one weight tile's rows
constexpr int kWTileK = 64;                // k of one weight tile
constexpr int kBK = 32;                    // k a step: half a weight tile
constexpr int kMmaThreads = 256;           // two warpgroups of products, 64 x 128 outputs each
constexpr int kCvtThreads = 128;           // a warpgroup that copies the steps and splits w
constexpr int kThreads = kMmaThreads + kCvtThreads;
constexpr int kWTileBytes = kBN * kWTileK; // 8,192: one tile of the w8 kernel layout
constexpr int kWStepBytes = kBN * kBK;     // 4,096: a step's half tile
constexpr int kCvtChunks = kWStepBytes / 16 / kCvtThreads;   // weight chunks a converter thread
constexpr int kLDP = kBK + 4;              // floats a raw x row: 144 bytes, 16-byte aligned
constexpr int kXStageFloats = kBM * kLDP;  // a step's x tile as it came
constexpr int kWPlaneFloats = kBN * kBK;   // w hi or lo, in wgmma core matrices
constexpr int kCoreBytes = 8 * 16;         // a core matrix: 8 rows x 4 values of k
constexpr int kStages = 3;                 // raw stages: copies two steps ahead
// w's planes (two sets of hi and lo), the raw x and weight stages: 133,120
constexpr int kSmemBytes = (4 * kWPlaneFloats + kStages * kXStageFloats) * 4 + kStages * kWStepBytes;
constexpr int kAcc = 64;                   // fp32 accumulators a product thread

struct W8Args {
  const float* x;
  const int8_t* wk;      // the w8 kernel layout: (ceil(N / 128), KT, 8192) int8
  const float* scale;    // (N)
  float* y;              // (M, N) contiguous
  int M, K, N, KT, KS, n_tiles, vec_y;
};

// The copies of step ks, by converter thread c (0..127): x rows [m0, m0 +
// 128), columns [32 ks, 32 ks + 32) into xs (zeros past M and K), eight
// 16-byte pieces a thread, and two 16-byte chunks of the half weight tile
// into ws. Chunk i of a tile's 512 is lane (g, t) = (i >> 2 & 7, i & 3) of
// half h = i >> 5 & 1 of 16-row slab s = i >> 6; raw chunk T (0..255) of
// half h = ks & 1 is tile chunk (T >> 5) * 64 + 32 h + (T & 31), and thread
// c takes raw chunks c and c + 128.
__device__ __forceinline__ void issue(float* xs, int8_t* ws, const W8Args& a, int m0,
                                      const int8_t* wtiles, int ks, int c) {
  const int k0 = ks * kBK;
#pragma unroll
  for (int it = 0; it < kBM * kBK / 4 / kCvtThreads; ++it) {
    const int idx = it * kCvtThreads + c;
    const int r = idx >> 3, col = (idx & 7) * 4;
    const bool ok = m0 + r < a.M && k0 + col < a.K;
    const float* src = ok ? a.x + static_cast<long long>(m0 + r) * a.K + k0 + col : a.x;
    tf32::cp_async16(xs + r * kLDP + col, src, ok);
  }
  const int8_t* tile = wtiles + static_cast<long long>(ks >> 1) * kWTileBytes;
#pragma unroll
  for (int it = 0; it < kCvtChunks; ++it) {
    const int T = it * kCvtThreads + c;
    const int chunk = (T >> 5) * 64 + (ks & 1) * 32 + (T & 31);
    tf32::cp_async16(ws + T * 16, tile + chunk * 16, true);
  }
}

// byte I of u (the int8 value + 128) as an exact float: the byte is the
// mantissa of 2^23 + byte, and 2^23 + 128 is subtracted (csrc/w8_matmul.cu's
// s8_to_f32)
__device__ __forceinline__ float s8_to_f32(uint32_t u, int I) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + I)), 8388736.0f);
}

// Converter thread c's two weight chunks of a landed stage into w's hi and
// lo planes: byte b of raw chunk T at row n = 16 (T >> 5) + 8 (b >> 1 & 1) +
// g, column k = 16 (b >> 3) + 8 (b >> 2 & 1) + 2 t + (b & 1) of the half
// ((g, t) = (T >> 2 & 7, T & 3)), dequantized with its row's scale sc[it][b
// >> 1 & 1] and split; w (n, k) lies in core matrix (n / 8, k / 4), row n %
// 8, at k % 4
__device__ __forceinline__ void convert_w(const int8_t* ws, float* wh, float* wl,
                                          const float (&sc)[kCvtChunks][2], int c) {
#pragma unroll
  for (int it = 0; it < kCvtChunks; ++it) {
    const int T = it * kCvtThreads + c;
    const uint4 u = *reinterpret_cast<const uint4*>(ws + T * 16);
    const uint32_t word[4] = {u.x, u.y, u.z, u.w};
    const int t = T & 3, g = (T >> 2) & 7, s = T >> 5;
#pragma unroll
    for (int b = 0; b < 16; b += 2) {
      const int n = s * 16 + 8 * ((b >> 1) & 1) + g;
      const int k = 16 * (b >> 3) + 8 * ((b >> 2) & 1) + 2 * t;   // and k + 1 (byte b + 1)
      const float scl = sc[it][(b >> 1) & 1];
      const uint32_t u = word[b >> 2] ^ 0x80808080u;
      uint32_t h0, l0, h1, l1;
      tf32::split(__fmul_rn(s8_to_f32(u, b & 3), scl), h0, l0);
      tf32::split(__fmul_rn(s8_to_f32(u, (b & 3) + 1), scl), h1, l1);
      const int at = (((n >> 3) * (kBK / 4) + (k >> 2)) * 8 + (n & 7)) * 4 + (k & 3);
      *reinterpret_cast<float2*>(wh + at) = make_float2(__uint_as_float(h0), __uint_as_float(h1));
      *reinterpret_cast<float2*>(wl + at) = make_float2(__uint_as_float(l0), __uint_as_float(l1));
    }
  }
}

// f = x w of one k8 step in 3xTF32, a fresh sum: lo_x hi_w, then hi_x lo_w
// and hi_x hi_w into it (bh, bl: the descriptors of w's hi and lo planes
// at the step)
__device__ __forceinline__ void step3(float (&f)[kAcc], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint64_t bh, uint64_t bl) {
  tf32::wgmma_tf32_z(f, al, bh);   // lo_x hi_w
  tf32::wgmma_tf32(f, ah, bl);     // hi_x lo_w
  tf32::wgmma_tf32(f, ah, bh);     // hi_x hi_w
}

__global__ void __launch_bounds__(kThreads, 1) w8_matmul_f32_kernel(W8Args a) {
  extern __shared__ __align__(16) float smem[];
  // w planes [set][hi, lo], then the raw x stages, then the raw w stages
  float* xs0 = smem + 2 * 2 * kWPlaneFloats;
  int8_t* ws0 = reinterpret_cast<int8_t*>(xs0 + kStages * kXStageFloats);
  const int nb = blockIdx.x % a.n_tiles;
  const int m0 = (blockIdx.x / a.n_tiles) * kBM, n0 = nb * kBN;
  const int8_t* wtiles = a.wk + static_cast<long long>(nb) * a.KT * kWTileBytes;
  auto xs = [&](int ks) { return xs0 + (ks % kStages) * kXStageFloats; };
  auto ws = [&](int ks) { return ws0 + (ks % kStages) * kWStepBytes; };
  auto wplanes = [&](int ks) { return smem + (ks & 1) * 2 * kWPlaneFloats; };

  if (threadIdx.x >= kMmaThreads) {
    // the converter warpgroup: every step's copies two steps ahead, and
    // during step ks step ks + 1's weights into the other plane set
    const int c = threadIdx.x - kMmaThreads;
    // the scales of the rows of W^T this thread dequantizes (0 past N,
    // where the layout's rows are zeros)
    float sc[kCvtChunks][2];
#pragma unroll
    for (int it = 0; it < kCvtChunks; ++it)
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        const int T = it * kCvtThreads + c;
        const int n = n0 + (T >> 5) * 16 + 8 * r8 + ((T >> 2) & 7);
        sc[it][r8] = n < a.N ? a.scale[n] : 0.f;
      }
    issue(xs(0), ws(0), a, m0, wtiles, 0, c);
    tf32::cp_commit();
    if (a.KS > 1) issue(xs(1), ws(1), a, m0, wtiles, 1, c);
    tf32::cp_commit();
    tf32::cp_wait_1();   // step 0's pieces are in
    convert_w(ws(0), wplanes(0), wplanes(0) + kWPlaneFloats, sc, c);
    tf32::fence_proxy_async();
    for (int ks = 0; ks < a.KS; ++ks) {
      __syncthreads();   // step ks's x and w are in; step ks - 1's stages and planes are free
      if (ks + 2 < a.KS) issue(xs(ks + 2), ws(ks + 2), a, m0, wtiles, ks + 2, c);
      tf32::cp_commit();
      if (ks + 1 < a.KS) {
        tf32::cp_wait_1();   // step ks + 1's pieces are in
        convert_w(ws(ks + 1), wplanes(ks + 1), wplanes(ks + 1) + kWPlaneFloats, sc, c);
        tf32::fence_proxy_async();
      }
    }
    return;
  }

  // the product warpgroups: 64 rows of x each, all 128 columns; thread
  // (warp w of the warpgroup, lane (g, t)) holds rows 16 w + g, + 8, and
  // splits the x values of its A fragments, which no other warp reads
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g;
  float acc[kAcc], f[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < a.KS; ++ks) {
    __syncthreads();   // step ks's x and w planes are in
    const float* x = xs(ks);
    const float* wh = wplanes(ks);
    const float* wl = wh + kWPlaneFloats;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      // A fragment: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g +
      // 8, t + 4) of the warp's 16 rows, split into hi and lo
      const int at = row0 * kLDP + 8 * kk + t;
      uint32_t ah[4], al[4];
      tf32::split(x[at], ah[0], al[0]);
      tf32::split(x[at + 8 * kLDP], ah[1], al[1]);
      tf32::split(x[at + 4], ah[2], al[2]);
      tf32::split(x[at + 8 * kLDP + 4], ah[3], al[3]);
      // B: k 8 kk .. 8 kk + 7 of w, core matrices 2 kk and 2 kk + 1 of each
      // 8-row group
      const uint64_t bh = tf32::desc_k(wh + 2 * kk * (kCoreBytes / 4), kCoreBytes,
                                       (kBK / 4) * kCoreBytes);
      const uint64_t bl = tf32::desc_k(wl + 2 * kk * (kCoreBytes / 4), kCoreBytes,
                                       (kBK / 4) * kCoreBytes);
      tf32::wgmma_fence();
      step3(f, ah, al, bh, bl);
      tf32::wgmma_commit();
      tf32::wgmma_wait_all();
      tf32::pin(f);
      // the step's sum added to the running one in fp32, to nearest
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] += f[i];
    }
  }

  // acc[4 j + 0, 1]: row row0, columns 8 j + 2 t, + 1; acc[4 j + 2, 3]: row
  // row0 + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + row0 + 8 * half;
    if (m >= a.M) continue;
    float* yr = a.y + static_cast<long long>(m) * a.N;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (a.vec_y && n + 2 <= a.N) {
        *reinterpret_cast<float2*>(yr + n) = make_float2(v0, v1);
      } else {
        if (n < a.N) yr[n] = v0;
        if (n + 1 < a.N) yr[n + 1] = v1;
      }
    }
  }
}

}  // namespace

// x (M, K) fp32, rows 16-byte aligned, K a multiple of 4; Wk the w8 kernel
// layout of W (ceil(N / 128) x ceil(K / 64) tiles of 8,192 bytes, as
// csrc/w8_matmul.cu reads it); scale (N) fp32; y (M, N) fp32 contiguous.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int w8_matmul_f32(const void* x, const void* Wk, const void* scale, void* y, int M,
                             int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15u) != 0 || (reinterpret_cast<uintptr_t>(Wk) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (N + kBN - 1) / kBN;
  const long long tiles = n_tiles * ((M + kBM - 1) / kBM);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(w8_matmul_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  W8Args a;
  a.x = static_cast<const float*>(x);
  a.wk = static_cast<const int8_t*>(Wk);
  a.scale = static_cast<const float*>(scale);
  a.y = static_cast<float*>(y);
  a.M = M; a.K = K; a.N = N;
  a.KT = (K + kWTileK - 1) / kWTileK;
  a.KS = (K + kBK - 1) / kBK;
  a.n_tiles = static_cast<int>(n_tiles);
  a.vec_y = N % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7u) == 0;
  w8_matmul_f32_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
