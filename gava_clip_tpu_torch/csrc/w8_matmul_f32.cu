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
// cannot go through it. Here every product is an fp32 FMA on the CUDA
// cores: a TF32 tensor-core product would round each operand to a 10-bit
// mantissa (~5e-4 relative), which an fp32 run must not see.
//
// What bounds it on an H100 SXM (data-sheet figures, not measured): at fc1
// of the w8 evaluation (M = 25216, K = 768, N = 3072) 119 GFLOP, 1.78 ms at
// 67 TFLOP/s of fp32 FMA, against 390 MB of x, W and y (0.116 ms at 3.35
// TB/s): operations. What matters is that each FMA takes its operands from
// registers, which the 8 x 8 patches below do (four 16-byte shared loads per
// 64 FMA).
//
// Design. A simple kernel that is right. A block computes 128 rows of x by
// 128 columns of y, 256 threads (16 x 16), each an 8 x 8 patch (rows 4 ty +
// i and 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j). Per 64-wide k
// step it stores the x tile transposed, xs[k][m] (a warp loads 16 rows x 2
// float4, one 32-byte sector a row, and its stores fall in 32 distinct
// banks), and dequantizes the weight tile into ws[k][n]: the 128 x 64 tile
// of the w8 kernel layout (ops/int8_matmul.w8_kernel_layout, 8,192
// contiguous bytes, the same weight leaf 'q_t' as the bf16 form), 16 bytes
// a thread twice, each byte to its (n, k) by the layout's order, each
// product with its column's scale. Then 64 rank-1 steps, each output summed
// in k order from 0 by fmaf. Two blocks share an SM, so one block's loads
// overlap the other's products.
//
// Ragged shapes: rows of x past M and k past K load as zeros, outputs past M
// or N are not stored; the layout holds W^T zero-padded to whole tiles. x's
// rows must be 16-byte aligned with K a multiple of 4 (the Python wrapper
// copies them zero-padded otherwise).
// Launches on the caller's stream, no sync, no allocation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                   // rows of x a block
constexpr int kBN = 128;                   // columns of y a block: one weight tile's rows
constexpr int kBK = 64;                    // k a step: one weight tile's columns
constexpr int kLDS = kBM + 4;              // padded shared row: 528 bytes, 16-byte aligned
constexpr int kTileFloats = kBK * kLDS;    // one 64 x 128 tile, k-major
constexpr int kThreads = 256;              // 16 x 16 threads, an 8 x 8 patch each
constexpr int kWTileBytes = kBN * kBK;     // 8,192: one tile of the w8 kernel layout
constexpr int kSmemBytes = 2 * kTileFloats * 4;   // xs and ws: 67,584

struct W8Args {
  const float* x;
  const int8_t* wk;      // the w8 kernel layout: (ceil(N / 128), KT, 8192) int8
  const float* scale;    // (N)
  float* y;              // (M, N) contiguous
  int M, K, N, KT, n_tiles, vec_y;
};

// The x tile of rows [m0, m0 + 128) and columns [k0, k0 + 64), transposed:
// xs[k][m]; rows past M and columns past K are zeros.
__device__ __forceinline__ void load_x(float* xs, const W8Args& a, int m0, int k0) {
#pragma unroll
  for (int it = 0; it < kBM * kBK / 4 / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int w = idx >> 5, l = idx & 31;
    const int r = (w & 7) * 16 + (l >> 1);
    const int c = ((w >> 3) * 2 + (l & 1)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < a.M && k0 + c < a.K)
      v = *reinterpret_cast<const float4*>(a.x + static_cast<long long>(m0 + r) * a.K + k0 + c);
    xs[(c + 0) * kLDS + r] = v.x;
    xs[(c + 1) * kLDS + r] = v.y;
    xs[(c + 2) * kLDS + r] = v.z;
    xs[(c + 3) * kLDS + r] = v.w;
  }
}

// The weight tile dequantized, ws[k][n] = (float)W * scale[n]. Chunk i of
// 16 bytes (two a thread) is lane (g, t) = (i >> 2 & 7, i & 3) of half h = i
// >> 5 & 1 of 16-row slab s = i >> 6; its byte b is row s * 16 + 8 (b >> 1
// & 1) + g, column 32 h + 16 (b >> 3) + 8 (b >> 2 & 1) + 2 t + (b & 1).
// sc[it][r8] is the scale of the chunk's row of half r8.
__device__ __forceinline__ void load_w(float* ws, const int8_t* tile, const float (&sc)[2][2]) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int t = i & 3, g = (i >> 2) & 7, h = (i >> 5) & 1, s = i >> 6;
    const uint4 u = *reinterpret_cast<const uint4*>(tile + i * 16);
    const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int8_t q = static_cast<int8_t>((word[b >> 2] >> (8 * (b & 3))) & 0xffu);
      const int n = s * 16 + 8 * ((b >> 1) & 1) + g;
      const int k = 32 * h + 16 * (b >> 3) + 8 * ((b >> 2) & 1) + 2 * t + (b & 1);
      ws[k * kLDS + n] = __fmul_rn(static_cast<float>(q), sc[it][(b >> 1) & 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) w8_matmul_f32_kernel(W8Args a) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = smem + kTileFloats;
  const int nb = blockIdx.x % a.n_tiles;
  const int m0 = (blockIdx.x / a.n_tiles) * kBM, n0 = nb * kBN;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // the scales of the rows of W^T this thread dequantizes (0 past N, where
  // the layout's rows are zeros)
  float sc[2][2];
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int i = it * kThreads + threadIdx.x;
#pragma unroll
    for (int r8 = 0; r8 < 2; ++r8) {
      const int n = n0 + (i >> 6) * 16 + 8 * r8 + ((i >> 2) & 7);
      sc[it][r8] = n < a.N ? a.scale[n] : 0.f;
    }
  }
  const int8_t* wtiles = a.wk + static_cast<long long>(nb) * a.KT * kWTileBytes;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < a.KT; ++kt) {
    __syncthreads();   // the previous step's tiles are read
    load_x(xs, a, m0, kt * kBK);
    load_w(ws, wtiles + static_cast<long long>(kt) * kWTileBytes, sc);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * kLDS + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + kk * kLDS + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(ws + kk * kLDS + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(ws + kk * kLDS + 64 + 4 * tx);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= a.M) continue;
    float* yr = a.y + static_cast<long long>(m) * a.N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + 64 * half + 4 * tx;
      const float* v = acc[i] + 4 * half;
      if (a.vec_y && n + 4 <= a.N) {
        *reinterpret_cast<float4*>(yr + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < 4 && n + j < a.N; ++j) yr[n + j] = v[j];
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
  a.KT = (K + kBK - 1) / kBK;
  a.n_tiles = static_cast<int>(n_tiles);
  a.vec_y = N % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15u) == 0;
  w8_matmul_f32_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
