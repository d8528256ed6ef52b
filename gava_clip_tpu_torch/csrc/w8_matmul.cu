// Weight-only int8 GEMM (w8 serving mode) for Hopper (sm_90a).
//
// Replaces the TPU kernel gava_clip_tpu/ops/int8_matmul.py: _kernel (reached
// through int8_matmul's pl.pallas_call); in the w8 serving mode it is every
// projection of a block (q, k, v, out, fc1, fc2):
//
//   x (M, K) bf16; W (K, N) int8, passed transposed (W^T (N, K), k
//   contiguous); scale (N) fp32:
//     w[k][n] = bf16((float)W[k][n] * scale[n])      one rounding per weight
//     y       = bf16(sum_k x[m][k] * w[k][n])        fp32 accumulation
//
// The bf16 weights never exist in device memory: a block reads its weight
// tile as int8 and dequantizes it on the way into shared memory, once per
// tile, so the inner loop sees plain bf16 operands.
//
// What bounds it on an H100 SXM (data-sheet figures, not measured): at the
// largest serving shape, fc1 (M = 25216, K = 768, N = 3072), 119 GFLOP of
// bf16, 0.12 ms at 989 TFLOP/s, against ~196 MB moved (59 us at 3.35 TB/s):
// operations. mma.sync reaches a part of that rate only; wgmma with TMA is
// later work.
//
// Design (simple first): a block of 8 warps owns a 128 x 128 output tile and
// walks K in 32-wide steps through two shared-memory buffers: while the
// warps multiply one step (ldmatrix + mma.sync m16n8k16, each warp 64 x 32),
// every thread holds the next step's global loads in registers (16 bytes of
// x twice, 16 int8 weights once), then converts and stores them. Two blocks
// share an SM (128 registers a thread), so one block's conversions overlap
// the other's products: measured on an H100 (NVIDIA H100 80GB HBM3,
// 700.00 W), 64-wide steps with one block per SM took 0.685 ms at fc1's
// shape against 0.533 ms for this form. M, N and K need not be multiples of
// the tile: rows and columns past the edge load as zeros and are not
// stored; K not a multiple of 16 (or unaligned pointers) takes element-wise
// guarded loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLD = kBK + 8;          // padded bf16 row of a shared tile
constexpr int kMT = 4, kNT = 4;       // m16 / n8 tiles per warp: 64 x 32
constexpr int kAVec = kBM * kBK / 8 / kThreads;    // 16-byte x loads per thread
constexpr int kBVec = kBN * kBK / 16 / kThreads;   // 16-weight loads per thread

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 bf16 of row `row` of x from column `col` on (zeros past M or K)
__device__ __forceinline__ uint4 load_x(const __nv_bfloat16* __restrict__ x, int M, int K,
                                        int row, int col, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= M || col >= K) return v;
  const __nv_bfloat16* p = x + static_cast<long long>(row) * K + col;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned short h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = col + j < K ? __bfloat16_as_ushort(p[j]) : 0;
  v.x = h[0] | (static_cast<uint32_t>(h[1]) << 16);
  v.y = h[2] | (static_cast<uint32_t>(h[3]) << 16);
  v.z = h[4] | (static_cast<uint32_t>(h[5]) << 16);
  v.w = h[6] | (static_cast<uint32_t>(h[7]) << 16);
  return v;
}

// 16 int8 of row `n` of W^T from k = `col` on (zeros past N or K)
__device__ __forceinline__ uint4 load_w(const int8_t* __restrict__ Wt, int N, int K, int n,
                                        int col, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (n >= N || col >= K) return v;
  const int8_t* p = Wt + static_cast<long long>(n) * K + col;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (col + j < K) w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// four int8 in one register -> two registers of bf16 pairs, each value
// bf16((float)w * s): the fp32 product rounded once
__device__ __forceinline__ void dequant4(uint32_t w, float s, uint32_t& lo, uint32_t& hi) {
  const float f0 = static_cast<float>(static_cast<int8_t>(w & 0xffu));
  const float f1 = static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu));
  const float f2 = static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu));
  const float f3 = static_cast<float>(static_cast<int8_t>(w >> 24));
  lo = pack2(__fmul_rn(f0, s), __fmul_rn(f1, s));
  hi = pack2(__fmul_rn(f2, s), __fmul_rn(f3, s));
}

__global__ void __launch_bounds__(kThreads, 2)
w8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ Wt,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int K,
                 int N, bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // 2 x kBM x kLD
  __nv_bfloat16* Bs = As + 2 * kBM * kLD;                       // 2 x kBN x kLD
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // the warp's tile
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // this thread's slots of the two tiles, and the scales of its weight rows
  int a_row[kAVec], a_col[kAVec], b_row[kBVec], b_col[kBVec];
  float b_scale[kBVec];
#pragma unroll
  for (int i = 0; i < kAVec; ++i) {
    const int idx = tid + kThreads * i;
    a_row[i] = idx / (kBK / 8);
    a_col[i] = (idx % (kBK / 8)) * 8;
  }
#pragma unroll
  for (int i = 0; i < kBVec; ++i) {
    const int idx = tid + kThreads * i;
    b_row[i] = idx / (kBK / 16);
    b_col[i] = (idx % (kBK / 16)) * 16;
    b_scale[i] = n0 + b_row[i] < N ? scale[n0 + b_row[i]] : 0.f;
  }

  uint4 a_reg[kAVec], b_reg[kBVec];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAVec; ++i)
      a_reg[i] = load_x(x, M, K, m0 + a_row[i], k0 + a_col[i], vec_x);
#pragma unroll
    for (int i = 0; i < kBVec; ++i)
      b_reg[i] = load_w(Wt, N, K, n0 + b_row[i], k0 + b_col[i], vec_w);
  };
  auto store_tile = [&](int buf) {
    __nv_bfloat16* a = As + buf * kBM * kLD;
    __nv_bfloat16* b = Bs + buf * kBN * kLD;
#pragma unroll
    for (int i = 0; i < kAVec; ++i)
      *reinterpret_cast<uint4*>(a + a_row[i] * kLD + a_col[i]) = a_reg[i];
#pragma unroll
    for (int i = 0; i < kBVec; ++i) {
      uint4 lo, hi;
      dequant4(b_reg[i].x, b_scale[i], lo.x, lo.y);
      dequant4(b_reg[i].y, b_scale[i], lo.z, lo.w);
      dequant4(b_reg[i].z, b_scale[i], hi.x, hi.y);
      dequant4(b_reg[i].w, b_scale[i], hi.z, hi.w);
      uint4* dst = reinterpret_cast<uint4*>(b + b_row[i] * kLD + b_col[i]);
      dst[0] = lo;
      dst[1] = hi;
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int KT = (K + kBK - 1) / kBK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const bool more = kt + 1 < KT;
    if (more) load_tile((kt + 1) * kBK);
    const __nv_bfloat16* a = As + (kt & 1) * kBM * kLD;
    const __nv_bfloat16* b = Bs + (kt & 1) * kBN * kLD;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // B fragments of the warp's four n8 tiles: one x4 per pair of tiles
      // (matrices: tile 0 k 0-7, tile 0 k 8-15, tile 1 k 0-7, tile 1 k 8-15)
      uint32_t bf[kNT / 2][4];
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp)
        ldmatrix_x4(bf[jp], b + (wn + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLD +
                                kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        // A fragment of one m16 tile (matrices: rows 0-7 k 0-7, rows 8-15
        // k 0-7, rows 0-7 k 8-15, rows 8-15 k 8-15)
        uint32_t af[4];
        ldmatrix_x4(af, a + (wm + i * 16 + (lane & 15)) * kLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_16816(acc[i][j], af, bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);
      }
    }
    if (more) store_tile((kt + 1) & 1);
    __syncthreads();
  }

  const bool pair = N % 2 == 0;   // 4-byte stores of two columns
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* yrow = y + static_cast<long long>(m) * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + wn + j * 8 + t * 2;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pair && n + 1 < N) {
          *reinterpret_cast<uint32_t*>(yrow + n) = pack2(v0, v1);
        } else {
          if (n < N) yrow[n] = __float2bfloat16(v0);
          if (n + 1 < N) yrow[n + 1] = __float2bfloat16(v1);
        }
      }
    }
}

}  // namespace

// x (M, K) bf16 contiguous; W^T (N, K) int8 contiguous; scale (N) fp32;
// y (M, N) bf16 contiguous. Returns cudaGetLastError() after the launch.
extern "C" int w8_matmul_bf16(const void* x, const void* Wt, const void* scale, void* y, int M,
                              int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(2) * (kBM + kBN) * kLD * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      w8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_x = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const bool vec_w = K % 16 == 0 && (reinterpret_cast<uintptr_t>(Wt) & 15u) == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8_matmul_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(Wt),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, K, N, vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
