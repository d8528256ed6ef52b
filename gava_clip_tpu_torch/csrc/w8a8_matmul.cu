// Fused w8a8 GEMM for Hopper (sm_90a): per-row int8 quant of x, int8 GEMM,
// rescale and bias.
//
// Replaces the TPU kernel gava_clip_tpu/ops/int8_matmul.py: _w8a8_kernel
// (w8a8_matmul's pl.pallas_call); on the serving path it is the patch-major
// patch embed, once per forward:
//
//   x (M, K) bf16 (raw 0..255 pixels there), W (K, N) int8, s (N) fp32,
//   b (N) fp32 or none -> y (M, N) bf16:
//     xs_m = max(max_k |x_mk|, 1e-6) * fp32(1/127)
//     c_mk = rint(x_mk * (1 / xs_m))                  (no clip)
//     y_mn = bf16(((float)(sum_k c_mk W_kn) * xs_m) * s_n + b_n)
//
// What bounds it on an H100 SXM (data-sheet figures, not measured), at the
// serving shape M = 25088 (16 clips x 8 frames x 196 patches), K = N = 768:
// 29.6 G int8 operations, 15 us at the 1,979 TOP/s int8 dense peak; it
// reads x (38.5 MB) and writes y (38.5 MB), 23 us at 3.35 TB/s. So it is
// near the balance point and neither roof is close for a simple kernel:
// what matters is that the codes never reach device memory (quant, GEMM
// and epilogue are one pass) and that x is read from HBM once.
//
// Design (simple first, shared pieces in w8a8_common.cuh): one block of 8
// warps per 64 rows quantizes them into shared memory (a warp per row),
// then runs passes of 384 columns in which every warp multiplies the 64
// rows by its own 48 columns (mma.sync m16n8k32 s8, exact int32
// accumulation), loading the weight fragments from W^T straight into
// registers (gemm_direct); x is read from HBM once. The epilogue is the
// exact fp32 rounding sequence of the plain version, so the kernel matches
// it bit for bit. The weight comes transposed (W^T (N, K), k contiguous).
// The codes of a block's rows sit in shared memory for the whole K: 64 rows
// while they fit (K <= 3,456), else 32 or 16 (K <= 14,272), each warp then
// multiplying fewer rows by its columns; a row longer than 1,024 values is
// quantized in passes over the row (w8a8_common.cuh quant_row_long).

#include "w8a8_common.cuh"

namespace {

using namespace w8a8;

constexpr int kNT = 6;  // each warp: all kMT * 16 rows x 48 columns
constexpr int kBN = kWarps * kNT * 8;

template <int kMT>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ Wt,
                   const float* __restrict__ s, const float* __restrict__ b,
                   __nv_bfloat16* __restrict__ y, int M, int K, int N, bool fast) {
  constexpr int kBM = kMT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int sa = codes_stride(K);
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(as + kBM * sa);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kBM;

  for (int r = warp; r < kBM; r += kWarps) {
    const int m = m0 + r;
    if (m < M) {
      const float v = quant_row_bf16(x + static_cast<long long>(m) * K, K, nullptr,
                                     nullptr, as + r * sa, lane);
      if (lane == 0) xs[r] = v;
    } else {
      for (int c = lane; c < sa; c += 32) as[r * sa + c] = 0;
      if (lane == 0) xs[r] = 0.f;
    }
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  for (int n0 = 0; n0 < N; n0 += kBN) {
    int acc[kMT][kNT][4];
    gemm_direct<kMT, kNT>(acc, as, sa, 0, Wt, K, N, n0 + warp * kNT * 8, fast);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i * 16 + g + 8 * h, m = m0 + r;
        if (m >= M) continue;
        const float xr = xs[r];
        __nv_bfloat16* yr = y + static_cast<long long>(m) * N;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int n = n0 + warp * kNT * 8 + j * 8 + t * 2;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < N)
              yr[n + e] = __float2bfloat16(
                  epilogue(acc[i][j][2 * h + e], xr, s[n + e], b ? b[n + e] : 0.f));
        }
      }
  }
}

template <int kMT>
cudaError_t launch(const void* x, const void* Wt, const void* s, const void* b, void* y, int M,
                   int K, int N, size_t bytes, cudaStream_t stream) {
  constexpr int kBM = kMT * 16;
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_matmul_kernel<kMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM);
  w8a8_matmul_kernel<kMT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(Wt),
      static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(y), M, K, N, K % 64 == 0 && aligned16(Wt));
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 and y (M, N) bf16 contiguous; W^T (N, K) int8 contiguous;
// s, b (N) fp32 (b may be null). Returns cudaGetLastError() after the
// launch: 0 when the launch was accepted; cudaErrorInvalidValue when not
// even 16 rows of K codes fit in shared memory.
extern "C" int w8a8_matmul_bf16(const void* x, const void* Wt, const void* s, const void* b,
                                void* y, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the most rows per block whose codes (and row scales) fit
  for (int mt = 4; mt >= 1; mt /= 2) {
    const size_t bytes = static_cast<size_t>(mt * 16) * (codes_stride(K) + sizeof(float));
    if (bytes > static_cast<size_t>(max_bytes)) continue;
    const cudaError_t err = mt == 4   ? launch<4>(x, Wt, s, b, y, M, K, N, bytes, st)
                            : mt == 2 ? launch<2>(x, Wt, s, b, y, M, K, N, bytes, st)
                                      : launch<1>(x, Wt, s, b, y, M, K, N, bytes, st);
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
