// Fused w8a8 transformer MLP, with and without the residual add, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of gava_clip_tpu/ops/int8_matmul.py: `kernel`
// inside w8a8_mlp_res (its pl.pallas_call), which closes every block of the
// serving path, and _w8a8_mlp_kernel (w8a8_mlp's pl.pallas_call), the same
// without the residual and with the LayerNorm optional, which an MLP block
// called without a residual reaches. One kernel template serves both: a
// flag drops the residual read, another the LayerNorm (the input rows are
// then quantized as they are); the residual form is the instantiation with
// both on.
//
//   x, r (M, K) bf16 (r is the residual, x itself in the tower); W1 (K, H),
//   W2 (H, N) int8, passed transposed (W1^T (H, K), W2^T (N, H), k
//   contiguous); s1, b1 (H), s2, b2 (N), gamma, beta (K) fp32:
//     n  = LayerNorm(x) in fp32;  c, xs = quant(n)
//     h  = QuickGELU(((float)(c @ W1) * xs) * s1 + b1)      fp32, never bf16
//     hc, hs = quant(h)   -- over the WHOLE H-wide hidden row
//     y  = bf16((((float)(hc @ W2) * hs) * s2 + b2) + r)
//
// What bounds it on an H100 SXM (data-sheet figures, not measured), at the
// serving shape M = 25216 (128 frame rows x 197 tokens), K = N = 768,
// H = 3072: 237.9 G int8 operations, 120 us at 1,979 TOP/s; it reads x and
// r and writes y, ~116 MB, 35 us at 3.35 TB/s. Compute-bound at the roof;
// the first thing this kernel buys is that the (M, H) hidden (310 MB in
// fp32) never reaches device memory.
//
// The hard part: the requant needs the absmax of the whole fp32 hidden row
// before any code of it exists, and a bf16-rounded h would be a different
// function. Design (simple first): one block of 8 warps per 16 rows keeps
// the 16 x H fp32 hidden in dynamic shared memory (197,632 bytes at
// H = 3072, with the 16 x K codes: 210,944 of the 232,448 bytes a block may
// have). Phase 1: LayerNorm + quant of the rows, then fc1 in 384-column
// passes (mma.sync m16n8k32 s8, each warp 16 x 48), bias and QuickGELU into
// the fp32 tile. Phase 2: per-row absmax over the H values, and the codes
// written in place over the first H bytes of each fp32 row. Phase 3: fc2
// over the in-place codes, bias, residual, bf16 store. With 16 rows a block
// has one row tile, so no two warps share a weight fragment: each warp
// loads its own B fragments from W^T straight into registers, with no
// barrier in either GEMM (gemm_direct). The cost of the layout: both
// weights are read from L2 once per 16 rows (7.4 GB per call at the
// serving shape), and with one block per SM the per-element phases (the
// QuickGELU epilogue, the requant) do not overlap the GEMMs: measured on an
// H100 (NVIDIA H100 80GB HBM3, 700.00 W), about half of the kernel's time
// is outside the two GEMMs. Clusters with TMA multicast and wgmma are later
// work. K is bounded by the shared-memory tile; a row longer than 1,024
// values is normalised and quantized in passes over the row
// (quant_row_long).

#include "w8a8_common.cuh"

namespace {

using namespace w8a8;

constexpr int kBM = 16, kBN = 384;  // 8 warps side by side, 16 x 48 each
constexpr int kMT = 1, kNT = 6;

// floats per row of the hidden tile: H rounded up to kBK plus 16, so the
// in-place codes' rows are 64 bytes (mod 128) apart, as gemm_direct's
// 16-byte loads want
__host__ __device__ constexpr int hidden_stride(int H) { return round_up(H, kBK) + 16; }

template <bool kRes, bool kLN>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_mlp_res_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ W1t,
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const int8_t* __restrict__ W2t, const float* __restrict__ s2,
                    const float* __restrict__ b2, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const __nv_bfloat16* __restrict__ r,
                    __nv_bfloat16* __restrict__ y, int M, int K, int H, int N, bool fast1,
                    bool fast2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hst = hidden_stride(H), sa = codes_stride(K);
  float* hsm = reinterpret_cast<float*>(smem);               // kBM x hst fp32
  int8_t* as = reinterpret_cast<int8_t*>(hsm + kBM * hst);   // kBM x sa codes
  float* xs = reinterpret_cast<float*>(as + kBM * sa);     // kBM
  float* hs = xs + kBM;                                        // kBM

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM;

  // phase 1a: LayerNorm + quant, two rows per warp
  for (int rr = warp; rr < kBM; rr += kWarps) {
    const int m = m0 + rr;
    if (m < M) {
      const float v = quant_row_bf16(x + static_cast<long long>(m) * K, K,
                                     kLN ? gamma : nullptr, beta, as + rr * sa, lane);
      if (lane == 0) xs[rr] = v;
    } else {
      for (int c = lane; c < sa; c += 32) as[rr * sa + c] = 0;
      if (lane == 0) xs[rr] = 0.f;
    }
  }

  __syncthreads();

  // phase 1b: h = QuickGELU(fc1) into the fp32 tile (rows past M compute
  // on zero codes and are never stored)
  for (int n0 = 0; n0 < H; n0 += kBN) {
    int acc[kMT][kNT][4];
    gemm_direct<kMT, kNT>(acc, as, sa, 0, W1t, K, H, n0 + warp * kNT * 8, fast1);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = g + 8 * hh;
      const float xr = xs[rr];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + warp * kNT * 8 + j * 8 + t * 2;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (n + c < H)
            hsm[rr * hst + n + c] =
                quick_gelu(epilogue(acc[0][j][2 * hh + c], xr, s1[n + c], b1[n + c]));
      }
    }
  }
  __syncthreads();

  // phase 2: per-row absmax over the H values, then the codes in place: the
  // int8 code of column c lands in byte c of the row, inside float c / 4,
  // which an earlier group of 256 columns (or this one, before the
  // __syncwarp) has already read
  const int Hp = round_up(H, kBK);
  for (int rr = warp; rr < kBM; rr += kWarps) {
    float* row = hsm + rr * hst;
    float mx = 0.f;
    for (int c = lane; c < H; c += 32) mx = fmaxf(mx, fabsf(row[c]));
    const float scale = quant_scale(warp_max(mx));
    const float inv = __fdiv_rn(1.0f, scale);
    if (lane == 0) hs[rr] = scale;
    int8_t* codes = reinterpret_cast<int8_t*>(row);
    for (int c0 = 0; c0 < Hp; c0 += 256) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + lane + 32 * i;
        v[i] = c < H ? row[c] : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + lane + 32 * i;
        if (c < Hp) codes[c] = c < H ? quant_code(v[i], inv) : static_cast<int8_t>(0);
      }
      __syncwarp();
    }
  }

  __syncthreads();

  // phase 3: y = fc2(codes) + b2 [+ r]
  const int sh = hst * 4;  // bytes per row of the in-place codes
  const int8_t* hc = reinterpret_cast<const int8_t*>(hsm);
  for (int n0 = 0; n0 < N; n0 += kBN) {
    int acc[kMT][kNT][4];
    gemm_direct<kMT, kNT>(acc, hc, sh, 0, W2t, H, N, n0 + warp * kNT * 8, fast2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = g + 8 * hh, m = m0 + rr;
      if (m >= M) continue;
      const float hr = hs[rr];
      const __nv_bfloat16* rrow = kRes ? r + static_cast<long long>(m) * N : nullptr;
      __nv_bfloat16* yrow = y + static_cast<long long>(m) * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + warp * kNT * 8 + j * 8 + t * 2;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (n + c < N) {
            const float v = epilogue(acc[0][j][2 * hh + c], hr, s2[n + c], b2[n + c]);
            yrow[n + c] =
                __float2bfloat16(kRes ? __fadd_rn(v, __bfloat162float(rrow[n + c])) : v);
          }
      }
    }
  }
}

template <bool kRes, bool kLN>
int launch(const void* x, const void* W1t, const void* s1, const void* b1, const void* W2t,
           const void* s2, const void* b2, const void* gamma, const void* beta, const void* r,
           void* y, int M, int K, int H, int N, void* stream) {
  if (M <= 0 || K <= 0 || H <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(kBM) * hidden_stride(H) * sizeof(float) +
                       static_cast<size_t>(kBM) * codes_stride(K) + 2 * kBM * sizeof(float);
  int dev = 0, max_bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(max_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = w8a8_mlp_res_kernel<kRes, kLN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool fast1 = K % 64 == 0 && aligned16(W1t);
  const bool fast2 = H % 64 == 0 && aligned16(W2t);
  kernel<<<(M + kBM - 1) / kBM, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(W1t),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(W2t), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(y), M, K, H, N, fast1, fast2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r (M, K) / (M, N) bf16 contiguous (N == K in the tower); W1^T (H, K),
// W2^T (N, H) int8 contiguous; s1, b1 (H), s2, b2 (N), gamma, beta (K) fp32;
// y (M, N) bf16 contiguous. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue when the tile does not fit in shared memory).
extern "C" int w8a8_mlp_res_bf16(const void* x, const void* W1t, const void* s1,
                                 const void* b1, const void* W2t, const void* s2,
                                 const void* b2, const void* gamma, const void* beta,
                                 const void* r, void* y, int M, int K, int H, int N,
                                 void* stream) {
  return launch<true, true>(x, W1t, s1, b1, W2t, s2, b2, gamma, beta, r, y, M, K, H, N, stream);
}

// The same without the residual; gamma == beta == nullptr skips the
// LayerNorm.
extern "C" int w8a8_mlp_bf16(const void* x, const void* W1t, const void* s1, const void* b1,
                             const void* W2t, const void* s2, const void* b2,
                             const void* gamma, const void* beta, void* y, int M, int K, int H,
                             int N, void* stream) {
  if (gamma != nullptr && beta != nullptr)
    return launch<false, true>(x, W1t, s1, b1, W2t, s2, b2, gamma, beta, nullptr, y, M, K, H, N,
                               stream);
  return launch<false, false>(x, W1t, s1, b1, W2t, s2, b2, nullptr, nullptr, nullptr, y, M, K,
                              H, N, stream);
}
