// Fused LayerNorm + shared int8 quant + q/k/v int8 GEMMs for Hopper (sm_90a).
//
// Replaces the TPU kernels gava_clip_tpu/ops/int8_matmul.py:
// _w8a8_kernel3_cat (w8a8_matmul3_cat's pl.pallas_call) and, with no extras
// rows (Le = 0, the promptless configuration), _w8a8_kernel3
// (w8a8_matmul3). On the serving path it opens every block:
//
//   x (B, Lx, K), e (B, Le, K) bf16; per clip b the kv rows are
//   [x[b, 0..Lx); e[b, 0..Le)] (the concatenation is never materialised);
//   for each kv row: fp32 LayerNorm (gamma, beta), ONE per-row quant, then
//   for w in q, k, v: out_w = bf16(((float)(codes @ W_w) * xs) * s_w + b_w),
//   three (B, Lx + Le, N) outputs.
//
// What bounds it on an H100 SXM (data-sheet figures, not measured), at the
// serving shape B = 128 frame rows, Lx = 197, Le = 17, K = N = 768: 96.9 G
// int8 operations, 49 us at 1,979 TOP/s; it reads 42 MB and writes 126 MB,
// 50 us at 3.35 TB/s: balanced. The design keeps the LayerNorm output and
// the codes out of device memory and reads each activation row from HBM
// once for all three products.
//
// Design (simple first, shared pieces in w8a8_common.cuh): one block of 8
// warps per kBM kv rows. LayerNorm + quant once per row (a warp per row,
// stitching x and e rows by index) into shared memory, then, for each of
// the three weights, passes of 384 columns in which every warp multiplies
// all kBM rows by its own 48 columns (mma.sync m16n8k32 s8), loading the
// weight fragments from W^T straight into registers (gemm_direct): each
// fragment feeds kMT mma, and no barrier is needed. The weights come
// transposed (W^T (N, K), k contiguous). K is bounded by the block's codes
// in shared memory (64 rows: K <= 3,456); a row longer than 1,024 values is
// normalised and quantized in passes over the row (quant_row_long).

#include "w8a8_common.cuh"

namespace {

using namespace w8a8;

constexpr int kMT = 4, kNT = 6;
constexpr int kBM = kMT * 16, kBN = kWarps * kNT * 8;

struct QKV {
  const int8_t* W[3];
  const float* s[3];
  const float* b[3];
  __nv_bfloat16* out[3];
};

__global__ void __launch_bounds__(kThreads, 1)
w8a8_qkv_cat_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ e,
                    QKV p, const float* __restrict__ gamma, const float* __restrict__ beta,
                    int B, int Lx, int Le, int K, int N, bool fast) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sa = codes_stride(K);
  int8_t* as = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(as + kBM * sa);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Lkv = Lx + Le;
  const long long M = static_cast<long long>(B) * Lkv;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;

  for (int r = warp; r < kBM; r += kWarps) {
    const long long m = m0 + r;
    if (m < M) {
      const long long clip = m / Lkv;
      const int j = static_cast<int>(m % Lkv);
      const __nv_bfloat16* src = j < Lx ? x + (clip * Lx + j) * K
                                        : e + (clip * Le + (j - Lx)) * K;
      const float v = quant_row_bf16(src, K, gamma, beta, as + r * sa, lane);
      if (lane == 0) xs[r] = v;
    } else {
      for (int c = lane; c < sa; c += 32) as[r * sa + c] = 0;
      if (lane == 0) xs[r] = 0.f;
    }
  }

  __syncthreads();
  const int g = lane >> 2, t = lane & 3;
  const int passes = (N + kBN - 1) / kBN;  // column passes per weight
  for (int pass = 0; pass < 3 * passes; ++pass) {
    const int w = pass / passes, n0 = (pass % passes) * kBN;
    int acc[kMT][kNT][4];
    gemm_direct<kMT, kNT>(acc, as, sa, 0, p.W[w], K, N, n0 + warp * kNT * 8, fast);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i * 16 + g + 8 * h;
        const long long m = m0 + r;
        if (m >= M) continue;
        const float xr = xs[r];
        __nv_bfloat16* yr = p.out[w] + m * N;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int n = n0 + warp * kNT * 8 + j * 8 + t * 2;
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (n + c < N)
              yr[n + c] = __float2bfloat16(
                  epilogue(acc[i][j][2 * h + c], xr, p.s[w][n + c], p.b[w][n + c]));
        }
      }
  }
}

}  // namespace

// x (B, Lx, K), e (B, Le, K) bf16 contiguous (e may be null when Le = 0);
// Wq^T/Wk^T/Wv^T (N, K) int8; sq..bv (N) fp32; gamma, beta (K) fp32; oq/ok/ov
// (B, Lx + Le, N) bf16 contiguous. Returns cudaGetLastError() after the
// launch.
extern "C" int w8a8_qkv_cat_bf16(const void* x, const void* e, const void* Wq, const void* Wk,
                                 const void* Wv, const void* sq, const void* sk, const void* sv,
                                 const void* bq, const void* bk, const void* bv,
                                 const void* gamma, const void* beta, void* oq, void* ok,
                                 void* ov, int B, int Lx, int Le, int K, int N, void* stream) {
  if (K <= 0 || N <= 0 || B <= 0 || Lx < 0 || Le < 0 || (Le > 0 && e == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * (Lx + Le);
  if (M == 0) return 0;
  QKV p;
  const void* Ws[3] = {Wq, Wk, Wv};
  const void* ss[3] = {sq, sk, sv};
  const void* bs[3] = {bq, bk, bv};
  void* os[3] = {oq, ok, ov};
  bool fast = K % 64 == 0;
  for (int i = 0; i < 3; ++i) {
    p.W[i] = static_cast<const int8_t*>(Ws[i]);
    p.s[i] = static_cast<const float*>(ss[i]);
    p.b[i] = static_cast<const float*>(bs[i]);
    p.out[i] = static_cast<__nv_bfloat16*>(os[i]);
    fast = fast && aligned16(Ws[i]);
  }
  const size_t bytes = static_cast<size_t>(kBM) * codes_stride(K) + kBM * sizeof(float);
  int dev = 0, max_bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(max_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_qkv_cat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM));
  w8a8_qkv_cat_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(e), p,
      static_cast<const float*>(gamma), static_cast<const float*>(beta), B, Lx, Le, K, N, fast);
  return static_cast<int>(cudaGetLastError());
}
