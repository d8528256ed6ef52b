// The bf16 entries of the fused w8a8 MLP (w8a8_mlp.cuh: the kernel, its
// design and what it replaces) and the check of its QuickGELU reciprocal.

#include "w8a8_mlp.cuh"

namespace {

// Every d in [1, 2^126) (float bit patterns 0x3F800000 .. 0x7E7FFFFF): add
// to *mismatches the ones for which rcp_newton(d) is not the IEEE
// reciprocal.
__global__ void rcp_check_kernel(unsigned long long* mismatches) {
  unsigned long long bad = 0;
  for (uint32_t u = 0x3F800000u + blockIdx.x * blockDim.x + threadIdx.x; u < 0x7E800000u;
       u += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(u);
    bad += __float_as_uint(rcp_newton(d)) != __float_as_uint(__frcp_rn(d));
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// x, r (M, K) / (M, N) bf16 contiguous (N == K in the tower); W1^T (H, K),
// W2^T (N, H) int8, 16-byte aligned, each row zero-padded to a multiple of
// 16 bytes (round_up(K, 16), round_up(H, 16): TMA's stride rule);
// s1, b1 (H), s2, b2 (N), gamma, beta (K) fp32; y (M, N) bf16 contiguous;
// hq the int8 scratch of the hidden codes, (ceil(M / rows) * rows,
// round_up(H, 128)), 16-byte aligned. rows (64 or 192), stages2 and smem
// are the launch plan (ops/int8_matmul.w8a8_mlp_plan). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// or plan the kernel does not take).
extern "C" int w8a8_mlp_res_bf16(const void* x, const void* W1t, const void* s1,
                                 const void* b1, const void* W2t, const void* s2,
                                 const void* b2, const void* gamma, const void* beta,
                                 const void* r, void* y, void* hq, int M, int K, int H, int N,
                                 int rows, int stages2, int smem, void* stream) {
  return launch<true, true, __nv_bfloat16>(x, W1t, s1, b1, W2t, s2, b2, gamma, beta, r, y, hq, M,
                                           K, H, N, rows, stages2, smem, stream);
}

// The same without the residual; gamma == beta == nullptr skips the
// LayerNorm.
extern "C" int w8a8_mlp_bf16(const void* x, const void* W1t, const void* s1, const void* b1,
                             const void* W2t, const void* s2, const void* b2,
                             const void* gamma, const void* beta, void* y, void* hq, int M,
                             int K, int H, int N, int rows, int stages2, int smem,
                             void* stream) {
  if (gamma != nullptr && beta != nullptr)
    return launch<false, true, __nv_bfloat16>(x, W1t, s1, b1, W2t, s2, b2, gamma, beta, nullptr,
                                              y, hq, M, K, H, N, rows, stages2, smem, stream);
  return launch<false, false, __nv_bfloat16>(x, W1t, s1, b1, W2t, s2, b2, nullptr, nullptr,
                                             nullptr, y, hq, M, K, H, N, rows, stages2, smem,
                                             stream);
}

// rcp_check_kernel on the stream; *mismatches (a device counter, zeroed by
// the caller) receives the count
extern "C" int w8a8_mlp_rcp_check(void* mismatches, void* stream) {
  rcp_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}
