// The fp32 entries of the fused w8a8 MLP (w8a8_mlp.cuh: the kernel, its
// design and what it replaces): fp32 x, r and y, the arithmetic of the bf16
// entries after the load, nothing rounded after the epilogue's roundings.
// A library of its own, so that its six instantiations of the kernel
// compile beside the bf16 ones instead of after them.

#include "w8a8_mlp.cuh"

// The fp32 forms: x, r and y fp32; the rest, and the launch plan, as the
// bf16 entries.
extern "C" int w8a8_mlp_res_f32(const void* x, const void* W1t, const void* s1, const void* b1,
                                const void* W2t, const void* s2, const void* b2,
                                const void* gamma, const void* beta, const void* r, void* y,
                                void* hq, int M, int K, int H, int N, int rows, int stages2,
                                int smem, void* stream) {
  return launch<true, true, float>(x, W1t, s1, b1, W2t, s2, b2, gamma, beta, r, y, hq, M, K, H,
                                   N, rows, stages2, smem, stream);
}

extern "C" int w8a8_mlp_f32(const void* x, const void* W1t, const void* s1, const void* b1,
                            const void* W2t, const void* s2, const void* b2, const void* gamma,
                            const void* beta, void* y, void* hq, int M, int K, int H, int N,
                            int rows, int stages2, int smem, void* stream) {
  if (gamma != nullptr && beta != nullptr)
    return launch<false, true, float>(x, W1t, s1, b1, W2t, s2, b2, gamma, beta, nullptr, y, hq,
                                      M, K, H, N, rows, stages2, smem, stream);
  return launch<false, false, float>(x, W1t, s1, b1, W2t, s2, b2, nullptr, nullptr, nullptr, y,
                                     hq, M, K, H, N, rows, stages2, smem, stream);
}
