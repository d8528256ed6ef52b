// Packed whole-row attention forward for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernels gava_clip_tpu/ops/flash_attention.py:
// _attention_kernel and _attention_kernel_den (reached through
// _packed_forward's pl.pallas_call), and computes their function, not their
// block structure. The second entry point also writes the per-head softmax
// denominators den (B, Lq, H) fp32, the sums of the bf16-ROUNDED e (on the
// TPU the ones column of the same dot), which the backward
// (packed_attention_bwd.cu) takes as a saved residual:
//
//   q (B, Lq, H*Dh), k/v (B, Lk, H*Dh), packed as the projections emit them
//   (no head relayout), o (B, Lq, H*Dh) in the input dtype. Per head:
//     s   = q_h k_h^T                          fp32 accumulation
//     e   = exp2(min(s * c, 110))              c = Dh^-0.5 * log2(e); no max
//                                              subtraction, the clamp is the
//                                              semantics; keys >= Lk give 0
//     e   = bf16(e)                            rounded BEFORE both sums below
//     o_h = (e @ v_h) / max(sum(e), 1e-30)
//
// What bounds it on an H100 SXM (data-sheet figures, not measured), per
// layer at the serving shape B = 16 clips x 8 frames = 128, Lq = 197,
// Lk = 214, H = 12, Dh = 64: it reads q, k, v and writes o, about 162 MB,
// so about 48 us at 3.35 TB/s; it does about 16.6 GFLOP, about 17 us at the
// 989 TFLOP/s bf16 dense peak. At about 100 FLOP/byte (below the card's
// ~295) it is bandwidth-bound: what matters is that the (Lq, Lk) score tile
// never reaches device memory and that q, k, v are read once from HBM.
//
// Design (simple first): one block of 4 warps per (q tile of 64 rows, head,
// batch row); each warp owns 16 query rows and keeps their q fragments in
// registers. K/V stream through shared memory in tiles of 64 keys (ragged
// tail loaded as zeros, never read past Lk). Scores and the AV product use
// mma.sync m16n8k16 bf16 -> fp32. Because the one-pass softmax has no
// running max, e @ v and sum(e) accumulate straight into fp32 registers
// with no rescaling; the score fragments are reused in registers as the A
// operand of the AV product. The kernel launches on the caller's stream,
// does not synchronise and allocates nothing. wgmma, TMA, a pipelined K/V
// ring and tile tuning are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 64;   // query rows per block, 16 per warp
constexpr int kTileK = 64;   // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 values in one register, `lo` (the lower column / k index) in the
// low half, as the mma fragments expect
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ den, int Lq, int Lk, int q_sb,
                        int q_sl, int k_sb, int k_sl, int v_sb, int v_sl,
                        int o_sb, int o_sl, float c) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LDS = HD + 8;  // padded shared row: fewer bank conflicts
  constexpr int KD = HD / 16;  // k-steps of the score product
  constexpr int NS = kTileK / 8;  // 8-key score fragments per tile
  constexpr int ND = HD / 8;      // 8-wide output fragments
  __shared__ __align__(16) __nv_bfloat16 ks[kTileK * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kTileK * LDS];

  const int b = blockIdx.z;
  const long long hoff = static_cast<long long>(blockIdx.y) * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group row, thread in group
  const int r0 = blockIdx.x * kTileQ + warp * 16 + g, r1 = r0 + 8;

  const __nv_bfloat16* qb = q + static_cast<long long>(b) * q_sb + hoff;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * k_sb + hoff;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * v_sb + hoff;

  // this warp's 16 query rows as mma A fragments; rows >= Lq are zeros
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int col = kk * 16 + t * 2;
    const __nv_bfloat16* p0 = qb + static_cast<long long>(r0) * q_sl + col;
    const __nv_bfloat16* p1 = qb + static_cast<long long>(r1) * q_sl + col;
    qa[kk][0] = r0 < Lq ? ld2(p0) : 0u;
    qa[kk][1] = r1 < Lq ? ld2(p1) : 0u;
    qa[kk][2] = r0 < Lq ? ld2(p0 + 8) : 0u;
    qa[kk][3] = r1 < Lq ? ld2(p1 + 8) : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float rsum[2] = {0.f, 0.f};  // rows r0 and r1, this thread's columns

  for (int k0 = 0; k0 < Lk; k0 += kTileK) {
    __syncthreads();  // every warp is done with the previous tile
    constexpr int VPR = HD / 8;  // 16-byte vectors per row
    for (int idx = threadIdx.x; idx < kTileK * VPR; idx += kThreads) {
      const int r = idx / VPR, cv = (idx % VPR) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + r < Lk) {
        kx = *reinterpret_cast<const uint4*>(
            kb + static_cast<long long>(k0 + r) * k_sl + cv);
        vx = *reinterpret_cast<const uint4*>(
            vb + static_cast<long long>(k0 + r) * v_sl + cv);
      }
      *reinterpret_cast<uint4*>(ks + r * LDS + cv) = kx;
      *reinterpret_cast<uint4*>(vs + r * LDS + cv) = vx;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * LDS + kk * 16 + t * 2;
        mma_16816(s[n], qa[kk], ld2(kp), ld2(kp + 8));
      }
    }

    // the one elementwise pass; e rounded to bf16 feeds both the AV product
    // and the denominator. Score fragment n (keys n*8..n*8+7) becomes half
    // n%2 of the A fragment of key slice n/2.
    uint32_t pa[kTileK / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      __nv_bfloat16 eb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + t * 2 + (i & 1);
        const float e = key < Lk ? exp2f(fminf(s[n][i] * c, 110.f)) : 0.f;
        eb[i] = __float2bfloat16(e);
        rsum[i >> 1] += __bfloat162float(eb[i]);
      }
      pa[n / 2][(n % 2) * 2 + 0] = pack2(eb[0], eb[1]);  // row r0
      pa[n / 2][(n % 2) * 2 + 1] = pack2(eb[2], eb[3]);  // row r1
    }

    // acc += e @ v over this tile's 64 keys
#pragma unroll
    for (int kc = 0; kc < kTileK / 16; ++kc) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const __nv_bfloat16* vp = vs + (kc * 16 + t * 2) * LDS + d * 8 + g;
        mma_16816(acc[d], pa[kc], pack2(vp[0], vp[LDS]),
                  pack2(vp[8 * LDS], vp[9 * LDS]));
      }
    }
  }

  // full row sums: the 4 threads of a group hold disjoint columns
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
  }
  if (den != nullptr && t == 0) {
    // the unclamped sums, (B, Lq, H) contiguous
    float* db = den + static_cast<long long>(b) * Lq * gridDim.y + blockIdx.y;
    if (r0 < Lq) db[static_cast<long long>(r0) * gridDim.y] = rsum[0];
    if (r1 < Lq) db[static_cast<long long>(r1) * gridDim.y] = rsum[1];
  }
  const float d0 = fmaxf(rsum[0], 1e-30f), d1 = fmaxf(rsum[1], 1e-30f);
  __nv_bfloat16* ob = o + static_cast<long long>(b) * o_sb + hoff;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(r0) * o_sl + col) =
          pack2(__float2bfloat16(acc[d][0] / d0), __float2bfloat16(acc[d][1] / d0));
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(r1) * o_sl + col) =
          pack2(__float2bfloat16(acc[d][2] / d1), __float2bfloat16(acc[d][3] / d1));
  }
}

template <int HD>
void launch(const void* q, const void* k, const void* v, void* o, float* den,
            int B, int Lq, int Lk, int H, int q_sb, int q_sl, int k_sb, int k_sl, int v_sb,
            int v_sl, int o_sb, int o_sl, float c, cudaStream_t stream) {
  const dim3 grid((Lq + kTileQ - 1) / kTileQ, H, B);
  packed_attention_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), den,
      Lq, Lk, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl, c);
}

}  // namespace

// Strides are in elements; the last dim is contiguous and rows are 16-byte
// aligned (checked by the Python wrapper). Returns cudaGetLastError() after
// the launch: 0 when the launch was accepted.
extern "C" int packed_attention_bf16(const void* q, const void* k, const void* v,
                                     void* o, int B, int Lq, int Lk, int H,
                                     int Dh, int q_sb, int q_sl, int k_sb,
                                     int k_sl, int v_sb, int v_sl, int o_sb,
                                     int o_sl, float c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // ViT-B/16 (and every CLIP tower the repo configures) has Dh = 64
  if (Dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  launch<64>(q, k, v, o, nullptr, B, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb,
             v_sl, o_sb, o_sl, c, st);
  return static_cast<int>(cudaGetLastError());
}

// The same forward, which also writes den (B, Lq, H) fp32 contiguous.
extern "C" int packed_attention_den_bf16(const void* q, const void* k,
                                         const void* v, void* o, void* den,
                                         int B, int Lq, int Lk, int H, int Dh,
                                         int q_sb, int q_sl, int k_sb, int k_sl,
                                         int v_sb, int v_sl, int o_sb, int o_sl,
                                         float c, void* stream) {
  if (Dh != 64 || den == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  launch<64>(q, k, v, o, static_cast<float*>(den), B, Lq, Lk, H, q_sb, q_sl,
             k_sb, k_sl, v_sb, v_sl, o_sb, o_sl, c,
             static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
