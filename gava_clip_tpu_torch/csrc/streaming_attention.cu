// Streaming (KV-blocked, online-softmax) attention forward for Hopper
// (sm_90a), bf16.
//
// Replaces the forward kernel of the stock TPU flash attention that
// gava_clip_tpu/ops/flash_attention.py:_streaming_flash wraps
// (jax.experimental.pallas.ops.tpu.flash_attention), for the causal text
// tower (L = 77) and for non-causal keys beyond the packed kernel's length.
// The TPU wrapper relays packed (B, L, H*Dh) activations to head-major and
// pads L to 128; here the kernel reads the packed layout directly and
// masks the ragged tail itself.
//
//   q (B, Lq, H*64), k/v (B, Lk, H*64) -> o (B, Lq, H*64) bf16 and the
//   per-row log-sum-exp lse (B, H, Lq) fp32 that the backward needs:
//     s = q k^T * scale (fp32); key j is visible to row i iff j < Lk and
//     (not causal or j <= i); p = exp(s - max); o = (bf16(p) @ v) / sum(p);
//     lse = max + log(sum(p)).
//   The standard softmax with max subtraction: a different function from
//   the packed kernel's clamp form once scores are large.
//
// At the text tower's shape (15 x 77 x 512) the whole problem is about
// 5 MB of traffic and 0.1 GFLOP: launch-bound. At long L it is
// compute-bound (2 products of 2 * Lq * Lk * 64 per head).
//
// Design (simple first): one block of 4 warps per (64 query rows, head,
// batch row), 16 rows per warp with their q fragments in registers; K/V
// stream through shared memory in tiles of 64 keys; each row carries a
// running max and sum in registers and rescales its fp32 accumulator when
// the max moves. Causal tiles above the diagonal are skipped. mma.sync
// m16n8k16 bf16 -> fp32. Launches on the caller's stream, no sync, no
// allocation.

#include "attention_common.cuh"

namespace {

using namespace attn;

__global__ void __launch_bounds__(kThreads)
streaming_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ o,
                               float* __restrict__ lse, int Lq, int Lk, int H,
                               long long q_sb, long long q_sl, long long k_sb,
                               long long k_sl, long long v_sb, long long v_sl,
                               float c, int causal) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kLDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kLDS];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const long long hoff = static_cast<long long>(h) * kHD;
  const long long D = static_cast<long long>(H) * kHD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  const __nv_bfloat16* kb = k + b * k_sb + hoff;
  const __nv_bfloat16* vb = v + b * v_sb + hoff;

  uint32_t qa[kKD][4];
  load_a_frags(qa, q + b * q_sb + hoff, r0, r1, Lq, q_sl, t);

  float acc[kHD / 8][4];
#pragma unroll
  for (int i = 0; i < kHD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // running max (in log2 units, scale folded in) and this thread's share
  // of the running sum, rows r0 and r1
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};

  const int kend = causal ? min(Lk, q0 + kTile) : Lk;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ks, kb, k0, Lk, k_sl);
    load_tile(vs, vb, k0, Lk, v_sl);
    __syncthreads();

    float s[kNF][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_a_tile_t(s, qa, ks, g, t);

    // scale, mask, and the tile's row maxima. Every tile that is visited
    // holds at least one visible key for every row (key k0 < Lk, and under
    // the causal mask key 0 in the first tile), so a row's max is finite
    // from its first tile on.
    float tmax[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + t * 2 + (i & 1);
        const int row = (i >> 1) ? r1 : r0;
        const bool valid = key < Lk && (!causal || key <= row);
        s[n][i] = valid ? s[n][i] * c : kNegBig;
        tmax[i >> 1] = fmaxf(tmax[i >> 1], s[n][i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tmax[j] = fmaxf(tmax[j], __shfl_xor_sync(0xffffffffu, tmax[j], 1));
      tmax[j] = fmaxf(tmax[j], __shfl_xor_sync(0xffffffffu, tmax[j], 2));
      const float mnew = fmaxf(m[j], tmax[j]);
      alpha[j] = exp2f(m[j] - mnew);
      m[j] = mnew;
      l[j] *= alpha[j];
    }
#pragma unroll
    for (int d = 0; d < kHD / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // p = exp2(s - max): the fp32 value feeds the sum, its bf16 rounding
    // the AV product
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = exp2f(s[n][i] - m[i >> 1]);
        l[i >> 1] += p[i];
      }
      pa[n / 2][(n % 2) * 2 + 0] = pack2f(p[0], p[1]);  // row r0
      pa[n / 2][(n % 2) * 2 + 1] = pack2f(p[2], p[3]);  // row r1
    }
    mma_p_tile(acc, pa, vs, g, t);
  }

  // full row sums: the 4 threads of a group hold disjoint columns
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
#pragma unroll
  for (int d = 0; d < kHD / 8; ++d) {
    acc[d][0] /= l[0];
    acc[d][1] /= l[0];
    acc[d][2] /= l[1];
    acc[d][3] /= l[1];
  }
  store_rows(o + static_cast<long long>(b) * Lq * D + hoff, D, acc, r0, r1, Lq,
             t, 1.f, 1.f);
  if (t == 0) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * Lq;
    if (r0 < Lq) lb[r0] = (m[0] + log2f(l[0])) * kLn2;
    if (r1 < Lq) lb[r1] = (m[1] + log2f(l[1])) * kLn2;
  }
}

}  // namespace

// o is (B, Lq, H*64) contiguous, lse (B, H, Lq) contiguous fp32; q, k, v
// have element strides (batch, row) with a contiguous last dim and 16-byte
// aligned rows (checked by the Python wrapper). Returns cudaGetLastError()
// after the launch: 0 when the launch was accepted.
extern "C" int streaming_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Lq, int Lk, int H, int Dh, int q_sb, int q_sl, int k_sb, int k_sl,
    int v_sb, int v_sl, float scale, int causal, void* stream) {
  if (Dh != attn::kHD) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Lq == 0) return 0;
  const dim3 grid((Lq + attn::kTile - 1) / attn::kTile, H, B);
  streaming_attention_fwd_kernel<<<grid, attn::kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
      scale * attn::kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
