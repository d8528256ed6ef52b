// Packed whole-row attention backward for Hopper (sm_90a), bf16, from q, k,
// v and do alone: the forward output and the denominators are rebuilt here.
//
// Replaces the TPU kernel gava_clip_tpu/ops/flash_attention.py:
// _attention_bwd_kernel_recompute (reached through
// _packed_backward_recompute's pl.pallas_call) and computes its function
// with its rounding points, not its block structure:
//
//   q, do (B, Lq, H*64), k, v (B, Lk, H*64) bf16
//   -> dq (B, Lq, H*64), dk, dv (B, Lk, H*64) bf16. Per head:
//     e     = bf16(exp2(min(q k^T * c, 110)))   c = Dh^-0.5 * log2(e)
//     den   = rowsum(e)                    fp32 sum of the ROUNDED e
//     inv_d = 1 / max(den, 1e-30)
//     o     = (e v) * inv_d                fp32, NOT rounded to bf16
//     delta = rowsum(do * o)               fp32
//     ds    = bf16((e * inv_d) * (do v^T - delta))
//     dq = (ds k) * scale   dk = (ds^T q) * scale   dv = e^T bf16(do * inv_d)
//
// It differs from the saved-residual backward (packed_attention_bwd.cu) in
// one rounding point only: that one reads the forward's bf16 output for
// delta, this one uses the fp32 output it has just rebuilt.
//
// The TPU kernel holds a whole clip row in one program. Here the dk / dv
// kernel owns a key tile and walks the query tiles, so rebuilding o inside
// it would repeat the whole row's work for every key tile. Design: a first
// kernel, one block per (64 query rows, head, batch row), runs the forward's
// two products over all key tiles and writes den and delta (B, Lq, H) fp32
// to scratch; then the dq and dk/dv kernels of attention_bwd.cuh run with
// DELTA_IN and read them. Three launches, no atomics, the same bits every
// run.
//
// What bounds it on an H100 SXM (data-sheet figures) at B = 128, Lq = 197,
// Lk = 214, H = 12: it reads q, do, k, v and writes dq, dk, dv, about 284 MB
// (85 us at 3.35 TB/s); the function needs six products per score entry
// (q k^T, e v, do v^T and the three gradients), about 50 GFLOP (50 us at
// 989 TFLOP/s bf16): bandwidth-bound. This design rebuilds the score tile
// in each of its three kernels, which the bound does not count.

#include "attention_bwd.cuh"

namespace {

using namespace attn;

__global__ void __launch_bounds__(kThreads)
recompute_stats_kernel(BwdArgs a, float* __restrict__ den, float* __restrict__ delta) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kLDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kLDS];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const long long hoff = static_cast<long long>(h) * kHD;
  const long long D = static_cast<long long>(a.H) * kHD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  const __nv_bfloat16* qb = a.q + b * a.q_sb + hoff;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + hoff;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + hoff;
  const __nv_bfloat16* dob = a.dout + static_cast<long long>(b) * a.Lq * D + hoff;

  uint32_t qa[kKD][4];
  load_a_frags(qa, qb, r0, r1, a.Lq, a.q_sl, t);

  float acc[kHD / 8][4];
#pragma unroll
  for (int i = 0; i < kHD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float rsum[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < a.Lk; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ks, kb, k0, a.Lk, a.k_sl);
    load_tile(vs, vb, k0, a.Lk, a.v_sl);
    __syncthreads();

    float s[kNF][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_a_tile_t(s, qa, ks, g, t);   // q k^T

    // e rounded to bf16 feeds both the e v product and the denominator
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      __nv_bfloat16 eb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + t * 2 + (i & 1);
        eb[i] = __float2bfloat16(key < a.Lk ? exp2f(fminf(s[n][i] * a.c, 110.f)) : 0.f);
        rsum[i >> 1] += __bfloat162float(eb[i]);
      }
      pa[n / 2][(n % 2) * 2 + 0] = pack2(eb[0], eb[1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack2(eb[2], eb[3]);
    }
    mma_p_tile(acc, pa, vs, g, t);   // num += e v
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
    rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
  }
  const float inv0 = 1.f / fmaxf(rsum[0], 1e-30f), inv1 = 1.f / fmaxf(rsum[1], 1e-30f);

  // delta = rowsum(do * o) with o = num * inv_d kept in fp32. The A
  // fragment of do holds the columns of the accumulator fragments: words 0,
  // 1 of k-step kk are columns kk * 16 + 2t, + 1 (accumulator 2 kk), words
  // 2, 3 the same columns + 8 (accumulator 2 kk + 1).
  uint32_t da[kKD][4];
  load_a_frags(da, dob, r0, r1, a.Lq, D, t);
  float dl[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float(&n)[4] = acc[2 * kk + half];
      const uint32_t d0 = da[kk][2 * half], d1 = da[kk][2 * half + 1];
      dl[0] += lo_f(d0) * (n[0] * inv0) + hi_f(d0) * (n[1] * inv0);
      dl[1] += lo_f(d1) * (n[2] * inv1) + hi_f(d1) * (n[3] * inv1);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 1);
    dl[i] += __shfl_xor_sync(0xffffffffu, dl[i], 2);
  }
  if (t == 0) {
    const long long row0 = static_cast<long long>(b) * a.Lq;
    if (r0 < a.Lq) {
      den[(row0 + r0) * a.H + h] = rsum[0];
      delta[(row0 + r0) * a.H + h] = dl[0];
    }
    if (r1 < a.Lq) {
      den[(row0 + r1) * a.H + h] = rsum[1];
      delta[(row0 + r1) * a.H + h] = dl[1];
    }
  }
}

}  // namespace

// do is (B, Lq, H*64) contiguous; den and delta are scratch (B, Lq, H) fp32
// contiguous that the first kernel fills; q, k, v have element strides
// (batch, row) with a contiguous last dim and 16-byte aligned rows (checked
// by the Python wrapper). Returns cudaGetLastError() after the launches: 0
// when all three were accepted.
extern "C" int packed_attention_bwd_recompute_bf16(
    const void* q, const void* k, const void* v, const void* dout, void* den,
    void* delta, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H,
    int Dh, int q_sb, int q_sl, int k_sb, int k_sl, int v_sb, int v_sl,
    float scale, void* stream) {
  if (Dh != attn::kHD) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Lq == 0 || Lk == 0) return 0;
  attn::BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.o = nullptr;
  a.rowstat = static_cast<const float*>(den);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.Lq = Lq; a.Lk = Lk; a.H = H;
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl;
  a.scale = scale;
  a.c = scale * attn::kLog2e;
  a.causal = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Lq + attn::kTile - 1) / attn::kTile, H, B);
  recompute_stats_kernel<<<grid, attn::kThreads, 0, st>>>(
      a, static_cast<float*>(den), static_cast<float*>(delta));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return attn::launch_bwd<false, true>(a, B, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
