// Streaming (online-softmax) attention backward for Hopper (sm_90a), bf16,
// for streaming_attention_bwd.cu. From the saved log-sum-exp lse (B, H, Lq):
//
//   p     = exp2(s * c - lse * log2(e))  masked keys give 0
//   delta = rowsum(do * o)
//   ds    = bf16(p * (do v^T - delta) * scale)
//   dq = ds k, dk = ds^T q, dv = bf16(p)^T do
//
// Two forms; ops/flash_attention.streaming_bwd_plan chooses between them
// from the layout streaming_attention_bwd_layout exports.
//
// One launch (Lq, Lk <= kFRows = 128, the text tower's L = 77), below: one
// block of 8 warps per (batch row, head) holds that head's q, do, k, v rows
// in shared memory (cp.async, zero rows past the end), takes delta once from
// do and o, and runs all three sums itself in a fixed order: no atomics,
// the same bits every run.
//   * warp w owns keys 16w .. 16w + 15; over the query tiles of 64 rows
//     (causal: from query 16w on, the tiles above the diagonal skipped) it
//     forms its 16 x 64 TRANSPOSED tiles k q^T and v do^T by ldmatrix into
//     mma.sync, rebuilds p and ds, adds bf16(p)^T do into dv and ds^T q
//     into dk (both in registers) and writes ds^T (bf16) to shared memory;
//   * after a barrier the warps split the (16 query rows, 32 head columns)
//     pieces of dq and sum ds k over the visible key chunks in order.
// Five products per visible score entry, each score tile formed once. The
// copies and fragment loops are B6b's (attention_frags.cuh).
//
// Key groups (longer rows: the vision tower's frame rows past 640 keys at
// 400^2 and 448^2, the causal text tower past 128 tokens): wgmma kernels
// in attention_bwd_wgmma.cuh. Launches on the caller's stream, no sync, no
// allocation. (The packed one-pass backward is packed_attention_bwd.cuh.)

#pragma once

#include "attention_common.cuh"
#include "attention_frags.cuh"

namespace attn {

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout, *o;
  const float* rowstat;  // lse (B, H, Lq), contiguous
  __nv_bfloat16 *dq, *dk, *dv;
  int Lq, Lk, H;
  // element strides (batch, row) of q, k, v; do, o, dq are (B, Lq, H*64)
  // contiguous and dk, dv (B, Lk, H*64) contiguous
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float c;      // Dh^-0.5 * log2(e)
  float scale;  // Dh^-0.5
  int causal;   // key j is visible to query row i iff j <= i
};

// lse of query row r in log2 units; a row past the end gets the value that
// makes every weight and ds exactly 0
__device__ __forceinline__ float row_stat(const BwdArgs& a, int b, int h, int r) {
  if (r >= a.Lq) return 1e30f;
  return a.rowstat[(static_cast<long long>(b) * a.H + h) * a.Lq + r] * kLog2e;
}

// weight and ds of one score; returns the weight, writes ds
__device__ __forceinline__ float weight_ds(float s, float dp, float stat,
                                           float delta, bool valid, float c,
                                           float scale, float* ds) {
  const float p = valid ? exp2f(s * c - stat) : 0.f;
  *ds = p * (dp - delta) * scale;
  return p;
}

// ---- one launch: a block per (batch row, head) ----

constexpr int kFWarps = 8;
constexpr int kFThreads = kFWarps * 32;
constexpr int kFRows = kFWarps * 16;          // most query rows and keys
constexpr int kDsLD = kFRows + 8;             // bf16 per ds^T row (+8: ldmatrix rows apart)
constexpr int kFTileBytes = kFRows * kLDS * 2;
// dynamic shared memory: q | do | k | v tiles, ds^T (the o tile before
// delta is taken), lse * log2(e) and delta per query row
constexpr int kFOffDs = 4 * kFTileBytes;
constexpr int kFOffStat = kFOffDs + kFRows * kDsLD * 2;
constexpr int kFSmemBytes = kFOffStat + 2 * kFRows * 4;

__global__ void __launch_bounds__(kFThreads, 1) attn_bwd_fused_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kFRows * kLDS;
  __nv_bfloat16* ks = dos + kFRows * kLDS;
  __nv_bfloat16* vs = ks + kFRows * kLDS;
  __nv_bfloat16* dsT = reinterpret_cast<__nv_bfloat16*>(smem + kFOffDs);
  float* lse2 = reinterpret_cast<float*>(smem + kFOffStat);
  float* dl = lse2 + kFRows;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const long long hoff = static_cast<long long>(h) * kHD;
  const long long D = static_cast<long long>(a.H) * kHD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int lq16 = (a.Lq + 15) / 16 * 16, lk16 = (a.Lk + 15) / 16 * 16;
  const __nv_bfloat16* qb = a.q + b * a.q_sb + hoff;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + hoff;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + hoff;
  const __nv_bfloat16* dob = a.dout + static_cast<long long>(b) * a.Lq * D + hoff;
  const __nv_bfloat16* ob = a.o + static_cast<long long>(b) * a.Lq * D + hoff;

  // whole tiles of kFRows rows: the rows past L are zero-filled, nothing read
  afrag::tile_async<kFRows, kFThreads>(qs, qb, 0, a.Lq, a.q_sl);
  afrag::tile_async<kFRows, kFThreads>(dos, dob, 0, a.Lq, D);
  afrag::tile_async<kFRows, kFThreads>(ks, kb, 0, a.Lk, a.k_sl);
  afrag::tile_async<kFRows, kFThreads>(vs, vb, 0, a.Lk, a.v_sl);
  afrag::tile_async<kFRows, kFThreads>(dsT, ob, 0, a.Lq, D);   // the o tile
  afrag::cp_commit();
  for (int r = threadIdx.x; r < lq16; r += kFThreads) lse2[r] = row_stat(a, b, h, r);
  afrag::cp_wait_all();
  __syncthreads();

  // delta = rowsum(do * o): four threads a row, 16 columns each (a warp
  // takes 8 whole rows, all inside or all past lq16)
  for (int row = threadIdx.x >> 2; row < lq16; row += kFThreads / 4) {
    const int c0 = (threadIdx.x & 3) * 16;
    float sum = 0.f;
#pragma unroll
    for (int v8 = 0; v8 < 2; ++v8) {
      const uint4 dw = *reinterpret_cast<const uint4*>(dos + row * kLDS + c0 + v8 * 8);
      const uint4 ow = *reinterpret_cast<const uint4*>(dsT + row * kLDS + c0 + v8 * 8);
      const uint32_t d4[4] = {dw.x, dw.y, dw.z, dw.w}, o4[4] = {ow.x, ow.y, ow.z, ow.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) sum += lo_f(d4[i]) * lo_f(o4[i]) + hi_f(d4[i]) * hi_f(o4[i]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((threadIdx.x & 3) == 0) dl[row] = row < a.Lq ? sum : 0.f;
  }
  __syncthreads();   // the o tile is read: ds^T may overwrite it

  // ---- keys: warp w's 16 keys against the visible query tiles ----
  const int kw = warp * 16;
  const int nqc = lq16 / 16;   // 16-row query chunks
  if (kw < a.Lk) {
    uint32_t ka[kKD][4], va[kKD][4];
    afrag::a_frags(ka, ks, kw, lane);
    afrag::a_frags(va, vs, kw, lane);
    const int kr0 = kw + g, kr1 = kr0 + 8;
    const bool kv0 = kr0 < a.Lk, kv1 = kr1 < a.Lk;
    float dk[kHD / 8][4], dv[kHD / 8][4];
#pragma unroll
    for (int i = 0; i < kHD / 8; ++i) {
      dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
      dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
    }
    // causal: query chunks before warp's own see none of its keys
    for (int c0 = a.causal ? warp : 0; c0 < nqc; c0 += 4) {
      int n8[8];
      bool use[8];
      float sT[8][4], dpT[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        n8[i] = c0 * 16 + i * 8;
        use[i] = c0 + i / 2 < nqc;
        sT[i][0] = sT[i][1] = sT[i][2] = sT[i][3] = 0.f;
        dpT[i][0] = dpT[i][1] = dpT[i][2] = dpT[i][3] = 0.f;
      }
      afrag::mma_rows_tn<8>(sT, ka, qs, n8, use, lane);    // k q^T
      afrag::mma_rows_tn<8>(dpT, va, dos, n8, use, lane);  // v do^T
      uint32_t ea[4][4], dsa[4][4];
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        if (use[f]) {
          const int ql = n8[f] + t * 2;
          float p[4], ds[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qrow = ql + (i & 1);
            const int key = (i >> 1) ? kr1 : kr0;
            const bool valid = ((i >> 1) ? kv1 : kv0) && qrow < a.Lq &&
                               (!a.causal || key <= qrow);
            p[i] = weight_ds(sT[f][i], dpT[f][i], lse2[qrow], dl[qrow], valid, a.c,
                             a.scale, &ds[i]);
          }
          ea[f / 2][(f % 2) * 2 + 0] = afrag::cvt_pack(p[0], p[1]);     // key kr0
          ea[f / 2][(f % 2) * 2 + 1] = afrag::cvt_pack(p[2], p[3]);     // key kr1
          const uint32_t d01 = afrag::cvt_pack(ds[0], ds[1]);
          const uint32_t d23 = afrag::cvt_pack(ds[2], ds[3]);
          dsa[f / 2][(f % 2) * 2 + 0] = d01;
          dsa[f / 2][(f % 2) * 2 + 1] = d23;
          *reinterpret_cast<uint32_t*>(dsT + kr0 * kDsLD + ql) = d01;
          *reinterpret_cast<uint32_t*>(dsT + kr1 * kDsLD + ql) = d23;
        }
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (c0 + kc < nqc) {
          afrag::mma_chunk<kHD / 16>(dv, ea[kc], dos, c0 + kc, 0, lane);   // dv += bf16(p)^T do
          afrag::mma_chunk<kHD / 16>(dk, dsa[kc], qs, c0 + kc, 0, lane);   // dk += ds^T q
        }
      }
    }
    store_rows(a.dk + static_cast<long long>(b) * a.Lk * D + hoff, D, dk, kr0, kr1, a.Lk, t, 1.f, 1.f);
    store_rows(a.dv + static_cast<long long>(b) * a.Lk * D + hoff, D, dv, kr0, kr1, a.Lk, t, 1.f, 1.f);
  }
  __syncthreads();   // every ds^T entry is written

  // ---- dq: (16 query rows, 32 head columns) pieces, ds k over the key
  // chunks in order (causal: those at or before the rows' own) ----
  const int nkc = lk16 / 16;
  __nv_bfloat16* dqb = a.dq + static_cast<long long>(b) * a.Lq * D + hoff;
  for (int item = warp; item < 2 * nqc; item += kFWarps) {
    const int slab = item >> 1, dh = item & 1;
    const int kend = a.causal ? min(nkc, slab + 1) : nkc;
    float c4[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c4[i][0] = c4[i][1] = c4[i][2] = c4[i][3] = 0.f;
    for (int kc = 0; kc < kend; ++kc) {
      uint32_t pa[4];
      afrag::ldsm_t(pa, dsT + (kc * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kDsLD +
                            slab * 16 + ((lane >> 3) & 1) * 8);
      afrag::mma_chunk<2>(c4, pa, ks, kc, dh * 32, lane);
    }
    const int r0 = slab * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = dh * 32 + i * 8 + t * 2;
      if (r0 < a.Lq)
        *reinterpret_cast<uint32_t*>(dqb + r0 * D + col) = pack2f(c4[i][0], c4[i][1]);
      if (r1 < a.Lq)
        *reinterpret_cast<uint32_t*>(dqb + r1 * D + col) = pack2f(c4[i][2], c4[i][3]);
    }
  }
}

// one launch of attn_bwd_fused_kernel (Lq, Lk <= kFRows; smem_bytes is
// kFSmemBytes). static: each library that includes this header keeps its
// own record of the attribute (an inline function's static would be one
// object across every loaded library, and a second library's kernel would
// launch without it).
static int launch_bwd(const BwdArgs& a, int B, int smem_bytes, cudaStream_t stream) {
  if (a.Lq > kFRows || a.Lk > kFRows || smem_bytes != kFSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || a.Lq == 0 || a.Lk == 0) return 0;
  // the shared-memory attribute, once per device
  static bool set_on[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!set_on[dev]) {
    err = cudaFuncSetAttribute(attn_bwd_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_on[dev] = true;
  }
  attn_bwd_fused_kernel<<<B * a.H, kFThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
