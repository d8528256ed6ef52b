// Streaming (online-softmax) attention backward for Hopper (sm_90a), bf16,
// for streaming_attention_bwd.cu. From the saved log-sum-exp lse (B, H, Lq):
//
//   p     = exp2(s * c - lse * log2(e))  masked keys give 0
//   delta = rowsum(do * o)
//   ds    = bf16(p * (do v^T - delta) * scale)
//   dq = ds k, dk = ds^T q, dv = bf16(p)^T do
//
// Two forms; ops/flash_attention.streaming_bwd_plan chooses between them
// from the layout this header exports (streaming_attention_bwd_layout).
//
// One launch (Lq, Lk <= kFRows = 128, the text tower's L = 77): one block
// of 8 warps per (batch row, head) holds that head's q, do, k, v rows in
// shared memory (cp.async, zero rows past the end), takes delta once from
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
// Two kernels (longer rows, which no main path reaches): blocks run in
// parallel, so the sums over keys (dq) and over query rows (dk, dv) are
// taken by two kernels that each own their output tile and loop over the
// other axis inside the block: no atomics, the same bits every run. Both
// rebuild the (64 x 64) score tile from q and k; it never reaches device
// memory.
//   dq kernel:    one block per (64 query rows, head, batch row); q and do
//                 fragments stay in registers, K/V tiles stream through
//                 shared memory.
//   dk/dv kernel: one block per (64 keys, head, batch row); it computes the
//                 TRANSPOSED score tile k q^T, so that its rows are keys and
//                 dk / dv accumulate in registers; q / do tiles stream
//                 through shared memory with the per-row lse and delta
//                 beside them.
// All products are mma.sync m16n8k16 bf16 -> fp32. Ragged tails: rows past
// the end are loaded as zeros and never stored, their weights are forced
// to 0. Launches on the caller's stream, no sync, no allocation. (The
// packed one-pass backward is packed_attention_bwd.cuh.)

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

__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(BwdArgs a) {
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

  uint32_t qa[kKD][4], da[kKD][4];
  load_a_frags(qa, qb, r0, r1, a.Lq, a.q_sl, t);
  load_a_frags(da, dob, r0, r1, a.Lq, D, t);

  // delta = rowsum(do * o): this thread's columns, then the 4 threads of
  // the row's group
  float delta[2] = {0.f, 0.f};
  {
    const __nv_bfloat16* ob = a.o + static_cast<long long>(b) * a.Lq * D + hoff;
    uint32_t oa[kKD][4];
    load_a_frags(oa, ob, r0, r1, a.Lq, D, t);
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        delta[i & 1] += lo_f(da[kk][i]) * lo_f(oa[kk][i]) +
                        hi_f(da[kk][i]) * hi_f(oa[kk][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
  }
  const float stat[2] = {row_stat(a, b, h, r0), row_stat(a, b, h, r1)};

  float acc[kHD / 8][4];
#pragma unroll
  for (int i = 0; i < kHD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // causal: keys past the tile's last query row are invisible to all of it
  const int kend = a.causal ? min(a.Lk, q0 + kTile) : a.Lk;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ks, kb, k0, a.Lk, a.k_sl);
    load_tile(vs, vb, k0, a.Lk, a.v_sl);
    __syncthreads();

    float s[kNF][4], dp[kNF][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    mma_a_tile_t(s, qa, ks, g, t);    // q k^T
    mma_a_tile_t(dp, da, vs, g, t);   // do v^T

    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + t * 2 + (i & 1);
        const int row = (i >> 1) ? r1 : r0;
        const bool valid = key < a.Lk && (!a.causal || key <= row);
        weight_ds(s[n][i], dp[n][i], stat[i >> 1], delta[i >> 1], valid, a.c,
                  a.scale, &ds[i]);
      }
      dsa[n / 2][(n % 2) * 2 + 0] = pack2f(ds[0], ds[1]);  // row r0
      dsa[n / 2][(n % 2) * 2 + 1] = pack2f(ds[2], ds[3]);  // row r1
    }
    mma_p_tile(acc, dsa, ks, g, t);   // dq += ds k
  }
  store_rows(a.dq + static_cast<long long>(b) * a.Lq * D + hoff, D, acc, r0, r1, a.Lq, t, 1.f, 1.f);
}

__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(BwdArgs a) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kLDS];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * kLDS];
  __shared__ float stat_s[kTile];
  __shared__ float delta_s[kTile];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const long long hoff = static_cast<long long>(h) * kHD;
  const long long D = static_cast<long long>(a.H) * kHD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;

  const __nv_bfloat16* qb = a.q + b * a.q_sb + hoff;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + hoff;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + hoff;
  const __nv_bfloat16* dob = a.dout + static_cast<long long>(b) * a.Lq * D + hoff;
  const __nv_bfloat16* ob = a.o + static_cast<long long>(b) * a.Lq * D + hoff;

  uint32_t ka[kKD][4], va[kKD][4];
  load_a_frags(ka, kb, kr0, kr1, a.Lk, a.k_sl, t);
  load_a_frags(va, vb, kr0, kr1, a.Lk, a.v_sl, t);

  float dk[kHD / 8][4], dv[kHD / 8][4];
#pragma unroll
  for (int i = 0; i < kHD / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  // causal: query rows before this key tile see none of its keys
  const int qstart = a.causal ? k0 : 0;
  for (int q0 = qstart; q0 < a.Lq; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(qs, qb, q0, a.Lq, a.q_sl);
    load_tile(dos, dob, q0, a.Lq, D);
    {
      // two threads per query row, 32 columns each: delta = rowsum(do * o)
      // and the row's lse
      const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
      const int r = q0 + row;
      const float st = row_stat(a, b, h, r);
      float sum = 0.f;
      if (r < a.Lq) {
        const __nv_bfloat16* dp_ = dob + r * D + half * 32;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t dw = ld2(dp_ + 2 * j);
          const uint32_t ow = ld2(ob + r * D + half * 32 + 2 * j);
          sum += lo_f(dw) * lo_f(ow) + hi_f(dw) * hi_f(ow);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        stat_s[row] = st;
        delta_s[row] = sum;
      }
    }
    __syncthreads();

    // transposed tiles: rows are this warp's 16 keys, columns the 64 query
    // rows of the tile
    float sT[kNF][4], dpT[kNF][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      sT[n][0] = sT[n][1] = sT[n][2] = sT[n][3] = 0.f;
      dpT[n][0] = dpT[n][1] = dpT[n][2] = dpT[n][3] = 0.f;
    }
    mma_a_tile_t(sT, ka, qs, g, t);     // k q^T
    mma_a_tile_t(dpT, va, dos, g, t);   // v do^T

    uint32_t ea[kTile / 16][4], dsa[kTile / 16][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
      float w[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = n * 8 + t * 2 + (i & 1);
        const int qrow = q0 + ql;
        const int key = (i >> 1) ? kr1 : kr0;
        const bool valid = key < a.Lk && qrow < a.Lq &&
                           (!a.causal || key <= qrow);
        w[i] = weight_ds(sT[n][i], dpT[n][i], stat_s[ql], delta_s[ql], valid,
                         a.c, a.scale, &ds[i]);
      }
      ea[n / 2][(n % 2) * 2 + 0] = pack2f(w[0], w[1]);     // key kr0
      ea[n / 2][(n % 2) * 2 + 1] = pack2f(w[2], w[3]);     // key kr1
      dsa[n / 2][(n % 2) * 2 + 0] = pack2f(ds[0], ds[1]);
      dsa[n / 2][(n % 2) * 2 + 1] = pack2f(ds[2], ds[3]);
    }
    mma_p_tile(dv, ea, dos, g, t);   // dv += bf16(p)^T do
    mma_p_tile(dk, dsa, qs, g, t);   // dk += ds^T q
  }
  store_rows(a.dk + static_cast<long long>(b) * a.Lk * D + hoff, D, dk, kr0, kr1, a.Lk, t, 1.f, 1.f);
  store_rows(a.dv + static_cast<long long>(b) * a.Lk * D + hoff, D, dv, kr0, kr1, a.Lk, t, 1.f, 1.f);
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

// form 1: one launch of attn_bwd_fused_kernel (Lq, Lk <= kFRows; smem_bytes
// is kFSmemBytes); form 0: the dq kernel, then the dk/dv kernel. static:
// each library that includes this header keeps its own record of the
// attribute (an inline function's static would be one object across every
// loaded library, and a second library's kernel would launch without it).
static int launch_bwd(const BwdArgs& a, int B, int form, int smem_bytes, cudaStream_t stream) {
  if (form == 1 && (a.Lq > kFRows || a.Lk > kFRows || smem_bytes != kFSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form != 0 && form != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || a.Lq == 0 || a.Lk == 0) return 0;
  if (form == 1) {
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
  const dim3 grid_q((a.Lq + kTile - 1) / kTile, a.H, B);
  attn_bwd_dq_kernel<<<grid_q, kThreads, 0, stream>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid_k((a.Lk + kTile - 1) / kTile, a.H, B);
  attn_bwd_dkdv_kernel<<<grid_k, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
