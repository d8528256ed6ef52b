// Attention backward for Hopper (sm_90a), bf16, shared by the packed
// one-pass-softmax backward (packed_attention_bwd.cu) and the streaming
// online-softmax backward (streaming_attention_bwd.cu). The two differ only
// in how a weight is rebuilt from a score and in where the scale and the
// normalisation enter; `STREAM` picks the arithmetic:
//
//   packed (STREAM = false), rowstat = saved denominators den (B, Lq, H):
//     inv_d = 1 / max(den, 1e-30)          delta = rowsum(do * o)
//     e     = bf16(exp2(min(s * c, 110)))  keys >= Lk give 0
//     ds    = bf16((e * inv_d) * (do v^T - delta))
//     dq = (ds k) * scale, dk = (ds^T q) * scale, dv = e^T bf16(do * inv_d)
//   streaming (STREAM = true), rowstat = saved log-sum-exp lse (B, H, Lq):
//     p     = exp2(s * c - lse * log2(e))  masked keys give 0
//     ds    = bf16(p * (do v^T - delta) * scale)
//     dq = ds k, dk = ds^T q, dv = bf16(p)^T do
//
// Blocks run in parallel, so the sums over keys (dq) and over query rows
// (dk, dv) are taken by two kernels that each own their output tile and
// loop over the other axis inside the block: no atomics, the same bits
// every run. Both rebuild the (64 x 64) score tile from q and k; it never
// reaches device memory.
//   dq kernel:    one block per (64 query rows, head, batch row); q and do
//                 fragments stay in registers, K/V tiles stream through
//                 shared memory.
//   dk/dv kernel: one block per (64 keys, head, batch row); it computes the
//                 TRANSPOSED score tile k q^T, so that its rows are keys and
//                 dk / dv accumulate in registers; q / do tiles stream
//                 through shared memory with the per-row inv_d (or lse) and
//                 delta beside them.
// All products are mma.sync m16n8k16 bf16 -> fp32. Ragged tails: rows past
// the end are loaded as zeros and never stored, their weights are forced
// to 0. Launches on the caller's stream, no sync, no allocation.

#pragma once

#include "attention_common.cuh"

namespace attn {

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout, *o;
  const float* rowstat;  // den (B, Lq, H) or lse (B, H, Lq), contiguous
  __nv_bfloat16 *dq, *dk, *dv;
  int Lq, Lk, H;
  // element strides (batch, row) of q, k, v; do, o, dq are (B, Lq, H*64)
  // contiguous and dk, dv (B, Lk, H*64) contiguous
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float c;      // Dh^-0.5 * log2(e)
  float scale;  // Dh^-0.5
  int causal;   // key j is visible to query row i iff j <= i
};

// inv_d (packed) or lse in log2 units (streaming) of query row r; a row
// past the end gets the value that makes every weight and ds exactly 0
template <bool STREAM>
__device__ __forceinline__ float row_stat(const BwdArgs& a, int b, int h, int r) {
  if (STREAM) {
    if (r >= a.Lq) return 1e30f;
    return a.rowstat[(static_cast<long long>(b) * a.H + h) * a.Lq + r] * kLog2e;
  }
  if (r >= a.Lq) return 0.f;
  return 1.f / fmaxf(a.rowstat[(static_cast<long long>(b) * a.Lq + r) * a.H + h],
                     1e-30f);
}

// weight and ds of one score; returns the weight, writes ds
template <bool STREAM>
__device__ __forceinline__ float weight_ds(float s, float dp, float stat,
                                           float delta, bool valid, float c,
                                           float scale, float* ds) {
  if (STREAM) {
    const float p = valid ? exp2f(s * c - stat) : 0.f;
    *ds = p * (dp - delta) * scale;
    return p;
  }
  const float e = __bfloat162float(
      __float2bfloat16(valid ? exp2f(fminf(s * c, 110.f)) : 0.f));
  *ds = (e * stat) * (dp - delta);
  return e;
}

template <bool STREAM>
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
  const __nv_bfloat16* ob = a.o + static_cast<long long>(b) * a.Lq * D + hoff;

  uint32_t qa[kKD][4], da[kKD][4];
  load_a_frags(qa, qb, r0, r1, a.Lq, a.q_sl, t);
  load_a_frags(da, dob, r0, r1, a.Lq, D, t);

  // delta = rowsum(do * o): this thread's columns, then the 4 threads of
  // the row's group
  float delta[2] = {0.f, 0.f};
  {
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
  const float stat[2] = {row_stat<STREAM>(a, b, h, r0),
                         row_stat<STREAM>(a, b, h, r1)};

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
        weight_ds<STREAM>(s[n][i], dp[n][i], stat[i >> 1], delta[i >> 1], valid,
                          a.c, a.scale, &ds[i]);
      }
      dsa[n / 2][(n % 2) * 2 + 0] = pack2f(ds[0], ds[1]);  // row r0
      dsa[n / 2][(n % 2) * 2 + 1] = pack2f(ds[2], ds[3]);  // row r1
    }
    mma_p_tile(acc, dsa, ks, g, t);   // dq += ds k
  }
  const float mul = STREAM ? 1.f : a.scale;
  store_rows(a.dq + static_cast<long long>(b) * a.Lq * D + hoff, D, acc, r0, r1, a.Lq, t, mul, mul);
}

template <bool STREAM>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(BwdArgs a) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kLDS];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * kLDS];
  // packed only: do * inv_d rounded to bf16, the B operand of dv
  __shared__ __align__(16) __nv_bfloat16 dons[STREAM ? 8 : kTile * kLDS];
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
      // two threads per query row, 32 columns each: delta = rowsum(do * o),
      // the row's inv_d or lse, and (packed) the normalised do
      const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
      const int r = q0 + row;
      const float st = row_stat<STREAM>(a, b, h, r);
      float sum = 0.f;
      if (r < a.Lq) {
        const __nv_bfloat16* dp_ = dob + r * D + half * 32;
        const __nv_bfloat16* op_ = ob + r * D + half * 32;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t dw = ld2(dp_ + 2 * j), ow = ld2(op_ + 2 * j);
          sum += lo_f(dw) * lo_f(ow) + hi_f(dw) * hi_f(ow);
          if (!STREAM)
            *reinterpret_cast<uint32_t*>(dons + row * kLDS + half * 32 + 2 * j) =
                pack2f(lo_f(dw) * st, hi_f(dw) * st);
        }
      } else if (!STREAM) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(dons + row * kLDS + half * 32 + 2 * j) = 0u;
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
        w[i] = weight_ds<STREAM>(sT[n][i], dpT[n][i], stat_s[ql], delta_s[ql],
                                 valid, a.c, a.scale, &ds[i]);
      }
      ea[n / 2][(n % 2) * 2 + 0] = pack2f(w[0], w[1]);     // key kr0
      ea[n / 2][(n % 2) * 2 + 1] = pack2f(w[2], w[3]);     // key kr1
      dsa[n / 2][(n % 2) * 2 + 0] = pack2f(ds[0], ds[1]);
      dsa[n / 2][(n % 2) * 2 + 1] = pack2f(ds[2], ds[3]);
    }
    mma_p_tile(dv, ea, STREAM ? dos : dons, g, t);   // dv += w^T do
    mma_p_tile(dk, dsa, qs, g, t);                   // dk += ds^T q
  }
  const float mul = STREAM ? 1.f : a.scale;
  store_rows(a.dk + static_cast<long long>(b) * a.Lk * D + hoff, D, dk, kr0, kr1, a.Lk, t, mul, mul);
  store_rows(a.dv + static_cast<long long>(b) * a.Lk * D + hoff, D, dv, kr0, kr1, a.Lk, t, 1.f, 1.f);
}

template <bool STREAM>
int launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  if (B == 0 || a.Lq == 0 || a.Lk == 0) return 0;
  const dim3 grid_q((a.Lq + kTile - 1) / kTile, a.H, B);
  attn_bwd_dq_kernel<STREAM><<<grid_q, kThreads, 0, stream>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid_k((a.Lk + kTile - 1) / kTile, a.H, B);
  attn_bwd_dkdv_kernel<STREAM><<<grid_k, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
