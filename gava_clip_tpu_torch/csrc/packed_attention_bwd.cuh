// Packed whole-row attention backward for Hopper (sm_90a), bf16: one kernel
// per launch, one block per (batch row, head), shared by the saved-residual
// backward (packed_attention_bwd.cu, RECOMPUTE = false) and the backward
// that rebuilds the forward's output and denominators
// (packed_attention_bwd_recompute.cu, RECOMPUTE = true).
//
// Function, per head, with fp32 accumulation, the scale after the dot and
// one cast per gradient at the store:
//   inv_d = 1 / max(den, 1e-30)          delta = rowsum(do * o)   (fp32)
//   e     = bf16(exp2(min(q k^T * c, 110)))   keys >= Lk give 0; exp2 by
//           ex2.approx.ftz, which flushes results below 2^-126 to 0 (ex2f)
//   ds    = bf16((e * inv_d) * (do v^T - delta))
//   dq = (ds k) * scale   dk = (ds^T q) * scale   dv = e^T bf16(do * inv_d)
// RECOMPUTE takes den = rowsum(e) (the ROUNDED e) and o = (e v) * inv_d in
// fp32, not rounded: the one rounding point in which the two differ.
//
// Design. The block owns every query row and every key of its (b, h), so
// all three sums run inside it in a fixed order: no atomics, the same bits
// on every run. 8 warps; the block walks key tiles of 128 keys (16 per
// warp), and inside each key tile the query tiles of 64 rows (the last one
// cut to a multiple of 16, so Lq = 197 computes 208 rows, not 256):
//   * per (key tile, query tile) each warp forms its 16 x 64 TRANSPOSED
//     score tile k q^T and v do^T, e and ds, and adds e^T bf16(do * inv_d)
//     into dv and ds^T q into dk, both held in registers for the key tile;
//   * it writes ds^T (bf16) to shared memory; after a barrier the warps
//     split the query tile's dq rows and add ds k into the block-private
//     fp32 dq accumulator: five products per score entry.
//   * inv_d and delta of a query row are taken where its tile first
//     arrives, in the first key tile, from the o rows and den values that
//     came with it. RECOMPUTE instead runs a first pass over (tiles of up
//     to 128 query rows, balanced, one warp per 16 rows; key tiles) of
//     q k^T and e v, with the q and do rows of a tile staged through the
//     ds^T and o buffers, which the pass does not use: seven products in
//     all, one launch, no scratch tensor.
// Tiles reach shared memory by cp.async through two stages each (q / do
// tiles of 64 rows, k / v tiles of 128), the next step's in flight while
// the current ones are used; each step's copies are issued after the
// barrier that opens it, so one barrier per step guards the stages.
// Fragments come from shared memory by ldmatrix (.trans for the operands
// whose k index runs down the rows) into mma.sync m16n8k16 bf16 -> fp32;
// the loops over a tile's query fragments unroll with the tile width known
// at compile time, so independent mma chains interleave. The dq
// accumulator and the row statistics (74 floats per query row) sit in
// dynamic shared memory while they fit beside the fixed 153.5 KB of tiles
// (Lq <= 240); past that in a block-private fp32 region of a global scratch
// buffer, the blocks then walking the (b, h) pairs with a grid stride. The
// Python wrapper computes that plan (ops/flash_attention.packed_bwd_plan)
// from the layout this header exports (packed_attention_bwd_layout).
// Ragged tails: rows past the end are loaded as zeros by the copy itself
// and never stored; their weights are forced to 0.
//
// What separates it from its bound (0.097 ms at B = 128, Lq = 197, Lk =
// 214, H = 12): one block of 8 warps per SM (the accumulator and 243
// registers a thread), so the tensor cores wait on the latency of each
// warp's mma chains, and mma.sync reads every B operand from shared memory
// once per warp; wgmma (a warpgroup reading B once) is the next step.

#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "attention_frags.cuh"

namespace pbwd {

using namespace attn;
using namespace afrag;

constexpr int kWarpsB = 8;
constexpr int kThreadsB = kWarpsB * 32;
constexpr int kKT = kWarpsB * 16;    // keys per key tile, 16 per warp
constexpr int kQT = 64;              // query rows per query tile
constexpr int kPT = kWarpsB * 16;    // query rows per tile of the first pass
constexpr int kAccLD = 72;           // floats per dq accumulator row (+8: no bank conflicts)
constexpr int kKTileBytes = kKT * kLDS * 2;
constexpr int kQTileBytes = kQT * kLDS * 2;
// dynamic shared memory: k, v stages | q, do stages | bf16(do * inv_d) |
// ds^T | o stages | den stages | (shared form) dq accumulator, inv_d, delta
constexpr int kOffQD = 4 * kKTileBytes;
constexpr int kOffDN = kOffQD + 4 * kQTileBytes;
constexpr int kOffDS = kOffDN + kQTileBytes;
constexpr int kOffO = kOffDS + kKTileBytes;        // saved-residual form: o stages
constexpr int kOffDen = kOffO + 2 * kQTileBytes;   // and den stages (64 floats)
constexpr int kFixedBytes = kOffDen + 2 * kQT * 4;
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr long long acc_floats(int lq_pad) {
  return static_cast<long long>(lq_pad) * (kAccLD + 2);
}

struct PArgs {
  const __nv_bfloat16 *q, *k, *v, *dout, *o;
  const float* den;       // (B, Lq, H); unused by RECOMPUTE
  __nv_bfloat16 *dq, *dk, *dv;
  float* scratch;         // global form: gridDim.x regions of acc_floats(lq_pad)
  int B, Lq, Lk, H, lq_pad;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float c, scale;
};

template <bool RECOMPUTE>
__global__ void __launch_bounds__(kThreadsB, 1) packed_bwd_kernel(PArgs a, bool acc_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [stage][k, v]
  __nv_bfloat16* qd_s = reinterpret_cast<__nv_bfloat16*>(smem + kOffQD);  // [stage][q, do]
  __nv_bfloat16* dn_s = reinterpret_cast<__nv_bfloat16*>(smem + kOffDN);
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem + kOffDS);
  __nv_bfloat16* o_s = reinterpret_cast<__nv_bfloat16*>(smem + kOffO);   // [stage]
  float* den_s = reinterpret_cast<float*>(smem + kOffDen);                // [stage]
  float* acc = acc_in_smem ? reinterpret_cast<float*>(smem + kFixedBytes)
                           : a.scratch + blockIdx.x * acc_floats(a.lq_pad);
  float* inv_s = acc + static_cast<long long>(a.lq_pad) * kAccLD;
  float* dl_s = inv_s + a.lq_pad;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long long D = static_cast<long long>(a.H) * kHD;
  const int KTn = (a.Lk + kKT - 1) / kKT;
  const int QTn = (a.lq_pad + kQT - 1) / kQT;
  // first pass: PTn tiles of ptr rows (a multiple of 16, at most kPT)
  const int PTn = RECOMPUTE ? (a.lq_pad + kPT - 1) / kPT : 0;
  const int ptr = RECOMPUTE ? (a.lq_pad + 16 * PTn - 1) / (16 * PTn) * 16 : 0;
  const int npass = PTn * KTn;
  const int nsteps = npass + KTn * QTn;

  for (int item = blockIdx.x; item < a.B * a.H; item += gridDim.x) {
    const int b = item / a.H, h = item % a.H;
    const long long hoff = static_cast<long long>(h) * kHD;
    const __nv_bfloat16* qb = a.q + b * a.q_sb + hoff;
    const __nv_bfloat16* kb = a.k + b * a.k_sb + hoff;
    const __nv_bfloat16* vb = a.v + b * a.v_sb + hoff;
    const __nv_bfloat16* dob = a.dout + static_cast<long long>(b) * a.Lq * D + hoff;
    const __nv_bfloat16* ob = RECOMPUTE ? nullptr : a.o + static_cast<long long>(b) * a.Lq * D + hoff;
    const float* denb = RECOMPUTE ? nullptr : a.den + static_cast<long long>(b) * a.Lq * a.H + h;

    // the copies of step s: its k / v tile when it starts one, the pass
    // tile's q rows (first pass, into the ds^T buffer, which the pass does
    // not use), its q / do tile (main steps) and, in the first key tile of
    // the saved-residual form, the tile's o rows and den values. Issued by
    // every thread after the barrier that opens step s - 1, so the stages
    // it overwrites (those of step s - 2) are free.
    auto issue = [&](int s) {
      if (s < nsteps) {
        int kvi = -1, m = -1;
        if (s < npass) {
          kvi = s;
          if (KTn > 1 && s % KTn == 0) tile_async<kPT, kThreadsB>(ds_s, qb, (s / KTn) * ptr, a.Lq, a.q_sl);
          if (KTn > 1 && s % KTn == KTn - 1) tile_async<kPT, kThreadsB>(o_s, dob, (s / KTn) * ptr, a.Lq, D);
        } else {
          m = s - npass;
          if (m % QTn == 0) kvi = npass + m / QTn;
        }
        if (kvi >= 0) {
          const int k0 = (s < npass ? kvi % KTn : kvi - npass) * kKT;
          __nv_bfloat16* st = kv_s + (kvi & 1) * 2 * kKT * kLDS;
          tile_async<kKT, kThreadsB>(st, kb, k0, a.Lk, a.k_sl);
          tile_async<kKT, kThreadsB>(st + kKT * kLDS, vb, k0, a.Lk, a.v_sl);
        }
        if (m >= 0) {
          const int q0 = (m % QTn) * kQT;
          __nv_bfloat16* st = qd_s + (m & 1) * 2 * kQT * kLDS;
          tile_async<kQT, kThreadsB>(st, qb, q0, a.Lq, a.q_sl);
          tile_async<kQT, kThreadsB>(st + kQT * kLDS, dob, q0, a.Lq, D);
          if (!RECOMPUTE && m < QTn) {
            tile_async<kQT, kThreadsB>(o_s + (m & 1) * kQT * kLDS, ob, q0, a.Lq, D);
            if (threadIdx.x < kQT) {
              const int r = q0 + threadIdx.x;
              cp_async4(den_s + (m & 1) * kQT + threadIdx.x, r < a.Lq ? denb + r * a.H : denb,
                        r < a.Lq);
            }
          }
        }
      }
      cp_commit();
    };

    issue(0);
    // zero the dq accumulator (and, for the first pass to fill, the row
    // statistics) while the first tiles are in flight
    {
      const long long n = RECOMPUTE ? acc_floats(a.lq_pad) : static_cast<long long>(a.lq_pad) * kAccLD;
      for (long long i = threadIdx.x * 4; i < n; i += kThreadsB * 4)
        *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    // ---- first pass (RECOMPUTE): den, o and delta per query row ----
    if (RECOMPUTE) {
      uint32_t qa[kKD][4];
      float oacc[kHD / 8][4];
      float rsum[2];
      for (int s = 0; s < npass; ++s) {
        cp_wait_all();
        __syncthreads();
        issue(s + 1);
        const int p0 = (s / KTn) * ptr, j = s % KTn, k0 = j * kKT;
        const int r0 = p0 + warp * 16 + g, r1 = r0 + 8;
        const bool active = warp * 16 < ptr && p0 + warp * 16 < a.Lq;
        const __nv_bfloat16* ks = kv_s + (s & 1) * 2 * kKT * kLDS;
        const __nv_bfloat16* vs = ks + kKT * kLDS;
        if (active) {
          if (j == 0) {
            if (KTn > 1)
              a_frags(qa, ds_s, warp * 16, lane);
            else   // the copy of the next tile may already be overwriting it
              load_a_frags(qa, qb, r0, r1, a.Lq, a.q_sl, t);
#pragma unroll
            for (int i = 0; i < kHD / 8; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
            rsum[0] = rsum[1] = 0.f;
          }
          const int nkc = min(kKT / 16, (a.Lk - k0 + 15) / 16);
          // FULL: every key of the tile is real (no masking, no guards)
          auto pass_tile = [&](auto full_c) {
            constexpr bool FULL = decltype(full_c)::value;
#pragma unroll
            for (int kp = 0; kp < kKT / 32; ++kp) {
              if (FULL || 2 * kp < nkc) {
                // 32 keys: four 8-key score fragments, four mma chains
                int n8[4];
                bool use[4];
                float s4[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  n8[i] = kp * 32 + i * 8;
                  use[i] = FULL || 2 * kp + i / 2 < nkc;
                  s4[i][0] = s4[i][1] = s4[i][2] = s4[i][3] = 0.f;
                }
                mma_rows_tn<4>(s4, qa, ks, n8, use, lane);
                // e rounded to bf16 feeds both the e v product and the denominator
                uint32_t pa[2][4];
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                  float e[4];
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    e[i] = ex2f(fminf(s4[f][i] * a.c, 110.f));
                    if (!FULL) e[i] = k0 + n8[f] + t * 2 + (i & 1) < a.Lk ? e[i] : 0.f;
                  }
                  const uint32_t p01 = cvt_pack(e[0], e[1]), p23 = cvt_pack(e[2], e[3]);
                  rsum[0] += lo_f(p01) + hi_f(p01);
                  rsum[1] += lo_f(p23) + hi_f(p23);
                  pa[f / 2][(f % 2) * 2 + 0] = p01;
                  pa[f / 2][(f % 2) * 2 + 1] = p23;
                }
#pragma unroll
                for (int c = 0; c < 2; ++c)
                  if (FULL || 2 * kp + c < nkc) mma_chunk<kHD / 16>(oacc, pa[c], vs, 2 * kp + c, 0, lane);   // num += e v
              }
            }
          };
          if (nkc == kKT / 16)
            pass_tile(std::true_type());
          else
            pass_tile(std::false_type());
          if (j == KTn - 1) {
            float inv0, inv1;
            {
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
                rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
              }
              inv0 = 1.f / fmaxf(rsum[0], 1e-30f);
              inv1 = 1.f / fmaxf(rsum[1], 1e-30f);
            }
            // delta = rowsum(do * o) with o = num * inv_d kept in fp32. The
            // A fragment of do holds the columns of the accumulator
            // fragments: words 0, 1 of k-step kk are columns kk * 16 + 2t,
            // + 1 (accumulator 2 kk), words 2, 3 the same + 8 (2 kk + 1).
            uint32_t da[kKD][4];
            if (KTn > 1)
              a_frags(da, o_s, warp * 16, lane);
            else
              load_a_frags(da, dob, r0, r1, a.Lq, D, t);
            float dl[2] = {0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const float(&n)[4] = oacc[2 * kk + half];
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
              if (r0 < a.Lq) {
                inv_s[r0] = inv0;
                dl_s[r0] = dl[0];
              }
              if (r1 < a.Lq) {
                inv_s[r1] = inv1;
                dl_s[r1] = dl[1];
              }
            }
          }
        }
      }
    }

    // ---- main walk: key tiles, and query tiles inside each ----
    float dk[kHD / 8][4], dv[kHD / 8][4];
#pragma unroll
    for (int i = 0; i < kHD / 8; ++i) {
      dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
      dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
    }
    for (int s = npass; s < nsteps; ++s) {
      cp_wait_all();
      __syncthreads();
      issue(s + 1);
      const int m = s - npass, j = m / QTn, qt = m % QTn;
      const int k0 = j * kKT, q0 = qt * kQT;
      const int nq = min(kQT, a.lq_pad - q0);   // a multiple of 16
      const __nv_bfloat16* ks = kv_s + ((npass + j) & 1) * 2 * kKT * kLDS;
      const __nv_bfloat16* vs = ks + kKT * kLDS;
      const __nv_bfloat16* qs = qd_s + (m & 1) * 2 * kQT * kLDS;
      const __nv_bfloat16* dos = qs + kQT * kLDS;

      // bf16(do * inv_d), the B operand of dv: 4 threads per row, 16
      // columns each. In the first key tile the saved-residual form also
      // takes the row's statistics here, from the o and den that arrived
      // with the tile: delta = rowsum(do * o), inv_d = 1 / max(den, 1e-30).
      {
        const int row = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
        uint32_t w[8];
#pragma unroll
        for (int v8 = 0; v8 < 2; ++v8) {
          const uint4 x = *reinterpret_cast<const uint4*>(dos + row * kLDS + c0 + v8 * 8);
          w[4 * v8] = x.x; w[4 * v8 + 1] = x.y; w[4 * v8 + 2] = x.z; w[4 * v8 + 3] = x.w;
        }
        float st;
        if (!RECOMPUTE && j == 0) {
          const __nv_bfloat16* os = o_s + (m & 1) * kQT * kLDS + row * kLDS + c0;
          float sum = 0.f;
#pragma unroll
          for (int v8 = 0; v8 < 2; ++v8) {
            const uint4 x = *reinterpret_cast<const uint4*>(os + v8 * 8);
            const uint32_t ow[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
              sum += lo_f(w[4 * v8 + i]) * lo_f(ow[i]) + hi_f(w[4 * v8 + i]) * hi_f(ow[i]);
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          const bool real = q0 + row < a.Lq;
          st = real ? 1.f / fmaxf(den_s[(m & 1) * kQT + row], 1e-30f) : 0.f;
          if ((threadIdx.x & 3) == 0 && row < nq) {
            inv_s[q0 + row] = st;
            dl_s[q0 + row] = real ? sum : 0.f;
          }
        } else {
          st = row < nq ? inv_s[q0 + row] : 0.f;
        }
#pragma unroll
        for (int v8 = 0; v8 < 2; ++v8) {
          uint32_t y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i] = cvt_pack(lo_f(w[4 * v8 + i]) * st, hi_f(w[4 * v8 + i]) * st);
          *reinterpret_cast<uint4*>(dn_s + row * kLDS + c0 + v8 * 8) = make_uint4(y[0], y[1], y[2], y[3]);
        }
      }
      __syncthreads();

      const int kw = k0 + warp * 16;   // this warp's first key
      if (kw < a.Lk) {
        const int kr0 = kw + g, kr1 = kr0 + 8;
        const bool kv0 = kr0 < a.Lk, kv1 = kr1 < a.Lk;
        const int qlim = a.Lq - q0;   // columns below it are real query rows
        // the tile's NQ query columns, NQ known at compile time: the loops
        // below unroll without a branch
        auto scores = [&](auto nq_c) {
          constexpr int NQ = decltype(nq_c)::value;
          uint32_t ka[kKD][4], va[kKD][4];
          a_frags(ka, ks, warp * 16, lane);
          a_frags(va, vs, warp * 16, lane);
          uint32_t ea[NQ / 16][4], dsa[NQ / 16][4];
#pragma unroll
          for (int f0 = 0; f0 < NQ / 8; f0 += 8) {
            // transposed tiles: rows are this warp's 16 keys, columns the
            // query rows of fragments f0 .. f0 + 7 (up to 16 mma chains)
            int n8[8];
            bool use[8];
            float sT[8][4], dpT[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              n8[i] = (f0 + i) * 8;
              use[i] = f0 + i < NQ / 8;
              sT[i][0] = sT[i][1] = sT[i][2] = sT[i][3] = 0.f;
              dpT[i][0] = dpT[i][1] = dpT[i][2] = dpT[i][3] = 0.f;
            }
            mma_rows_tn<8>(sT, ka, qs, n8, use, lane);     // k q^T
            mma_rows_tn<8>(dpT, va, dos, n8, use, lane);   // v do^T
#pragma unroll
            for (int f = 0; f < 8; ++f) {
              const int n = f0 + f;
              if (n < NQ / 8) {
                const int ql = n * 8 + t * 2;
                const float2 inv = *reinterpret_cast<const float2*>(inv_s + q0 + ql);
                const float2 dl = *reinterpret_cast<const float2*>(dl_s + q0 + ql);
                const bool qv0 = ql < qlim, qv1 = ql + 1 < qlim;
                float e[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) e[i] = ex2f(fminf(sT[f][i] * a.c, 110.f));
                e[0] = kv0 && qv0 ? e[0] : 0.f;
                e[1] = kv0 && qv1 ? e[1] : 0.f;
                e[2] = kv1 && qv0 ? e[2] : 0.f;
                e[3] = kv1 && qv1 ? e[3] : 0.f;
                const uint32_t e01 = cvt_pack(e[0], e[1]), e23 = cvt_pack(e[2], e[3]);
                ea[n / 2][(n % 2) * 2 + 0] = e01;   // key kr0
                ea[n / 2][(n % 2) * 2 + 1] = e23;   // key kr1
                const uint32_t d01 = cvt_pack((lo_f(e01) * inv.x) * (dpT[f][0] - dl.x),
                                              (hi_f(e01) * inv.y) * (dpT[f][1] - dl.y));
                const uint32_t d23 = cvt_pack((lo_f(e23) * inv.x) * (dpT[f][2] - dl.x),
                                              (hi_f(e23) * inv.y) * (dpT[f][3] - dl.y));
                dsa[n / 2][(n % 2) * 2 + 0] = d01;
                dsa[n / 2][(n % 2) * 2 + 1] = d23;
                // ds^T for the dq product, bf16 as the products take it
                *reinterpret_cast<uint32_t*>(ds_s + (warp * 16 + g) * kLDS + ql) = d01;
                *reinterpret_cast<uint32_t*>(ds_s + (warp * 16 + g + 8) * kLDS + ql) = d23;
              }
            }
          }
#pragma unroll
          for (int kc = 0; kc < NQ / 16; ++kc) {
            mma_chunk<kHD / 16>(dv, ea[kc], dn_s, kc, 0, lane);   // dv += e^T bf16(do * inv_d)
            mma_chunk<kHD / 16>(dk, dsa[kc], qs, kc, 0, lane);    // dk += ds^T q
          }
        };
        switch (nq) {
          case 16: scores(std::integral_constant<int, 16>()); break;
          case 32: scores(std::integral_constant<int, 32>()); break;
          case 48: scores(std::integral_constant<int, 48>()); break;
          default: scores(std::integral_constant<int, 64>()); break;
        }
        if (qt == QTn - 1) {
          store_rows(a.dk + static_cast<long long>(b) * a.Lk * D + hoff, D, dk, kr0, kr1, a.Lk, t, a.scale, a.scale);
          store_rows(a.dv + static_cast<long long>(b) * a.Lk * D + hoff, D, dv, kr0, kr1, a.Lk, t, 1.f, 1.f);
#pragma unroll
          for (int i = 0; i < kHD / 8; ++i) {
            dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
            dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
          }
        }
      }
      __syncthreads();

      // dq rows of this query tile += ds k over the tile's keys: warp w takes
      // 16 rows (w / 2) and 32 head columns (w % 2)
      {
        const int slab = warp >> 1, dh = warp & 1;
        const int nks = min(kKT / 16, (a.Lk - k0 + 15) / 16);
        if (slab < nq / 16) {
          float c4[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c4[i][0] = c4[i][1] = c4[i][2] = c4[i][3] = 0.f;
#pragma unroll
          for (int kc = 0; kc < kKT / 16; ++kc) {
            if (kc < nks) {
              uint32_t pa[4];
              ldsm_t(pa, ds_s + (kc * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * kLDS + slab * 16 +
                             ((lane >> 3) & 1) * 8);
              mma_chunk<2>(c4, pa, ks, kc, dh * 32, lane);
            }
          }
          const int row = q0 + slab * 16 + g;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* p0 = acc + static_cast<long long>(row) * kAccLD + dh * 32 + i * 8 + t * 2;
            float* p1 = p0 + 8 * kAccLD;
            float2 x0 = *reinterpret_cast<float2*>(p0), x1 = *reinterpret_cast<float2*>(p1);
            x0.x += c4[i][0];
            x0.y += c4[i][1];
            x1.x += c4[i][2];
            x1.y += c4[i][3];
            *reinterpret_cast<float2*>(p0) = x0;
            *reinterpret_cast<float2*>(p1) = x1;
          }
        }
      }
    }
    __syncthreads();

    // dq = acc * scale, one cast
    __nv_bfloat16* dqb = a.dq + static_cast<long long>(b) * a.Lq * D + hoff;
    for (int idx = threadIdx.x; idx < a.Lq * 8; idx += kThreadsB) {
      const int r = idx >> 3, cv = (idx & 7) * 8;
      const float* src = acc + static_cast<long long>(r) * kAccLD + cv;
      const float4 x0 = *reinterpret_cast<const float4*>(src);
      const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
      *reinterpret_cast<uint4*>(dqb + r * D + cv) =
          make_uint4(pack2f(x0.x * a.scale, x0.y * a.scale), pack2f(x0.z * a.scale, x0.w * a.scale),
                     pack2f(x1.x * a.scale, x1.y * a.scale), pack2f(x1.z * a.scale, x1.w * a.scale));
    }
    __syncthreads();   // the next (b, h) zeroes the accumulator
  }
}

// One launch of the plan that ops/flash_attention.packed_bwd_plan computes
// from the layout packed_attention_bwd_layout exports: smem_bytes is
// kFixedBytes, plus acc_floats(lq_pad) * 4 when the accumulator is in
// shared memory.
template <bool RECOMPUTE>
int launch_packed_bwd(const PArgs& a, int grid, bool acc_in_smem, int smem_bytes,
                      cudaStream_t stream) {
  if (a.lq_pad < a.Lq || a.lq_pad % 16 != 0 || grid < 1 || smem_bytes > kMaxSmem ||
      (!acc_in_smem && a.scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0 || a.Lq == 0 || a.Lk == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(packed_bwd_kernel<RECOMPUTE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_bwd_kernel<RECOMPUTE><<<grid, kThreadsB, smem_bytes, stream>>>(a, acc_in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pbwd

// The shared-memory layout the launch plan is computed from: the bytes of
// the tile stages, the floats per query row of the dq accumulator and row
// statistics, and the most dynamic shared memory a block may take.
extern "C" void packed_attention_bwd_layout(int* out) {
  out[0] = pbwd::kFixedBytes;
  out[1] = static_cast<int>(pbwd::acc_floats(1));
  out[2] = pbwd::kMaxSmem;
}
