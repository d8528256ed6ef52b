// Fused prompt extras of one vision block, for Hopper (sm_90a).
//
// Replaces the TPU kernel gava_clip_tpu/ops/extras_kernel.py: _extras_kernel
// (reached through fused_extras' pl.pallas_call); with the switch on it
// opens every block of the w8a8 serving path, in front of the qkv kernel:
//
//   cls (BT, D), the cls rows of the BT = Bb * Tb frame rows; per clip b
//   (its Tb rows), everything in fp32 whatever the inputs' types:
//     cp      = cls @ Wc + bc
//     sn      = LayerNorm(cp)                 biased variance, eps 1e-5
//     q, k, v = sn @ Wq + bq, ...             H heads of D / H
//     p       = softmax(q_h k_h^T * (D/H)^-0.5) over the clip's Tb rows
//               (exact: max subtracted, exp, divide)
//     summary = cp + (p v) @ Wo + bo
//     local[t'] = lp[t'] + cp[t']
//   e (BT, le_pad, D): for each of the clip's frame rows
//     [gp (G rows) | summary of that row | local[0..Tb-1] | zero rows],
//   and summary (BT, D), both cast to cls's type at the store.
//
// What bounds it on an H100 SXM (data-sheet figures): at the serving shape
// (BT = 128, Tb = 8, D = 768, G = 8, le_pad = 17) the five D x D weights
// are 11.8 MB in fp32 (3.5 us at 3.35 TB/s) and e is 3.3 MB in bf16,
// against 0.76 GFLOP of products: 11 us as fp32 FMA on every SM, 4.6 us as
// the three TF32 products of each fp32 product below (495 TFLOP/s).
//
// Like the TPU kernel, which takes every dot over all BT rows at once, the
// design reads each weight from device memory once per launch, for all BT
// rows, and spreads the output columns over the card. One persistent
// cooperative launch of thread-block clusters (CS = 8 blocks by default, 12
// clusters at the serving shape: 96 blocks; the driver refuses the launch
// unless every block can be resident) runs three stages with a grid-wide
// barrier (cooperative groups) between them:
//   1. cls_proj: cluster c takes the 64 output columns of slice c; its
//      block j the j-th eighth of K (96 rows of Wc) for all BT rows
//      (split K). The 8 partial tiles meet in the blocks' shared memory
//      (distributed shared memory): block j sums rows 16j .. 16j + 15 of all
//      8 in a fixed order, adds the bias, writes cp to a workspace, the
//      frame rows' local rows of e, and the LayerNorm's count / mean /
//      centred square sum of its 64-column piece of each row.
//   2. LayerNorm + q/k/v + attention: cluster h takes head h. Each block
//      merges the pieces' statistics per row (Chan's formula, fixed order),
//      normalises its K range of cp on the way into shared memory and
//      multiplies it with its 96 rows of the head's 192 q, k, v columns;
//      the partials meet as in stage 1 and the sums go to the workspace.
//      After a cluster barrier each block runs the exact-softmax attention
//      of its clips for the head (Tb x Tb scores) into the workspace.
//   3. out-projection + residual: as stage 1 on the attention output and
//      Wo; the owner adds bo and cp and stores summary and e's summary rows.
// e's global and zero rows are written by every block at the start.
//
// The products run on the tensor cores as 3xTF32 (mma.sync m16n8k8, the
// steps of tf32_frags.cuh, shared with attention_f32.cu): each
// fp32 operand is split into hi = tf32(x) and lo = x - hi, and a * b is
// taken as lo_a hi_b + hi_a lo_b + hi_a hi_b in the fp32 accumulator (the
// lo_a lo_b term, 2^-22 of the product, is dropped): fp32 accuracy at three
// TF32 products a product (a bf16 operand has lo = 0, one product less).
// Sums are taken in a fixed order and no output is written by an atomic:
// the same bits every run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "attention_frags.cuh"
#include "tf32_frags.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // 8 warps, 16 rows of a row tile each
constexpr int kRowsT = 128;            // rows of a row tile
constexpr int kKC = 96;                // K values of a sub-chunk in shared memory
constexpr int kSliceN = 64;            // columns of a cls_proj / out-projection slice
constexpr int kHeadN = 192;            // q, k, v columns of a head (64 each, zero past D / H)
constexpr int kLDA = kKC + 4;          // floats per A row: conflict-free fragments
constexpr int kLDP1 = kSliceN + 8;     // floats per partial row, stages 1 and 3
constexpr int kLDP3 = kHeadN + 8;      // floats per partial row, stage 2
constexpr int kMaxTb = 64;             // frame rows of a clip, at most
constexpr int kMaxCS = 8;              // blocks of a cluster, at most
constexpr int kPer = kRowsT * (kKC / 4) / kThreads;   // A groups of four a thread

__host__ __device__ constexpr int ldw(int n) { return n + 8; }   // weight tile row

// dynamic shared memory: A tile | weight tile | partial tile | row mean, inv
template <typename WT>
__host__ __device__ constexpr int smem_bytes() {
  return kRowsT * kLDA * 4 + kKC * ldw(kHeadN) * static_cast<int>(sizeof(WT)) +
         kRowsT * kLDP3 * 4 + 2 * kRowsT * 4;
}

struct Args {
  const void* cls;
  long long cls_stride;
  const void* w[5];                    // Wc, Wq, Wk, Wv, Wo: (D, D), rows = input dim
  const float *bc, *lns, *lnb, *bq, *bk, *bv, *bo, *lp, *gp;
  void* e;
  void* summary;
  float* cp;                           // workspace (BT, D): cls_proj's output
  float* attn;                         // (BT, D): the attention's output
  float* qkv;                          // (H, BT, 192): q, k, v of each head
  float* stats;                        // (BT, NS, 2): mean, centred square sum
  int Bb, Tb, G, D, H, le_pad;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// a value the kernel itself wrote (the workspace): through L2, never a
// stale L1 line
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// four values global -> shared, asynchronously (16 bytes of fp32, 8 of
// bf16); zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async4v(float* dst, const float* src, bool ok) {
  afrag::cp_async16(dst, src, ok);
}
__device__ __forceinline__ void cp_async4v(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool ok) {
  afrag::cp_async8(dst, src, ok);
}

using tf32::mma_tf32;
using tf32::split;

// acc (this warp's 16 rows x 8 NT columns) += A_s (rows, kn values) x W_s
// (kn rows, 8 NT columns), 3xTF32. kn is a multiple of 8; ALO / BLO: the
// operand may have a nonzero lo part (false for bf16 values). Eight column
// tiles at a time, each of the three products over all eight before the
// next, so that no mma waits on the one before it.
template <int NT, bool ALO, bool BLO, typename WT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const float* A_s,
                                          const WT* W_s, int ldws, int kn, int warp, int lane) {
  static_assert(NT % 8 == 0, "column tiles in groups of 8");
  const int g = lane >> 2, t = lane & 3;
  const float* ar = A_s + (warp * 16 + g) * kLDA + t;
  const WT* wr = W_s + t * ldws + g;
  for (int k = 0; k < kn; k += 8) {
    uint32_t ah[4], al[4];
    split(ar[k], ah[0], al[0]);
    split(ar[8 * kLDA + k], ah[1], al[1]);
    split(ar[k + 4], ah[2], al[2]);
    split(ar[8 * kLDA + k + 4], ah[3], al[3]);
    const WT* w0 = wr + k * ldws;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += 8) {
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float b = to_f32(w0[h * 4 * ldws + (n0 + j) * 8]);
          if (BLO)
            split(b, bh[j][h], bl[j][h]);
          else
            bh[j][h] = __float_as_uint(b);   // a bf16 value is a TF32 one
        }
      }
      if (ALO) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[n0 + j], al, bh[j][0], bh[j][1]);
      }
      if (BLO) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[n0 + j], ah, bl[j][0], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(acc[n0 + j], ah, bh[j][0], bh[j][1]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

template <int NT>
__device__ __forceinline__ void store_partial(const float (&acc)[NT][4], float* P_s, int ldp,
                                              int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float* p0 = P_s + (warp * 16 + g) * ldp + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(p0 + n * 8) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(p0 + 8 * ldp + n * 8) = make_float2(acc[n][2], acc[n][3]);
  }
}

// the weight rows [k0, k0 + kn) of the columns cols[p] .. cols[p] + w of
// the NP weights `W[p]` (each (D, D)) into W_s (kn x 64 NP, part p at
// column 64 p), asynchronously; columns past w and rows past D are zero
template <int NP, typename WT>
__device__ void load_w(WT* W_s, const WT* const (&W)[NP], const int (&cols)[NP], int w,
                       int k0, int kn, int D) {
  constexpr int Q = 16;                    // groups of four values a part row
  for (int i = threadIdx.x; i < kn * NP * Q; i += kThreads) {
    const int q = i % Q, p = (i / Q) % NP, r = i / (Q * NP);
    const int k = k0 + r;
    const bool ok = k < D && 4 * q < w;
    cp_async4v(W_s + r * ldw(64 * NP) + 64 * p + 4 * q,
               ok ? W[p] + static_cast<long long>(k) * D + cols[p] + 4 * q : W[p], ok);
  }
}

// the block's partial tile into the owner's rows: returns the sum over the
// cluster's blocks, in rank order, of the float4 at (row, col) of P_s (every
// remote load issued before the first add)
__device__ __forceinline__ float4 cluster_sum(cg::cluster_group& cluster, float* P_s, int ldp,
                                              int row, int col) {
  const int n = static_cast<int>(cluster.num_blocks());
  float4 v[kMaxCS];
#pragma unroll
  for (int r = 0; r < kMaxCS; ++r)
    if (r < n)
      v[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(P_s, r) + row * ldp + col);
  float4 s = v[0];
#pragma unroll
  for (int r = 1; r < kMaxCS; ++r) {
    if (r < n) {
      s.x += v[r].x;
      s.y += v[r].y;
      s.z += v[r].z;
      s.w += v[r].w;
    }
  }
  return s;
}

// The exact-softmax attention of head h for nc clips: clip c is clip
// b0 + c * bstep, its Tb rows of q | k | v (192 floats a row, at 0, 64,
// 128) at rows c * Tb .. of qkv_s; the scores go to sc_s; the outputs to
// the head's columns of attn (row stride D). Ends with a barrier.
__device__ void clip_attention(const float* qkv_s, float* sc_s, int nc, int b0, int bstep,
                               int Tb, int Dh, int h, int D, float* attn) {
  const int tid = threadIdx.x;
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));   // IEEE: 0.125 at Dh = 64
  for (int i = tid; i < nc * Tb * Tb; i += kThreads) {
    const int c = i / (Tb * Tb), qi = (i / Tb) % Tb, kj = i % Tb;
    const float* qr = qkv_s + (c * Tb + qi) * kHeadN;
    const float* kr = qkv_s + (c * Tb + kj) * kHeadN + 64;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);   // four partial sums
    for (int d = 0; d < Dh; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qr + d);
      const float4 y = *reinterpret_cast<const float4*>(kr + d);
      s4 = make_float4(fmaf(x.x, y.x, s4.x), fmaf(x.y, y.y, s4.y), fmaf(x.z, y.z, s4.z),
                       fmaf(x.w, y.w, s4.w));
    }
    sc_s[i] = ((s4.x + s4.y) + (s4.z + s4.w)) * scale;
  }
  __syncthreads();
  for (int i = tid; i < nc * Tb; i += kThreads) {
    float* row = sc_s + i * Tb;
    float m = row[0];
    for (int j = 1; j < Tb; ++j) m = fmaxf(m, row[j]);
    float sum = 0.f;
    for (int j = 0; j < Tb; ++j) {
      row[j] = expf(row[j] - m);
      sum += row[j];
    }
    for (int j = 0; j < Tb; ++j) row[j] = row[j] / sum;
  }
  __syncthreads();
  for (int i = tid; i < nc * Tb * Dh; i += kThreads) {
    const int row = i / Dh, d = i % Dh, c = row / Tb;
    const float* p = sc_s + row * Tb;
    const float* vr = qkv_s + c * Tb * kHeadN + 128 + d;
    float acc = 0.f;
    for (int j = 0; j < Tb; ++j) acc = fmaf(p[j], vr[j * kHeadN], acc);
    const int r = (b0 + c * bstep) * Tb + row % Tb;
    attn[static_cast<long long>(r) * D + h * Dh + d] = acc;
  }
  __syncthreads();
}

template <typename WT, typename CT>
__global__ void __launch_bounds__(kThreads, 1) fused_extras_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  // the stages meet at grid-wide barriers: a cooperative launch, so every
  // block is resident (the launch fails otherwise)
  const cg::grid_group grid = cg::this_grid();
  float* A_s = reinterpret_cast<float*>(smem_raw);
  WT* W_s = reinterpret_cast<WT*>(smem_raw + kRowsT * kLDA * 4);
  float* P_s = reinterpret_cast<float*>(smem_raw + kRowsT * kLDA * 4 +
                                        kKC * ldw(kHeadN) * sizeof(WT));
  float* mean_s = P_s + kRowsT * kLDP3;
  float* inv_s = mean_s + kRowsT;

  const int CS = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D, H = a.H, Tb = a.Tb, G = a.G;
  const int BT = a.Bb * Tb, Dh = D / H;
  const int NS = (D + kSliceN - 1) / kSliceN;           // column slices
  const int NRT = (BT + kRowsT - 1) / kRowsT;           // row tiles
  const int KCB = ((D + CS * 8 - 1) / (CS * 8)) * 8;    // K values of a block
  const int kb0 = rank * KCB, kb1 = min(D, kb0 + KCB);  // this block's K range
  const int own = kRowsT / CS;                          // rows a block owns in a tile
  const WT* const* W = reinterpret_cast<const WT* const*>(a.w);
  CT* e = static_cast<CT*>(a.e);
  const int npad = a.le_pad - (G + 1 + Tb);

  // ---------------- stage 1: cls_proj ----------------
  constexpr bool kActLo = sizeof(CT) == 4, kWLo = sizeof(WT) == 4;
  const int nsub = (kb1 - kb0 + kKC - 1) / kKC;
  for (int item = cl; item < NS; item += ncl) {
    const int c0 = item * kSliceN, w = min(kSliceN, D - c0);
    const WT* wp[1] = {W[0]};
    const int cols[1] = {c0};
    for (int rt = 0; rt < NRT; ++rt) {
      const int r0 = rt * kRowsT;
      float acc[kSliceN / 8][4];
      zero(acc);
      for (int s = 0; s < max(nsub, 1); ++s) {
        const int k0 = kb0 + s * kKC, kn = max(0, min(kKC, kb1 - k0));
        __syncthreads();   // the tiles' last readers are done
        if (rt == 0 || nsub > 1) load_w<1>(W_s, wp, cols, w, k0, (kn + 7) / 8 * 8, D);
        const CT* x = static_cast<const CT*>(a.cls);
        float4 buf[kPer];   // every load in flight before the first store
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads, r = i / (kKC / 4), kk = (i % (kKC / 4)) * 4;
          buf[j] = r0 + r < BT && kk < kn ? load4(x + (r0 + r) * a.cls_stride + k0 + kk)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads;
          store4(A_s + (i / (kKC / 4)) * kLDA + (i % (kKC / 4)) * 4, buf[j]);
        }
        afrag::cp_commit();
        afrag::cp_wait_all();
        __syncthreads();
        warp_gemm<kSliceN / 8, kActLo, kWLo>(acc, A_s, W_s, ldw(kSliceN), (kn + 7) / 8 * 8,
                                             warp, lane);
      }
      store_partial(acc, P_s, kLDP1, warp, lane);
      cluster.sync();
      // owner: rows rank * own .. + own of the tile, 16 threads a row
      for (int i = tid; i < own * 16; i += kThreads) {
        const int lr = rank * own + i / 16, col = (i % 16) * 4;
        const int r = r0 + lr;
        float4 v = cluster_sum(cluster, P_s, kLDP1, lr, col);
        const bool ok = r < BT && col < w;
        if (ok) {
          const float4 b4 = *reinterpret_cast<const float4*>(a.bc + c0 + col);
          v = make_float4(v.x + b4.x, v.y + b4.y, v.z + b4.z, v.w + b4.w);
          *reinterpret_cast<float4*>(a.cp + static_cast<long long>(r) * D + c0 + col) = v;
          // local row t' = r % Tb of every frame row of the clip
          const int t_ = r % Tb, rb = r - t_;
          const float4 l4 = *reinterpret_cast<const float4*>(a.lp + t_ * D + c0 + col);
          const float4 lv = make_float4(l4.x + v.x, l4.y + v.y, l4.z + v.z, l4.w + v.w);
          for (int f = 0; f < Tb; ++f)
            store4(e + (static_cast<long long>(rb + f) * a.le_pad + G + 1 + t_) * D + c0 + col,
                   lv);
        }
        // the LayerNorm's statistics of the row's piece: mean, then the
        // centred square sum (16 lanes of one warp hold the row)
        float s = ok ? v.x + v.y + v.z + v.w : 0.f;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const float mean = s / static_cast<float>(w);
        float q = 0.f;
        if (ok) {
          const float dx = v.x - mean, dy = v.y - mean, dz = v.z - mean, dw = v.w - mean;
          q = dx * dx + dy * dy + dz * dz + dw * dw;
        }
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
        if (r < BT && col == 0)
          reinterpret_cast<float2*>(a.stats)[static_cast<long long>(r) * NS + item] =
              make_float2(mean, q);
      }
      // the partial tiles are read: they may be overwritten (after the
      // last tile the grid barrier says so)
      if (item + ncl < NS || rt + 1 < NRT) cluster.sync();
    }
  }
  // stage 2's first weight tile, while the blocks meet
  const WT* wqkv[3] = {W[1], W[2], W[3]};
  if (cl < H && nsub <= 1) {
    const int cols[3] = {cl * Dh, cl * Dh, cl * Dh};
    load_w<3>(W_s, wqkv, cols, Dh, kb0, (max(0, kb1 - kb0) + 7) / 8 * 8, D);
  }
  auto arrived = grid.barrier_arrive();
  // e's global-prompt rows and zero rows, while the other blocks finish
  // stage 1: a warp per (frame row, slot), the lanes over the columns
  {
    const int nl = G + npad;
    for (int rl = blockIdx.x * (kThreads / 32) + warp; rl < BT * nl;
         rl += gridDim.x * (kThreads / 32)) {
      const int r = rl / nl, li = rl % nl;
      const int l = li < G ? li : G + 1 + Tb + (li - G);
      CT* dst = e + (static_cast<long long>(r) * a.le_pad + l) * D;
      for (int c = lane * 4; c < D; c += 128)
        store4(dst + c, li < G ? *reinterpret_cast<const float4*>(a.gp + li * D + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }

  grid.barrier_wait(std::move(arrived));

  // ---------------- stage 2: LayerNorm + q/k/v + attention ----------------
  // when a block's rows of a tile are whole clips (Tb divides them) and
  // their q, k, v and scores fit the A tile, each block runs the attention
  // of its own rows right after the partial sums meet
  const bool local_attn = own % Tb == 0 && own * (kHeadN + Tb) <= kRowsT * kLDA;
  for (int h = cl; h < H; h += ncl) {
    const int cols[3] = {h * Dh, h * Dh, h * Dh};
    const float* bias[3] = {a.bq, a.bk, a.bv};
    for (int rt = 0; rt < NRT; ++rt) {
      const int r0 = rt * kRowsT;
      __syncthreads();
      // each row's mean and 1 / sqrt(var + eps) from its pieces, in order
      for (int r = tid; r < kRowsT; r += kThreads) {
        float n = 0.f, mean = 0.f, m2 = 0.f;
        if (r0 + r < BT) {
          const float2* st =
              reinterpret_cast<const float2*>(a.stats) + static_cast<long long>(r0 + r) * NS;
          for (int s0 = 0; s0 < NS; s0 += 8) {   // eight pieces' loads in flight
            float2 mq[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (s0 + j < NS) mq[j] = __ldcg(st + s0 + j);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (s0 + j < NS) {
                const float nb = static_cast<float>(min(kSliceN, D - (s0 + j) * kSliceN));
                const float nn = n + nb, d = mq[j].x - mean;
                mean += d * (nb / nn);
                m2 += mq[j].y + d * d * (n * nb / nn);
                n = nn;
              }
            }
          }
        }
        mean_s[r] = mean;
        inv_s[r] = rsqrtf(m2 / static_cast<float>(D) + 1e-5f);
      }
      float acc[kHeadN / 8][4];
      zero(acc);
      for (int s = 0; s < max(nsub, 1); ++s) {
        const int k0 = kb0 + s * kKC, kn = max(0, min(kKC, kb1 - k0));
        __syncthreads();
        if ((rt == 0 && h != cl) || nsub > 1)   // (the first: loaded above)
          load_w<3>(W_s, wqkv, cols, Dh, k0, (kn + 7) / 8 * 8, D);
        float4 buf[kPer];   // every load in flight before the first store
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads, r = i / (kKC / 4), kk = (i % (kKC / 4)) * 4;
          buf[j] = r0 + r < BT && kk < kn
                       ? ldcg4(a.cp + static_cast<long long>(r0 + r) * D + k0 + kk)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads, r = i / (kKC / 4), kk = (i % (kKC / 4)) * 4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r0 + r < BT && kk < kn) {
            const float4 x = buf[j], g4 = load4(a.lns + k0 + kk), b4 = load4(a.lnb + k0 + kk);
            const float m = mean_s[r], iv = inv_s[r];
            v = make_float4((x.x - m) * iv * g4.x + b4.x, (x.y - m) * iv * g4.y + b4.y,
                            (x.z - m) * iv * g4.z + b4.z, (x.w - m) * iv * g4.w + b4.w);
          }
          store4(A_s + r * kLDA + kk, v);
        }
        afrag::cp_commit();
        afrag::cp_wait_all();
        __syncthreads();
        warp_gemm<kHeadN / 8, true, kWLo>(acc, A_s, W_s, ldw(kHeadN), (kn + 7) / 8 * 8, warp,
                                          lane);
      }
      store_partial(acc, P_s, kLDP3, warp, lane);
      cluster.sync();
      for (int i = tid; i < own * (kHeadN / 4); i += kThreads) {
        const int lr = rank * own + i / (kHeadN / 4), n = (i % (kHeadN / 4)) * 4;
        const int r = r0 + lr, p = n / 64, d = n % 64;
        if (r < BT) {
          float4 v = cluster_sum(cluster, P_s, kLDP3, lr, n);
          if (d < Dh) {
            const float4 b4 = *reinterpret_cast<const float4*>(bias[p] + h * Dh + d);
            v = make_float4(v.x + b4.x, v.y + b4.y, v.z + b4.z, v.w + b4.w);
          }
          if (local_attn)
            *reinterpret_cast<float4*>(A_s + (lr - rank * own) * kHeadN + n) = v;
          else
            *reinterpret_cast<float4*>(
                a.qkv + (static_cast<long long>(h) * BT + r) * kHeadN + n) = v;
        }
      }
      if (local_attn) {
        // this block's rows are whole clips: their attention now, from
        // shared memory
        __syncthreads();
        const int b0 = (r0 + rank * own) / Tb;
        clip_attention(A_s, A_s + own * kHeadN, max(0, min(own / Tb, a.Bb - b0)), b0, 1, Tb, Dh,
                       h, D, a.attn);
      }
      if (rt + 1 < NRT) cluster.sync();
    }
    if (local_attn) {
      if (h + ncl < H) cluster.sync();   // the partial tiles are read
      continue;
    }
    __threadfence();
    cluster.sync();   // the head's q, k, v are in the workspace; partials read

    // the exact-softmax attention of the clips b = rank, rank + CS, ..., a
    // group of clips at a time: q, k, v into P_s, the scores into A_s
    const int per = max(1, kRowsT / Tb);                          // clips of a group
    for (int b0 = rank; b0 < a.Bb; b0 += CS * per) {
      int nc = 0;
      while (nc < per && b0 + nc * CS < a.Bb) ++nc;
      for (int i = tid; i < nc * Tb * (kHeadN / 4); i += kThreads) {
        const int row = i / (kHeadN / 4), n = (i % (kHeadN / 4)) * 4;
        const int b = b0 + (row / Tb) * CS, r = b * Tb + row % Tb;
        *reinterpret_cast<float4*>(P_s + row * kHeadN + n) =
            ldcg4(a.qkv + (static_cast<long long>(h) * BT + r) * kHeadN + n);
      }
      __syncthreads();
      clip_attention(P_s, A_s, nc, b0, CS, Tb, Dh, h, D, a.attn);
    }
  }

  // stage 3's first weight tile, while the blocks meet
  const WT* wo[1] = {W[4]};
  if (cl < NS && nsub <= 1) {
    const int cols[1] = {cl * kSliceN};
    load_w<1>(W_s, wo, cols, min(kSliceN, D - cl * kSliceN), kb0,
              (max(0, kb1 - kb0) + 7) / 8 * 8, D);
  }
  grid.sync();

  // ---------------- stage 3: out-projection + residual ----------------
  CT* summary = static_cast<CT*>(a.summary);
  for (int item = cl; item < NS; item += ncl) {
    const int c0 = item * kSliceN, w = min(kSliceN, D - c0);
    const int cols[1] = {c0};
    for (int rt = 0; rt < NRT; ++rt) {
      const int r0 = rt * kRowsT;
      float acc[kSliceN / 8][4];
      zero(acc);
      for (int s = 0; s < max(nsub, 1); ++s) {
        const int k0 = kb0 + s * kKC, kn = max(0, min(kKC, kb1 - k0));
        __syncthreads();
        if ((rt == 0 && item != cl) || nsub > 1)   // (the first: loaded above)
          load_w<1>(W_s, wo, cols, w, k0, (kn + 7) / 8 * 8, D);
        for (int i = tid; i < kRowsT * (kKC / 4); i += kThreads) {
          const int r = i / (kKC / 4), kk = (i % (kKC / 4)) * 4;
          const bool ok = r0 + r < BT && kk < kn;
          cp_async4v(A_s + r * kLDA + kk,
                     ok ? a.attn + static_cast<long long>(r0 + r) * D + k0 + kk : a.attn, ok);
        }
        afrag::cp_commit();
        afrag::cp_wait_all();
        __syncthreads();
        warp_gemm<kSliceN / 8, true, kWLo>(acc, A_s, W_s, ldw(kSliceN), (kn + 7) / 8 * 8, warp,
                                           lane);
      }
      store_partial(acc, P_s, kLDP1, warp, lane);
      cluster.sync();
      for (int i = tid; i < own * 16; i += kThreads) {
        const int lr = rank * own + i / 16, col = (i % 16) * 4;
        const int r = r0 + lr;
        if (r < BT && col < w) {
          const float4 v = cluster_sum(cluster, P_s, kLDP1, lr, col);
          const float4 b4 = *reinterpret_cast<const float4*>(a.bo + c0 + col);
          const float4 c4 = ldcg4(a.cp + static_cast<long long>(r) * D + c0 + col);
          const float4 sv = make_float4(c4.x + (v.x + b4.x), c4.y + (v.y + b4.y),
                                        c4.z + (v.z + b4.z), c4.w + (v.w + b4.w));
          store4(summary + static_cast<long long>(r) * D + c0 + col, sv);
          store4(e + (static_cast<long long>(r) * a.le_pad + G) * D + c0 + col, sv);
        }
      }
      cluster.sync();
    }
  }
}

// the launch's shape: clusters of CS blocks, cooperative (every block
// resident at once, or the launch fails)
struct LaunchShape {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  LaunchShape(int CS, int ncl, int bytes, cudaStream_t stream) {
    cfg.gridDim = dim3(CS * ncl);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
  }
};

template <typename WT, typename CT>
cudaError_t set_smem() {
  // per device: the shared-memory attribute, set at the first launch only
  static bool set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!set[dev]) {
    err = cudaFuncSetAttribute(fused_extras_kernel<WT, CT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<WT>());
    if (err != cudaSuccess) return err;
    set[dev] = true;
  }
  return cudaSuccess;
}

template <typename WT, typename CT>
int launch(const Args& a, int CS, int ncl, cudaStream_t stream) {
  cudaError_t err = set_smem<WT, CT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  LaunchShape l(CS, ncl, smem_bytes<WT>(), stream);
  err = cudaLaunchKernelEx(&l.cfg, fused_extras_kernel<WT, CT>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int max_clusters(int CS, int* out) {
  const cudaError_t err = set_smem<WT, __nv_bfloat16>();
  if (err != cudaSuccess) return static_cast<int>(err);
  LaunchShape l(CS, 1, smem_bytes<WT>(), nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, fused_extras_kernel<WT, __nv_bfloat16>, &l.cfg));
}

}  // namespace

// The constants the launch plan (ops/extras_kernel.fused_extras_plan) is
// computed from: rows of a row tile, K values of a sub-chunk, columns of a
// slice, q/k/v columns of a head, most frame rows of a clip, most blocks of
// a cluster, and the dynamic shared bytes with fp32 and with bf16 weights.
extern "C" void fused_extras_layout(int* out) {
  out[0] = kRowsT;
  out[1] = kKC;
  out[2] = kSliceN;
  out[3] = kHeadN;
  out[4] = kMaxTb;
  out[5] = kMaxCS;
  out[6] = smem_bytes<float>();
  out[7] = smem_bytes<__nv_bfloat16>();
}

// The most clusters of CS blocks the current device holds at once (fp32
// weights when w_bf16 == 0), or a negative CUDA error code.
extern "C" int fused_extras_max_clusters(int CS, int w_bf16) {
  int n = 0;
  const int err = w_bf16 ? max_clusters<__nv_bfloat16>(CS, &n) : max_clusters<float>(CS, &n);
  return err ? -err : n;
}

// cls: Bb * Tb rows of D values, `cls_stride` elements apart, bf16
// (act_bf16 != 0) or fp32. Wc, Wq, Wk, Wv, Wo (D, D) contiguous, rows = input
// dim, all bf16 (w_bf16 != 0) or all fp32, 16-byte aligned. bc, lns, lnb, bq,
// bk, bv, bo (D), lp (Tb, D), gp (G, D) fp32 contiguous, 16-byte aligned.
// e (Bb * Tb, le_pad, D), summary (Bb * Tb, D) contiguous in cls's type.
// workspace: 2 BT D + 192 H BT + 2 BT ceil(D / 64) floats, 16-byte
// aligned. The plan: CS blocks a cluster, ncl clusters. Returns the
// launch's error code (cudaErrorInvalidValue when the shapes do not fit:
// D % 4, D % H, (D / H) % 4, D / H > 64, Tb > 64, le_pad < G + 1 + Tb;
// cudaErrorCooperativeLaunchTooLarge when the clusters cannot all be
// resident).
extern "C" int fused_extras(const void* cls, long long cls_stride, const void* Wc,
                            const void* bc, const void* lns, const void* lnb, const void* Wq,
                            const void* bq, const void* Wk, const void* bk, const void* Wv,
                            const void* bv, const void* Wo, const void* bo, const void* lp,
                            const void* gp, void* e, void* summary, void* workspace, int Bb, int Tb, int G, int D, int H, int le_pad,
                            int w_bf16, int act_bf16, int CS, int ncl, void* stream) {
  if (Bb <= 0 || Tb <= 0 || G < 0 || D <= 0 || H <= 0 || D % 4 || D % H || (D / H) % 4 ||
      D / H > 64 || Tb > kMaxTb || le_pad < G + 1 + Tb || CS < 1 || CS > kMaxCS ||
      kRowsT % CS || ncl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long BT = static_cast<long long>(Bb) * Tb;
  float* ws = static_cast<float*>(workspace);
  Args a;
  a.cls = cls;
  a.cls_stride = cls_stride;
  a.w[0] = Wc;
  a.w[1] = Wq;
  a.w[2] = Wk;
  a.w[3] = Wv;
  a.w[4] = Wo;
  a.bc = static_cast<const float*>(bc);
  a.lns = static_cast<const float*>(lns);
  a.lnb = static_cast<const float*>(lnb);
  a.bq = static_cast<const float*>(bq);
  a.bk = static_cast<const float*>(bk);
  a.bv = static_cast<const float*>(bv);
  a.bo = static_cast<const float*>(bo);
  a.lp = static_cast<const float*>(lp);
  a.gp = static_cast<const float*>(gp);
  a.e = e;
  a.summary = summary;
  a.cp = ws;
  a.attn = ws + BT * D;
  a.qkv = ws + 2 * BT * D;
  a.stats = a.qkv + BT * H * kHeadN;
  a.Bb = Bb;
  a.Tb = Tb;
  a.G = G;
  a.D = D;
  a.H = H;
  a.le_pad = le_pad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16 && act_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, CS, ncl, st);
  if (w_bf16) return launch<__nv_bfloat16, float>(a, CS, ncl, st);
  if (act_bf16) return launch<float, __nv_bfloat16>(a, CS, ncl, st);
  return launch<float, float>(a, CS, ncl, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
