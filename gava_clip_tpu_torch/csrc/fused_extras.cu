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
// What bounds it on an H100 SXM (data-sheet figures, not measured): at the
// serving shape (BT = 128, Tb = 8, D = 768, G = 8, le_pad = 17) the five
// D x D weights are 11.8 MB in fp32 (5.9 MB in bf16), e is 3.3 MB in bf16:
// ~5 us at 3.35 TB/s, against 0.76 GFLOP of fp32 FMA (11 us at 67 TFLOP/s if
// every SM took part). It is a launch-and-latency problem: the work of a
// clip is a chain of five small GEMMs (Tb rows) with a LayerNorm and a tiny
// attention between them.
//
// The TPU body is one program that masks a (BT, BT) score tile block-
// diagonally and repeats the local rows with a one-hot matmul; neither
// belongs here. The work is independent per clip, so a clip's Tb rows go
// through the chain in shared memory. The hard part is that whoever holds a
// clip reads every weight whole (from L2 after the first) with only Tb rows
// to reuse it on, and that the chain needs whole rows between its GEMMs (the
// LayerNorm, the out-projection). Design: a thread block CLUSTER per clip.
// Each of its blocks owns a slice of the D columns that holds whole heads:
// it computes that slice of every GEMM from the full input rows, runs the
// attention of its own heads, and the two results that the next stage needs
// whole (cls_proj's output and the attention's) are written into every
// block's shared memory through the cluster's distributed shared memory,
// with one cluster barrier each. Inside a block the GEMM splits K across
// the threads (each thread four columns of one K range, 16-byte weight
// loads, the rows broadcast from shared memory) to keep enough loads in
// flight, and sums the partial tiles in a fixed order. The cluster size is
// the largest of 8, 4, 2, 1 that divides the heads (4 at H = 12: 64 blocks
// at batch 16). fp32 FMA throughout; tensor cores are not used.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 768;
constexpr int kMaxKSplit = 16;   // K ranges of the block GEMM, at most
constexpr int kRows = 8;         // rows per register tile of the block GEMM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out (Tb x Dc, shared) = x (Tb x D, shared) @ W[:, c0 : c0 + Dc] + bias,
// W (D x D, device, row k contiguous over the columns). part: KS x Tb x Dc
// floats of shared memory. Ends with a barrier; x may not alias out.
template <typename WT>
__device__ void block_gemm(const float* x, const WT* __restrict__ W,
                           const float* __restrict__ bias, float* out, float* part, int Tb,
                           int D, int c0, int Dc, int KS) {
  const int CG = Dc / 4;                           // groups of 4 columns
  const int KC = ((D + KS - 1) / KS + 3) / 4 * 4;  // k's per range
  for (int r0 = 0; r0 < Tb; r0 += kRows) {
    for (int it = threadIdx.x; it < CG * KS; it += kThreads) {
      const int cgi = it % CG, ks = it / CG;
      const int k_end = min(D, (ks + 1) * KC);
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      const WT* wp = W + c0 + 4 * cgi;
      for (int k = ks * KC; k < k_end; k += 4) {     // D % 4 == 0: whole steps
        float4 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = load4(wp + static_cast<long long>(k + i) * D);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r0 + r < Tb) {
            const float4 xv = *reinterpret_cast<const float4*>(x + (r0 + r) * D + k);
            const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[r][0] = fmaf(xs[i], w[i].x, acc[r][0]);
              acc[r][1] = fmaf(xs[i], w[i].y, acc[r][1]);
              acc[r][2] = fmaf(xs[i], w[i].z, acc[r][2]);
              acc[r][3] = fmaf(xs[i], w[i].w, acc[r][3]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < Tb)
          *reinterpret_cast<float4*>(part + (ks * Tb + r0 + r) * Dc + 4 * cgi) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Tb * Dc; i += kThreads) {
    float s = part[i];
    for (int ks = 1; ks < KS; ++ks) s += part[ks * Tb * Dc + i];
    out[i] = s + bias[c0 + i % Dc];
  }
  __syncthreads();
}

// The block's (Tb x Dc) slice into columns c0.. of the (Tb x D) buffer `full`
// of every block of the cluster (its own too), then a cluster barrier.
__device__ void share_slice(cg::cluster_group& cluster, const float* slice, float* full,
                            int Tb, int D, int c0, int Dc) {
  const unsigned n = cluster.num_blocks();
  for (unsigned r = 0; r < n; ++r) {
    float* dst = cluster.map_shared_rank(full, r);
    for (int i = threadIdx.x; i < Tb * Dc; i += kThreads)
      dst[(i / Dc) * D + c0 + i % Dc] = slice[i];
  }
  cluster.sync();
}

template <typename WT, typename CT>
__global__ void __launch_bounds__(kThreads, 1)
fused_extras_kernel(const CT* __restrict__ cls, long long cls_stride,
                    const WT* __restrict__ Wc, const float* __restrict__ bc,
                    const float* __restrict__ lns, const float* __restrict__ lnb,
                    const WT* __restrict__ Wq, const float* __restrict__ bq,
                    const WT* __restrict__ Wk, const float* __restrict__ bk,
                    const WT* __restrict__ Wv, const float* __restrict__ bv,
                    const WT* __restrict__ Wo, const float* __restrict__ bo,
                    const float* __restrict__ lp, const float* __restrict__ gp,
                    CT* __restrict__ e, CT* __restrict__ summary, int Tb, int G, int D, int H,
                    int le_pad, int KS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = static_cast<int>(cluster.num_blocks());
  const int Dc = D / CS, Hc = H / CS, Dh = D / H;     // this block's columns, heads
  const int c0 = static_cast<int>(cluster.block_rank()) * Dc;
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int TD = Tb * D, TC = Tb * Dc;
  float* xb = smem;             // whole rows: cls, then the LayerNorm's output
  float* cp = xb + TD;          // whole rows of cls_proj's output
  float* ab = cp + TD;          // whole rows of the attention's output
  float* qb = ab + TD;          // slices: q, later the summary
  float* kb = qb + TC;
  float* vb = kb + TC;
  float* tb = vb + TC;          // a slice on its way to the whole-row buffers
  float* part = tb + TC;        // KS x Tb x Dc
  float* sc = part + KS * TC;   // Hc x Tb x Tb
  const int b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long row0 = static_cast<long long>(b) * Tb;

  for (int i = tid; i < TD; i += kThreads)
    xb[i] = to_f32(cls[(row0 + i / D) * cls_stride + i % D]);
  // every block of the cluster runs before any writes into another's
  // shared memory (also the block's own barrier for xb)
  cluster.sync();

  block_gemm(xb, Wc, bc, tb, part, Tb, D, c0, Dc, KS);
  share_slice(cluster, tb, cp, Tb, D, c0, Dc);

  // summary LayerNorm of the whole rows (every block its own copy): one
  // warp per row, two-pass variance
  for (int r = warp; r < Tb; r += kThreads / 32) {
    const float* src = cp + r * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += src[c];
    const float mean = warp_sum(s) / static_cast<float>(D);
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = src[c] - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / static_cast<float>(D) + 1e-5f);
    for (int c = lane; c < D; c += 32) xb[r * D + c] = (src[c] - mean) * inv * lns[c] + lnb[c];
  }
  __syncthreads();

  block_gemm(xb, Wq, bq, qb, part, Tb, D, c0, Dc, KS);
  block_gemm(xb, Wk, bk, kb, part, Tb, D, c0, Dc, KS);
  block_gemm(xb, Wv, bv, vb, part, Tb, D, c0, Dc, KS);

  // scores of the clip's Tb x Tb pairs for this block's heads, then the
  // exact softmax
  const float scale = 1.0f / sqrtf(static_cast<float>(Dh));   // IEEE: 0.125 at Dh = 64
  for (int i = tid; i < Hc * Tb * Tb; i += kThreads) {
    const int h = i / (Tb * Tb), qi = (i / Tb) % Tb, kj = i % Tb;
    const float* qr = qb + qi * Dc + h * Dh;
    const float* kr = kb + kj * Dc + h * Dh;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
    sc[i] = s * scale;
  }
  __syncthreads();
  for (int i = tid; i < Hc * Tb; i += kThreads) {
    float* row = sc + i * Tb;
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
  for (int i = tid; i < TC; i += kThreads) {
    const int qi = i / Dc, c = i % Dc, h = c / Dh;
    const float* p = sc + (h * Tb + qi) * Tb;
    float a = 0.f;
    for (int j = 0; j < Tb; ++j) a = fmaf(p[j], vb[j * Dc + c], a);
    tb[i] = a;
  }
  __syncthreads();
  share_slice(cluster, tb, ab, Tb, D, c0, Dc);

  block_gemm(ab, Wo, bo, qb, part, Tb, D, c0, Dc, KS);
  for (int i = tid; i < TC; i += kThreads) qb[i] += cp[(i / Dc) * D + c0 + i % Dc];   // summary
  __syncthreads();

  // stores of this block's columns: summary (Tb rows) and the Tb frame rows
  // of e, four columns at a time
  const int C4 = Dc / 4;
  for (int i = tid; i < Tb * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4;
    store4(summary + (row0 + r) * D + c0 + c, load4(qb + r * Dc + c));
  }
  for (int i = tid; i < Tb * le_pad * C4; i += kThreads) {
    const int c = (i % C4) * 4, l = (i / C4) % le_pad, f = i / (C4 * le_pad);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l < G) {
      v = load4(gp + l * D + c0 + c);
    } else if (l == G) {
      v = load4(qb + f * Dc + c);
    } else if (l < G + 1 + Tb) {
      const int t = l - G - 1;
      const float4 a = load4(lp + t * D + c0 + c), cc = load4(cp + t * D + c0 + c);
      v = make_float4(a.x + cc.x, a.y + cc.y, a.z + cc.z, a.w + cc.w);
    }
    store4(e + ((row0 + f) * le_pad + l) * D + c0 + c, v);
  }
}

template <typename WT, typename CT>
int launch(const void* cls, long long cls_stride, const void* const* w, const float* const* v,
           void* e, void* summary, int Bb, int Tb, int G, int D, int H, int le_pad, int CS,
           int KS, size_t bytes, cudaStream_t stream) {
  auto kernel = fused_extras_kernel<WT, CT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, Bb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const CT*>(cls), cls_stride, static_cast<const WT*>(w[0]), v[0],
      v[1], v[2], static_cast<const WT*>(w[1]), v[3], static_cast<const WT*>(w[2]), v[4],
      static_cast<const WT*>(w[3]), v[5], static_cast<const WT*>(w[4]), v[6], v[7], v[8],
      static_cast<CT*>(e), static_cast<CT*>(summary), Tb, G, D, H, le_pad, KS);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cls: Bb * Tb rows of D values, `cls_stride` elements apart, bf16
// (act_bf16 != 0) or fp32. Wc, Wq, Wk, Wv, Wo (D, D) contiguous, rows = input
// dim, all bf16 (w_bf16 != 0) or all fp32, 16-byte aligned. bc, lns, lnb, bq,
// bk, bv, bo (D), lp (Tb, D), gp (G, D) fp32 contiguous, 16-byte aligned.
// e (Bb * Tb, le_pad, D), summary (Bb * Tb, D) contiguous in cls's type.
// Returns the launch's error code (cudaErrorInvalidValue when the shapes
// do not fit: D % 4, D % H, le_pad < G + 1 + Tb, or the clip's rows exceed a
// block's shared memory).
extern "C" int fused_extras(const void* cls, long long cls_stride, const void* Wc,
                            const void* bc, const void* lns, const void* lnb, const void* Wq,
                            const void* bq, const void* Wk, const void* bk, const void* Wv,
                            const void* bv, const void* Wo, const void* bo, const void* lp,
                            const void* gp, void* e, void* summary, int Bb, int Tb, int G,
                            int D, int H, int le_pad, int w_bf16, int act_bf16, void* stream) {
  if (Bb <= 0 || Tb <= 0 || G < 0 || D <= 0 || H <= 0 || D % 4 || D % H ||
      le_pad < G + 1 + Tb)
    return static_cast<int>(cudaErrorInvalidValue);
  // blocks per clip: whole heads and whole groups of four columns each
  int CS = 1;
  for (int c = 8; c > 1; c /= 2)
    if (H % c == 0 && (D / c) % 4 == 0) {
      CS = c;
      break;
    }
  const int Dc = D / CS;
  int KS = kThreads / (Dc / 4);
  KS = KS < 1 ? 1 : (KS > kMaxKSplit ? kMaxKSplit : KS);
  const size_t bytes = (static_cast<size_t>(3) * Tb * D +
                        static_cast<size_t>(4 + KS) * Tb * Dc +
                        static_cast<size_t>(H / CS) * Tb * Tb) *
                       sizeof(float);
  int dev = 0, max_bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > static_cast<size_t>(max_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  const void* w[5] = {Wc, Wq, Wk, Wv, Wo};
  const float* v[9] = {static_cast<const float*>(bc),  static_cast<const float*>(lns),
                       static_cast<const float*>(lnb), static_cast<const float*>(bq),
                       static_cast<const float*>(bk),  static_cast<const float*>(bv),
                       static_cast<const float*>(bo),  static_cast<const float*>(lp),
                       static_cast<const float*>(gp)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_bf16 && act_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(cls, cls_stride, w, v, e, summary, Bb, Tb, G, D,
                                                H, le_pad, CS, KS, bytes, st);
  if (w_bf16)
    return launch<__nv_bfloat16, float>(cls, cls_stride, w, v, e, summary, Bb, Tb, G, D, H,
                                        le_pad, CS, KS, bytes, st);
  if (act_bf16)
    return launch<float, __nv_bfloat16>(cls, cls_stride, w, v, e, summary, Bb, Tb, G, D, H,
                                        le_pad, CS, KS, bytes, st);
  return launch<float, float>(cls, cls_stride, w, v, e, summary, Bb, Tb, G, D, H, le_pad, CS, KS,
                              bytes, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
