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
//   the packed kernel's clamp form once scores are large. The fp32 p feeds
//   the row sum, its bf16 rounding the AV product.
//
// What bounds it on an H100 SXM (data-sheet figures, not measured): at the
// text tower's shape (15 x 77 x 512, causal) about 5 MB of traffic and
// 0.1 GFLOP, so launch-bound; at (4, 1024, 1024, 8 heads) causal 8.6 GFLOP
// of visible pairs, ~9 us at 989 TFLOP/s, against 17 MB, ~5 us: the tensor
// cores, once the loads stay off their path.
//
// Design (the form of the packed forward, packed_attention.cu). One block
// of kWarps warps per (head, batch row, chunk of query rows), two blocks
// per SM; each warp owns kSlabs 16-row slabs and keeps their q fragments
// in registers. K and V stream through shared memory in tiles of 64 keys
// by cp.async in a ring of three stages behind one barrier per tile; K
// fragments come by ldmatrix, V fragments by ldmatrix.trans, into mma.sync
// m16n8k16, each fragment feeding all of the warp's slabs. Each row carries
// a running max and sum (fp32) and rescales its fp32 accumulator when the
// max moves. A tile whose 64 keys are all visible to every row of the warp
// runs with no branch and no mask in its unrolled loops; only the ragged
// last tile and the tiles that cross the warp's diagonal mask keys. Under
// the causal mask a block loads only the tiles up to its last row and a
// warp skips those past its own; the chunks run heaviest first (the chunk
// index is the grid's slowest axis, reversed), so that the long causal
// chunks do not form the tail. The exp2 is ex2.approx.ftz. The block is 4
// warps of one slab (64-row chunks): utils/kernel_variants.py times it
// against 8 warps of one slab and 4 of two, and on the card it was the
// fastest at the text tower's shape (240 blocks; the others 120) and at
// (4, 1024, 1024, 8) causal, where the latency of each warp's chain of
// tiles, not the products, sets the pace. Launches on the caller's stream,
// no sync, no allocation.

#include <type_traits>

#include "attention_common.cuh"
#include "attention_pipe.cuh"

namespace {

using namespace apipe;

constexpr int kTileK = 64;                       // keys per shared-memory tile
constexpr int kStages = 3;
constexpr int kLDS = attn::kLDS;                 // padded bf16 row: 144 bytes
constexpr int kTileElems = kTileK * kLDS;
constexpr int kSmemBytes = kStages * 2 * kTileElems * 2;   // 55,296
constexpr int kNF = kTileK / 8;                  // 8-key score fragments per tile
constexpr int kND = attn::kHD / 8;               // 8-wide output fragments
constexpr float kNegBig = attn::kNegBig;
// 4 warps of one 16-row slab: 64 query rows a block (see the note above)
constexpr int kWarps = 4;
constexpr int kSlabs = 1;
constexpr int kRows = kWarps * 16 * kSlabs;

__global__ void __launch_bounds__(kWarps * 32, 2)
streaming_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ o,
                               float* __restrict__ lse, int Lq, int Lk, int H,
                               int q_sb, int q_sl, int k_sb, int k_sl, int v_sb,
                               int v_sl, float c, int causal) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kWarpRows = 16 * kSlabs;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem);   // [stage][K, V]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // heaviest chunk first
  const long long hoff = static_cast<long long>(h) * attn::kHD;
  const long long D = static_cast<long long>(H) * attn::kHD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qb = q + static_cast<long long>(b) * q_sb + hoff;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * k_sb + hoff;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * v_sb + hoff;
  // keys the block needs: under the causal mask none past its last row
  const int kend = causal ? min(Lk, min(Lq, q0 + kRows)) : Lk;
  const int NT = (kend + kTileK - 1) / kTileK;

  // the K and V rows of key tile `tile` into its stage (one commit group
  // per call, empty past the last tile, so that the groups count steps)
  auto issue = [&](int tile) {
    if (tile < NT) {
      __nv_bfloat16* st = kv + (tile % kStages) * 2 * kTileElems;
      const int k0 = tile * kTileK;
#pragma unroll
      for (int i = 0; i < 2 * kTileK * 8 / kThreads; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int which = idx / (kTileK * 8), r = (idx / 8) % kTileK, cv = (idx % 8) * 8;
        const bool ok = k0 + r < Lk;
        const __nv_bfloat16* src =
            which ? vb + static_cast<long long>(ok ? k0 + r : 0) * v_sl + cv
                  : kb + static_cast<long long>(ok ? k0 + r : 0) * k_sl + cv;
        cp_async16(st + which * kTileElems + r * kLDS + cv, src, ok);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // this warp's kSlabs 16-row slabs (rows first + 16 * sl + g, + 8); a
  // warp with no query row only helps with the copies
  const int first = q0 + warp * kWarpRows;
  const bool act = first < Lq;
  // keys this warp sees: [0, wend)
  const int wend = causal ? min(Lk, min(Lq, first + kWarpRows)) : Lk;
  uint32_t qa[kSlabs][attn::kKD][4];
#pragma unroll
  for (int sl = 0; sl < kSlabs; ++sl)
    attn::load_a_frags(qa[sl], qb, first + 16 * sl + g, first + 16 * sl + g + 8,
                       act ? Lq : 0, q_sl, t);

  float acc[kSlabs][kND][4];
  // running max (log2 units, scale folded in) and this thread's share of
  // the running sum, rows (sl, g) and (sl, g + 8)
  float m[kSlabs][2], l[kSlabs][2];
#pragma unroll
  for (int sl = 0; sl < kSlabs; ++sl) {
#pragma unroll
    for (int d = 0; d < kND; ++d) acc[sl][d][0] = acc[sl][d][1] = acc[sl][d][2] = acc[sl][d][3] = 0.f;
    m[sl][0] = m[sl][1] = kNegBig;
    l[sl][0] = l[sl][1] = 0.f;
  }

  // one key tile; FULL: all 64 keys are visible to every row of the warp.
  // Each K and V fragment feeds the products of all the warp's slabs.
  auto tile_step = [&](auto full_c, const __nv_bfloat16* ks, const __nv_bfloat16* vs, int k0) {
    constexpr bool FULL = decltype(full_c)::value;
    const int nf = FULL ? kNF : min(kNF, (wend - k0 + 7) / 8);   // fragments with a visible key
    float s[kSlabs][kNF][4];
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
      for (int n = 0; n < kNF; ++n) s[sl][n][0] = s[sl][n][1] = s[sl][n][2] = s[sl][n][3] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
        if (FULL || n < nf) {
          uint32_t bk[4];
          ldsm(bk, ks + (n * 8 + (lane & 7)) * kLDS + (lane >> 3) * 8 + half * 32);
#pragma unroll
          for (int sl = 0; sl < kSlabs; ++sl) {
            mma(s[sl][n], qa[sl][2 * half], bk[0], bk[1]);
            mma(s[sl][n], qa[sl][2 * half + 1], bk[2], bk[3]);
          }
        }
      }
    }

    uint32_t pa[kSlabs][kTileK / 16][4];
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) {
      // mask, and the tile's row maxima of the unscaled scores (the scale
      // is positive, so the max of the scaled scores is the scaled max,
      // rounding included). Every row sees key 0 in the first tile, so a
      // row's max is finite from then on; a tile with no visible key for a
      // row leaves its max and sum as they are.
      float tmax[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!FULL) {
            const int key = k0 + n * 8 + t * 2 + (i & 1);
            const int row = first + 16 * sl + g + 8 * (i >> 1);
            const bool valid = n < nf && key < Lk && (!causal || key <= row);
            s[sl][n][i] = valid ? s[sl][n][i] : kNegBig;
          }
          tmax[i >> 1] = fmaxf(tmax[i >> 1], s[sl][n][i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        tmax[j] = fmaxf(tmax[j], __shfl_xor_sync(0xffffffffu, tmax[j], 1));
        tmax[j] = fmaxf(tmax[j], __shfl_xor_sync(0xffffffffu, tmax[j], 2));
        const float mnew = fmaxf(m[sl][j], tmax[j] * c);
        const float alpha = ex2f(m[sl][j] - mnew);
        m[sl][j] = mnew;
        l[sl][j] *= alpha;
#pragma unroll
        for (int d = 0; d < kND; ++d) {
          acc[sl][d][2 * j] *= alpha;
          acc[sl][d][2 * j + 1] *= alpha;
        }
      }

      // p = exp2(s * scale - max), one rounding (an FMA): the fp32 value
      // feeds the sum, its bf16 rounding the AV product. Score fragment n
      // (keys n*8..n*8+7) becomes half n%2 of the A fragment of key slice
      // n/2.
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {   // rows g, g + 8
          const float p0 = ex2f(fmaf(s[sl][n][2 * j], c, -m[sl][j]));
          const float p1 = ex2f(fmaf(s[sl][n][2 * j + 1], c, -m[sl][j]));
          l[sl][j] += p0;
          l[sl][j] += p1;
          pa[sl][n / 2][(n % 2) * 2 + j] = cvt_pack(p0, p1);
        }
      }
    }

#pragma unroll
    for (int kc = 0; kc < kTileK / 16; ++kc) {
      if (FULL || 2 * kc < nf) {
#pragma unroll
        for (int dp = 0; dp < kND / 2; ++dp) {
          uint32_t bv[4];
          ldsm_t(bv, vs + (kc * 16 + (lane & 15)) * kLDS + (2 * dp + (lane >> 4)) * 8);
#pragma unroll
          for (int sl = 0; sl < kSlabs; ++sl) {
            mma(acc[sl][2 * dp], pa[sl][kc], bv[0], bv[1]);
            mma(acc[sl][2 * dp + 1], pa[sl][kc], bv[2], bv[3]);
          }
        }
      }
    }
  };

  for (int kt = 0; kt < NT; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();   // tile kt has landed for every thread; tile kt - 1 is free
    issue(kt + kStages - 1);
    const int k0 = kt * kTileK;
    if (act && k0 < wend) {
      const __nv_bfloat16* ks = kv + (kt % kStages) * 2 * kTileElems;
      if (k0 + kTileK <= Lk && (!causal || k0 + kTileK - 1 <= first))
        tile_step(std::true_type{}, ks, ks + kTileElems, k0);
      else
        tile_step(std::false_type{}, ks, ks + kTileElems, k0);
    }
  }
  if (!act) return;

  __nv_bfloat16* ob = o + static_cast<long long>(b) * Lq * D + hoff;
  float* lb = lse + (static_cast<long long>(b) * H + h) * Lq;
#pragma unroll
  for (int sl = 0; sl < kSlabs; ++sl) {
    // full row sums: the 4 threads of a group hold disjoint columns
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[sl][j] += __shfl_xor_sync(0xffffffffu, l[sl][j], 1);
      l[sl][j] += __shfl_xor_sync(0xffffffffu, l[sl][j], 2);
    }
    const int ra = first + 16 * sl + g, rb = ra + 8;
#pragma unroll
    for (int d = 0; d < kND; ++d) {
      const int col = d * 8 + t * 2;
      if (ra < Lq)
        *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(ra) * D + col) =
            attn::pack2(__float2bfloat16(acc[sl][d][0] / l[sl][0]),
                        __float2bfloat16(acc[sl][d][1] / l[sl][0]));
      if (rb < Lq)
        *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(rb) * D + col) =
            attn::pack2(__float2bfloat16(acc[sl][d][2] / l[sl][1]),
                        __float2bfloat16(acc[sl][d][3] / l[sl][1]));
    }
    if (t == 0) {
      if (ra < Lq) lb[ra] = (m[sl][0] + log2f(l[sl][0])) * attn::kLn2;
      if (rb < Lq) lb[rb] = (m[sl][1] + log2f(l[sl][1])) * attn::kLn2;
    }
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
  static const cudaError_t attr =   // once per process: the host cost matters
      cudaFuncSetAttribute(streaming_attention_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, B, (Lq + kRows - 1) / kRows);
  streaming_attention_fwd_kernel<<<grid, kWarps * 32, kSmemBytes,
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
