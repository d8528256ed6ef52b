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
//                                              semantics; keys >= Lk give 0;
//                                              results below 2^-126 flush
//                                              to 0 (ex2f)
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
// Design. One block of 8 warps per (query chunk of 128 rows, head, batch
// row), two blocks per SM; each warp owns one 16-row slab of the chunk and
// keeps its q fragments in registers, and a slab with no query row does no
// products (at Lq = 197 the head's 13 slabs compute, not 16). K/V stream
// through shared memory in tiles of 64 keys by cp.async in a ring of four
// stages: the copies of the next three tiles are in flight while this one
// is multiplied, behind one barrier per tile (keys past Lk arrive as zeros
// and are never read from memory). The K fragments come by ldmatrix, the V
// fragments by ldmatrix.trans, into mma.sync m16n8k16 (bf16 -> fp32). A
// tile whose 64 keys are all real runs with no branch and no mask inside
// its unrolled loops; only the last, ragged tile skips fragments past Lk
// and masks keys. Because the one-pass softmax has no running max, e @ v
// accumulates straight into fp32 registers with no rescaling; the score
// fragments are reused in registers as the A operand of the AV product,
// and the denominators come from the same A fragments against a column of
// ones (one more mma per 16 keys, as the TPU kernel's ones column of the
// dot), so they sum exactly the bf16-rounded e. The exp2 is
// ex2.approx.ftz (see ex2f).
// On the card the kernel is held back by the latency of its loads more
// than by its products or its bytes: one block of 16 warps per 256-row
// chunk (K and V read once per head instead of twice) ran slower than two
// blocks of 8 warps on an SM, whose prologues and epilogues overlap each
// other's tiles, so the chunk is 128 rows (utils/kernel_variants.py
// measures both). mma.sync, not wgmma: the products are not what sets the
// pace. The kernel launches on the caller's stream, does not synchronise
// and allocates nothing.

#include <type_traits>

#include "attention_common.cuh"
#include "attention_pipe.cuh"

namespace {

// the launch configuration: warps per block (one 16-row query slab each)
// and blocks per SM that the registers must allow
constexpr int kWarps = 8;
constexpr int kMinBlocks = 2;
constexpr int kTileK = 64;                       // keys per shared-memory tile
constexpr int kStages = 4;
constexpr int kLDS = attn::kLDS;                 // padded bf16 row: 144 bytes
constexpr int kTileElems = kTileK * kLDS;
constexpr int kSmemBytes = kStages * 2 * kTileElems * 2;   // 73,728
constexpr uint32_t kOnes = 0x3F803F80u;          // two bf16 1.0
constexpr int kNF = kTileK / 8;                  // 8-key score fragments per tile
constexpr int kND = attn::kHD / 8;               // 8-wide output fragments

using namespace apipe;

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
packed_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ den, int Lq, int Lk, int q_sb,
                        int q_sl, int k_sb, int k_sl, int v_sb, int v_sl,
                        int o_sb, int o_sl, float c) {
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem);   // [stage][K, V]

  const int b = blockIdx.z;
  const long long hoff = static_cast<long long>(blockIdx.y) * attn::kHD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma group row, thread in group

  const __nv_bfloat16* qb = q + static_cast<long long>(b) * q_sb + hoff;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * k_sb + hoff;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * v_sb + hoff;
  const int NT = (Lk + kTileK - 1) / kTileK;

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

  // this warp's slab: its q fragments in registers (rows >= Lq are zeros);
  // a slab with no query row only helps with the copies
  const int first = (blockIdx.x * kWarps + warp) * 16;
  const bool act = first < Lq;
  const int ra = first + g, rb = ra + 8;
  uint32_t qa[attn::kKD][4];
  attn::load_a_frags(qa, qb, ra, rb, act ? Lq : 0, q_sl, t);

  float acc[kND][4];
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};   // (row ra, row ra, row rb, row rb)
#pragma unroll
  for (int d = 0; d < kND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  // one key tile; FULL: all 64 keys are real, so no fragment is skipped and
  // no key is masked (the loops unroll with no branch inside)
  auto tile_step = [&](auto full_c, const __nv_bfloat16* ks, const __nv_bfloat16* vs, int k0) {
    constexpr bool FULL = decltype(full_c)::value;
    const int nf = FULL ? kNF : min(kNF, (Lk - k0 + 7) / 8);   // fragments with a real key
    float s[kNF][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int n = 0; n < kNF; ++n) {
        if (FULL || n < nf) {
          // keys n*8 .. n*8+7 x head columns half*32 .. +31: k16 steps
          // 2*half and 2*half + 1
          uint32_t bk[4];
          ldsm(bk, ks + (n * 8 + (lane & 7)) * kLDS + (lane >> 3) * 8 + half * 32);
          mma(s[n], qa[2 * half], bk[0], bk[1]);
          mma(s[n], qa[2 * half + 1], bk[2], bk[3]);
        }
      }
    }

    // the one elementwise pass; e rounded to bf16 feeds both the AV product
    // and the denominator. Score fragment n (keys n*8..n*8+7) becomes half
    // n%2 of the A fragment of key slice n/2.
    uint32_t pa[kTileK / 16][4];
#pragma unroll
    for (int n = 0; n < kNF; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // rows ra, rb
        float e[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + n * 8 + t * 2 + j;
          e[j] = FULL || key < Lk ? ex2f(fminf(s[n][2 * h + j] * c, 110.f)) : 0.f;
        }
        const uint32_t p = cvt_pack(e[0], e[1]);
        pa[n / 2][(n % 2) * 2 + h] = p;
      }
    }

    // acc += e @ v over the tile's key slices that hold a real key
#pragma unroll
    for (int kc = 0; kc < kTileK / 16; ++kc) {
      if (FULL || 2 * kc < nf) {
#pragma unroll
        for (int dp = 0; dp < kND / 2; ++dp) {
          // keys kc*16 .. +15 x head columns dp*16 .. +15, transposed
          uint32_t bv[4];
          ldsm_t(bv, vs + (kc * 16 + (lane & 15)) * kLDS + (2 * dp + (lane >> 4)) * 8);
          mma(acc[2 * dp], pa[kc], bv[0], bv[1]);
          mma(acc[2 * dp + 1], pa[kc], bv[2], bv[3]);
        }
        // the denominators: the same weights against a column of ones
        mma(dsum, pa[kc], kOnes, kOnes);
      }
    }
  };

  for (int kt = 0; kt < NT; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();   // tile kt has landed for every thread; tile kt - 1 is free
    issue(kt + kStages - 1);
    if (act) {
      const __nv_bfloat16* ks = kv + (kt % kStages) * 2 * kTileElems;
      const int k0 = kt * kTileK;
      if (k0 + kTileK <= Lk)
        tile_step(std::true_type{}, ks, ks + kTileElems, k0);
      else
        tile_step(std::false_type{}, ks, ks + kTileElems, k0);
    }
  }
  if (!act) return;

  // every thread of a group holds its rows' full sums
  float rsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rsum[h] = dsum[2 * h];
  if (den != nullptr && t == 0) {
    // the unclamped sums, (B, Lq, H) contiguous
    float* db = den + static_cast<long long>(b) * Lq * gridDim.y + blockIdx.y;
    if (ra < Lq) db[static_cast<long long>(ra) * gridDim.y] = rsum[0];
    if (rb < Lq) db[static_cast<long long>(rb) * gridDim.y] = rsum[1];
  }
  const float d0 = fmaxf(rsum[0], 1e-30f), d1 = fmaxf(rsum[1], 1e-30f);
  __nv_bfloat16* ob = o + static_cast<long long>(b) * o_sb + hoff;
#pragma unroll
  for (int d = 0; d < kND; ++d) {
    const int col = d * 8 + t * 2;
    if (ra < Lq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(ra) * o_sl + col) =
          attn::pack2(__float2bfloat16(acc[d][0] / d0), __float2bfloat16(acc[d][1] / d0));
    if (rb < Lq)
      *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(rb) * o_sl + col) =
          attn::pack2(__float2bfloat16(acc[d][2] / d1), __float2bfloat16(acc[d][3] / d1));
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* den, int B,
                   int Lq, int Lk, int H, int q_sb, int q_sl, int k_sb, int k_sl, int v_sb,
                   int v_sl, int o_sb, int o_sl, float c, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kWarps * 16 - 1) / (kWarps * 16), H, B);
  packed_attention_kernel<<<grid, kWarps * 32, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), den,
      Lq, Lk, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl, c);
  return cudaGetLastError();
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
  // ViT-B/16 (and every CLIP tower the repo configures) has Dh = 64
  if (Dh != attn::kHD) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(q, k, v, o, nullptr, B, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl,
                                 v_sb, v_sl, o_sb, o_sl, c, static_cast<cudaStream_t>(stream)));
}

// The same forward, which also writes den (B, Lq, H) fp32 contiguous.
extern "C" int packed_attention_den_bf16(const void* q, const void* k,
                                         const void* v, void* o, void* den,
                                         int B, int Lq, int Lk, int H, int Dh,
                                         int q_sb, int q_sl, int k_sb, int k_sl,
                                         int v_sb, int v_sl, int o_sb, int o_sl,
                                         float c, void* stream) {
  if (Dh != attn::kHD || den == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(q, k, v, o, static_cast<float*>(den), B, Lq, Lk, H, q_sb,
                                 q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl, c,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
