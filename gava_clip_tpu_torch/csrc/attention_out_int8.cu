// Fused attention + w8a8 out-projection + residual for Hopper (sm_90a).
//
// Replaces the TPU kernel gava_clip_tpu/ops/flash_attention.py:
// _attention_out_kernel with its epilogue _int8_outproj_epilogue (reached
// through flash_attention_out_int8's pl.pallas_call); on the serving path it
// is the middle of every block:
//
//   q (B, Lq_arr, H*64), k/v (B, Lk, H*64) bf16, packed as the qkv kernel
//   writes them; the queries are the first lq rows of q, the keys all Lk.
//   Per head (the one-pass clamp softmax of csrc/packed_attention.cu):
//     e   = bf16(exp2(min((q_h k_h^T) * c, 110)))    c = 64^-0.5 * log2(e)
//     a_h = (e @ v_h) / max(sum(e), 1e-30)           fp32, NOT rounded
//   then, over the whole H*64-wide fp32 row a:
//     xs = max(max |a|, 1e-6) * fp32(1/127), codes = rint(a * (1 / xs))
//     out = bf16(((((float)(codes @ W) * xs) * s) + b) + r)   (B, lq, H*64)
//
// What bounds it on an H100 SXM (data-sheet figures, not measured), at the
// serving shape B = 128 frame rows, lq = 197, Lk = 214, H = 12: the
// attention does 16.6 GFLOP bf16 (17 us at 989 TFLOP/s) and the
// out-projection 29.7 G int8 operations (15 us at 1,979 TOP/s); it reads
// q, k, v, r (~142 MB) and writes 39 MB, 54 us at 3.35 TB/s: bandwidth
// first. The score tile never leaves the registers; the fp32 attention
// output makes one round trip through a scratch that L2 mostly holds.
//
// The hard part: the per-row quant needs all H heads' fp32 outputs of a row
// before any code exists, and keeping them in shared memory (3 KB a row)
// caps a block at 32 rows, too few for wgmma and for the weight's reuse.
// Design: a block of 7 warps takes 112 query rows of one frame row (a
// 197-token frame row takes two blocks), one 16-row slab per warp, and two
// blocks share an SM, so that one block's barriers, head changes and
// out-projection overlap the other's tiles. It walks (head, 64-key tile) in
// B1's form: K and V of one head stream through a 4-stage cp.async ring
// behind one barrier per tile, K fragments by ldmatrix and V fragments by
// ldmatrix.trans into mma.sync m16n8k16 (bf16 -> fp32), the denominators
// from the same bf16 e against a column of ones; a tile of 64 real keys has
// no branch. Each thread keeps its rows' running absmax and writes its fp32
// outputs to a scratch (B, rows, H*64) in device memory, which it alone
// reads back once the row's scale is known (no barrier: a thread reads its
// own writes; the scratch of a block stays mostly in L2); the codes go into
// a 112 x H*64 int8 code tile, 128-byte swizzled, in the shared memory the
// K/V ring used. Then the out-projection runs as in the w8a8 GEMM kernels:
// one producer thread streams 64-row W^T slabs by TMA (its first stages
// land during the attention), and one consumer warpgroup runs wgmma
// m64n112k32 s8 on the code tile (w8a8_wgmma.cuh ring_product), with bias
// and residual in an epilogue that reads and stores two bf16 of one row per
// thread. K and V of a frame row are read from L2 twice instead of once per
// 32 query rows, the weight once per 112 rows instead of once per 32.
//
// The int8 QK^T form (a template flag; TPU: the int8_qk branch of
// _onepass_softmax_av_masked inside the same pallas_call) quantizes each
// head's 64-wide slice of a query row and of a key row per row,
//     qs = max(max |q_h|, 1e-6),  qq = rint(q_h * (127 / qs))   (same for k)
// runs the score product as s8 mma.sync m16n8k32 and folds the scales into
// the exp2 argument in this order of multiplication:
//     e = bf16(exp2(min(((float)(qq . kq) * (qs * c2)) * ks, 110)))
// with c2 = c / 127^2 handed over by the caller. The query codes are made in
// registers from the bf16 A fragments; once a K tile has landed, a thread
// per key row turns it into codes in place (in the k order in which the
// query codes sit: a permutation of k applied to both operands, exact in
// int32), so each key row is quantized once per block (of 112 query rows),
// not once per 32-row query tile.
//
// The two-source form (a second template flag; replaces the TPU kernel
// _attention_out_kernel_2src, reached through
// flash_attention_out_int8_2src's pl.pallas_call) takes the keys and values
// as the union [k1; k2] of two arrays, (B, L1, H*64) and (B, L2, H*64), that
// are never concatenated in device memory: the staging copies take key row j
// from the first source while j < L1 and row j - L1 of the second after, so
// shared memory fills in the order [k1; k2] and every sum runs in the order
// of the single-source kernel on the concatenation. Both score forms.
//
// The exp2 is ex2.approx.ftz (see attention_pipe.cuh ex2f). Head dim 64
// only; H*64 <= 1024.

#include <type_traits>

#include "attention_pipe.cuh"
#include "w8a8_wgmma.cuh"

namespace {

using namespace w8a8;

constexpr int kHD = 64;                          // head dim
constexpr int kWarpsAttn = 7;                    // one 16-row query slab each
constexpr int kRows = kWarpsAttn * 16;           // query rows of a block: 112
constexpr int kThreadsAttn = kWarpsAttn * 32;
constexpr int kTileK = 64;                       // keys per staged K/V tile
constexpr int kLDS = kHD + 8;                    // padded bf16 row of a staged tile: 144 bytes
constexpr int kTileElems = kTileK * kLDS;
constexpr int kKVStages = 4;
constexpr int kKVStageBytes = 2 * kTileElems * 2;   // K then V: 18,432
constexpr int kRingBytes = kKVStages * kKVStageBytes;
constexpr int kWStages = 3;                      // W^T ring stages
constexpr int kSlabBytes = 64 * kKC;             // 64 W^T rows x 128 k
constexpr int kWRingBytes = kWStages * kSlabBytes;
constexpr int kStaticBytes = 128;                // the static shared barriers (48), rounded up
constexpr uint32_t kOnes = 0x3F803F80u;          // two bf16 1.0
constexpr int kNF = kTileK / 8;                  // 8-key score fragments per tile
constexpr int kND = kHD / 8;                     // 8-wide output fragments

// dynamic shared bytes of one block: alignment slack, the K/V ring (then,
// in the same space, the code tile), the W^T ring, the row scales, the key
// scales of the int8 QK^T form
__host__ __device__ constexpr int smem_bytes(int Dp) {
  return 1024 + (kRows * Dp > kRingBytes ? kRows * Dp : kRingBytes) + kWRingBytes + 4 * kRows +
         4 * kKVStages * kTileK;
}

// two bf16 in one register -> their two int8 codes in the low 16 bits
__device__ __forceinline__ uint32_t quant_pair(uint32_t pair, float inv) {
  const float lo = __uint_as_float(pair << 16), hi = __uint_as_float(pair & 0xffff0000u);
  return (static_cast<uint32_t>(__float2int_rn(__fmul_rn(lo, inv))) & 0xffu) |
         ((static_cast<uint32_t>(__float2int_rn(__fmul_rn(hi, inv))) & 0xffu) << 8);
}

__device__ __forceinline__ float absmax_pair(uint32_t pair, float m) {
  return fmaxf(m, fmaxf(fabsf(__uint_as_float(pair << 16)),
                        fabsf(__uint_as_float(pair & 0xffff0000u))));
}

// the second key / value source of the two-source form: rows L1.. of the
// keys are rows 0.. of k2, v2 (element strides, batch and row)
struct Source2 {
  const __nv_bfloat16 *k2, *v2;
  int L1, k2_sb, k2_sl, v2_sb, v2_sl;
};

struct Params {
  const __nv_bfloat16 *q, *k, *v, *r;
  const float *s, *bias;
  __nv_bfloat16* o;
  float* a32;   // (B, chunks * R, H*64) fp32 scratch of the attention outputs
  int lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float c;
  Source2 s2;
};

// The consumer warpgroup: N output rows of the block (code-tile rows from
// xc, row scales from xs, query rows from m0) = codes @ W, then
// bias and residual; W^T's 64-row slabs arrive through the warpgroup's ring.
// acc[4c + 2h + e] is out^T[col0 + 8h][row 8c + 2t + e]; a lane pair swaps
// one value so that each thread holds row 8c + 2t + odd, columns col0 + 8h
// - odd and the next one, read and written as bf16 pairs.
template <int N, int R>
__device__ __forceinline__ void out_projection(const Params& p, const int8_t* xc,
                                               const float* xs, const unsigned char* ring,
                                               uint64_t* full, uint64_t* empty, int b, int m0,
                                               int D, int KC) {
  const int lane = threadIdx.x % 32, wi = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3, odd = g & 1;
  const long long ob = static_cast<long long>(b) * p.lq;
  int acc[N / 2];
  int st = 0;
  uint32_t ph = 0;
  for (int sl = 0; sl < D / 64; ++sl) {
    ring_product<N>(acc, ring, kSlabBytes, full, empty, kWStages, st, ph, xc, R * kKC, KC, lane);
    const int col0 = sl * 64 + wi * 16 + g;
    float sa[2], ba[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sa[h] = p.s[col0 + 8 * h];
      ba[h] = p.bias[col0 + 8 * h];
    }
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const int m = m0 + 8 * c + 2 * t + odd;
      const float x0 = xs[8 * c + 2 * t], x1 = xs[8 * c + 2 * t + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = epilogue(acc[4 * c + 2 * h], x0, sa[h], ba[h]);
        const float v1 = epilogue(acc[4 * c + 2 * h + 1], x1, sa[h], ba[h]);
        const float other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const float lo = odd ? other : v0, hi = odd ? v1 : other;
        if (m < p.lq) {
          const long long at = (ob + m) * D + col0 + 8 * h - odd;
          const uint32_t rr = *reinterpret_cast<const uint32_t*>(p.r + at);
          *reinterpret_cast<uint32_t*>(p.o + at) =
              apipe::cvt_pack(__fadd_rn(lo, __uint_as_float(rr << 16)),
                              __fadd_rn(hi, __uint_as_float(rr & 0xffff0000u)));
        }
      }
    }
  }
}

template <bool kInt8QK, bool k2Src>
__global__ void __launch_bounds__(kThreadsAttn, 2)
attention_out_int8_kernel(const __grid_constant__ CUtensorMap wmap, const Params p) {
  constexpr int R = kRows;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kWStages], empty[kWStages];
  const int D = p.H * kHD, Dp = round_up(D, kKC);
  unsigned char* smem = align1024(smem_raw);
  int8_t* xc = reinterpret_cast<int8_t*>(smem);             // [Dp / 128][R][128] codes
  unsigned char* ring = smem;                                // K/V ring (then the codes)
  unsigned char* wring = smem + (R * Dp > kRingBytes ? R * Dp : kRingBytes);   // [stage]
  float* xs = reinterpret_cast<float*>(wring + kWRingBytes);  // row scales
  float* ksc = xs + R;                                        // [stage][64] key scales

  const int b = blockIdx.y, q0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);   // one arrival per warp of the consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const __nv_bfloat16* qb = p.q + static_cast<long long>(b) * p.q_sb;
  const __nv_bfloat16* kb = p.k + static_cast<long long>(b) * p.k_sb;
  const __nv_bfloat16* vb = p.v + static_cast<long long>(b) * p.v_sb;
  const __nv_bfloat16* k2b = k2Src ? p.s2.k2 + static_cast<long long>(b) * p.s2.k2_sb : nullptr;
  const __nv_bfloat16* v2b = k2Src ? p.s2.v2 + static_cast<long long>(b) * p.s2.v2_sb : nullptr;
  const int NT = (p.Lk + kTileK - 1) / kTileK;
  const int tiles = p.H * NT;   // (head, key tile)

  // the K and V rows of tile i into its stage (one commit group per call,
  // empty past the last tile, so that the groups count tiles)
  auto issue = [&](int i) {
    if (i < tiles) {
      unsigned char* st = ring + (i % kKVStages) * kKVStageBytes;
      const long long hoff = static_cast<long long>((i / NT) % p.H) * kHD;
      const int k0 = (i % NT) * kTileK;
      for (int idx = threadIdx.x; idx < 2 * kTileK * 8; idx += kThreadsAttn) {
        const int which = idx / (kTileK * 8), rr = (idx / 8) % kTileK, cv = (idx % 8) * 8;
        const bool ok = k0 + rr < p.Lk;
        const int j = ok ? k0 + rr : 0;
        const __nv_bfloat16* src;
        if (k2Src && j >= p.s2.L1)
          src = (which ? v2b + static_cast<long long>(j - p.s2.L1) * p.s2.v2_sl
                       : k2b + static_cast<long long>(j - p.s2.L1) * p.s2.k2_sl);
        else
          src = which ? vb + static_cast<long long>(j) * p.v_sl
                      : kb + static_cast<long long>(j) * p.k_sl;
        apipe::cp_async16(st + (which * kTileElems + rr * kLDS + cv) * 2, src + hoff + cv, ok);
      }
    }
    apipe::cp_commit();
  };
#pragma unroll
  for (int i = 0; i < kKVStages - 1; ++i) issue(i);
  __syncthreads();   // the barriers are initialised

  // warp 4, lane 0: the producer of the W^T ring (64-row slab sl, k-chunk
  // kc of item sl * KC + kc); the first stages are loaded now and land
  // during the attention
  const int KC = Dp / kKC, NSL = D / 64;
  const bool producer = warp == 4 && lane == 0;
  int pi = 0, pst = 0;
  uint32_t pph = 0;
  auto produce = [&](int upto) {
    for (; pi < upto; ++pi) {
      hopper::mbar_wait(&empty[pst], pph ^ 1u);
      hopper::mbar_expect_tx(&full[pst], kSlabBytes);
      hopper::tma_load(wring + pst * kSlabBytes, &wmap, (pi % KC) * kKC, (pi / KC) * 64,
                       &full[pst]);
      if (++pst == kWStages) {
        pst = 0;
        pph ^= 1u;
      }
    }
  };
  if (producer) produce(min(NSL * KC, kWStages));

  // this warp's slab; a slab with no query row only helps with the copies
  const int first = q0 + warp * 16;
  const bool act = first < p.lq;
  const int ra = first + g, rb = ra + 8;          // query rows
  const int lra = warp * 16 + g, lrb = lra + 8;   // rows of the code tile
  float rmax[2] = {0.f, 0.f};                     // rows ra, rb: running absmax
  // this thread's fp32 outputs of rows lra, lrb in the block's scratch rows,
  // at column 2t of each 8-column group (it reads back only what it wrote)
  float* a0 = p.a32 + (static_cast<long long>(b * gridDim.x + blockIdx.x) * R + lra) * D + 2 * t;
  float* a1 = a0 + 8ll * D;

  {
    int it = 0;   // tile index
    for (int head = 0; head < p.H; ++head) {
      const long long hoff = static_cast<long long>(head) * kHD;
      uint32_t qa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int col = kk * 16 + t * 2;
        const __nv_bfloat16* p0 = qb + static_cast<long long>(ra) * p.q_sl + hoff + col;
        const __nv_bfloat16* p1 = qb + static_cast<long long>(rb) * p.q_sl + hoff + col;
        const bool ok0 = act && ra < p.lq, ok1 = act && rb < p.lq;
        qa[kk][0] = ok0 ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
        qa[kk][1] = ok1 ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
        qa[kk][2] = ok0 ? *reinterpret_cast<const uint32_t*>(p0 + 8) : 0u;
        qa[kk][3] = ok1 ? *reinterpret_cast<const uint32_t*>(p1 + 8) : 0u;
      }
      // int8 QK^T: the rows' codes as A fragments of two m16n8k32 steps; a
      // thread's 16 values of a row fill its k slots 4t..4t+3 and 16+4t..
      // of each step in the order kk = 2 * step, 2 * step + 1
      uint32_t qi[2][4];
      float rq[2];   // qs * c2 of rows g and g + 8
      if constexpr (kInt8QK) {
        float mx0 = 0.f, mx1 = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mx0 = absmax_pair(qa[kk][2], absmax_pair(qa[kk][0], mx0));
          mx1 = absmax_pair(qa[kk][3], absmax_pair(qa[kk][1], mx1));
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        const float qs0 = fmaxf(mx0, 1e-6f), qs1 = fmaxf(mx1, 1e-6f);
        const float i0 = __fdiv_rn(127.0f, qs0), i1 = __fdiv_rn(127.0f, qs1);
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int kk = 2 * st + hf;
            qi[st][2 * hf] = quant_pair(qa[kk][0], i0) | (quant_pair(qa[kk][2], i0) << 16);
            qi[st][2 * hf + 1] = quant_pair(qa[kk][1], i1) | (quant_pair(qa[kk][3], i1) << 16);
          }
        rq[0] = __fmul_rn(qs0, p.c);
        rq[1] = __fmul_rn(qs1, p.c);
      }
      float acc[kND][4];
#pragma unroll
      for (int d = 0; d < kND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
      float dsum[4] = {0.f, 0.f, 0.f, 0.f};   // (row ra, row ra, row rb, row rb)

      // one key tile; FULL: all 64 keys are real, so no fragment is skipped
      // and no key is masked (the loops unroll with no branch inside)
      auto tile_step = [&](auto full_c, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                           const float* kscale, int k0) {
        constexpr bool FULL = decltype(full_c)::value;
        const int nf = FULL ? kNF : min(kNF, (p.Lk - k0 + 7) / 8);   // fragments with a key
        float s[kNF][4];
        if constexpr (kInt8QK) {
          const int8_t* kq = reinterpret_cast<const int8_t*>(ks);
#pragma unroll
          for (int n = 0; n < kNF; ++n) {
            if (FULL || n < nf) {
              int si[4] = {0, 0, 0, 0};
              const uint4 kw =
                  *reinterpret_cast<const uint4*>(kq + (n * 8 + g) * (kLDS * 2) + 16 * t);
              mma_s8(si, qi[0], kw.x, kw.y);
              mma_s8(si, qi[1], kw.z, kw.w);
              const float2 ksv = *reinterpret_cast<const float2*>(kscale + n * 8 + t * 2);
              // ((float)s32 * (qs * c2)) * ks, in this order
              s[n][0] = __fmul_rn(__fmul_rn(__int2float_rn(si[0]), rq[0]), ksv.x);
              s[n][1] = __fmul_rn(__fmul_rn(__int2float_rn(si[1]), rq[0]), ksv.y);
              s[n][2] = __fmul_rn(__fmul_rn(__int2float_rn(si[2]), rq[1]), ksv.x);
              s[n][3] = __fmul_rn(__fmul_rn(__int2float_rn(si[3]), rq[1]), ksv.y);
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < kNF; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int n = 0; n < kNF; ++n) {
              if (FULL || n < nf) {
                // keys n*8 .. n*8+7 x head columns half*32 .. +31
                uint32_t bk[4];
                apipe::ldsm(bk, ks + (n * 8 + (lane & 7)) * kLDS + (lane >> 3) * 8 + half * 32);
                apipe::mma(s[n], qa[2 * half], bk[0], bk[1]);
                apipe::mma(s[n], qa[2 * half + 1], bk[2], bk[3]);
              }
            }
          }
        }
        // e rounded to bf16 feeds both the AV product and the denominator;
        // score fragment n becomes half n%2 of the A fragment of slice n/2
        uint32_t pa[kTileK / 16][4];
#pragma unroll
        for (int n = 0; n < kNF; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float e[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int key = k0 + n * 8 + t * 2 + j;
              const float arg = kInt8QK ? s[n][2 * h + j] : s[n][2 * h + j] * p.c;
              e[j] = FULL || key < p.Lk ? apipe::ex2f(fminf(arg, 110.f)) : 0.f;
            }
            pa[n / 2][(n % 2) * 2 + h] = apipe::cvt_pack(e[0], e[1]);
          }
        }
#pragma unroll
        for (int kc = 0; kc < kTileK / 16; ++kc) {
          if (FULL || 2 * kc < nf) {
#pragma unroll
            for (int dp = 0; dp < kND / 2; ++dp) {
              // keys kc*16 .. +15 x head columns dp*16 .. +15, transposed
              uint32_t bv[4];
              apipe::ldsm_t(bv, vs + (kc * 16 + (lane & 15)) * kLDS + (2 * dp + (lane >> 4)) * 8);
              apipe::mma(acc[2 * dp], pa[kc], bv[0], bv[1]);
              apipe::mma(acc[2 * dp + 1], pa[kc], bv[2], bv[3]);
            }
            // the denominators: the same weights against a column of ones
            apipe::mma(dsum, pa[kc], kOnes, kOnes);
          }
        }
      };

      for (int kt = 0; kt < NT; ++kt, ++it) {
        apipe::cp_wait<kKVStages - 2>();
        __syncthreads();   // tile it has landed for every thread; tile it - 1 is free
        issue(it + kKVStages - 1);
        unsigned char* st = ring + (it % kKVStages) * kKVStageBytes;
        __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(st);
        float* kscale = ksc + (it % kKVStages) * kTileK;
        if constexpr (kInt8QK) {
          // four neighbouring threads per key row, thread j on dims 16j ..
          // 16j + 15: the row's scale (their absmax) and codes, in place
          // over the row's first 64 bytes
          // (whole warps in each round)
          for (int idx = threadIdx.x; idx < 4 * kTileK; idx += kThreadsAttn) {
            const int row = idx / 4, j = idx % 4;
            const uint4* src = reinterpret_cast<const uint4*>(ks + row * kLDS) + 2 * j;
            const uint4 r0 = src[0], r1 = src[1];
            float mx = absmax_pair(r0.w, absmax_pair(r0.z, absmax_pair(r0.y,
                                                                absmax_pair(r0.x, 0.f))));
            mx = absmax_pair(r1.w, absmax_pair(r1.z, absmax_pair(r1.y, absmax_pair(r1.x, mx))));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float kscl = fmaxf(mx, 1e-6f);
            const float ki = __fdiv_rn(127.0f, kscl);
            // codes in natural order, four to a word: word w holds dims
            // 16j + 4w .. +3
            const uint32_t nat[4] = {
                quant_pair(r0.x, ki) | (quant_pair(r0.y, ki) << 16),
                quant_pair(r0.z, ki) | (quant_pair(r0.w, ki) << 16),
                quant_pair(r1.x, ki) | (quant_pair(r1.y, ki) << 16),
                quant_pair(r1.z, ki) | (quant_pair(r1.w, ki) << 16)};
            __syncwarp();   // the row's values are read before codes land on them
            // thread tt of an mma quad reads bytes 16tt..16tt+15 of the row:
            // word j of them holds dims 16j + 2tt, +1 and 16j + 8 + 2tt, +1
            int8_t* kqd = reinterpret_cast<int8_t*>(ks) + row * (kLDS * 2) + 4 * j;
#pragma unroll
            for (int tt = 0; tt < 4; ++tt)
              *reinterpret_cast<uint32_t*>(kqd + 16 * tt) =
                  __byte_perm(nat[tt / 2], nat[2 + tt / 2], (tt & 1) ? 0x7632u : 0x5410u);
            if (j == 0) kscale[row] = kscl;
          }
          __syncthreads();
        }
        if (act) {
          const int k0 = kt * kTileK;
          if (k0 + kTileK <= p.Lk)
            tile_step(std::true_type{}, ks, ks + kTileElems, kscale, k0);
          else
            tile_step(std::false_type{}, ks, ks + kTileElems, kscale, k0);
        }
      }
      if (act) {
        // the head's fp32 outputs: the rows' absmax, and the values to the
        // scratch until the whole row's scale is known
        const float d0 = fmaxf(dsum[0], 1e-30f), d1 = fmaxf(dsum[2], 1e-30f);
#pragma unroll
        for (int d = 0; d < kND; ++d) {
          const float2 v0 = make_float2(acc[d][0] / d0, acc[d][1] / d0);
          const float2 v1 = make_float2(acc[d][2] / d1, acc[d][3] / d1);
          rmax[0] = fmaxf(rmax[0], fmaxf(fabsf(v0.x), fabsf(v0.y)));
          rmax[1] = fmaxf(rmax[1], fmaxf(fabsf(v1.x), fabsf(v1.y)));
          *reinterpret_cast<float2*>(a0 + head * kHD + d * 8) = v0;
          *reinterpret_cast<float2*>(a1 + head * kHD + d * 8) = v1;
        }
      }
    }
  }
  // every warp is done with the K/V ring, whose space takes the codes
  apipe::cp_wait<0>();
  __syncthreads();
  if (act) {
    // every thread of a quad holds other columns of the same rows
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = rmax[h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float scale = quant_scale(m);
      inv[h] = __fdiv_rn(1.0f, scale);
      if (t == 0) xs[h ? lrb : lra] = scale;
    }
    // this thread's values back (its own writes) -> codes, two to a piece
    for (int head = 0; head < p.H; ++head) {
#pragma unroll
      for (int d = 0; d < kND; ++d) {
        const int col = head * kHD + d * 8 + t * 2;
        const float2 v0 = *reinterpret_cast<const float2*>(a0 + col - 2 * t);
        const float2 v1 = *reinterpret_cast<const float2*>(a1 + col - 2 * t);
        *reinterpret_cast<uint16_t*>(xc + code_at<R>(lra, col)) = static_cast<uint16_t>(
            static_cast<uint8_t>(quant_code(v0.x, inv[0])) |
            (static_cast<uint8_t>(quant_code(v0.y, inv[0])) << 8));
        *reinterpret_cast<uint16_t*>(xc + code_at<R>(lrb, col)) = static_cast<uint16_t>(
            static_cast<uint8_t>(quant_code(v1.x, inv[1])) |
            (static_cast<uint8_t>(quant_code(v1.y, inv[1])) << 8));
      }
    }
  }
  // the codes (generic writes) before the async proxy reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // ---- int8 out-projection + bias + residual ----------------------------
  // warps 0-3: one consumer warpgroup, all R rows against all of W^T's
  // 64-row slabs; warp 4 feeds its ring
  if (warp >= 4) {
    if (producer) produce(NSL * KC);
    return;
  }
  out_projection<R, R>(p, xc, xs, wring, full, empty, b, q0, D, KC);
}

template <bool kInt8QK, bool k2Src>
int launch(const void* q, const void* k, const void* v, const void* Wt, const void* s,
           const void* bias, const void* r, void* o, void* a32, int B, int lq, int Lk, int H,
           int q_sb, int q_sl, int k_sb, int k_sl, int v_sb, int v_sl, float c, int rows,
           int smem, void* stream, Source2 s2) {
  const int D = H * kHD;
  if (H <= 0 || D > kMaxRowPerLane * 32 || B <= 0 || lq <= 0 || Lk <= 0 || rows != kRows ||
      smem < smem_bytes(round_up(D, kKC)) || !aligned16(Wt) || a32 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap wmap;
  if (!encode_codes(encode, &wmap, Wt, D, D, 64)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(r),
                 static_cast<const float*>(s), static_cast<const float*>(bias),
                 static_cast<__nv_bfloat16*>(o), static_cast<float*>(a32), lq, Lk, H, q_sb, q_sl,
                 k_sb, k_sl, v_sb, v_sl, c, s2};
  auto kernel = attention_out_int8_kernel<kInt8QK, k2Src>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kRows - 1) / kRows, B);
  kernel<<<grid, kThreadsAttn, smem, static_cast<cudaStream_t>(stream)>>>(wmap, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v strides in elements, last dim contiguous, rows 16-byte aligned
// (checked by the Python wrapper); W^T (D, D) int8 (the out-projection
// kernel transposed, k contiguous), 16-byte aligned; s, bias (D) fp32;
// r, o (B, lq, D) bf16 contiguous, D = H * 64; a32 the fp32 scratch of the
// attention outputs, (B, ceil(lq / rows) * rows, D); c = 64^-0.5 * log2(e);
// rows (112) and smem are the launch plan
// (ops/flash_attention.attention_out_plan). Returns cudaGetLastError() after
// the launch.
extern "C" int attention_out_int8_bf16(const void* q, const void* k, const void* v,
                                       const void* Wt, const void* s, const void* bias,
                                       const void* r, void* o, void* a32, int B, int lq,
                                       int Lk, int H, int q_sb, int q_sl, int k_sb, int k_sl,
                                       int v_sb, int v_sl, float c, int rows, int smem,
                                       void* stream) {
  return launch<false, false>(q, k, v, Wt, s, bias, r, o, a32, B, lq, Lk, H, q_sb, q_sl, k_sb,
                              k_sl, v_sb, v_sl, c, rows, smem, stream, Source2{});
}

// The int8 QK^T form: the same arguments, except that the constant is
// c2 = fp32(c / 127^2).
extern "C" int attention_out_int8_qk8_bf16(const void* q, const void* k, const void* v,
                                           const void* Wt, const void* s, const void* bias,
                                           const void* r, void* o, void* a32, int B, int lq,
                                           int Lk, int H, int q_sb, int q_sl, int k_sb,
                                           int k_sl, int v_sb, int v_sl, float c2, int rows,
                                           int smem, void* stream) {
  return launch<true, false>(q, k, v, Wt, s, bias, r, o, a32, B, lq, Lk, H, q_sb, q_sl, k_sb,
                             k_sl, v_sb, v_sl, c2, rows, smem, stream, Source2{});
}

// The two-source form: keys and values are [k1; k2] and [v1; v2], k1, v1
// (B, L1, D) and k2, v2 (B, L2, D) with their own strides; every row of q
// (B, Lq, D) is a query. int8_qk picks the score form (c is then c / 127^2).
extern "C" int attention_out_int8_2src_bf16(
    const void* q, const void* k1, const void* v1, const void* k2, const void* v2,
    const void* Wt, const void* s, const void* bias, const void* r, void* o, void* a32, int B,
    int Lq,
    int L1, int L2, int H, int q_sb, int q_sl, int k1_sb, int k1_sl, int v1_sb, int v1_sl,
    int k2_sb, int k2_sl, int v2_sb, int v2_sl, float c, int int8_qk, int rows, int smem,
    void* stream) {
  if (L1 < 0 || L2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Source2 s2{static_cast<const __nv_bfloat16*>(k2), static_cast<const __nv_bfloat16*>(v2),
                   L1, k2_sb, k2_sl, v2_sb, v2_sl};
  const int Lk = L1 + L2;
  if (int8_qk)
    return launch<true, true>(q, k1, v1, Wt, s, bias, r, o, a32, B, Lq, Lk, H, q_sb, q_sl,
                              k1_sb, k1_sl, v1_sb, v1_sl, c, rows, smem, stream, s2);
  return launch<false, true>(q, k1, v1, Wt, s, bias, r, o, a32, B, Lq, Lk, H, q_sb, q_sl,
                             k1_sb, k1_sl, v1_sb, v1_sl, c, rows, smem, stream, s2);
}

// The constants of the launch plan, for the Python side to check its own
// against: {bytes of a K/V ring stage, K/V stages, threads per block, static
// shared bytes, bytes of the two W^T rings, the current device's opt-in
// shared bytes per block}.
extern "C" void attention_out_int8_layout(int* out) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  out[0] = kKVStageBytes;
  out[1] = kKVStages;
  out[2] = kThreadsAttn;
  out[3] = kStaticBytes;
  out[4] = kWRingBytes;
  out[5] = optin;
}
