// Fused w8a8 transformer MLP, with and without the residual add, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of gava_clip_tpu/ops/int8_matmul.py: `kernel`
// inside w8a8_mlp_res (its pl.pallas_call), which closes every block of the
// serving path, and _w8a8_mlp_kernel (w8a8_mlp's pl.pallas_call), the same
// without the residual and with the LayerNorm optional, which an MLP block
// called without a residual reaches. One kernel template serves both: a
// flag drops the residual read, another the LayerNorm (the input rows are
// then quantized as they are); the residual form is the instantiation with
// both on.
//
//   x, r (M, K) bf16 (r is the residual, x itself in the tower); W1 (K, H),
//   W2 (H, N) int8, passed transposed (W1^T (H, K), W2^T (N, H), k
//   contiguous); s1, b1 (H), s2, b2 (N), gamma, beta (K) fp32:
//     n  = LayerNorm(x) in fp32;  c, xs = quant(n)
//     h  = QuickGELU(((float)(c @ W1) * xs) * s1 + b1)      fp32, never bf16
//     hc, hs = quant(h)   -- over the WHOLE H-wide hidden row
//     y  = bf16((((float)(hc @ W2) * hs) * s2 + b2) + r)
//
// The fp32 form (w8a8_mlp_res_f32, w8a8_mlp_f32: the TPU kernels emit
// their input's dtype) reads fp32 x and r (4 values a 16-byte load in
// phase 0) and stores y in fp32: the residual is added to the fp32 value
// as it is and nothing is rounded after the epilogue's own roundings. It
// serves int8-forward training in fp32 and the w8a8 evaluation of an fp32
// run.
//
// What bounds it on an H100 SXM (data-sheet figures, not measured), at the
// serving shape M = 25216 (128 frame rows x 197 tokens), K = N = 768,
// H = 3072: 237.9 G int8 operations, 120 us at 1,979 TOP/s; it reads x and
// r and writes y, ~116 MB, 35 us at 3.35 TB/s. Compute-bound at the roof,
// and only wgmma reaches that rate on this card.
//
// The hard part: the requant needs the absmax of the whole fp32 hidden row
// before any code of it exists, and a bf16-rounded h would be a different
// function. Keeping the fp32 hidden of a row tile in shared memory caps the
// tile at 16 rows (196 KB at H = 3072), and then every weight is read from
// L2 once per 16 rows (7.4 GB per call at the serving shape) by products
// too narrow for wgmma: the earlier form of this kernel spent 1.63 ms so.
//
// Design. fc1 runs TWICE, and the fp32 hidden never needs a home: the first
// pass finds each row's absmax, the second recomputes the same h bit for bit
// (the int32 products are exact and the epilogue is the same fp32 sequence)
// and quantizes it with the now known scale. That frees the row tile from
// the hidden's size, so a block takes BM = 192 rows (64 for short or long
// rows: the launch plan, ops/int8_matmul.w8a8_mlp_plan), and each weight
// tile serves 192 rows: 1.5x the products of one pass, but the weights
// cross L2 12x less often (0.94 GB per call) and every product is a wgmma.
// The block computes transposed tiles, h^T = W1^T c^T and y^T = W2^T hc^T:
// A is a 64-row slab of W^T (one per consumer warpgroup), B the block's rows
// (the wgmma N = BM), both k-major in 128-byte swizzled shared memory as
// wgmma wants them for s8:
//   * phase 0: each consumer warp normalises and quantizes its rows into a
//     swizzled code tile (BM x K) that stays in shared memory;
//   * fc1, two passes: two producer threads stream the 64 x 128-byte W1^T
//     slabs of the two consumer warpgroups by TMA, each through its own
//     3-stage mbarrier ring; each warpgroup runs wgmma m64nBMk32 (s8 x s8
//     -> s32) over K, then the epilogue on its 64 hidden columns x BM rows.
//     The first pass keeps only each row's largest pre-activation
//     v = (acc * xs) * s1 + b1 (an FMNMX a value, no QuickGELU); the second
//     evaluates QuickGELU, keeps a slab's codes in registers and then
//     writes them through a shared staging tile, 16 bytes a thread, to an
//     int8 scratch (Mp, Hp) in device memory (78 MB at the serving shape);
//   * fc2: the producer streams 256 x 128-byte W2^T tiles and the block's
//     own hidden codes back by TMA (the code tile's space now holds a ring
//     of up to 4 stages); each warpgroup runs two 64-row slabs of the tile,
//     so the codes are read back once per 256 output columns; epilogue
//     scale, bias, residual, bf16 (or fp32) store.
// One wgmma group stays in flight while the previous stage is released. A
// ring barrier that never completes traps after ~2^36 cycles instead of
// holding the card.
//
// Why the first pass's maximum gives the absmax exactly. qgelu (below) is
// non-decreasing over the non-negative floats, and |qgelu(v)| <= kQStar =
// 0.1637 over the negative ones (in real numbers the least of v * sigma(1.702
// v) is -0.163610, at v = -0.7512). w8a8_mlp_qgelu_check tries every float on
// the card (chip_smoke.py runs it): no non-negative float u has qgelu(next
// float) < qgelu(u), and the largest |qgelu| over the negative floats is
// 0.16361022. So wherever a = qgelu(max(0, vmax)) >= kQStar, a is the row's
// absmax of |QuickGELU| bit for bit; the second pass's codes and the outputs
// are then the full pass's. A block with a row of M below (every
// pre-activation negative or small) runs the full first pass (|QuickGELU|'s
// max) after the short one: one decision a block, taken once, with no branch
// inside the value loops; the producer streams the W1^T slabs a third time
// for it. Rows past M take no part.
//
// Where the time goes (utils/kernel_variants.py b5_parent b5_split, on an
// NVIDIA H100 80GB HBM3 at 700.00 W; CUDA graphs, bf16 / fp32): at the
// serving shape the form before (QuickGELU in both passes) took 0.572 /
// 0.563 ms: phase 0 0.053 / 0.061, the first fc1 pass 0.139 (0.063 of it
// its QuickGELU epilogue), the second 0.199, fc2 0.17-0.18 (its products
// alone 0.063 at the int8 rate; it streams 56 KB a stage from L2, W2^T and
// the block's codes, three times a block). This form: 0.483 / 0.481 ms
// (0.840x / 0.845x in turns): the first pass's epilogue gone (0.89x), the
// second pass's codes kept in registers to the slab's end (a store among
// them had the compiler run its chains two values at a time: ~20 dependent
// steps a pair) and made by an FADD. The second pass's epilogue, ~22
// instructions a value with two MUFU ops on two consumer warps a
// scheduler, is still on its warpgroup's critical path: issuing slab
// ch + 1's products during slab ch's epilogue needs two 96-register
// accumulator sets (5.8 KB of spills at 192 rows, and ptxas then serializes
// the wgmma: 1.8x slower); the warpgroups' products taking turns, two rows
// a warp in phase 0, prefetching x or the residual into L2 and fc2's
// residual loads issued before its stores were no faster. A branch around
// a value's chain (the IEEE division's slow path, a bounds check, a warp
// vote that skips values that cannot move the max) keeps the compiler from
// interleaving the chains, so the epilogues have none: QuickGELU takes its
// reciprocal without the division's slow-path branch (qgelu), and columns
// past H run the same code on zero products and scales.
//
// TMA wants the weights 16-byte aligned with rows of a multiple of 16
// bytes (the Python wrapper zero-pads other weights). K is bounded by the
// code tile in shared memory (the plan raises beyond it); a row longer
// than 1,024 values is normalised and quantized in passes over the row
// (quant_row_long).
//
// The kernel template and its launch live in this header; two sources
// instantiate it, w8a8_mlp.cu with bf16 rows and w8a8_mlp_f32.cu with fp32
// rows, so that the two libraries compile side by side (each takes as long
// as the other).

#pragma once

#include <type_traits>

#include "w8a8_wgmma.cuh"

namespace {

using namespace hopper;
using namespace w8a8;

constexpr int kWRows = 128;                     // W^T rows per stage: 2 warpgroups x 64
constexpr int kWTileBytes = kWRows * kKC;       // 16,384
// fc2: W2^T rows per stage, 2 x 64 per consumer warpgroup, so that the
// block's hidden codes are read back once per 256 output columns
constexpr int kW2Slabs = 2;
constexpr int kW2Rows = kWRows * kW2Slabs;
constexpr int kW2TileBytes = kW2Rows * kKC;     // 32,768
constexpr int kStages1 = 3;                     // fc1 ring of each consumer warpgroup
constexpr int kW1Half = kWTileBytes / 2;        // one warpgroup's 64-row slab of a tile
constexpr int kMaxStages2 = 4;                  // fc2 ring
constexpr int kStageLD = kKC + 16;              // bytes per row of the code staging tile
constexpr int kStaticBytes = 256;               // the static shared barriers (168), rounded up
constexpr int kThreadsMlp = 384;                // producer warpgroup + 2 consumer warpgroups

// dynamic shared bytes of one block (1,024 of alignment slack, the code
// tile or the fc2 ring, the staging tile, four floats per row)
__host__ __device__ constexpr int region_bytes(int BM, int Kp, int stages2) {
  return BM * Kp + kStages1 * kWTileBytes > stages2 * (kW2TileBytes + BM * kKC)
             ? BM * Kp + kStages1 * kWTileBytes
             : stages2 * (kW2TileBytes + BM * kKC);
}

__host__ __device__ constexpr int smem_bytes(int BM, int Kp, int stages2) {
  return 1024 + region_bytes(BM, Kp, stages2) + BM * kStageLD + 16 * BM;
}

__device__ __forceinline__ void consumers_sync() { named_sync(1, 256); }

// a named barrier of one consumer warpgroup alone
__device__ __forceinline__ void warpgroup_sync(int wg) { named_sync(2 + wg, 128); }

// QuickGELU h * (1 / (1 + exp(-1.702 h))) with the plain version's fp32
// roundings. The reciprocal of d = 1 + exp(..) >= 1 is rcp.approx and one
// Newton step in FMAs, with no branch: that is the correctly rounded 1/d,
// the IEEE division's value, for every d in [1, 2^126) (w8a8_mlp_rcp_check
// tries them all on the card; chip_smoke.py runs it). The division's own
// sequence branches to a slow path for each value, which kept the
// compiler from overlapping the values' instruction chains. For d >= 2^126
// (h < -51) it gives 0 where the division gives a subnormal; h times either
// quantizes to code 0 under any row scale, and d = inf is clamped so that
// the Newton step sees no inf * 0.
__device__ __forceinline__ float rcp_newton(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(fmaf(-d, r, 1.0f), r, r);
}

__device__ __forceinline__ float qgelu(float h) {
  return __fmul_rn(h, rcp_newton(fminf(__fadd_rn(1.0f, expf(-__fmul_rn(1.702f, h))), 3.0e38f)));
}

// quant_code's byte without the conversion unit: rint(x * inv), ties to
// even, is the low byte of the bits of x * inv + 1.5 * 2^23, for |x * inv|
// < 2^22 (at most ~127 in a row of M, whose codes are of its own absmax); a
// NaN gives 0, as the conversion does. Bit-equal to quant_code there; an
// FADD and an FMNMX take the place of an F2I, which shares its unit with
// QuickGELU's two MUFU ops.
__device__ __forceinline__ int8_t quant_code_fadd(float x, float inv) {
  return static_cast<int8_t>(
      __float_as_uint(__fadd_rn(fmaxf(__fmul_rn(x, inv), -4194304.0f), 12582912.0f)));
}

// A float at or above |qgelu(v)| for every negative float v: in real numbers
// the least of v * sigma(1.702 v) is -0.163610 (v = -0.7512).
// w8a8_mlp_qgelu_check holds the kernel's own qgelu to it on the card, and
// checks that qgelu is non-decreasing over the non-negative floats.
constexpr float kQStar = 0.1637f;

template <class T>   // __nv_bfloat16 or float: x, r and y
struct Params {
  const T* x;
  const float* s1;
  const float* b1;
  const float* s2;
  const float* b2;
  const float* gamma;
  const float* beta;
  int8_t* hq;          // (Mp, Hp) hidden codes, rows of this block at m0
  int M, K, H, N, Kp, Hp, stages2;
};

template <int BM, bool kRes, bool kLN, class T>
__global__ void __launch_bounds__(kThreadsMlp, 1)
w8a8_mlp_kernel(const __grid_constant__ CUtensorMap w1map,
                const __grid_constant__ CUtensorMap w2map,
                const __grid_constant__ CUtensorMap hqmap, const Params<T> p,
                const T* __restrict__ r, T* __restrict__ y) {
  constexpr int kAcc = BM / 2;   // s32 accumulators per consumer thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full1[2][kStages1], empty1[2][kStages1];
  __shared__ __align__(8) uint64_t full2[kMaxStages2], empty2[kMaxStages2];
  __shared__ __align__(8) uint64_t hq_ready, decided;
  __shared__ int full_first_pass;   // 1: some row of the block takes the full first pass
  // the swizzled tiles need 1,024-byte alignment
  unsigned char* smem = align1024(smem_raw);
  const int KC = p.Kp / kKC, HC = p.Hp / kKC, NC = (p.N + kW2Rows - 1) / kW2Rows;
  const int region = region_bytes(BM, p.Kp, p.stages2);
  const int S2 = kW2TileBytes + BM * kKC;   // fc2 stage: a W2^T tile, the block's codes
  int8_t* xc = reinterpret_cast<int8_t*>(smem);        // [KC][BM][128] swizzled codes
  unsigned char* ring1 = smem + BM * p.Kp;             // fc1: [wg][stage][64][128]
  unsigned char* ring2 = smem;                         // fc2: over both, after fc1
  int8_t* stg = reinterpret_cast<int8_t*>(smem + region);   // BM x kStageLD
  float* xs = reinterpret_cast<float*>(smem + region + BM * kStageLD);
  float* hs = xs + BM;
  float* hinv = hs + BM;
  unsigned* amax = reinterpret_cast<unsigned*>(hinv + BM);
  const int m0 = blockIdx.x * BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages1; ++s) {
      for (int w = 0; w < 2; ++w) {
        mbar_init(&full1[w][s], 1);
        mbar_init(&empty1[w][s], 4);   // one arrival per warp of the warpgroup
      }
    }
    for (int s = 0; s < kMaxStages2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 8);
    }
    mbar_init(&hq_ready, 256);    // every consumer thread, its codes written
    mbar_init(&decided, 1);       // full_first_pass is final
    full_first_pass = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: thread 0 feeds consumer warpgroup 0's fc1 ring
    // and then the fc2 ring, thread 32 warpgroup 1's fc1 ring; the W1^T
    // slabs twice, or three times where the block takes the full first pass
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const int w = threadIdx.x / 32;
      int st = 0;
      uint32_t ph = 0;
      for (int pass = 0; pass < 3; ++pass) {
        if (pass == 2) {
          mbar_wait(&decided, 0);
          if (!*static_cast<volatile int*>(&full_first_pass)) break;
        }
        for (int ch = 0; ch < HC; ++ch)
          for (int kc = 0; kc < KC; ++kc) {
            mbar_wait(&empty1[w][st], ph ^ 1u);
            mbar_expect_tx(&full1[w][st], kW1Half);
            tma_load(ring1 + (w * kStages1 + st) * kW1Half, &w1map, kc * kKC,
                     ch * kWRows + w * 64, &full1[w][st]);
            if (++st == kStages1) {
              st = 0;
              ph ^= 1u;
            }
          }
      }
      if (w == 1) return;
      // the hidden codes of every row are in device memory, and fc1 no
      // longer reads the code tile or its ring
      mbar_wait(&hq_ready, 0);
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      st = 0;
      ph = 0;
      for (int nc = 0; nc < NC; ++nc)
        for (int hc = 0; hc < HC; ++hc) {
          mbar_wait(&empty2[st], ph ^ 1u);
          mbar_expect_tx(&full2[st], S2);
          unsigned char* s = ring2 + st * S2;
          tma_load(s, &w2map, hc * kKC, nc * kW2Rows, &full2[st]);
          tma_load(s + kW2TileBytes, &hqmap, hc * kKC, m0, &full2[st]);
          if (++st == p.stages2) {
            st = 0;
            ph ^= 1u;
          }
        }
    }
    return;
  }

  // consumer warpgroups: 64 rows of W^T each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128;            // 0 .. 255
  const int wg = ct / 128, cw = ct / 32, wi = cw % 4;
  const int lane = ct % 32, g = lane >> 2, t = lane & 3;

  // phase 0: LayerNorm + quant of the block's rows into the swizzled code
  // tile (byte k of row rr: k-chunk k / 128, its 16-byte piece XOR rr % 8)
  quant_tile<BM>(
      xc, xs,
      [&](int rr) {
        return m0 + rr < p.M ? p.x + static_cast<long long>(m0 + rr) * p.K : nullptr;
      },
      p.K, p.Kp, kLN ? p.gamma : nullptr, p.beta, cw, 8, lane);
  for (int rr = ct; rr < BM; rr += 256) amax[rr] = 0u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();

  int acc[kAcc];
  int st = 0;
  uint32_t ph = 0;
  // acc = this warpgroup's 64 hidden columns of slab ch x the BM rows, over
  // K, from its own ring
  auto fc1 = [&]() {
    ring_product<BM>(acc, ring1 + wg * kStages1 * kW1Half, kW1Half, full1[wg], empty1[wg],
                     kStages1, st, ph, xc, BM * kKC, KC, lane);
  };

  // acc[4c + 2h + e] is h^T[col0 + 8h][row 8c + 2t + e]
  const int lcol = wg * 64 + wi * 16 + g;   // column of the 128-wide slab, h = 0
  // a first pass of fc1 over the H columns: each row's largest
  // pre-activation v (FULL false) or largest |QuickGELU(v)| (FULL true),
  // at least 0, into `into` (float bits, zeroed beforehand)
  auto first_pass = [&](auto full_c, unsigned* into) {
    constexpr bool FULL = decltype(full_c)::value;
    float mx[BM / 4];
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) mx[i] = 0.f;
    for (int ch = 0; ch < HC; ++ch) {
      float sa[2], ba[2];   // 0 past H, where the products are 0 too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ch * kWRows + lcol + 8 * h;
        sa[h] = col < p.H ? p.s1[col] : 0.f;
        ba[h] = col < p.H ? p.b1[col] : 0.f;
      }
      fc1();
#pragma unroll
      for (int c = 0; c < BM / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xr = xs[8 * c + 2 * t + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // no branch: columns past H give 0
            float v = epilogue(acc[4 * c + 2 * h + e], xr, sa[h], ba[h]);
            if constexpr (FULL) v = fabsf(qgelu(v));
            mx[2 * c + e] = fmaxf(mx[2 * c + e], v);
          }
        }
    }
    // the 8 groups of a warp hold other columns of the same rows
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) {
      float v = mx[i];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (g == 0) atomicMax(&into[8 * (i >> 1) + 2 * t + (i & 1)], __float_as_uint(v));
    }
  };

  // fc1, first pass: each row's largest pre-activation vmax. QuickGELU is
  // non-decreasing over the non-negative floats and below kQStar in
  // magnitude over the negative ones, so where qgelu(vmax) >= kQStar that
  // is the row's absmax, bit for bit. A block with a row of M below it
  // (every pre-activation negative or small) runs the full first pass.
  first_pass(std::false_type{}, amax);
  consumers_sync();
  for (int rr = ct; rr < BM; rr += 256) {
    const float a = qgelu(__uint_as_float(amax[rr]));
    hs[rr] = a;
    amax[rr] = 0u;
    if (m0 + rr < p.M && !(a >= kQStar)) full_first_pass = 1;
  }
  consumers_sync();
  if (ct == 0) mbar_arrive(&decided);
  if (*static_cast<volatile int*>(&full_first_pass)) {
    first_pass(std::true_type{}, amax);
    consumers_sync();
    for (int rr = ct; rr < BM; rr += 256) hs[rr] = __uint_as_float(amax[rr]);
  }
  for (int rr = ct; rr < BM; rr += 256) {
    const float scale = quant_scale(hs[rr]);
    hs[rr] = scale;
    hinv[rr] = __fdiv_rn(1.0f, scale);
  }
  consumers_sync();

  // fc1, second pass: the same h, quantized, through the staging tile to
  // the block's rows of the hidden codes
  for (int ch = 0; ch < HC; ++ch) {
    float sa[2], ba[2];   // 0 past H, where the products are 0 too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = ch * kWRows + lcol + 8 * h;
      sa[h] = col < p.H ? p.s1[col] : 0.f;
      ba[h] = col < p.H ? p.b1[col] : 0.f;
    }
    fc1();
    // the slab's codes stay in registers, four to a word, until its last
    // value: a store to the staging tile among them would order the next
    // rows' scale loads (shared memory too) after it, and the compiler
    // would run the chains a pair at a time
    uint32_t code[BM / 8];
#pragma unroll
    for (int c = 0; c < BM / 8; ++c) {
      code[c] = 0u;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * c + 2 * t + e;
        const float xr = xs[row], inv = hinv[row];
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // no branch: columns past H give 0
          const float v = qgelu(epilogue(acc[4 * c + 2 * h + e], xr, sa[h], ba[h]));
          code[c] |= static_cast<uint32_t>(static_cast<uint8_t>(quant_code_fadd(v, inv)))
                     << (8 * (2 * h + e));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < BM / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stg[(8 * c + 2 * t + e) * kStageLD + lcol + 8 * h] =
              static_cast<int8_t>(code[c] >> (8 * (2 * h + e)));
    // this warpgroup's 64 columns of the slab, 16 bytes a thread
    warpgroup_sync(wg);
    for (int i = ct % 128; i < BM * 4; i += 128) {
      const int row = i / 4, at = wg * 64 + (i % 4) * 16;
      *reinterpret_cast<uint4*>(p.hq + static_cast<long long>(m0 + row) * p.Hp + ch * kKC +
                                at) = *reinterpret_cast<const uint4*>(stg + row * kStageLD + at);
    }
    warpgroup_sync(wg);
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __threadfence();
  mbar_arrive(&hq_ready);

  // fc2: y^T slab nc = W2^T slab x hc^T over H, then scale, bias, residual;
  // this warpgroup's kW2Slabs 64-row slabs of the stage's W2^T tile
  int acc2[kW2Slabs][kAcc];
  st = 0;
  ph = 0;
  for (int nc = 0; nc < NC; ++nc) {
#pragma unroll
    for (int sl = 0; sl < kW2Slabs; ++sl)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc2[sl][i] = 0;
    int prev = -1;
    for (int hc = 0; hc < HC; ++hc) {
      mbar_wait(&full2[st], ph);
      const unsigned char* s = ring2 + st * S2;
      const uint64_t da = tile_desc(s + wg * kW2Slabs * kW1Half);
      const uint64_t db = tile_desc(s + kW2TileBytes);
#pragma unroll
      for (int sl = 0; sl < kW2Slabs; ++sl) fence_regs(acc2[sl]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int sl = 0; sl < kW2Slabs; ++sl)
          wgmma_ss<BM>(acc2[sl], da + sl * (kW1Half >> 4) + 2 * j, db + 2 * j, 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty2[prev]);
      }
      prev = st;
      if (++st == p.stages2) {
        st = 0;
        ph ^= 1u;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int sl = 0; sl < kW2Slabs; ++sl) fence_regs(acc2[sl]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty2[prev]);

    // acc2[sl][4c + 2h + e] is y^T[col of slab sl + 8h][row 8c + 2t + e];
    // q = 2 sl + h
    constexpr int kQ = 2 * kW2Slabs;
    float sa[kQ], ba[kQ];
    int col[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      col[q] = nc * kW2Rows + (wg * kW2Slabs + (q >> 1)) * 64 + wi * 16 + g + 8 * (q & 1);
      sa[q] = col[q] < p.N ? p.s2[col[q]] : 0.f;
      ba[q] = col[q] < p.N ? p.b2[col[q]] : 0.f;
    }
    // FULL: every row and column of the tile is inside y, so the loop has
    // no branch and the residual loads need not wait for one another
    auto store = [&](auto full_c) {
      constexpr bool FULL = decltype(full_c)::value;
#pragma unroll
      for (int c = 0; c < BM / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * c + 2 * t + e, m = m0 + row;
          if (!FULL && m >= p.M) continue;
          const float hr = hs[row];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            if (!FULL && col[q] >= p.N) continue;
            const long long at = static_cast<long long>(m) * p.N + col[q];
            const float v = epilogue(acc2[q >> 1][4 * c + 2 * (q & 1) + e], hr, sa[q], ba[q]);
            store_as(y + at, kRes ? __fadd_rn(v, to_f32(r[at])) : v);
          }
        }
    };
    if (m0 + BM <= p.M && (nc + 1) * kW2Rows <= p.N)
      store(std::true_type{});
    else
      store(std::false_type{});
  }
}

template <int BM, bool kRes, bool kLN, class T>
int launch_rows(const CUtensorMap& w1map, const CUtensorMap& w2map, const CUtensorMap& hqmap,
                const Params<T>& p, const void* r, void* y, int smem, cudaStream_t stream) {
  auto kernel = w8a8_mlp_kernel<BM, kRes, kLN, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(p.M + BM - 1) / BM, kThreadsMlp, smem, stream>>>(
      w1map, w2map, hqmap, p, static_cast<const T*>(r), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <bool kRes, bool kLN, class T>
int launch(const void* x, const void* W1t, const void* s1, const void* b1, const void* W2t,
           const void* s2, const void* b2, const void* gamma, const void* beta, const void* r,
           void* y, void* hq, int M, int K, int H, int N, int rows, int stages2, int smem,
           void* stream) {
  const int Kp = round_up(K, kKC), Hp = round_up(H, kKC);
  if (M <= 0 || K <= 0 || H <= 0 || N <= 0 || (rows != 64 && rows != 192) || stages2 < 2 ||
      stages2 > kMaxStages2 ||
      smem < smem_bytes(rows, Kp, stages2) || !aligned16(W1t) || !aligned16(W2t) ||
      !aligned16(hq))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const int Mp = (M + rows - 1) / rows * rows;
  CUtensorMap w1map, w2map, hqmap;
  if (!encode_codes(encode, &w1map, W1t, H, round_up(K, 16), 64) ||
      !encode_codes(encode, &w2map, W2t, N, round_up(H, 16), kW2Rows) ||
      !encode_codes(encode, &hqmap, hq, Mp, Hp, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params<T> p{static_cast<const T*>(x), static_cast<const float*>(s1),
                 static_cast<const float*>(b1), static_cast<const float*>(s2),
                 static_cast<const float*>(b2), static_cast<const float*>(gamma),
                 static_cast<const float*>(beta), static_cast<int8_t*>(hq), M, K, H, N, Kp, Hp,
                 stages2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == 64 ? launch_rows<64, kRes, kLN, T>(w1map, w2map, hqmap, p, r, y, smem, st)
                    : launch_rows<192, kRes, kLN, T>(w1map, w2map, hqmap, p, r, y, smem, st);
}

}  // namespace

// The constants of the launch plan, for the Python side to check its own
// against: {bytes of an fc1 weight tile, fc1 stages, most fc2 stages,
// bytes per staging row, static shared bytes, bytes of an fc2 weight tile,
// the current device's opt-in shared bytes per block}.
extern "C" void w8a8_mlp_layout(int* out) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  out[0] = kWTileBytes;
  out[1] = kStages1;
  out[2] = kMaxStages2;
  out[3] = kStageLD;
  out[4] = kStaticBytes;
  out[5] = kW2TileBytes;
  out[6] = optin;
}
