// B7's streaming attention backward past one key tile ('key_groups'), for
// Hopper (sm_90a), bf16, on wgmma. streaming_attention_bwd.cu launches it;
// up to 128 query rows and keys the one-launch form of attention_bwd.cuh
// takes the call. The function is that header's:
//
//   p     = exp2(s * c - lse * log2(e))  masked keys give 0
//   delta = rowsum(do * o)
//   ds    = bf16(p * (do v^T - delta) * scale)
//   dq = ds k, dk = ds^T q, dv = bf16(p)^T do   (fp32 sums, one cast each)
//
// It replaces the first form past 128 rows (a dq kernel a query tile and a
// dk / dv kernel a key tile, both on mma.sync, seven products a score
// entry). What bounds it on an H100 SXM (data-sheet figures): at a 400^2
// frame row of the vision tower, 4 clips x 8 frames, (32, 626, 643, 12), five
// products of 2 * 626 * 643 * 64 per (batch row, head) are 98.9 GFLOP, 0.100
// ms at 989 TFLOP/s, against 0.046 ms of bytes: the tensor cores, which only
// wgmma drives at full rate. So every product is a wgmma, each score entry
// is formed once, and its weight and ds never leave the registers but as
// the ds^T tile the dq product reads. Up to three launches, on the caller's
// stream, no sync, no allocation (the wrapper allocates the scratch):
//
//   1. attn_bwd_stat_kernel: each query row's (lse * log2(e), delta) into a
//      (B * H, lq_pad) float2 scratch, eight threads a row; a row past Lq
//      gets (1e30, 0), which makes its every weight and ds exactly 0.
//   2. attn_bwd_wgmma_kernel: a block of two warpgroups per (batch row,
//      head, group of key tiles of 128 keys), one block an SM. Per key tile
//      the block holds the tile's k rows in shared memory, warpgroup w its v
//      rows 64 w .. 64 w + 63 as wgmma A fragments in registers and their dk,
//      dv sums in registers, and walks the query tiles of 64 rows (causal:
//      from the first that sees the tile's keys), whose q, do and stat rows
//      come in by cp.async one step ahead (two stages). Per step and
//      warpgroup: s^T = k q^T (both operands in shared memory) and dp^T = v
//      do^T (A from registers) by wgmma m64n64k16; p and ds in registers;
//      dv += bf16(p)^T do and dk += ds^T q by wgmma with A the rounded
//      accumulators repacked as fragments and B the step's tiles read
//      mn-major; ds^T (bf16) into shared memory; after the block's barrier
//      dq_step = ds k over the tile's keys that can be nonzero, the two
//      warpgroups each 32 of its head columns (m64n32k16, both operands
//      mn-major), added into the block's fp32 dq accumulator. A warpgroup
//      whose 64 keys all lie past Lk (643 keys: the sixth tile holds 3) or
//      after the step's rows (causal) skips its products. exp2 is one MUFU
//      instruction (ex2.approx.ftz, as B1's and B7's forwards take it; the
//      rounding points above stay), and a warpgroup whose keys all exist
//      takes its weights without the mask's tests (on an H100 at the frame
//      row the tests and exp2f took 0.11 ms of 0.55).
//   3. attn_bwd_dq_sum_kernel (more than one group): the groups' dq sums
//      added in group order, cast to bf16.
//
// dq without atomics: only the block writes its accumulator, in a fixed key
// tile order, so every run gives the same bits. The accumulator (lq_pad x 64
// fp32, its 8-float chunks permuted by the row so that a warp's stores fall
// in all 32 banks) lies in shared memory while it fits beside the tiles
// (lq_pad <= 640), else in the block's region of the scratch, where it stays
// in L2. One group: the block casts it into dq itself. More groups
// (ops/flash_attention.streaming_bwd_plan; under the causal mask with fewer
// pairs than SMs, one a key tile): each block's sums go to its region of the
// scratch for the third launch.
//
// Tiles in shared memory are rows of 64 bf16 (128 bytes) under the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), 1,024-byte
// aligned: one layout that the descriptors read k-major (rows along the
// product's m or n) and mn-major (rows along its k). Rows past the end are
// zero-filled by the copy and their weights forced to 0.

#pragma once

#include <type_traits>

#include "attention_bwd.cuh"
#include "hopper_tma.cuh"

namespace attn {

constexpr int kGKeys = 128;                             // keys of a key tile, 64 a warpgroup
constexpr int kGRows = 64;                              // query rows of a step
constexpr int kGThreads = 256;                          // two warpgroups
constexpr int kGRowBytes = kHD * 2;                     // a tile row: 64 bf16
constexpr int kGOffDs = kGKeys * kGRowBytes;            // after the key tile
constexpr int kGOffStage = kGOffDs + kGKeys * kGRowBytes;
constexpr int kGStageBytes = 2 * kGRows * kGRowBytes;   // q rows | do rows
constexpr int kGOffStat = kGOffStage + 2 * kGStageBytes;
constexpr int kGOffAcc = kGOffStat + 2 * kGRows * 8;    // two stages of float2 stats
constexpr int kGFixedBytes = kGOffAcc + 1024;           // + the slack of the 1,024-byte alignment
constexpr int kGAccRowBytes = kHD * 4;                  // a dq accumulator row
constexpr int kGMaxSmem = 232448;                       // a block's shared memory on an H100
constexpr int kStatRows = kGThreads / 8;                // rows a block of the stat kernel

namespace gmma {

// byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * kGRowBytes + ((c ^ (r & 7)) << 4); }

// the tile read k-major: rows along m or n, 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t desc_k(const unsigned char* p) { return hopper::tile_desc(p); }

// the tile read mn-major: rows along k, 8-row groups 1,024 bytes apart (both
// stride fields: the one between 64-wide mn blocks is never taken, as no
// operand here is wider than 64)
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* p) {
  const uint64_t a = hopper::smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

// float index of (row, col) in a dq accumulator
__device__ __forceinline__ int acc_at(int r, int col) {
  return r * kHD + ((((col >> 3) ^ (r & 7))) << 3) + (col & 7);
}

// keep the compiler from moving reads or writes of these registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void pin(uint32_t (&a)[kKD][4]) {
#pragma unroll
  for (int j = 0; j < kKD; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
}

// d (64 x 64, fp32) (+)= A x B, both operands in shared memory by
// descriptor; TA / TB: 0 k-major, 1 mn-major; scale_d 0 starts a fresh sum
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 32, fp32) (+)= A x B, both operands in shared memory by
// descriptor; TA / TB: 0 k-major, 1 mn-major; scale_d 0 starts a fresh sum
template <int TA, int TB>
__device__ __forceinline__ void mma_ss_32(float (&d)[16], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64, fp32) (+)= A x B, A (64 x 16) from registers in the
// m16n8k16 A fragment of each warp's 16 rows, B in shared memory by
// descriptor; TB: 0 k-major, 1 mn-major; scale_d 0 starts a fresh sum
template <int TB>
__device__ __forceinline__ void mma_rs_64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// rows [row0, row0 + ROWS) of one head into a swizzled tile by cp.async, a
// block's threads a 16-byte chunk each; rows >= L zero-filled
template <int ROWS>
__device__ __forceinline__ void tile_async(unsigned char* dst, const __nv_bfloat16* src, int row0,
                                           int L, long long stride) {
#pragma unroll
  for (int it = 0; it < ROWS * 8 / kGThreads; ++it) {
    const int idx = it * kGThreads + threadIdx.x, r = idx >> 3, c = idx & 7;
    const bool ok = row0 + r < L;
    afrag::cp_async16(dst + swz(r, c), ok ? src + (row0 + r) * stride + c * 8 : src, ok);
  }
}

}  // namespace gmma

// the key groups' launch plan (ops/flash_attention.streaming_bwd_plan)
struct GrpArgs {
  const float2* stat;   // (B * H, lq_pad): lse * log2(e), delta
  float* sums;          // blocks' dq accumulators (more groups, or past shared memory)
  int groups, tiles;    // groups of key tiles a (row, head); key tiles a group
  int lq_pad;           // query rows rounded up to a step
  int acc_in_smem;
};

__global__ void __launch_bounds__(kGThreads) attn_bwd_stat_kernel(BwdArgs a, float2* stat,
                                                                  int lq_pad, long long rows) {
  const long long rid = static_cast<long long>(blockIdx.x) * kStatRows + threadIdx.x / 8;
  const int c = threadIdx.x & 7;
  const long long pair = rid / lq_pad;
  const int r = static_cast<int>(rid % lq_pad);
  const bool live = rid < rows && r < a.Lq;
  float sum = 0.f;
  if (live) {
    const long long b = pair / a.H, h = pair % a.H;
    const long long off = (b * a.Lq + r) * a.H * kHD + h * kHD + c * 8;
    const uint4 dw = *reinterpret_cast<const uint4*>(a.dout + off);
    const uint4 ow = *reinterpret_cast<const uint4*>(a.o + off);
    const uint32_t d4[4] = {dw.x, dw.y, dw.z, dw.w}, o4[4] = {ow.x, ow.y, ow.z, ow.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += lo_f(d4[i]) * lo_f(o4[i]) + hi_f(d4[i]) * hi_f(o4[i]);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  if (c == 0 && rid < rows)
    stat[rid] = live ? make_float2(a.rowstat[pair * a.Lq + r] * kLog2e, sum)
                     : make_float2(1e30f, 0.f);
}

__global__ void __launch_bounds__(kGThreads, 1) attn_bwd_wgmma_kernel(BwdArgs a, GrpArgs ga) {
  using namespace gmma;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (hopper::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ks = sm;
  unsigned char* dsT = sm + kGOffDs;
  float2* stat_s = reinterpret_cast<float2*>(sm + kGOffStat);

  const int item = blockIdx.x, pair = item / ga.groups, grp = item % ga.groups;
  const int b = pair / a.H, h = pair % a.H;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long hoff = static_cast<long long>(h) * kHD;
  const long long D = static_cast<long long>(a.H) * kHD;
  const __nv_bfloat16* qb = a.q + b * a.q_sb + hoff;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + hoff;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + hoff;
  const __nv_bfloat16* dob = a.dout + static_cast<long long>(b) * a.Lq * D + hoff;
  const float2* statb = ga.stat + static_cast<long long>(pair) * ga.lq_pad;
  float* acc = ga.acc_in_smem ? reinterpret_cast<float*>(sm + kGOffAcc)
                              : ga.sums + static_cast<long long>(item) * ga.lq_pad * kHD;
  const int n_kt = (a.Lk + kGKeys - 1) / kGKeys;
  const int kt_begin = grp * ga.tiles, kt_end = min(kt_begin + ga.tiles, n_kt);
  const int nq = ga.lq_pad / kGRows;

  // the q, do and stat rows of query tile qi into stage st
  auto load_stage = [&](int st, int qi) {
    unsigned char* qs = sm + kGOffStage + st * kGStageBytes;
    tile_async<kGRows>(qs, qb, qi * kGRows, a.Lq, a.q_sl);
    tile_async<kGRows>(qs + kGRows * kGRowBytes, dob, qi * kGRows, a.Lq, D);
    if (tid < kGRows / 2)
      afrag::cp_async16(stat_s + st * kGRows + 2 * tid, statb + qi * kGRows + 2 * tid, true);
  };

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kGKeys, wk0 = k0 + wg * 64;
    const int qt0 = a.causal ? k0 / kGRows : 0;   // the first step that sees the tile's keys
    const bool first = kt == kt_begin;
    tile_async<kGKeys>(ks, kb, k0, a.Lk, a.k_sl);
    if (qt0 < nq) load_stage(0, qt0);
    afrag::cp_commit();
    // this warpgroup's v rows as A fragments: warp w rows 16 w + g, + 8
    const int kr0 = wk0 + warp * 16 + g, kr1 = kr0 + 8;
    uint32_t va[kKD][4];
    load_a_frags(va, vb, kr0, kr1, a.Lk, a.v_sl, t);
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    for (int qi = qt0; qi < nq; ++qi) {
      const int st = (qi - qt0) & 1;
      afrag::cp_wait_all();
      tf32::fence_proxy_async();
      __syncthreads();   // stage st has landed; every thread is past step qi - 1
      if (qi + 1 < nq) load_stage(st ^ 1, qi + 1);
      afrag::cp_commit();
      const int q0 = qi * kGRows;
      const unsigned char* qs = sm + kGOffStage + st * kGStageBytes;
      const unsigned char* dos = qs + kGRows * kGRowBytes;
      const float2* sst = stat_s + st * kGRows;
      const bool busy = wk0 < a.Lk && (!a.causal || wk0 < q0 + kGRows);
      uint32_t pa[kKD][4], da[kKD][4];
      if (busy) {
        float s[32], dp[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKD; ++kk)   // s^T = k q^T
          mma_ss_64<0, 0>(s, desc_k(ks + wg * 64 * kGRowBytes) + 2 * kk, desc_k(qs) + 2 * kk, kk);
#pragma unroll
        for (int kk = 0; kk < kKD; ++kk)   // dp^T = v do^T
          mma_rs_64<0>(dp, va[kk], desc_k(dos) + 2 * kk, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        pin(s);
        pin(dp);
        pin(va);
        // entry 4 j + i: key kr0 (i < 2) or kr1, query q0 + 8 j + 2 t + (i &
        // 1); FULL: every key of the warpgroup exists and the mask is off,
        // so no entry is tested
        auto weights = [&](auto full_c) {
          constexpr bool FULL = decltype(full_c)::value;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int key = (i & 2) ? kr1 : kr0, ql = 8 * j + 2 * t + (i & 1);
              const float2 sv = sst[ql];
              float p = afrag::ex2f(s[4 * j + i] * a.c - sv.x);
              if (!FULL && !(key < a.Lk && (!a.causal || key <= q0 + ql))) p = 0.f;
              dp[4 * j + i] = p * (dp[4 * j + i] - sv.y) * a.scale;
              s[4 * j + i] = p;
            }
          }
        };
        if (!a.causal && wk0 + 64 <= a.Lk)
          weights(std::true_type{});
        else
          weights(std::false_type{});
#pragma unroll
        for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = afrag::cvt_pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
            da[kk][r] = afrag::cvt_pack(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
        }
        // ds^T rows kr0, kr1 (local 64 wg + 16 warp + g, + 8) into shared memory
        const int lr = wg * 64 + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<uint32_t*>(dsT + swz(lr, j) + 4 * t) = da[j >> 1][(j & 1) * 2];
          *reinterpret_cast<uint32_t*>(dsT + swz(lr + 8, j) + 4 * t) = da[j >> 1][(j & 1) * 2 + 1];
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKD; ++kk)   // dv += bf16(p)^T do
          mma_rs_64<1>(dv, pa[kk], desc_mn(dos + kk * 16 * kGRowBytes), 1);
#pragma unroll
        for (int kk = 0; kk < kKD; ++kk)   // dk += ds^T q
          mma_rs_64<1>(dk, da[kk], desc_mn(qs + kk * 16 * kGRowBytes), 1);
        hopper::wgmma_commit();   // in flight over the barrier and the dq product
      }
      tf32::fence_proxy_async();
      __syncthreads();   // every ds^T row of the step is written
      // dq of the step's rows, this warpgroup's 32 head columns: ds k over
      // the tile's keys that can be nonzero
      int kmax = min(kGKeys, a.Lk - k0);
      if (a.causal) kmax = min(kmax, q0 + kGRows - k0);
      const int nk = (kmax + 15) / 16;
      float dq[16];
      hopper::wgmma_fence();
      for (int kk = 0; kk < nk; ++kk)
        mma_ss_32<1, 1>(dq, desc_mn(dsT + kk * 16 * kGRowBytes),
                        desc_mn(ks + kk * 16 * kGRowBytes + wg * 64), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      pin(dq);
      if (busy) {
        pin(dv);
        pin(dk);
        pin(pa);
        pin(da);
      }
      // into the block's accumulator: the group's first key tile stores,
      // the later ones add
      const int r0 = q0 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wg * 32 + 8 * j + 2 * t;
        float2* p0 = reinterpret_cast<float2*>(acc + acc_at(r0, col));
        float2* p1 = reinterpret_cast<float2*>(acc + acc_at(r0 + 8, col));
        float2 v0 = make_float2(dq[4 * j], dq[4 * j + 1]);
        float2 v1 = make_float2(dq[4 * j + 2], dq[4 * j + 3]);
        if (!first) {
          const float2 o0 = *p0, o1 = *p1;
          v0 = make_float2(o0.x + v0.x, o0.y + v0.y);
          v1 = make_float2(o1.x + v1.x, o1.y + v1.y);
        }
        *p0 = v0;
        *p1 = v1;
      }
    }
    // this warpgroup's dk, dv rows
    __nv_bfloat16* dkb = a.dk + static_cast<long long>(b) * a.Lk * D + hoff;
    __nv_bfloat16* dvb = a.dv + static_cast<long long>(b) * a.Lk * D + hoff;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (kr0 < a.Lk) {
        *reinterpret_cast<uint32_t*>(dkb + kr0 * D + col) = afrag::cvt_pack(dk[4 * j], dk[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dvb + kr0 * D + col) = afrag::cvt_pack(dv[4 * j], dv[4 * j + 1]);
      }
      if (kr1 < a.Lk) {
        *reinterpret_cast<uint32_t*>(dkb + kr1 * D + col) =
            afrag::cvt_pack(dk[4 * j + 2], dk[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dvb + kr1 * D + col) =
            afrag::cvt_pack(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
    afrag::cp_wait_all();   // a tile with no step leaves its key rows in flight
    __syncthreads();        // the tile's dq products are done: its key rows may go
  }

  // the block's dq: cast into dq (one group), else its sums into the scratch
  if (ga.groups == 1) {
    __nv_bfloat16* dqb = a.dq + static_cast<long long>(b) * a.Lq * D + hoff;
    for (int idx = tid; idx < a.Lq * 8; idx += kGThreads) {
      const int r = idx >> 3, c = idx & 7;
      const float* src = acc + r * kHD + ((c ^ (r & 7)) << 3);
      const float4 x0 = *reinterpret_cast<const float4*>(src);
      const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
      *reinterpret_cast<uint4*>(dqb + r * D + c * 8) =
          make_uint4(afrag::cvt_pack(x0.x, x0.y), afrag::cvt_pack(x0.z, x0.w),
                     afrag::cvt_pack(x1.x, x1.y), afrag::cvt_pack(x1.z, x1.w));
    }
  } else if (ga.acc_in_smem) {
    float4* dst = reinterpret_cast<float4*>(ga.sums + static_cast<long long>(item) * ga.lq_pad * kHD);
    const float4* src = reinterpret_cast<const float4*>(acc);
    for (int idx = tid; idx < ga.lq_pad * kHD / 4; idx += kGThreads) dst[idx] = src[idx];
  }
}

// dq = bf16(the groups' sums, in group order): a thread per 8 columns of a
// row. Under the causal mask a group's sums start at its first key's row.
__global__ void __launch_bounds__(kGThreads) attn_bwd_dq_sum_kernel(BwdArgs a, GrpArgs ga,
                                                                    long long units) {
  const long long idx = static_cast<long long>(blockIdx.x) * kGThreads + threadIdx.x;
  if (idx >= units) return;
  const int c = static_cast<int>(idx & 7);
  const long long row = idx >> 3;
  const int r = static_cast<int>(row % a.Lq);
  const long long pair = row / a.Lq;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int grp = 0; grp < ga.groups; ++grp) {
    if (a.causal && r < grp * ga.tiles * kGKeys) break;
    const float* src = ga.sums + ((pair * ga.groups + grp) * ga.lq_pad + r) * kHD + ((c ^ (r & 7)) << 3);
    const float4 x0 = *reinterpret_cast<const float4*>(src);
    const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
    s[0] += x0.x; s[1] += x0.y; s[2] += x0.z; s[3] += x0.w;
    s[4] += x1.x; s[5] += x1.y; s[6] += x1.z; s[7] += x1.w;
  }
  const long long b = pair / a.H, h = pair % a.H;
  const long long D = static_cast<long long>(a.H) * kHD;
  *reinterpret_cast<uint4*>(a.dq + (b * a.Lq + r) * D + h * kHD + c * 8) =
      make_uint4(afrag::cvt_pack(s[0], s[1]), afrag::cvt_pack(s[2], s[3]),
                 afrag::cvt_pack(s[4], s[5]), afrag::cvt_pack(s[6], s[7]));
}

// the key groups' launches (Lq or Lk past kFRows): the stat kernel, the
// wgmma kernel on B * H * groups blocks, and with more groups the dq sum.
// The plan must be the one ops/flash_attention.streaming_bwd_plan computes
// from the layout; a plan the kernel cannot take returns an error, and
// nothing is launched. static: as launch_bwd.
static int launch_bwd_groups(const BwdArgs& a, int B, const GrpArgs& ga, int smem_bytes,
                             cudaStream_t stream) {
  const int n_kt = (a.Lk + kGKeys - 1) / kGKeys;
  const long long acc_bytes = static_cast<long long>(ga.lq_pad) * kGAccRowBytes;
  if (ga.groups < 1 || ga.tiles < 1 || (ga.groups - 1) * ga.tiles >= n_kt ||
      ga.groups * ga.tiles < n_kt || ga.lq_pad % kGRows || ga.lq_pad < a.Lq ||
      ga.lq_pad >= a.Lq + kGRows || ga.stat == nullptr ||
      smem_bytes != kGFixedBytes + (ga.acc_in_smem ? acc_bytes : 0) || smem_bytes > kGMaxSmem ||
      ((ga.groups > 1 || !ga.acc_in_smem) && ga.sums == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool set_on[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!set_on[dev]) {
    err = cudaFuncSetAttribute(attn_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_on[dev] = true;
  }
  const long long rows = static_cast<long long>(B) * a.H * ga.lq_pad;
  attn_bwd_stat_kernel<<<static_cast<unsigned>((rows + kStatRows - 1) / kStatRows), kGThreads, 0,
                         stream>>>(a, const_cast<float2*>(ga.stat), ga.lq_pad, rows);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  attn_bwd_wgmma_kernel<<<B * a.H * ga.groups, kGThreads, smem_bytes, stream>>>(a, ga);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || ga.groups == 1) return e;
  const long long units = static_cast<long long>(B) * a.H * a.Lq * 8;
  attn_bwd_dq_sum_kernel<<<static_cast<unsigned>((units + kGThreads - 1) / kGThreads), kGThreads,
                           0, stream>>>(a, ga, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn
