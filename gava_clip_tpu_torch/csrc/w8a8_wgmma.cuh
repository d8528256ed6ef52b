// The pieces of the TMA-fed wgmma w8a8 kernels for Hopper (sm_90a) that
// more than one of them uses (w8a8_matmul.cu, w8a8_qkv.cu, w8a8_mlp.cu,
// attention_out_int8.cu, mega_layer.cu):
//   * the block's int8 code tile: BM rows of Kp = round_up(K, 128) codes,
//     k-major and 128-byte swizzled as wgmma wants its B operand (byte k of
//     row rr sits in k-chunk k / 128, its 16-byte piece XOR rr % 8), and
//     the phase that fills it (fp32 LayerNorm + per-row quant of the rows,
//     a warp per row: w8a8_common.cuh quant_row_to);
//   * wgmma m64nNk32 s8 x s8 -> s32 with both operands in shared memory, for
//     the N (= rows of a block) the kernels use;
//   * the product of one consumer warpgroup's 64-row W^T slab with the code
//     tile over K, its slabs arriving by TMA through an mbarrier ring of its
//     own, one wgmma group in flight while the previous stage is released;
//   * the epilogue of a transposed tile: bf16 through a per-warp staging
//     tile in 16-byte stores (w8a8_matmul.cu, mega_layer.cu), fp32 (with an
//     optional fp32 residual) straight from the registers in 8-byte stores
//     (w8a8_matmul.cu);
//   * the tensor map of a row-major int8 matrix in 128-byte swizzled boxes.
// The kernels compute transposed tiles, y^T = W^T c^T: A is a 64-row slab of
// W^T, B the block's rows, and the accumulator acc[4c + 2h + e] of thread
// (warp wi of the warpgroup, lane g * 4 + t) is y^T[slab row wi * 16 + g +
// 8h][block row 8c + 2t + e].

#pragma once

#include "hopper_tma.cuh"
#include "w8a8_common.cuh"

namespace w8a8 {

using hopper::mbar_arrive;
using hopper::mbar_wait;
using hopper::tile_desc;

constexpr int kKC = 128;   // k bytes per ring stage and per code-tile chunk: one swizzled row

// offset of code c of row rr in a BM-row swizzled code tile
template <int BM>
__device__ __forceinline__ int code_at(int rr, int c) {
  return (c >> 7) * (BM * kKC) + rr * kKC + ((((c >> 4) & 7) ^ (rr & 7)) << 4) + (c & 15);
}

// Phase 0: warps w0, w0 + nw, ... of the block fill rows rr of the code
// tile `xc` from row_ptr(rr) (K bf16 or fp32 values, or nullptr for a row
// past the matrix: zero codes, scale 0) through [LayerNorm (gamma !=
// nullptr) ->] the per-row quant; xs[rr] receives the row scale.
template <int BM, class RowPtr>
__device__ __forceinline__ void quant_tile(int8_t* xc, float* xs, RowPtr row_ptr, int K, int Kp,
                                           const float* gamma, const float* beta, int w0,
                                           int nw, int lane) {
  for (int rr = w0; rr < BM; rr += nw) {
    auto store = [xc, rr](int c, int8_t code) { xc[code_at<BM>(rr, c)] = code; };
    // eight codes from c0 (a multiple of 8) lie in one 16-byte piece
    auto store8 = [xc, rr](int c0, uint2 codes) {
      *reinterpret_cast<uint2*>(xc + code_at<BM>(rr, c0)) = codes;
    };
    const auto src = row_ptr(rr);
    float v = 0.f;
    if (src != nullptr)
      v = quant_row_to(src, K, gamma, beta, Kp, store, store8, lane);
    else
      for (int c = lane; c < Kp; c += 32) store(c, static_cast<int8_t>(0));
    if (lane == 0) xs[rr] = v;
  }
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// named barrier `id` over `count` threads (id 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d (64 rows of W^T x N rows of the block, s32) += A (desc) x B (desc), k 32
template <int N>
__device__ __forceinline__ void wgmma_ss(int (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<8>(int (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(int (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(int (&d)[16], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(int (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<112>(int (&d)[56], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(int (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(int (&d)[96], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc = this warpgroup's 64-row W^T slab x BM rows of a code tile over KC
// k-chunks (chunk kc of the rows at xc + kc * chunk_bytes), the slabs taken
// from the warpgroup's ring (stage s at ring + s * stage_bytes, barriers
// full[s] / empty[s], `stages` of them; st, ph carry the ring's position
// from call to call).
// One wgmma group stays in flight while the previous stage is released (one
// arrival per warp).
template <int BM>
__device__ __forceinline__ void ring_product(int (&acc)[BM / 2], const unsigned char* ring,
                                             int stage_bytes, uint64_t* full, uint64_t* empty,
                                             int stages, int& st, uint32_t& ph,
                                             const int8_t* xc, int chunk_bytes, int KC,
                                             int lane) {
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0;
  int prev = -1;
  for (int kc = 0; kc < KC; ++kc) {
    mbar_wait(&full[st], ph);
    const uint64_t da = tile_desc(ring + st * stage_bytes);
    const uint64_t db = tile_desc(xc + kc * chunk_bytes);
    fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_ss<BM>(acc, da + 2 * j, db + 2 * j, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = st;
    if (++st == stages) {
      st = 0;
      ph ^= 1u;
    }
  }
  hopper::wgmma_wait<0>();
  fence_regs(acc);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[prev]);
}

// bytes of one warp's staging tile of store_tile_bf16: 32 rows x 16 bf16
constexpr int kWarpStageBytes = 32 * 32;

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// The epilogue of accumulators a0 = acc[4c + 2h], a1 = acc[4c + 2h + 1]
// (rows 8c + 2t and 8c + 2t + 1 of column g + 8h, scales x0, x1), fp32:
// ((float)acc * xs) * s + b. A lane pair swaps one value so that each
// thread holds two neighbouring columns of one row: row 8c + 2t + odd,
// columns (g - odd) + 8h and the next, returned as (lo, hi).
__device__ __forceinline__ float2 epilogue_pair(int a0, int a1, float x0, float x1, float s,
                                                float b, int odd) {
  const float v0 = epilogue(a0, x0, s, b);
  const float v1 = epilogue(a1, x1, s, b);
  const float other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
  return make_float2(odd ? other : v0, odd ? v1 : other);
}

// The epilogue of one warp's 16 columns of a transposed tile (acc[4c + 2h +
// e] = out^T[col0 + g + 8h][row 8c + 2t + e], thread g * 4 + t of the warp):
//   y[m0 + row][col0 + j] = bf16(((float)acc * xs[row]) * s[col] + b[col])
// (b null adds 0, as the plain version's zero bias does). The pairs of
// epilogue_pair go through the warp's staging tile `wst` (32 rows x 32
// bytes, the two 16-byte halves of a row swapped in every second group of
// four rows, so that neither the 4-byte writes nor the 16-byte reads meet a
// bank twice) and leave it as 16-byte stores, 32 rows at a time: the 32
// bytes of a row fill one sector. Rows from M and columns from N are not
// written; other than 16 whole columns of a y with N % 8 == 0 at a 16-byte
// aligned base go out 2 bytes at a time.
template <int BM>
__device__ __forceinline__ void store_tile_bf16(const int (&acc)[BM / 2], const float* xs,
                                                const float* __restrict__ s,
                                                const float* __restrict__ b,
                                                __nv_bfloat16* __restrict__ y, int m0,
                                                int col0, int M, int N, unsigned char* wst,
                                                int lane) {
  constexpr int kRows = BM < 32 ? BM : 32;   // rows staged at a time
  const int g = lane >> 2, t = lane & 3, odd = g & 1;
  float sa[2], ba[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = col0 + g + 8 * h;
    sa[h] = col < N ? s[col] : 0.f;
    ba[h] = col < N && b != nullptr ? b[col] : 0.f;
  }
  const bool vec = N % 8 == 0 && col0 + 16 <= N && aligned16(y);
#pragma unroll
  for (int r0 = 0; r0 < BM; r0 += kRows) {
#pragma unroll
    for (int cc = 0; cc < kRows / 8; ++cc) {
      const int c = r0 / 8 + cc;
      const float x0 = xs[8 * c + 2 * t], x1 = xs[8 * c + 2 * t + 1];
      const int lr = 8 * cc + 2 * t + odd;   // this thread's row of the staging tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = epilogue_pair(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1], x0, x1,
                                       sa[h], ba[h], odd);
        // columns (g - odd) + 8h and the next: word g / 2 of half h
        *reinterpret_cast<uint32_t*>(wst + lr * 32 + ((h ^ ((lr >> 2) & 1)) << 4) +
                                     (g >> 1) * 4) = bf16_pair(v.x, v.y);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < (kRows + 15) / 16; ++i) {
      const int lr = 16 * i + (lane >> 1), hl = lane & 1, m = m0 + r0 + lr;
      if (lr < kRows && m < M) {
        const uint4 v = *reinterpret_cast<const uint4*>(wst + lr * 32 +
                                                        ((hl ^ ((lr >> 2) & 1)) << 4));
        __nv_bfloat16* dst = y + static_cast<long long>(m) * N + col0 + 8 * hl;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (col0 + 8 * hl + j < N)
              dst[j] = __ushort_as_bfloat16(static_cast<unsigned short>(w[j / 2] >> (16 * (j & 1))));
        }
      }
    }
    __syncwarp();
  }
}

// The fp32 form of store_tile_bf16, with an optional fp32 residual r (same
// shape as y): y = (((float)acc * xs) * s + b) [+ r], each step rounded on
// its own (__fadd_rn: no FMA). No staging: after epilogue_pair's swap each
// thread holds two neighbouring fp32 columns of one row, 8 bytes, and the
// 32 lanes of a warp cover 8 rows x 32 contiguous bytes, one whole sector a
// row; where N is even they go out (and r comes in) 8 bytes at a time, else
// a value at a time. Rows from M and columns from N are not written.
template <int BM>
__device__ __forceinline__ void store_tile_f32(const int (&acc)[BM / 2], const float* xs,
                                               const float* __restrict__ s,
                                               const float* __restrict__ b,
                                               const float* __restrict__ r,
                                               float* __restrict__ y, int m0, int col0, int M,
                                               int N, int lane) {
  const int g = lane >> 2, t = lane & 3, odd = g & 1;
  float sa[2], ba[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = col0 + g + 8 * h;
    sa[h] = col < N ? s[col] : 0.f;
    ba[h] = col < N && b != nullptr ? b[col] : 0.f;
  }
  const bool vec = N % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7u) == 0 &&
                   (r == nullptr || (reinterpret_cast<uintptr_t>(r) & 7u) == 0);
#pragma unroll
  for (int c = 0; c < BM / 8; ++c) {
    const float x0 = xs[8 * c + 2 * t], x1 = xs[8 * c + 2 * t + 1];
    const int m = m0 + 8 * c + 2 * t + odd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v = epilogue_pair(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1], x0, x1, sa[h], ba[h],
                               odd);
      const int col = col0 + g - odd + 8 * h;
      if (m >= M || col >= N) continue;
      const long long at = static_cast<long long>(m) * N + col;
      if (vec) {
        if (r != nullptr) {
          const float2 rr = *reinterpret_cast<const float2*>(r + at);
          v = make_float2(__fadd_rn(v.x, rr.x), __fadd_rn(v.y, rr.y));
        }
        *reinterpret_cast<float2*>(y + at) = v;
      } else {
        y[at] = r != nullptr ? __fadd_rn(v.x, r[at]) : v.x;
        if (col + 1 < N) y[at + 1] = r != nullptr ? __fadd_rn(v.y, r[at + 1]) : v.y;
      }
    }
  }
}

// a map of the row-major int8 matrix (rows, cols) in boxes of 128 bytes x
// box_rows, 128-byte swizzled; rows and columns past the matrix load as
// zeros
inline bool encode_codes(hopper::EncodeTiled encode, CUtensorMap* map, const void* base,
                         int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kKC), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the shared memory of a block past the dynamic allocation's start, rounded
// up to the 1,024 bytes that a swizzled tile wants
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (hopper::smem_u32(p) & 1023u)) & 1023u);
}

}  // namespace w8a8
