// Weight-only int8 GEMM (w8 serving mode) for Hopper (sm_90a).
//
// Replaces the TPU kernel gava_clip_tpu/ops/int8_matmul.py: _kernel (reached
// through int8_matmul's pl.pallas_call); in the w8 serving mode it is every
// projection of a block (q, k, v, out, fc1, fc2):
//
//   x (M, K) bf16; W (K, N) int8; scale (N) fp32:
//     w[k][n] = bf16((float)W[k][n] * scale[n])      one rounding per weight
//     y       = bf16(sum_k x[m][k] * w[k][n])        fp32 accumulation
//
// What bounds it on an H100 SXM (data-sheet figures, not measured): at the
// largest serving shapes, fc1 (M = 25216, K = 768, N = 3072) and fc2 (K =
// 3072, N = 768), 119 GFLOP of bf16, 0.1203 ms at 989 TFLOP/s, against
// ~196 MB moved (59 us at 3.35 TB/s): operations. Only wgmma reaches that
// rate on this card, so the product is wgmma, and what is left is to keep
// the loads and the dequantization off its path.
//
// Design (the mixed-input form). The block computes a tile of y^T = W^T x^T:
// 128 weight rows (two consumer warpgroups of 64) by 256 rows of x, so each
// consumer warpgroup issues wgmma m64n256k16 with
//   * A = its 64 weight rows, from REGISTERS: each thread dequantizes its own
//     A fragment (int8 -> fp32 exactly by a byte permute into the mantissa
//     of 2^23 and a subtraction, __fmul_rn by the scale of its row, one
//     cvt.rn.bf16x2: the same bits of w as the plain version's one rounding);
//   * B = the x tile (256 rows x 64 k, k contiguous), K-major in 128-byte
//     swizzled shared memory, as a TMA load leaves it.
// A producer warp keeps a ring of 3 stages in flight through mbarriers: per
// 64-wide k step one TMA load of the x tile and one bulk copy of the weight
// tile (8 KB, contiguous in the kernel layout below). Each consumer thread
// dequantizes the next stage's fragments while the current stage's four
// wgmma run, so neither the loads nor the conversion sit between two
// products; the stage goes back to the producer when its products are
// done. The grid is persistent (one block per SM walks the tiles, the tiles
// of one x row block next to each other so that they share it in L2), and
// the producer runs on into the next tile while the consumers write the
// last one: they transpose it through shared memory so that rows of y are
// written 16 bytes a thread, coalesced. SS-wgmma on a bf16 weight tile that
// a third warpgroup would dequantize into shared memory was the
// alternative; it moves every weight through shared memory twice and needs
// a barrier between the dequantization and the product, so the fragments
// stay in registers here.
//
// What is left between it and the products' rate is the dequantization:
// each weight is converted once per 256 rows of x, 15 instructions per
// four values, on the same warps that issue the products. A tile of 256 rows
// (not 192) converts each weight 25% less often and keeps the tensor cores
// busier for each conversion; a variant that skips the conversion (wrong
// values) runs close to torch.matmul (utils/kernel_variants.py).
//
// Kernel layout of the weight (ops/int8_matmul.w8_kernel_layout): W^T
// (N, K), zero-padded to multiples of 128 rows and 64 columns, cut into
// (128 x 64) tiles, tile (nb, kb) at byte (nb * KT + kb) * 8192; inside a
// tile, 16-row slab s (0..7), half h (k steps 2h, 2h + 1), lane (g, t): 16
// bytes at ((s * 2 + h) * 32 + lane) * 16, for each of the two k16 steps j
// the 8 bytes (row g, k 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), then
// the same at k + 8: one 16-byte shared load gives a thread its A
// fragments for two k16 steps, and a warp's loads are contiguous.
//
// Ragged shapes: rows of x past M load as zeros (TMA) and are not stored;
// weight rows past N are zero and not stored; k past K is zero on both
// sides. x's rows must be 16-byte aligned with K a multiple of 8 (the
// Python wrapper pads them otherwise).

#include <cuda_bf16.h>

#include "hopper_tma.cuh"

namespace {

using namespace hopper;

constexpr int kBN = 128;                        // weight rows per tile: 2 x 64
constexpr int kBM = 256;                        // rows of x per tile: the wgmma N
constexpr int kBK = 64;                         // k per stage: a 128-byte bf16 row
constexpr int kStages = 3;
constexpr int kXBytes = kBM * kBK * 2;          // 32,768
constexpr int kWBytes = kBN * kBK;              // 8,192
constexpr int kStageBytes = kXBytes + kWBytes;  // 40,960 (a multiple of 1,024)
constexpr int kYLD = kBN + 8;                   // bf16 per row of the output staging tile
constexpr int kYBytes = kBM * kYLD * 2;         // 69,632
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kYBytes;
constexpr int kThreads = 384;                   // producer warpgroup + 2 consumer warpgroups
constexpr int kAcc = kBM / 2;                   // fp32 accumulators per consumer thread

// keep the compiler from moving reads or writes of these registers across
// the asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
}

// d (64 weight rows x kBM rows of x, fp32) += A (registers) x B (desc)
__device__ __forceinline__ void wgmma_rs(float (&d)[kAcc], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
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
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// bf16(lo) | bf16(hi) << 16, round to nearest even
__device__ __forceinline__ uint32_t cvt_pack(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// byte I of u (the int8 value + 128) as an exact float: the byte is the
// mantissa of 2^23 + byte, and 2^23 + 128 is subtracted
template <int I>
__device__ __forceinline__ float s8_to_f32(uint32_t u) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + I)), 8388736.0f);
}

// four int8 (row a: bytes 0, 1; row b: bytes 2, 3) -> two registers of bf16
// pairs, each value bf16((float)w * s) with its row's scale
__device__ __forceinline__ void dequant_word(uint32_t w, float sa, float sb, uint32_t& ra,
                                             uint32_t& rb) {
  const uint32_t u = w ^ 0x80808080u;
  ra = cvt_pack(__fmul_rn(s8_to_f32<0>(u), sa), __fmul_rn(s8_to_f32<1>(u), sa));
  rb = cvt_pack(__fmul_rn(s8_to_f32<2>(u), sb), __fmul_rn(s8_to_f32<3>(u), sb));
}

// this thread's A fragments of the four k16 steps of a stage's weight tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const unsigned char* wtile, int slab,
                                       int lane, float s0, float s1) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(wtile + ((slab * 2 + h) * 32 + lane) * 16);
    dequant_word(v.x, s0, s1, a[2 * h][0], a[2 * h][1]);
    dequant_word(v.y, s0, s1, a[2 * h][2], a[2 * h][3]);
    dequant_word(v.z, s0, s1, a[2 * h + 1][0], a[2 * h + 1][1]);
    dequant_word(v.w, s0, s1, a[2 * h + 1][2], a[2 * h + 1][3]);
  }
}

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* smem;
  int stage;
  uint32_t phase;
};

// one k step of a consumer warpgroup: the four products of the stage whose
// fragments are in a[CUR]; meanwhile the next stage's fragments into
// a[CUR ^ 1] (when the tile has one); then the stage goes back to the
// producer
template <int CUR>
__device__ __forceinline__ void consume_stage(float (&acc)[kAcc], uint32_t (&a)[2][4][4],
                                              Ring& r, bool more, int slab, int lane, float s0,
                                              float s1) {
  const uint64_t desc = tile_desc(r.smem + r.stage * kStageBytes);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs(acc, a[CUR][j], desc + 2 * j);   // +32 bytes per k16
  wgmma_commit();
  int next = r.stage + 1;
  uint32_t next_phase = r.phase;
  if (next == kStages) {
    next = 0;
    next_phase ^= 1u;
  }
  if (more) {
    mbar_wait(&r.full[next], next_phase);
    load_a(a[CUR ^ 1], r.smem + next * kStageBytes + kXBytes, slab, lane, s0, s1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a[CUR]);
  __syncwarp();
  if (lane == 0) mbar_arrive(&r.empty[r.stage]);
  r.stage = next;
  r.phase = next_phase;
}

__device__ __forceinline__ void named_barrier_consumers() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
w8_matmul_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ Wk,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int N,
                 int KT, int n_tiles, int tiles, bool vec_y) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // the swizzled x tiles need 1,024-byte alignment
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM;
        const int8_t* wsrc = Wk + static_cast<long long>(tile % n_tiles) * KT * kWBytes;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1u);
          unsigned char* st = smem + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load(st, &xmap, kt * kBK, m0, &full[stage]);
          bulk_load(st + kXBytes, wsrc + static_cast<long long>(kt) * kWBytes, kWBytes,
                    &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: 64 weight rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int slab = (threadIdx.x - 128) / 32;   // 16-row slab of the tile's 128 rows
  const int ct = threadIdx.x - 128;            // 0 .. 255
  Ring ring{full, empty, smem, 0, 0u};
  float acc[kAcc];
  uint32_t a[2][4][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kBN;
    const int nr = n0 + slab * 16 + g;
    const float s0 = nr < N ? scale[nr] : 0.f;
    const float s1 = nr + 8 < N ? scale[nr + 8] : 0.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    mbar_wait(&ring.full[ring.stage], ring.phase);
    load_a(a[0], smem + ring.stage * kStageBytes + kXBytes, slab, lane, s0, s1);
    for (int kt = 0; kt < KT; kt += 2) {
      consume_stage<0>(acc, a, ring, kt + 1 < KT, slab, lane, s0, s1);
      if (kt + 1 < KT) consume_stage<1>(acc, a, ring, kt + 2 < KT, slab, lane, s0, s1);
    }

    // acc[4c + 2h + e] is y[m0 + 8c + 2t + e][n0 + slab * 16 + g + 8h]:
    // through the staging tile (rows of y) to 16-byte stores
    named_barrier_consumers();   // the previous tile's staging has been read
#pragma unroll
    for (int c = 0; c < kBM / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ys[(8 * c + 2 * t + e) * kYLD + slab * 16 + g + 8 * h] =
              __float2bfloat16(acc[4 * c + 2 * h + e]);
    named_barrier_consumers();
    for (int i = ct; i < kBM * (kBN / 8); i += 256) {
      const int r = i >> 4, n = n0 + (i & 15) * 8, m = m0 + r;
      if (m >= M || n >= N) continue;
      const __nv_bfloat16* src = ys + r * kYLD + (i & 15) * 8;
      __nv_bfloat16* dst = y + static_cast<long long>(m) * N + n;
      if (vec_y && n + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
      }
    }
  }
}

}  // namespace

// x (M, K) bf16, rows 16-byte aligned, K a multiple of 8; Wk the kernel
// layout of W (ceil(N / 128) x ceil(K / 64) tiles of 8,192 bytes, see the
// note above); scale (N) fp32; y (M, N) bf16 contiguous. Returns
// cudaGetLastError() after the launch: 0 when the launch was accepted.
extern "C" int w8_matmul_bf16(const void* x, const void* Wk, const void* scale, void* y, int M,
                              int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || (reinterpret_cast<uintptr_t>(x) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(Wk) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(w8_matmul_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = n_tiles * ((M + kBM - 1) / kBM);
  const int grid = tiles < sms ? tiles : sms;
  const bool vec_y = N % 8 == 0 && (reinterpret_cast<uintptr_t>(y) & 15u) == 0;
  w8_matmul_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const int8_t*>(Wk), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(y), M, N, (K + kBK - 1) / kBK, n_tiles, tiles, vec_y);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
