// Fused w8a8 GEMM for Hopper (sm_90a): per-row int8 quant of x, int8 GEMM,
// rescale and bias.
//
// Replaces the TPU kernel gava_clip_tpu/ops/int8_matmul.py: _w8a8_kernel
// (w8a8_matmul's pl.pallas_call); on the serving path it is the patch-major
// patch embed, once per forward, and every 'qa' linear of a w8a8 text tower
// (its out-projection, fc1 and fc2):
//
//   x (M, K) bf16 (raw 0..255 pixels at the patch embed), W (K, N) int8,
//   s (N) fp32, b (N) fp32 or none -> y (M, N) bf16:
//     xs_m = max(max_k |x_mk|, 1e-6) * fp32(1/127)
//     c_mk = rint(x_mk * (1 / xs_m))                  (no clip)
//     y_mn = bf16(((float)(sum_k c_mk W_kn) * xs_m) * s_n + b_n)
//
// The fp32 form (w8a8_matmul_f32; the TPU kernel emits its input's dtype,
// and int8-forward training in fp32 runs it at every frozen linear) reads
// fp32 rows and stores y in fp32 with no rounding after the epilogue's.
// With an fp32 residual r (M, N) it is also the second half of the fp32
// attention + int8 out-projection (TPU _attention_out_kernel's epilogue
// _int8_outproj_epilogue, ops/flash_attention.attention_out_int8_cuda):
// y = (((float)acc * xs) * s + b) + r, each step rounded on its own.
//
// What bounds it on an H100 SXM (data-sheet figures, not measured), at the
// patch embed M = 25088 (16 clips x 8 frames x 196 patches), K = N = 768:
// 29.6 G int8 operations, 15 us at the 1,979 TOP/s int8 dense peak; it
// reads x (38.5 MB) and writes y (38.5 MB), 23 us at 3.35 TB/s: bound by
// bytes, with the operations close behind (in fp32 x and y are twice the
// bytes: 46 us). The codes never reach device memory, x is read from HBM
// once and y written once.
//
// Design (B3's form, csrc/w8a8_qkv.cu, with one weight; the pieces they
// share are in w8a8_wgmma.cuh). A block of a producer warpgroup and two
// consumer warpgroups takes BM rows (192, 128, 64, 32, 16 or 8) and a range
// of units, a unit being one 128-row slab of W^T (128 output columns): all
// ceil(N / 128) of them, or a share when the row tiles alone are too few
// for the card. The launch plan (ops/int8_matmul.w8a8_matmul_plan) picks
// the rows, the units a block, the ring stages and two blocks to an SM for
// tiles of at most 64 rows.
//   * the producer threads issue the first stages of the weight rings
//     first: the weights do not wait for the codes;
//   * phase 0: all 12 warps quantize the block's rows (a warp a row,
//     w8a8_common.cuh quant_row_to, rows of more than 1,024 values in passes
//     over the row) into the 128-byte swizzled code tile, which stays in
//     shared memory for all the units;
//   * two producer threads stream 64 x 128-byte W^T slabs by TMA, one
//     mbarrier ring per consumer warpgroup; each weight tile is read once
//     per BM rows;
//   * per unit, each consumer warpgroup runs wgmma m64nBMk32 s8 over K on
//     its 64 W^T rows (ring_product), then the epilogue: the plain version's
//     fp32 sequence, through a per-warp staging tile in 16-byte stores
//     (store_tile_bf16), or in fp32 straight from the registers in 8-byte
//     stores that fill whole sectors (store_tile_f32: no staging tile).
// The codes and the epilogue are the plain version's, and the int32 sums
// are exact, so the kernel matches it bit for bit. TMA wants W^T 16-byte
// aligned with rows of a multiple of 16 bytes (the Python wrapper pads
// others); columns of W^T past K and rows past N load as zeros. K is bounded
// by the code tile in shared memory: 8 rows of K <= 23,808 at 227 KB.

#include <type_traits>

#include "w8a8_wgmma.cuh"

namespace {

using namespace hopper;
using namespace w8a8;

constexpr int kThreadsB2 = 384;             // producer warpgroup + 2 consumer warpgroups
constexpr int kWarpsB2 = kThreadsB2 / 32;
constexpr int kMaxStages = 8;               // ring stages of each consumer warpgroup, at most
constexpr int kSlabBytes = 64 * kKC;        // one warpgroup's 64 W^T rows x 128 k
constexpr int kUnitCols = 128;              // output columns of a unit (2 x 64)
constexpr int kStaticBytes = 256;           // the static shared barriers (256), rounded up

constexpr int kStageBytes = 8 * kWarpStageBytes;   // the 8 consumer warps' staging tiles (bf16)
constexpr int kStageBytesF32 = 0;                  // the fp32 epilogue stores from the registers
template <class T> constexpr int kStage =
    std::is_same<T, float>::value ? kStageBytesF32 : kStageBytes;

// dynamic shared bytes of one block: alignment slack, the code tile, the two
// rings of `stages` stages, the staging tiles, the row scales
template <class T>
__host__ __device__ constexpr int smem_bytes(int BM, int Kp, int stages) {
  return 1024 + BM * Kp + 2 * stages * kSlabBytes + kStage<T> + 4 * BM;
}

// blocks of BM rows an SM may hold at once: two of up to 64 rows (their
// threads then get at most 80 registers), else one
__host__ __device__ constexpr int blocks_per_sm(int BM) { return BM <= 64 ? 2 : 1; }

template <class T>   // __nv_bfloat16 or float: x and y
struct Params {
  const T* x;
  const float* s;
  const float* b;     // null: no bias
  const float* r;     // fp32 only; null: no residual
  T* y;
  int M, K, N, Kp;
  int units;          // units per block
  int total;          // ceil(N / 128)
  int stages;         // ring stages of each consumer warpgroup
};

template <int BM, class T>
__global__ void __launch_bounds__(kThreadsB2, blocks_per_sm(BM))
w8a8_matmul_kernel(const __grid_constant__ CUtensorMap wmap, const Params<T> p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2][kMaxStages], empty[2][kMaxStages];
  unsigned char* smem = align1024(smem_raw);
  int8_t* xc = reinterpret_cast<int8_t*>(smem);             // [KC][BM][128] swizzled codes
  unsigned char* ring = smem + BM * p.Kp;                    // [wg][stage][64][128]
  unsigned char* stg = ring + 2 * p.stages * kSlabBytes;     // [warp][32][32] (bf16)
  float* xs = reinterpret_cast<float*>(stg + kStage<T>);
  const int KC = p.Kp / kKC;
  const int m0 = blockIdx.x * BM;
  const int u0 = blockIdx.y * p.units;
  const int u1 = min(u0 + p.units, p.total);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < p.stages; ++s) {
        mbar_init(&full[w][s], 1);
        mbar_init(&empty[w][s], 4);   // one arrival per warp of the warpgroup
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // threads 0 and 32 feed consumer warpgroup 0's and 1's ring: item i is
  // k-chunk i % KC of unit u0 + i / KC, that warpgroup's 64 rows of the
  // unit's W^T slab
  const bool producer = threadIdx.x == 0 || threadIdx.x == 32;
  const int items = (u1 - u0) * KC;
  int pi = 0, pst = 0;
  uint32_t pph = 0;
  auto produce = [&](int upto) {
    for (; pi < upto; ++pi) {
      mbar_wait(&empty[warp][pst], pph ^ 1u);
      mbar_expect_tx(&full[warp][pst], kSlabBytes);
      tma_load(ring + (warp * p.stages + pst) * kSlabBytes, &wmap, (pi % KC) * kKC,
               (u0 + pi / KC) * kUnitCols + warp * 64, &full[warp][pst]);
      if (++pst == p.stages) {
        pst = 0;
        pph ^= 1u;
      }
    }
  };
  if (producer) produce(min(items, p.stages));
  __syncwarp();

  // phase 0, all warps
  quant_tile<BM>(
      xc, xs,
      [&](int rr) -> const T* {
        return m0 + rr < p.M ? p.x + static_cast<long long>(m0 + rr) * p.K : nullptr;
      },
      p.K, p.Kp, nullptr, nullptr, warp, kWarpsB2, lane);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x < 128) {
    if constexpr (blocks_per_sm(BM) == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (producer) produce(items);
    return;
  }

  if constexpr (blocks_per_sm(BM) == 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128;            // 0 .. 255
  const int wg = ct / 128, wi = (ct / 32) % 4;
  unsigned char* wst = stg + (ct / 32) * kWarpStageBytes;
  int acc[BM / 2];
  int st = 0;
  uint32_t ph = 0;
  for (int u = u0; u < u1; ++u) {
    ring_product<BM>(acc, ring + wg * p.stages * kSlabBytes, kSlabBytes, full[wg], empty[wg],
                     p.stages, st, ph, xc, BM * kKC, KC, lane);
    const int col0 = u * kUnitCols + wg * 64 + wi * 16;
    if constexpr (std::is_same<T, float>::value)
      store_tile_f32<BM>(acc, xs, p.s, p.b, p.r, p.y, m0, col0, p.M, p.N, lane);
    else
      store_tile_bf16<BM>(acc, xs, p.s, p.b, p.y, m0, col0, p.M, p.N, wst, lane);
  }
}

template <int BM, class T>
int launch_rows(const CUtensorMap& map, const Params<T>& p, int grid_y, int smem,
                cudaStream_t stream) {
  auto kernel = w8a8_matmul_kernel<BM, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.M + BM - 1) / BM, grid_y);
  kernel<<<grid, kThreadsB2, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const void* x, const void* Wt, const void* s, const void* b, const void* r, void* y,
           int M, int K, int N, int rows, int units, int stages, int smem, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = round_up(K, kKC), total = (N + kUnitCols - 1) / kUnitCols;
  if ((rows != 192 && rows != 128 && rows != 64 && rows != 32 && rows != 16 && rows != 8) ||
      units <= 0 || stages < 2 || stages > kMaxStages || smem < smem_bytes<T>(rows, Kp, stages) ||
      !aligned16(Wt))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap map;
  if (!encode_codes(encode, &map, Wt, N, round_up(K, 16), 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params<T> p{static_cast<const T*>(x), static_cast<const float*>(s),
                    static_cast<const float*>(b), static_cast<const float*>(r), static_cast<T*>(y),
                    M, K, N, Kp, units, total, stages};
  const int grid_y = (total + units - 1) / units;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 192: return launch_rows<192>(map, p, grid_y, smem, st);
    case 128: return launch_rows<128>(map, p, grid_y, smem, st);
    case 64: return launch_rows<64>(map, p, grid_y, smem, st);
    case 32: return launch_rows<32>(map, p, grid_y, smem, st);
    case 16: return launch_rows<16>(map, p, grid_y, smem, st);
    default: return launch_rows<8>(map, p, grid_y, smem, st);
  }
}

template <class T>
void layout(int* out) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  out[0] = kSlabBytes;
  out[1] = kMaxStages;
  out[2] = kUnitCols;
  out[3] = kStage<T>;
  out[4] = kStaticBytes;
  out[5] = optin;
}

}  // namespace

// x (M, K) bf16 and y (M, N) bf16 contiguous; W^T (N, K) int8, 16-byte
// aligned, each row zero-padded to a multiple of 16 bytes (round_up(K, 16):
// TMA's stride rule); s, b (N) fp32 (b may be null). rows (192, 128, 64,
// 32, 16 or 8), units per block, ring stages and smem are the launch plan
// (ops/int8_matmul.w8a8_matmul_plan). Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape or plan the kernel does not
// take).
extern "C" int w8a8_matmul_bf16(const void* x, const void* Wt, const void* s, const void* b,
                                void* y, int M, int K, int N, int rows, int units, int stages,
                                int smem, void* stream) {
  return launch<__nv_bfloat16>(x, Wt, s, b, nullptr, y, M, K, N, rows, units, stages, smem,
                               stream);
}

// The fp32 form: x (M, K) and y (M, N) fp32 contiguous, and r (M, N) fp32
// contiguous or null (no residual); the rest as w8a8_matmul_bf16, the plan
// from the fp32 layout.
extern "C" int w8a8_matmul_f32(const void* x, const void* Wt, const void* s, const void* b,
                               const void* r, void* y, int M, int K, int N, int rows, int units,
                               int stages, int smem, void* stream) {
  return launch<float>(x, Wt, s, b, r, y, M, K, N, rows, units, stages, smem, stream);
}

// The constants of the launch plan, for the Python side to check its own
// against: {bytes of one warpgroup's ring stage, most stages per ring,
// output columns per unit, bytes of the staging tiles, static shared bytes,
// the current device's opt-in shared bytes per block}; the fp32 form's,
// whose epilogue has no staging tiles.
extern "C" void w8a8_matmul_layout(int* out) { layout<__nv_bfloat16>(out); }
extern "C" void w8a8_matmul_layout_f32(int* out) { layout<float>(out); }
