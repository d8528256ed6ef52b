// Fused LayerNorm + shared int8 quant + q/k/v int8 GEMMs for Hopper (sm_90a).
//
// Replaces the TPU kernels gava_clip_tpu/ops/int8_matmul.py:
// _w8a8_kernel3_cat (w8a8_matmul3_cat's pl.pallas_call) and, with no extras
// rows (Le = 0, the promptless configuration), _w8a8_kernel3
// (w8a8_matmul3). On the serving path it opens every block:
//
//   x (B, Lx, K), e (B, Le, K) bf16; per clip b the kv rows are
//   [x[b, 0..Lx); e[b, 0..Le)] (the concatenation is never materialised);
//   for each kv row: fp32 LayerNorm (gamma, beta; optional), ONE per-row
//   quant, then for w in q, k, v:
//   out_w = bf16(((float)(codes @ W_w) * xs) * s_w + b_w), three
//   (B, Lx + Le, N) outputs.
//
// What bounds it on an H100 SXM (data-sheet figures, not measured), at the
// serving shape B = 128 frame rows, Lx = 197, Le = 17, K = N = 768: 96.9 G
// int8 operations, 49 us at 1,979 TOP/s; it reads 42 MB and writes 126 MB,
// 50 us at 3.35 TB/s: balanced. Only wgmma reaches the int8 rate, and the
// three weights (1.77 MB) must cross L2 as few times as the rows allow.
//
// Design (B5's form, csrc/w8a8_mlp.cu, with the pieces they share in
// w8a8_wgmma.cuh). A block of a producer warpgroup and two consumer
// warpgroups takes BM rows and a range of units, a unit being one 128-row
// slab of one W^T (a 128-column slab of one output): all 3 * ceil(N / 128)
// of them, or a share when the row tiles alone are fewer than the SMs. The
// launch plan (ops/int8_matmul.w8a8_qkv_plan) takes 128 rows where those
// tiles fill the card (the serving shape: 214 blocks), else 64 or 32 rows
// with two blocks to an SM (the text tower's 1,155 rows: 37 tiles of 32 x 4
// groups of 3 units), and gives the weight rings what shared memory is
// left, up to 8 stages.
//   * phase 0: all 12 warps normalise and quantize the block's rows (from x
//     or e by index) into the 128-byte swizzled code tile, which stays in
//     shared memory for all the units;
//   * two producer threads stream 64 x 128-byte W^T slabs by TMA, one
//     mbarrier ring per consumer warpgroup;
//   * per unit, each consumer warpgroup runs wgmma m64nBMk32 s8 over K on
//     its 64 W^T rows (ring_product), then the epilogue acc * xs * s + b:
//     a lane pair swaps one value so that each thread holds two neighbouring
//     columns of one row, and stores them as one 4-byte bf16 pair; the
//     8 lanes of a row write 16 contiguous bytes. A tile wholly inside the
//     output (rows, columns, even N) has no branch.
// What holds it back on the card (utils/kernel_variants.py): the weight
// tiles' trip through L2 (a deeper ring, fewer rows per tile than 208 and
// 192 but not fewer than 128 made it faster), the LayerNorm of phase 0,
// and the epilogue's stores.
// The epilogue is the plain version's fp32 sequence and the products are
// exact, so the outputs differ from the plain version only where a code
// flips at a rounding tie of the LayerNorm (a warp butterfly here, torch's
// reduction there). TMA wants each W^T 16-byte aligned with rows of a
// multiple of 16 bytes (the Python wrapper pads others); columns of W^T past
// K and rows past N load as zeros. K is bounded by the code tile in shared
// memory (32 rows, 3 stages: K <= 5,632 at 227 KB); a row longer than 1,024 values is
// normalised and quantized in passes over it (quant_row_long).

#include <type_traits>

#include "w8a8_wgmma.cuh"

namespace {

using namespace hopper;
using namespace w8a8;

constexpr int kThreadsQkv = 384;             // producer warpgroup + 2 consumer warpgroups
constexpr int kWarpsQkv = kThreadsQkv / 32;
constexpr int kMaxStages = 8;                // ring stages of each consumer warpgroup, at most
constexpr int kSlabBytes = 64 * kKC;         // one warpgroup's 64 W^T rows x 128 k
constexpr int kUnitCols = 128;               // output columns of a unit (2 x 64)
constexpr int kStaticBytes = 256;            // the static shared barriers (256), rounded up

// dynamic shared bytes of one block: alignment slack, the code tile, the two
// rings of `stages` stages, the row scales
__host__ __device__ constexpr int smem_bytes(int BM, int Kp, int stages) {
  return 1024 + BM * Kp + 2 * stages * kSlabBytes + 4 * BM;
}

// blocks of BM rows that an SM may hold at once: two of up to 64 rows (their
// threads then get at most 80 registers), else one
__host__ __device__ constexpr int blocks_per_sm(int BM) { return BM <= 64 ? 2 : 1; }

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* e;
  const float* s[3];
  const float* b[3];
  __nv_bfloat16* out[3];
  const float* gamma;
  const float* beta;
  int Lx, Le, M, K, N, Kp;
  int units;       // units (one weight's 128-column slab) per block
  int total;       // 3 * ceil(N / 128)
  int stages;      // ring stages of each consumer warpgroup
};

template <int BM>
__global__ void __launch_bounds__(kThreadsQkv, blocks_per_sm(BM))
w8a8_qkv_kernel(const __grid_constant__ CUtensorMap wq, const __grid_constant__ CUtensorMap wk,
                const __grid_constant__ CUtensorMap wv, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2][kMaxStages], empty[2][kMaxStages];
  unsigned char* smem = align1024(smem_raw);
  int8_t* xc = reinterpret_cast<int8_t*>(smem);            // [KC][BM][128] swizzled codes
  unsigned char* ring = smem + BM * p.Kp;                   // [wg][stage][64][128]
  float* xs = reinterpret_cast<float*>(ring + 2 * p.stages * kSlabBytes);
  const int KC = p.Kp / kKC, NS = p.total / 3;
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

  // phase 0, all warps: kv row m0 + rr is x[clip, j] or e[clip, j - Lx]
  const int Lkv = p.Lx + p.Le;
  quant_tile<BM>(
      xc, xs,
      [&](int rr) -> const __nv_bfloat16* {
        const int m = m0 + rr;
        if (m >= p.M) return nullptr;
        const int clip = m / Lkv, j = m % Lkv;
        return j < p.Lx ? p.x + (static_cast<long long>(clip) * p.Lx + j) * p.K
                        : p.e + (static_cast<long long>(clip) * p.Le + (j - p.Lx)) * p.K;
      },
      p.K, p.Kp, p.gamma, p.beta, warp, kWarpsQkv, lane);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x < 128) {
    if constexpr (blocks_per_sm(BM) == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // threads 0 and 32 feed consumer warpgroup 0's and 1's ring: k-chunk
    // kc of unit u, that warpgroup's 64 rows of the unit's W^T slab
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const int w = warp;
      int st = 0;
      uint32_t ph = 0;
      for (int u = u0; u < u1; ++u) {
        const CUtensorMap* map = u / NS == 0 ? &wq : (u / NS == 1 ? &wk : &wv);
        for (int kc = 0; kc < KC; ++kc) {
          mbar_wait(&empty[w][st], ph ^ 1u);
          mbar_expect_tx(&full[w][st], kSlabBytes);
          tma_load(ring + (w * p.stages + st) * kSlabBytes, map, kc * kKC,
                   (u % NS) * kUnitCols + w * 64, &full[w][st]);
          if (++st == p.stages) {
            st = 0;
            ph ^= 1u;
          }
        }
      }
    }
    return;
  }

  if constexpr (blocks_per_sm(BM) == 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128;            // 0 .. 255
  const int wg = ct / 128, wi = (ct / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const int odd = g & 1;
  int acc[BM / 2];
  int st = 0;
  uint32_t ph = 0;
  for (int u = u0; u < u1; ++u) {
    ring_product<BM>(acc, ring + wg * p.stages * kSlabBytes, kSlabBytes, full[wg], empty[wg],
                     p.stages, st, ph, xc, BM * kKC, KC, lane);
    const int w = u / NS;
    // acc[4c + 2h + e] is out^T[col0 + 8h][row 8c + 2t + e]
    const int col0 = (u % NS) * kUnitCols + wg * 64 + wi * 16 + g;
    float sa[2], ba[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 8 * h;
      sa[h] = col < p.N ? p.s[w][col] : 0.f;
      ba[h] = col < p.N ? p.b[w][col] : 0.f;
    }
    __nv_bfloat16* out = p.out[w];
    // after the swap, this thread holds row 8c + 2t + odd, columns
    // col0 + 8h - odd and the next one
    auto store = [&](auto full_c) {
      constexpr bool FULL = decltype(full_c)::value;
#pragma unroll
      for (int c = 0; c < BM / 8; ++c) {
        const int row = 8 * c + 2 * t + odd, m = m0 + row;
        const float x0 = xs[8 * c + 2 * t], x1 = xs[8 * c + 2 * t + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = epilogue(acc[4 * c + 2 * h], x0, sa[h], ba[h]);
          const float v1 = epilogue(acc[4 * c + 2 * h + 1], x1, sa[h], ba[h]);
          const float other = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
          const float lo = odd ? other : v0, hi = odd ? v1 : other;
          const int col = col0 + 8 * h - odd;
          if (FULL) {
            *reinterpret_cast<uint32_t*>(out + static_cast<long long>(m) * p.N + col) =
                static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
                (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
          } else if (m < p.M) {
            __nv_bfloat16* y = out + static_cast<long long>(m) * p.N + col;
            if (col < p.N) y[0] = __float2bfloat16(lo);
            if (col + 1 < p.N) y[1] = __float2bfloat16(hi);
          }
        }
      }
    };
    if (m0 + BM <= p.M && (u % NS + 1) * kUnitCols <= p.N && p.N % 2 == 0)
      store(std::true_type{});
    else
      store(std::false_type{});
  }
}

template <int BM>
int launch_rows(const CUtensorMap (&maps)[3], const Params& p, int grid_y, int smem,
                cudaStream_t stream) {
  auto kernel = w8a8_qkv_kernel<BM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.M + BM - 1) / BM, grid_y);
  kernel<<<grid, kThreadsQkv, smem, stream>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, Lx, K), e (B, Le, K) bf16 contiguous (e may be null when Le = 0);
// Wq^T/Wk^T/Wv^T (N, K) int8, 16-byte aligned, each row zero-padded to a
// multiple of 16 bytes (round_up(K, 16): TMA's stride rule); sq..bv (N)
// fp32; gamma, beta (K) fp32, both null for no LayerNorm; oq/ok/ov
// (B, Lx + Le, N) bf16 contiguous. rows (128, 64 or 32), units
// per block, ring stages and smem are the launch plan
// (ops/int8_matmul.w8a8_qkv_plan). Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape or plan the kernel does not
// take).
extern "C" int w8a8_qkv_cat_bf16(const void* x, const void* e, const void* Wq, const void* Wk,
                                 const void* Wv, const void* sq, const void* sk, const void* sv,
                                 const void* bq, const void* bk, const void* bv,
                                 const void* gamma, const void* beta, void* oq, void* ok,
                                 void* ov, int B, int Lx, int Le, int K, int N, int rows,
                                 int units, int stages, int smem, void* stream) {
  const long long Mll = static_cast<long long>(B) * (Lx + Le);
  if (K <= 0 || N <= 0 || B <= 0 || Lx < 0 || Le < 0 || (Le > 0 && e == nullptr) ||
      Mll > (1ll << 30) || (gamma == nullptr) != (beta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Mll == 0) return 0;
  const int Kp = round_up(K, kKC), total = 3 * ((N + kUnitCols - 1) / kUnitCols);
  if ((rows != 128 && rows != 64 && rows != 32) || units <= 0 ||
      stages < 2 || stages > kMaxStages || smem < smem_bytes(rows, Kp, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* Ws[3] = {Wq, Wk, Wv};
  const void* ss[3] = {sq, sk, sv};
  const void* bs[3] = {bq, bk, bv};
  void* os[3] = {oq, ok, ov};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  Params p{};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    if (!aligned16(Ws[i]) || !encode_codes(encode, &maps[i], Ws[i], N, round_up(K, 16), 64))
      return static_cast<int>(cudaErrorInvalidValue);
    p.s[i] = static_cast<const float*>(ss[i]);
    p.b[i] = static_cast<const float*>(bs[i]);
    p.out[i] = static_cast<__nv_bfloat16*>(os[i]);
  }
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.e = static_cast<const __nv_bfloat16*>(e);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.Lx = Lx;
  p.Le = Le;
  p.M = static_cast<int>(Mll);
  p.K = K;
  p.N = N;
  p.Kp = Kp;
  p.units = units;
  p.total = total;
  p.stages = stages;
  const int grid_y = (total + units - 1) / units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 128: return launch_rows<128>(maps, p, grid_y, smem, st);
    case 64: return launch_rows<64>(maps, p, grid_y, smem, st);
    default: return launch_rows<32>(maps, p, grid_y, smem, st);
  }
}

// The constants of the launch plan, for the Python side to check its own
// against: {bytes of one warpgroup's ring stage, most stages per ring,
// output columns per unit, static shared bytes, the current device's opt-in
// shared bytes per block}.
extern "C" void w8a8_qkv_layout(int* out) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  out[0] = kSlabBytes;
  out[1] = kMaxStages;
  out[2] = kUnitCols;
  out[3] = kStaticBytes;
  out[4] = optin;
}
