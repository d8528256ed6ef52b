// Float32 attention for Hopper (sm_90a): the fp32 forms of the packed
// forward (with and without den, with the int8 score product, over two key
// / value sources), of its backward from the saved output and den, of the
// backward that rebuilds them, and of the streaming (causal or long)
// forward and backward.
//
// Replaces, for float32 q / k / v, the TPU kernels of
// gava_clip_tpu/ops/flash_attention.py: _attention_kernel (:181) and
// _attention_kernel_den (:193) (B1 / B6a), _attention_bwd_kernel (:213)
// (B6b), _attention_bwd_kernel_recompute (:410) (B8), and the forward and
// backward kernels of the stock TPU flash attention that _streaming_flash
// (:534) wraps (B7); and the attention of the w8a8 serving fusion's int8
// QK^T form (:117-132, inside the kernel of :754) (B11) and of its
// two-source entry _attention_out_kernel_2src (:775) (B12), whose int8
// out-projection is csrc/w8a8_matmul.cu's fp32 entry (the second launch of
// their fp32 forms). Those emit their input's dtype; the port's bf16
// kernels (packed_attention.cu, packed_attention_bwd.cuh,
// streaming_attention.cu, attention_bwd.cuh) are built on bf16 mma
// fragments and take bf16 only. The functions are the bf16 forms' with
// every cast to v's dtype a no-op:
//
//   packed (Lk <= 640, per head): s = q k^T (fp32), c = 64^-0.5 * log2(e)
//     e   = exp2(min(s * c, 110))           keys >= Lk give 0; no max
//                                           subtraction: the clamp is the
//                                           semantics
//     den = sum(e)                          written by the den entry
//     o   = (e @ v) / max(den, 1e-30)
//   int8 scores (B11), per head: each q and k row's qs = max(absmax, 1e-6),
//     its codes rint(x * (127 / qs)) (an IEEE division), s32 the codes'
//     product, then the exp2 argument (s32 * (qs * (c / 127^2))) * ks in
//     that order, clamped and masked as above;
//   two sources (B12): the keys and values [k1; k2], [v1; v2], row j < L1
//     read from source 1 and row j >= L1 from source 2 at j - L1;
//   its backward, from o and den (or, recompute, from o and den rebuilt by
//   the forward above into scratch):
//     inv = 1 / max(den, 1e-30), delta = rowsum(do * o), p = e * inv,
//     ds = p * (do v^T - delta), dq = scale ds k, dk = scale ds^T q,
//     dv = p^T do
//   streaming: s2 = s * c; key j is visible to row i iff j < Lk and (not
//     causal or j <= i); a running max m and sum l over key tiles,
//     p = exp2(s2 - m), o = (p @ v) / l, lse = (m + log2(l)) * ln(2);
//   its backward: p = exp2(s2 - lse * log2(e)) over the visible keys, then
//     as the packed backward with inv = 1.
//
// Two kinds of kernel. The packed attention of the training step and of
// the evaluation forward (B1 / B6a, B6b, B8), B7's forward at every length,
// and B7's backward while its rows fit one key tile (Lq, Lk <= 128: the text
// tower), run every product
// on the tensor cores as 3xTF32 (tf32_frags.cuh: mma.sync m16n8k8, each fp32
// operand split once into hi and lo as it enters registers, the lo x lo
// product dropped; each step's three products summed in a fresh
// accumulator and added in fp32, since the tensor core truncates what it
// accumulates): at least as close to a float64 attention as torch's fp32
// matmuls (tests/test_torch_attention_f32.py holds that under an emulation
// that truncates as the tensor core does), where one TF32 product alone
// rounds each operand to a 10-bit mantissa (~5e-4 relative), which an fp32
// run must not see. B7's backward past 128 rows runs as fp32 FMA on 64 x 64
// shared tiles. The attention of the w8a8 fusion's fp32
// forms (B4, B11, B12) runs as fp32 FMA too, every sum in one fixed order:
// each score over the head columns and each numerator over the keys one
// fmaf after another from 0, the denominator a pairwise tree over each key
// tile, the tiles in order (the int8 out-projection behind them quantizes
// each attention row, and its limits, chip_smoke's F32_W8A8_LIMITS, hold
// the row's scale to within ulps of the plain version's, which other sums
// move: on an H100 the 3xTF32 forward put more than the limit's 5% of B4's
// outputs beyond 2 ulp, a denominator summed key after key 7.7%, the tree
// 0.5%). B11's
// score product is exact in any order (every partial sum an integer of at
// most 127^2 * 64 = 1,032,256 < 2^24), so it runs on the int8 tensor cores
// (mma.sync m16n8k32 s8) and equals the plain version's fp32 sums bit for
// bit. The exp2 is ex2.approx.ftz (at most 2 ulp; results below 2^-126
// flush to 0), as in the bf16 forms.
//
// What bounds it on an H100 SXM (data-sheet figures, not measured) at the
// training shape B = 16 clips x 8 frames = 128, Lq = 197, Lk = 214, H = 12:
// the packed forward does two products per score entry, 16.6 GFLOP, 0.100
// ms as 3xTF32 at 495 TFLOP/s (0.247 ms as fp32 FMA at 67), against 161 MB
// of q, k, v and o, 0.048 ms at 3.35 TB/s; the backward five products,
// 41.4 GFLOP, 0.251 ms as 3xTF32, against 0.19 ms of bytes.
//
// The 3xTF32 packed forward (B1 / B6a; the first launch of B8): one block
// of 4 warps per (64 query rows, head, batch row), 16 query rows a warp (a
// warp whose rows all lie past Lq only helps load). A warp loads its q
// rows once and splits them into hi / lo A fragments that stay in
// registers. Key / value tiles of 64 rows reach shared memory by cp.async
// through two stages, the next tile in flight while the current one is
// used. The keys go by chunks of 8 (214 keys compute 216), four chunks at
// a time: s = q k^T for the four, then per chunk e = exp2(min(s c, 110)),
// masked past Lk and summed into den in registers, and o += e v with e as
// the A operand straight from the score accumulator. A k8 fragment's k
// indices do not line up with an m16n8 accumulator's columns, so V's rows
// are re-indexed instead: k index t reads key 2t of the chunk and t + 4 key
// 2t + 1, which lines the accumulator's c0, c2, c1, c3 up with a0..a3.
//
// B7's forward (the same kernel, packed_fwd_kernel<true>), at every length:
// the streaming function, its keys in steps of kStreamChunks chunks (16
// keys), two blocks to an SM. Per step a warp masks its scores s c to -inf
// (past Lk and, under the causal mask, past the row), takes each row's max
// over the step and the quad of lanes that shares the row (two shuffles),
// rescales the running sum and the o accumulator by exp2(m_old - m_new),
// then adds p = exp2(s c - m) into the sum and p v into o as above. A step
// whose chunks all hold a key is compiled without the tests of each chunk,
// so that its loads and products interleave (on an H100 the tested step
// takes 1.23x / 1.30x as long at the two shapes below). Under the causal
// mask a block stops at the key tile of its last row and a warp at the
// chunk of its own last row's key, and the grid's x runs backwards, so that
// the blocks with the most key tiles start first. At the text tower's 15
// prompts x 77 tokens x 8 heads it moves 9.5 MB (0.0028 ms at 3.35 TB/s)
// for 92 MFLOP of visible scores (0.0006 ms as 3xTF32): bytes, and at 240
// blocks, one wave on 132 SMs, launch and latency in fact; at (4, 1024,
// 1024, 8) causal 4.3 GFLOP, 0.026 ms as 3xTF32, against 0.010 ms of
// bytes. Its first form took 64 x 64 tiles as fp32 FMA, each key and value
// tile loaded synchronously behind three barriers, and e^T written back to
// shared memory before its AV product.
//
// The 3xTF32 packed backward (B6b; the second launch of B8): one launch,
// one block of 8 warps per (batch row, head) owning every query row and
// every key of it, so all three sums run inside it in a fixed order: no
// atomics, the same bits on every run (packed_attention_bwd.cuh's design in
// bf16). It first takes each query row's inv_d = 1 / max(den, 1e-30) and
// delta = rowsum(do * o), a warp a row, then walks key tiles of 128 keys
// (16 a warp) and, inside each, query tiles of 32 rows (the last cut to 16:
// Lq = 197 computes 208 rows). Per step each warp forms its 16 x 32
// TRANSPOSED tiles k q^T and v do^T, p = e * inv_d (0 past Lk) and ds = p *
// (dp - delta), and adds p^T do into dv and ds^T q into dk, both held in
// registers for the key tile (p and ds enter as A operands by the forward's
// re-indexing, with the query rows as k); it writes ds^T to shared memory,
// and after a barrier the warps split the query tile's dq rows (16 rows x
// 16 columns a warp) and add ds k into the block-private fp32 dq
// accumulator: five products per score entry. The accumulator and the
// rows' inv_d and delta (74 floats a query row) sit in dynamic shared
// memory beside the fixed 154 KB of tiles while Lq <= 240; past that in a
// block-private region of a global scratch, the blocks then walking the
// (b, h) pairs with a grid stride (ops/flash_attention.attention_f32_plan
// computes the plan from the layout attention_f32_layout exports). Tiles
// come in by cp.async: key tiles and query / do tiles through two stages
// each, the next step's in flight; the value tile, read only by the scores,
// through one, the next key tile's issued as soon as the last step of the
// current one has taken its scores.
//
// B7's backward in one launch (the same kernel, packed_bwd_kernel<true>):
// at the text tower's 15 prompts x 77 tokens x 8 heads it moves 19 MB
// (0.0057 ms at 3.35 TB/s) for 0.23 GFLOP of visible scores (0.0014 ms as
// 3xTF32): bytes, and at 120 blocks, one wave on 132 SMs, launch and
// latency in fact. Its first form, the two FMA kernels below, rebuilt q k^T
// and do v^T in both (seven products a score entry) and passed each row's
// delta and statistic through a scratch. Here one block per (batch row,
// head) walks the one key tile with the packed backward's steps: the row
// slot of inv_d holds st = lse log2 e, p = exp2(s c - st), 0 past Lk, past
// Lq and, under the causal mask, for a key past its row; delta = rowsum(do
// o) as there; five products a score entry in a fixed order, no scratch and
// the same bits on every run. Under the causal mask a warp whose 16 keys
// all lie past the query tile's last row skips the tile (its p and ds are 0
// and its ds^T is never read), and a slab's dq sum stops at the chunk of its
// last row's key. Rows past 128 keep the two FMA kernels: a block per (b, h)
// would leave most SMs idle there.
//
// The FMA tiles (B7's backward past 128 rows): every product is a 64 x 64
// x 64 product of tiles in shared memory, 256 threads (16 x 16) each
// holding a 4 x 4 patch of the result, 64 rank-1 steps from two float4
// loads. Both operands are stored with the summed index as the row
// ("x-major"): a tile of q, k, v or do is stored transposed (loader load_t,
// conflict-free: a warp writes 16 rows x 2 float4 into distinct banks)
// where its head columns are summed, and as it is (load_n) where its rows
// are. A dq kernel (ops/flash_attention.attention_f32_plan 'two_kernels'),
// one block per (64 query rows, head, batch row), walks the key tiles; it
// first takes each row's delta and statistic and leaves them in a scratch
// buffer for the dk / dv kernel, one block per (64 keys, head, batch row),
// which walks the query tiles from the key tile's own. Each owns its output
// tile: no atomics. Under the causal mask the dq kernel stops at its last
// row's key.
//
// The w8a8 fusion's fp32 attention (fma_fwd_kernel; B4, B11, B12): one
// block of 7 warps per (112 query rows, head, batch row), 16 rows a warp,
// two blocks an SM; a warp whose rows all lie past Lq only helps load, so
// the rows computed are Lq rounded up to 16 (197: 208). The block's q rows
// come in once by cp.async, then key and value tiles of 64 rows, each in
// one buffer: the next key tile is issued when every warp has taken its
// scores and lands during the AV product, the value tile is issued when
// the AV product of the one before is done and lands during the scores;
// two barriers a tile. A tile's work stops at its last eighth of keys with
// a real key (214 keys compute 216). Per tile a warp forms its 16 x 64
// scores as 4 x 8 patches a thread (rows rl + 4 i, keys cl + 8 j, lane 8
// rl + cl: twelve float4 loads feed 128 fmaf, the q loads broadcast to the
// eight lanes of a row group), e = exp2(min(s c, 110)) into its own e rows
// in shared memory, each row's sum of the tile's e as a pairwise tree (lane
// r and r + 16 row r, a half each), then the AV product as 4 x 8 patches (rows rl + 4 i, columns 4 cl + n and
// 32 + 4 cl + n). The int8 form codes the block's q rows once and each key
// tile once (four threads a row) into rows of bytes and takes the scores
// from mma.sync m16n8k32 s8, the q codes held as A fragments for every
// tile; its check entry runs the same kernel with the exp2 arguments
// written out in place of the AV product. The two-source form picks each
// key row's source where its copy is issued, so its tiles, sums and bits
// are those of the one-source form on [k1; k2].
// Launches on the caller's stream, no sync, no allocation (the wrapper
// allocates the outputs and the scratch).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_frags.cuh"

namespace {

constexpr int kHD = 64;                  // head dim the kernels are built for
constexpr float kClamp = 110.f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the FMA tiles
constexpr int kT = 64;                   // query rows or keys of a tile
constexpr int kLD = kT + 4;              // padded shared row: 272 bytes, 16-byte aligned
constexpr int kTileFloats = kHD * kLD;   // one 64 x 64 tile, either orientation
constexpr int kThreads = 256;            // 16 x 16 threads, a 4 x 4 patch each
// dynamic shared bytes: the dq kernel's q^T, do^T, k^T, k, v^T, ds^T and
// two floats a row; the dk / dv kernel's k^T, v^T, q^T, do^T, q, do, p, ds
// and two floats a row
constexpr int kDqSmemBytes = 6 * kTileFloats * 4 + 2 * kT * 4;
constexpr int kDkvSmemBytes = 8 * kTileFloats * 4 + 2 * kT * 4;
// the 3xTF32 tiles: rows of 64 floats padded to 68 (272 bytes, 16-byte
// aligned; a fragment's 32 reads fall in 32 banks)
constexpr int kLDF = kHD + 4;
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdRows = kFwdWarps * 16;   // query rows of a forward block
constexpr int kFwdKeys = 64;               // keys of a forward key / value tile
constexpr int kFwdStageFloats = 2 * kFwdKeys * kLDF;
constexpr int kPFwdSmemBytes = 2 * kFwdStageFloats * 4;
// chunks of 8 keys per step of B7's forward: its scores masked, its row
// max taken and the running sums rescaled once for them (a quarter of a
// key tile: on an H100 faster than half or the whole tile at the text
// tower's shape and at 1,024 keys)
constexpr int kStreamChunks = 2;
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdKeys = kBwdWarps * 16;   // keys of a backward key tile, 16 a warp
constexpr int kBwdRows = 32;               // query rows of a backward query tile
constexpr int kLDD = kBwdRows + 4;         // floats per ds^T row
constexpr int kAccLD = kHD + 8;            // floats per dq accumulator row
// backward shared memory (floats): key stages | value tile | q, do stages |
// ds^T | (shared form) dq accumulator, inv_d, delta
constexpr int kOffV = 2 * kBwdKeys * kLDF;
constexpr int kOffQD = kOffV + kBwdKeys * kLDF;
constexpr int kOffDS = kOffQD + 4 * kBwdRows * kLDF;
constexpr int kBwdFixedBytes = (kOffDS + kBwdKeys * kLDD) * 4;
constexpr int kMaxSmem = 232448;
// the most query rows and keys the streaming backward takes in one launch
// (one key tile; ops/flash_attention.attention_f32_plan's 'one_launch')
constexpr int kStreamBwdRows = kBwdKeys;
// the w8a8 fusion's fp32 attention (B4, B11, B12): warps of 16 query rows
// each, key / value tiles of 64 rows, a warp's e rows of 64 floats padded
// to 72 (a warp's stores of one e value a lane fall in 32 banks), int8
// codes rows of 64 bytes padded to 80 (an mma fragment's 32 word loads
// fall in 32 banks)
constexpr int kFmaWarps = 7;
constexpr int kFmaThreads = kFmaWarps * 32;
constexpr int kFmaRows = kFmaWarps * 16;   // query rows of a block
constexpr int kFmaKeys = 64;               // keys of a key / value tile
constexpr int kLDE = kFmaKeys + 8;
constexpr int kLDC = 80;
// its shared memory (bytes): q rows | key tile | value tile | each warp's
// e rows | q and key row scales | q and key codes
constexpr int kFmaOffK = kFmaRows * kLDF * 4;
constexpr int kFmaOffV = kFmaOffK + kFmaKeys * kLDF * 4;
constexpr int kFmaOffE = kFmaOffV + kFmaKeys * kLDF * 4;
constexpr int kFmaOffS = kFmaOffE + kFmaWarps * 16 * kLDE * 4;
constexpr int kFmaOffC = kFmaOffS + (kFmaRows + kFmaKeys) * 4;
constexpr int kFmaSmemBytes = kFmaOffC + (kFmaRows + kFmaKeys) * kLDC;

// floats a block's dq accumulator and row statistics take at lq_pad rows
__host__ __device__ constexpr long long acc_floats(int lq_pad) {
  return static_cast<long long>(lq_pad) * (kAccLD + 2);
}

// 2^x in one MUFU instruction (see attention_pipe.cuh's ex2f)
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The rows of one head: rows [0, L1) at p1 (row stride ld1), rows [L1, L)
// at p2 + (row - L1) * ld2 (the second source; L1 = L for one source)
struct Rows {
  const float *p1, *p2;
  long long ld1, ld2;
  int L1, L;
  __device__ __forceinline__ const float* row(int r) const {
    return r < L1 ? p1 + r * ld1 : r < L ? p2 + (r - L1) * ld2 : nullptr;
  }
};

__device__ __forceinline__ Rows one_source(const float* p, int L, long long ld) {
  return Rows{p, nullptr, ld, 0, L, L};
}

struct FwdArgs {
  const float *q, *k, *v;
  float* o;
  float* stat;   // den (B, Lq, H) in the packed form (may be null), lse (B, H, Lq) streaming
  int Lq, Lk, H;
  int q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl;
  float c;       // 64^-0.5 * log2(e); 1 in the int8 form (its scales carry c)
  int causal;
  // the int8 form: c / 127^2; the two-source form: the second source and
  // the first source's key count (L1 = Lk for one source)
  float cq;
  const float *k2, *v2;
  int L1, k2_sb, k2_sl, v2_sb, v2_sl;
};

// ---------------------------------------------------------------------------
// the packed attention on the tensor cores (B1 / B6a, B6b, B8)
// ---------------------------------------------------------------------------

// rows [r0, r0 + ROWS) of one head (64 floats a row) into a shared tile of
// kLDF floats a row by cp.async, issued by a block of THREADS; rows past the
// source's end are zero-filled
template <int ROWS, int THREADS>
__device__ __forceinline__ void tile_async(float* dst, const Rows& src, int r0) {
  static_assert(ROWS * 16 % THREADS == 0, "whole 16-byte pieces a thread");
#pragma unroll
  for (int it = 0; it < ROWS * 16 / THREADS; ++it) {
    const int idx = it * THREADS + threadIdx.x;
    const int r = idx >> 4, c = (idx & 15) * 4;
    const float* p = src.row(r0 + r);
    tf32::cp_async16(dst + r * kLDF + c, p != nullptr ? p + c : src.p1, p != nullptr);
  }
}

// d += a b in 3xTF32: a = ah + al and b = bh + bl as tf32::split gives
// them, the lo x lo product dropped. The three products are summed in a
// fresh accumulator, the two of a lo part first, and added to d in fp32:
// the tensor core truncates the sum it accumulates, which over a chain of
// products into d would drift by about an ulp of d a step, where the fp32
// add rounds to nearest
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  float p[4];
  tf32::mma_tf32_z(p, al, bh0, bh1);
  tf32::mma_tf32(p, ah, bl0, bl1);
  tf32::mma_tf32(p, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// an A fragment (a0..a3 in order) split into hi and lo
__device__ __forceinline__ void split4(uint32_t (&hi)[4], uint32_t (&lo)[4], float a0,
                                       float a1, float a2, float a3) {
  tf32::split(a0, hi[0], lo[0]);
  tf32::split(a1, hi[1], lo[1]);
  tf32::split(a2, hi[2], lo[2]);
  tf32::split(a3, hi[3], lo[3]);
}

// B1 / B6a in 3xTF32 (STREAM false): o (and, with a.stat, den) of one
// block's 64 query rows of one head. B7's forward (STREAM true): o and lse,
// the weights taken against a running max, masked past Lk and, with
// a.causal, past each row; two blocks to an SM (its registers do not spill,
// where three blocks' 168 a thread did)
template <bool STREAM>
__global__ void __launch_bounds__(kFwdThreads, STREAM ? 2 : 3) packed_fwd_kernel(FwdArgs a) {
  constexpr int GC = STREAM ? kStreamChunks : 4;   // chunks of 8 keys a step
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const bool causal = STREAM && a.causal;
  // (causal) the grid's x backwards: the blocks with the most key tiles first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = qt * kFwdRows + warp * 16;            // the warp's first query row
  const int r0 = w0 + g, r1 = r0 + 8;                  // the thread's two rows
  const int wlast = min(w0 + 15, a.Lq - 1);            // the warp's last real row
  const bool active = w0 < a.Lq;
  const long long hoff = static_cast<long long>(h) * kHD;
  const float* qb = a.q + static_cast<long long>(b) * a.q_sb + hoff;
  const Rows krows = one_source(a.k + static_cast<long long>(b) * a.k_sb + hoff, a.Lk, a.k_sl);
  const Rows vrows = one_source(a.v + static_cast<long long>(b) * a.v_sb + hoff, a.Lk, a.v_sl);
  // (causal) no row of the block sees a key past its last row
  const int kend = causal ? min(a.Lk, (qt + 1) * kFwdRows) : a.Lk;
  const int nkt = (kend + kFwdKeys - 1) / kFwdKeys;
  auto issue = [&](int kt) {
    if (kt < nkt) {
      float* st = smem + (kt & 1) * kFwdStageFloats;
      tile_async<kFwdKeys, kFwdThreads>(st, krows, kt * kFwdKeys);
      tile_async<kFwdKeys, kFwdThreads>(st + kFwdKeys * kLDF, vrows, kt * kFwdKeys);
    }
    tf32::cp_commit();
  };
  issue(0);

  // the warp's q rows as A fragments, split once: k step kk holds columns
  // 8 kk + t (a0 row r0, a1 row r1) and 8 kk + t + 4 (a2, a3); zeros past Lq
  uint32_t qh[kHD / 8][4], ql[kHD / 8][4];
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i & 1 ? r1 : r0;
      x[i] = r < a.Lq ? qb[r * a.q_sl + 8 * kk + t + 4 * (i >> 1)] : 0.f;
    }
    split4(qh[kk], ql[kk], x[0], x[1], x[2], x[3]);
  }

  float oacc[kHD / 8][4];
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // den (streaming: the running sum l) and the running max of rows r0, r1
  float den0 = 0.f, den1 = 0.f, m0 = -INFINITY, m1 = -INFINITY;
  for (int kt = 0; kt < nkt; ++kt) {
    tf32::cp_wait_all();
    __syncthreads();   // tile kt is in; every warp is done with the other stage
    issue(kt + 1);
    if (!active) continue;
    const float* ks = smem + (kt & 1) * kFwdStageFloats;
    const float* vs = ks + kFwdKeys * kLDF;
    const int k0 = kt * kFwdKeys;
    // chunks of 8 keys with a real key (the last tile's others are skipped)
    int nch = (min(kFwdKeys, a.Lk - k0) + 7) / 8;
    // (causal) and with a key at or before the warp's last row
    if (causal) nch = wlast < k0 ? 0 : min(nch, (wlast - k0) / 8 + 1);
    // a step of GC chunks from chunk GC * c4 on; FULL (streaming, each of
    // them has a key to take) compiles without the tests of each chunk, so
    // that the step's loads and products interleave (the packed form keeps
    // the tests: without them its registers spill)
    auto step = [&](auto full, int c4) {
      constexpr bool FULL = decltype(full)::value;
      // s = q k^T for GC chunks: B fragment of chunk c from key c * 8 + g
      float s[GC][4];
#pragma unroll
      for (int j = 0; j < GC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHD / 8; ++kk) {
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          if (FULL || GC * c4 + j < nch) {
            const float* kr = ks + ((GC * c4 + j) * 8 + g) * kLDF + 8 * kk + t;
            uint32_t bh0, bl0, bh1, bl1;
            tf32::split(kr[0], bh0, bl0);
            tf32::split(kr[4], bh1, bl1);
            mma3(s[j], qh[kk], ql[kk], bh0, bh1, bl0, bl1);
          }
        }
      }
      // (streaming) s c masked to -inf; the rows' max over these chunks and
      // the quad that shares each row; den and o rescaled to it
      float mu0 = 0.f, mu1 = 0.f;
      if (STREAM) {
        float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          if (!FULL && GC * c4 + j >= nch) break;
          const int kc = k0 + (GC * c4 + j) * 8 + 2 * t;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = kc + (i & 1), row = i < 2 ? r0 : r1;
            const bool vis = key < a.Lk && (!a.causal || key <= row);
            s[j][i] = vis ? s[j][i] * a.c : -INFINITY;
          }
          mt0 = fmaxf(mt0, fmaxf(s[j][0], s[j][1]));
          mt1 = fmaxf(mt1, fmaxf(s[j][2], s[j][3]));
        }
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
        const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
        // a row with no visible key yet takes 0 (its weights are 0)
        mu0 = mn0 == -INFINITY ? 0.f : mn0;
        mu1 = mn1 == -INFINITY ? 0.f : mn1;
        const float al0 = ex2f(m0 - mu0), al1 = ex2f(m1 - mu1);   // 0 while m is -inf
        den0 *= al0;
        den1 *= al1;
#pragma unroll
        for (int n = 0; n < kHD / 8; ++n) {
          oacc[n][0] *= al0;
          oacc[n][1] *= al0;
          oacc[n][2] *= al1;
          oacc[n][3] *= al1;
        }
        m0 = mn0;
        m1 = mn1;
      }
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        if (!FULL && GC * c4 + j >= nch) break;
        // the tile's keys of the accumulator's columns 2t (c0, c2) and 2t + 1
        const int kc = (GC * c4 + j) * 8 + 2 * t;
        float e[4];
        if (STREAM) {
#pragma unroll
          for (int i = 0; i < 4; ++i) e[i] = ex2f(s[j][i] - (i < 2 ? mu0 : mu1));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            e[i] = k0 + kc + (i & 1) < a.Lk ? ex2f(fminf(s[j][i] * a.c, kClamp)) : 0.f;
        }
        den0 += e[0] + e[1];
        den1 += e[2] + e[3];
        // e as the A operand of e v: k index t is key kc, t + 4 key kc + 1
        uint32_t eh[4], el[4];
        split4(eh, el, e[0], e[2], e[1], e[3]);
        const float* vr = vs + kc * kLDF + g;
#pragma unroll
        for (int n = 0; n < kHD / 8; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          tf32::split(vr[8 * n], bh0, bl0);
          tf32::split(vr[kLDF + 8 * n], bh1, bl1);
          mma3(oacc[n], eh, el, bh0, bh1, bl0, bl1);
        }
      }
    };
#pragma unroll
    for (int c4 = 0; c4 < kFwdKeys / (8 * GC); ++c4) {
      if (GC * c4 >= nch) break;
      if (STREAM && GC * (c4 + 1) <= nch)
        step(std::true_type{}, c4);
      else
        step(std::false_type{}, c4);
    }
  }

  // den: the four threads of a row in a fixed order
  den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
  den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 2);
  if (!active) return;
  float* ob = a.o + static_cast<long long>(b) * a.o_sb + hoff;
  // (streaming) every row sees key 0: l > 0
  const float d0 = STREAM ? den0 : fmaxf(den0, 1e-30f);
  const float d1 = STREAM ? den1 : fmaxf(den1, 1e-30f);
#pragma unroll
  for (int n = 0; n < kHD / 8; ++n) {
    if (r0 < a.Lq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(r0) * a.o_sl + 8 * n + 2 * t) =
          make_float2(oacc[n][0] / d0, oacc[n][1] / d0);
    if (r1 < a.Lq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(r1) * a.o_sl + 8 * n + 2 * t) =
          make_float2(oacc[n][2] / d1, oacc[n][3] / d1);
  }
  if (a.stat != nullptr && t == 0) {
    if (STREAM) {
      // lse (B, H, Lq) = (m + log2 l) ln 2
      float* lse = a.stat + (static_cast<long long>(b) * a.H + h) * a.Lq;
      if (r0 < a.Lq) lse[r0] = (m0 + log2f(den0)) * kLn2;
      if (r1 < a.Lq) lse[r1] = (m1 + log2f(den1)) * kLn2;
    } else {
      if (r0 < a.Lq) a.stat[(static_cast<long long>(b) * a.Lq + r0) * a.H + h] = den0;
      if (r1 < a.Lq) a.stat[(static_cast<long long>(b) * a.Lq + r1) * a.H + h] = den1;
    }
  }
}

struct PBwdArgs {
  const float *q, *k, *v, *dout, *o;
  const float* rowstat;   // den (B, Lq, H); the streaming form: lse (B, H, Lq)
  float *dq, *dk, *dv;
  float* scratch;     // the global form: gridDim.x regions of acc_floats(lq_pad)
  int B, Lq, Lk, H, lq_pad, acc_in_smem;
  int q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;   // do and o: (B, Lq, H*64) contiguous
  float scale, c;
  int causal;         // the streaming form only
};

// STREAM false: B6b (and B8's second launch), p = e * inv_d from den, the
// clamp. STREAM true: B7's backward, p = exp2(s c - lse log2 e) from the
// saved log-sum-exp, 0 past Lq and, under the causal mask, for a key past
// its row; a warp whose keys all lie past the query tile's last row skips
// the tile, and the dq sums stop at a slab's last row's key.
template <bool STREAM>
__global__ void __launch_bounds__(kBwdThreads, 1) packed_bwd_kernel(PBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* k_st = smem;               // [stage][kBwdKeys][kLDF]
  float* v_s = smem + kOffV;        // [kBwdKeys][kLDF]
  float* qd_st = smem + kOffQD;     // [stage][q, do][kBwdRows][kLDF]
  float* ds_s = smem + kOffDS;      // ds^T [kBwdKeys][kLDD]
  float* acc = a.acc_in_smem ? ds_s + kBwdKeys * kLDD
                             : a.scratch + blockIdx.x * acc_floats(a.lq_pad);
  float* st_s = acc + static_cast<long long>(a.lq_pad) * kAccLD;   // inv_d, or lse log2 e
  float* dl_s = st_s + a.lq_pad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long D = static_cast<long long>(a.H) * kHD;
  const int KTn = (a.Lk + kBwdKeys - 1) / kBwdKeys;
  const int QTn = (a.lq_pad + kBwdRows - 1) / kBwdRows;
  const int nsteps = KTn * QTn;

  for (int item = blockIdx.x; item < a.B * a.H; item += gridDim.x) {
    const int b = item / a.H, h = item % a.H;
    const long long hoff = static_cast<long long>(h) * kHD;
    const float* qb = a.q + static_cast<long long>(b) * a.q_sb + hoff;
    const float* kb = a.k + static_cast<long long>(b) * a.k_sb + hoff;
    const float* vb = a.v + static_cast<long long>(b) * a.v_sb + hoff;
    const float* dob = a.dout + static_cast<long long>(b) * a.Lq * D + hoff;
    const float* obb = a.o + static_cast<long long>(b) * a.Lq * D + hoff;
    // a query row r's statistic: rowstat[r * st_r]
    const float* statb = STREAM ? a.rowstat + (static_cast<long long>(b) * a.H + h) * a.Lq
                                : a.rowstat + static_cast<long long>(b) * a.Lq * a.H + h;
    const long long st_r = STREAM ? 1 : a.H;
    const Rows qrows = one_source(qb, a.Lq, a.q_sl), dorows = one_source(dob, a.Lq, D);
    const Rows krows = one_source(kb, a.Lk, a.k_sl), vrows = one_source(vb, a.Lk, a.v_sl);

    // the copies of step s, issued after the barrier that opens step s - 1
    // (the stages they overwrite are free): its q / do tile, and its key
    // tile where it starts one (step 0: the first value tile too)
    auto issue = [&](int s) {
      if (s < nsteps) {
        const int j = s / QTn, qt = s % QTn;
        float* qd = qd_st + (s & 1) * 2 * kBwdRows * kLDF;
        tile_async<kBwdRows, kBwdThreads>(qd, qrows, qt * kBwdRows);
        tile_async<kBwdRows, kBwdThreads>(qd + kBwdRows * kLDF, dorows, qt * kBwdRows);
        if (qt == 0)
          tile_async<kBwdKeys, kBwdThreads>(k_st + (j & 1) * kBwdKeys * kLDF, krows,
                                            j * kBwdKeys);
        if (s == 0) tile_async<kBwdKeys, kBwdThreads>(v_s, vrows, 0);
      }
      tf32::cp_commit();
    };
    issue(0);

    // while the first tiles are in flight: zero the dq accumulator, and
    // take each query row's inv_d (streaming: lse log2 e) and delta =
    // rowsum(do * o), a warp a row (0 for the rows past Lq, whose p and ds
    // are then 0)
    for (long long i = threadIdx.x * 4; i < static_cast<long long>(a.lq_pad) * kAccLD;
         i += kBwdThreads * 4)
      *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = warp; r < a.lq_pad; r += kBwdWarps) {
      float d = 0.f;
      if (r < a.Lq) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long at = r * D + half * 32 + lane;
          d = fmaf(dob[at], obb[at], d);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) {
        float st = 0.f;
        if (r < a.Lq) {
          const float x = statb[r * st_r];
          st = STREAM ? x * kLog2e : 1.f / fmaxf(x, 1e-30f);
        }
        st_s[r] = st;
        dl_s[r] = d;
      }
    }

    float dk[kHD / 8][4], dv[kHD / 8][4];
#pragma unroll
    for (int n = 0; n < kHD / 8; ++n) {
      dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
      dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
    }
    for (int s = 0; s < nsteps; ++s) {
      tf32::cp_wait_all();
      __syncthreads();
      issue(s + 1);
      const int j = s / QTn, qt = s % QTn, k0 = j * kBwdKeys, q0 = qt * kBwdRows;
      const int nq = min(kBwdRows, a.lq_pad - q0);   // 16 or 32
      const float* ks = k_st + (j & 1) * kBwdKeys * kLDF;
      const float* qs = qd_st + (s & 1) * 2 * kBwdRows * kLDF;
      const float* dos = qs + kBwdRows * kLDF;
      const int kw = k0 + warp * 16;   // this warp's first key
      // (streaming, causal) no row of the query tile sees this warp's keys
      const bool hidden = STREAM && a.causal && kw > q0 + nq - 1;
      if (kw < a.Lk && !hidden) {
        const bool kv0 = kw + g < a.Lk, kv1 = kw + g + 8 < a.Lk;
        // transposed tiles: rows are this warp's keys kw + g (c0, c1) and
        // kw + g + 8 (c2, c3), columns the query rows q0 + 8 f + 2 t, + 1
        float sT[kBwdRows / 8][4], dpT[kBwdRows / 8][4];
#pragma unroll
        for (int f = 0; f < kBwdRows / 8; ++f) {
          sT[f][0] = sT[f][1] = sT[f][2] = sT[f][3] = 0.f;
          dpT[f][0] = dpT[f][1] = dpT[f][2] = dpT[f][3] = 0.f;
        }
        const float* kr = ks + (warp * 16 + g) * kLDF + t;
        const float* vr = v_s + (warp * 16 + g) * kLDF + t;
#pragma unroll
        for (int kk = 0; kk < kHD / 8; ++kk) {
          uint32_t kh[4], kl[4], vh[4], vl[4];
          split4(kh, kl, kr[8 * kk], kr[8 * kLDF + 8 * kk], kr[8 * kk + 4],
                 kr[8 * kLDF + 8 * kk + 4]);
          split4(vh, vl, vr[8 * kk], vr[8 * kLDF + 8 * kk], vr[8 * kk + 4],
                 vr[8 * kLDF + 8 * kk + 4]);
#pragma unroll
          for (int f = 0; f < kBwdRows / 8; ++f) {
            if (8 * f < nq) {
              const float* qr = qs + (8 * f + g) * kLDF + 8 * kk + t;
              const float* dr = dos + (8 * f + g) * kLDF + 8 * kk + t;
              uint32_t bh0, bl0, bh1, bl1;
              tf32::split(qr[0], bh0, bl0);
              tf32::split(qr[4], bh1, bl1);
              mma3(sT[f], kh, kl, bh0, bh1, bl0, bl1);   // k q^T
              tf32::split(dr[0], bh0, bl0);
              tf32::split(dr[4], bh1, bl1);
              mma3(dpT[f], vh, vl, bh0, bh1, bl0, bl1);  // v do^T
            }
          }
        }
        // per 8 query rows: p and ds, ds^T into shared memory, dv += p^T do
        // and dk += ds^T q with the query rows as k (k index t: row 2t of
        // the chunk, c0 / c2; t + 4: row 2t + 1, c1 / c3)
#pragma unroll
        for (int f = 0; f < kBwdRows / 8; ++f) {
          if (8 * f < nq) {
            const int qc = q0 + 8 * f + 2 * t;
            const float st[2] = {st_s[qc], st_s[qc + 1]};
            const float dl[2] = {dl_s[qc], dl_s[qc + 1]};
            float p[4], ds[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const bool kv = i < 2 ? kv0 : kv1;
              if (STREAM) {
                // key kw + g (+ 8 for c2, c3), query row qc (+ 1 for c1, c3)
                const int key = kw + g + 8 * (i >> 1), row = qc + (i & 1);
                const bool vis = kv && row < a.Lq && (!a.causal || key <= row);
                p[i] = vis ? ex2f(sT[f][i] * a.c - st[i & 1]) : 0.f;
              } else {
                p[i] = kv ? ex2f(fminf(sT[f][i] * a.c, kClamp)) * st[i & 1] : 0.f;
              }
              ds[i] = p[i] * (dpT[f][i] - dl[i & 1]);
            }
            *reinterpret_cast<float2*>(ds_s + (warp * 16 + g) * kLDD + 8 * f + 2 * t) =
                make_float2(ds[0], ds[1]);
            *reinterpret_cast<float2*>(ds_s + (warp * 16 + g + 8) * kLDD + 8 * f + 2 * t) =
                make_float2(ds[2], ds[3]);
            uint32_t ph[4], pl[4], dh[4], dlo[4];
            split4(ph, pl, p[0], p[2], p[1], p[3]);
            split4(dh, dlo, ds[0], ds[2], ds[1], ds[3]);
            const float* dor = dos + (8 * f + 2 * t) * kLDF + g;
            const float* qor = qs + (8 * f + 2 * t) * kLDF + g;
#pragma unroll
            for (int n = 0; n < kHD / 8; ++n) {
              uint32_t bh0, bl0, bh1, bl1;
              tf32::split(dor[8 * n], bh0, bl0);
              tf32::split(dor[kLDF + 8 * n], bh1, bl1);
              mma3(dv[n], ph, pl, bh0, bh1, bl0, bl1);    // dv += p^T do
              tf32::split(qor[8 * n], bh0, bl0);
              tf32::split(qor[kLDF + 8 * n], bh1, bl1);
              mma3(dk[n], dh, dlo, bh0, bh1, bl0, bl1);   // dk += ds^T q
            }
          }
        }
      }
      __syncthreads();   // ds^T is whole; no warp reads the value tile again
      if (qt == QTn - 1 && j + 1 < KTn) {
        tile_async<kBwdKeys, kBwdThreads>(v_s, vrows, (j + 1) * kBwdKeys);
        tf32::cp_commit();
      }

      // dq rows of this query tile += ds k: warp w takes 16 rows (w / 4)
      // and 16 head columns ((w % 4) * 16), the key chunks of 8 with a real
      // key as k (k index t: key 2t of the chunk, t + 4: key 2t + 1)
      {
        const int slab = warp >> 2, c0 = (warp & 3) * 16;
        if (16 * slab < nq) {
          int nkc = (min(kBwdKeys, a.Lk - k0) + 7) / 8;
          // (streaming, causal) the chunks with a key at or before the
          // slab's last row; the others' ds are 0 (or, a hidden warp's, not
          // written)
          if (STREAM && a.causal) nkc = min(nkc, (q0 + 16 * slab + 15 - k0 + 8) / 8);
          float dq[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
          for (int kc = 0; kc < kBwdKeys / 8; ++kc) {
            if (kc < nkc) {
              const float* dr = ds_s + (8 * kc + 2 * t) * kLDD + 16 * slab + g;
              uint32_t ah[4], al[4];
              split4(ah, al, dr[0], dr[8], dr[kLDD], dr[kLDD + 8]);
              const float* kr2 = ks + (8 * kc + 2 * t) * kLDF + c0 + g;
#pragma unroll
              for (int n = 0; n < 2; ++n) {
                uint32_t bh0, bl0, bh1, bl1;
                tf32::split(kr2[8 * n], bh0, bl0);
                tf32::split(kr2[kLDF + 8 * n], bh1, bl1);
                mma3(dq[n], ah, al, bh0, bh1, bl0, bl1);   // ds k
              }
            }
          }
          const int row = q0 + 16 * slab + g;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float* p0 = acc + static_cast<long long>(row) * kAccLD + c0 + 8 * n + 2 * t;
            float* p1 = p0 + 8 * kAccLD;
            float2 x0 = *reinterpret_cast<float2*>(p0), x1 = *reinterpret_cast<float2*>(p1);
            x0.x += dq[n][0];
            x0.y += dq[n][1];
            x1.x += dq[n][2];
            x1.y += dq[n][3];
            *reinterpret_cast<float2*>(p0) = x0;
            *reinterpret_cast<float2*>(p1) = x1;
          }
        }
      }

      // the key tile's last query tile: this warp's dk (scaled) and dv rows
      if (qt == QTn - 1 && kw < a.Lk) {
        float* dkb = a.dk + static_cast<long long>(b) * a.Lk * D + hoff;
        float* dvb = a.dv + static_cast<long long>(b) * a.Lk * D + hoff;
        const long long at0 = (kw + g) * D + 2 * t, at1 = at0 + 8 * D;
#pragma unroll
        for (int n = 0; n < kHD / 8; ++n) {
          if (kw + g < a.Lk) {
            *reinterpret_cast<float2*>(dkb + at0 + 8 * n) =
                make_float2(dk[n][0] * a.scale, dk[n][1] * a.scale);
            *reinterpret_cast<float2*>(dvb + at0 + 8 * n) = make_float2(dv[n][0], dv[n][1]);
          }
          if (kw + g + 8 < a.Lk) {
            *reinterpret_cast<float2*>(dkb + at1 + 8 * n) =
                make_float2(dk[n][2] * a.scale, dk[n][3] * a.scale);
            *reinterpret_cast<float2*>(dvb + at1 + 8 * n) = make_float2(dv[n][2], dv[n][3]);
          }
          dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
          dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
        }
      }
    }
    __syncthreads();   // every dq sum is in

    // dq = acc * scale
    float* dqb = a.dq + static_cast<long long>(b) * a.Lq * D + hoff;
    for (int idx = threadIdx.x; idx < a.Lq * (kHD / 4); idx += kBwdThreads) {
      const int r = idx / (kHD / 4), c = (idx % (kHD / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(acc + static_cast<long long>(r) * kAccLD + c);
      *reinterpret_cast<float4*>(dqb + r * D + c) =
          make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
    }
    __syncthreads();   // the next (b, h) zeroes the accumulator
  }
}

// ---------------------------------------------------------------------------
// fp32 FMA tiles: B7's backward past 128 rows
// ---------------------------------------------------------------------------

// Rows [r0, r0 + 64) of one head (64 floats a row) into a tile stored
// transposed, dst[d * kLD + r]; rows >= L are zeros and are never read. A
// warp loads 16 rows x 2 float4 (one 32-byte sector a row) and its stores
// fall in 32 distinct banks.
__device__ __forceinline__ void load_t(float* dst, const Rows& src, int r0) {
#pragma unroll
  for (int it = 0; it < kT * kHD / 4 / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int w = idx >> 5, l = idx & 31;
    const int r = (w & 3) * 16 + (l >> 1);
    const int c = ((w >> 2) * 2 + (l & 1)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (const float* p = src.row(r0 + r)) x = *reinterpret_cast<const float4*>(p + c);
    dst[(c + 0) * kLD + r] = x.x;
    dst[(c + 1) * kLD + r] = x.y;
    dst[(c + 2) * kLD + r] = x.z;
    dst[(c + 3) * kLD + r] = x.w;
  }
}

__device__ __forceinline__ void load_t(float* dst, const float* src, int r0, int L,
                                       long long ld) {
  load_t(dst, one_source(src, L, ld), r0);
}

// The same rows stored as they are, dst[r * kLD + d].
__device__ __forceinline__ void load_n(float* dst, const Rows& src, int r0) {
#pragma unroll
  for (int it = 0; it < kT * kHD / 4 / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx >> 4, c = (idx & 15) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (const float* p = src.row(r0 + r)) x = *reinterpret_cast<const float4*>(p + c);
    *reinterpret_cast<float4*>(dst + r * kLD + c) = x;
  }
}

__device__ __forceinline__ void load_n(float* dst, const float* src, int r0, int L,
                                       long long ld) {
  load_n(dst, one_source(src, L, ld), r0);
}

// acc[i][j] += sum over x < 64 of a[x][4 ty + i] * b[x][4 tx + j]: both
// operands x-major, fp32 FMA.
__device__ __forceinline__ void mm64(float (&acc)[4][4], const float* a, const float* b,
                                     int ty, int tx) {
#pragma unroll 8
  for (int x = 0; x < kT; ++x) {
    const float4 av = *reinterpret_cast<const float4*>(a + x * kLD + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(b + x * kLD + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// a thread's 4 x 4 patch, transposed, into an x-major tile: dst[4 tx + j][4 ty + i]
__device__ __forceinline__ void store_patch_t(float* dst, const float (&p)[4][4], int ty,
                                              int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (4 * tx + j) * kLD + 4 * ty) =
        make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
}

// ---------------------------------------------------------------------------
// the w8a8 fusion's attention in fp32 (B4, B11, B12): register-tiled FMA in
// the plain version's summation order
// ---------------------------------------------------------------------------

// rows [r0, r0 + n) of one head into a shared tile of kLDF floats a row by
// cp.async, issued by the block's kFmaThreads; rows past the source's end
// are zero-filled
__device__ __forceinline__ void rows_async(float* dst, const Rows& src, int r0, int n) {
  for (int idx = threadIdx.x; idx < n * 16; idx += kFmaThreads) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    const float* p = src.row(r0 + r);
    tf32::cp_async16(dst + r * kLDF + c, p != nullptr ? p + c : src.p1, p != nullptr);
  }
}

// The int8 form's codes of rows [0, n) of a shared tile (kLDF floats a row)
// into dst (kLDC bytes a row): four threads a row, 16 values each, their
// absmax met by two shuffles (n * 4 a multiple of 32: a warp takes whole
// rows); qs = max(absmax, 1e-6), code = rint(x * (127 / qs)) with an IEEE
// division; sc[r] = qs * mul (mul c / 127^2 for the q rows, 1 for the keys)
__device__ __forceinline__ void quant_rows(const float* t, int8_t* dst, float* sc, int n,
                                           float mul) {
  for (int idx = threadIdx.x; idx < n * 4; idx += kFmaThreads) {
    const int r = idx >> 2, part = idx & 3;
    float x[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(t + r * kLDF + part * 16 + 4 * i);
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) m = fmaxf(m, fabsf(x[i]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float qs = fmaxf(m, 1e-6f);
    const float inv = __fdiv_rn(127.f, qs);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t code = static_cast<int8_t>(rintf(__fmul_rn(x[4 * i + j], inv)));
        w[i] |= static_cast<uint32_t>(static_cast<uint8_t>(code)) << (8 * j);
      }
    }
    uint4 u;
    u.x = w[0];
    u.y = w[1];
    u.z = w[2];
    u.w = w[3];
    *reinterpret_cast<uint4*>(dst + r * kLDC + part * 16) = u;
    if (part == 0) sc[r] = __fmul_rn(qs, mul);
  }
}

// The int8 form's exp2 argument of one score: the exact integer product
// s32 times its rank-1 rescale, in the plain version's order, (s32 * (qs *
// (c / 127^2))) * ks; qf = qs * (c / 127^2)
__device__ __forceinline__ float qk8_arg(float s32, float qf, float ks) {
  return __fmul_rn(__fmul_rn(s32, qf), ks);
}

// acc + a . b as four fmaf, x first
__device__ __forceinline__ float dot4(float acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float part4(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// The fp32 scores of a warp's 16 query rows (qw, kLDF floats a row) against
// a key tile (kt): s[i][j] = q[rl + 4 i] . k[cl + 8 j], summed over the 64
// head columns one fmaf after another from 0, the first column first (the
// plain version's order); only the first nj eighths of the tile's keys
// (all of them when FULL)
template <bool FULL>
__device__ __forceinline__ void scores_fma(float (&s)[4][8], const float* qw, const float* kt,
                                           int rl, int cl, int nj) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kHD; d += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qw + (rl + 4 * i) * kLDF + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!FULL && j >= nj) break;
      const float4 kv = *reinterpret_cast<const float4*>(kt + (cl + 8 * j) * kLDF + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = dot4(s[i][j], qv[i], kv);
    }
  }
}

// e of those scores into the warp's e rows (ew, kLDE floats a row): exp2 of
// the clamped s c, 0 for a key past Lk (every eighth of the tile, those
// past nj too)
__device__ __forceinline__ void store_e(float* ew, const float (&s)[4][8], int rl, int cl,
                                        int k0, int Lk, float c) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool real = k0 + cl + 8 * j < Lk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ew[(rl + 4 * i) * kLDE + cl + 8 * j] = real ? ex2f(fminf(s[i][j] * c, kClamp)) : 0.f;
  }
}

// The sum of a tile's 64 e of one row as a pairwise tree, the half-warp
// lane's half of them (er: keys [32 h, 32 h + 32) of the row, lane 16 h + r
// its row r) and the two halves added: the same bits in both lanes
__device__ __forceinline__ float tile_sum(const float* er) {
  float p[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float4 e = *reinterpret_cast<const float4*>(er + 4 * m);
    p[m] = (e.x + e.y) + (e.z + e.w);
  }
  const float t = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
  return t + __shfl_xor_sync(0xffffffffu, t, 16);
}

// acc[i][n] += e[rl + 4 i][x] v[x][column n] over the tile's first nx keys
// (a multiple of 4), one fmaf after another in key order; column n of the
// thread: 4 cl + n for n < 4, 32 + 4 cl + n - 4 after
__device__ __forceinline__ void av_fma(float (&acc)[4][8], const float* ew, const float* vt,
                                       int rl, int cl, int nx) {
#pragma unroll 2
  for (int x = 0; x < nx; x += 4) {
    float4 ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ev[i] = *reinterpret_cast<const float4*>(ew + (rl + 4 * i) * kLDE + x);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 v0 = *reinterpret_cast<const float4*>(vt + (x + u) * kLDF + 4 * cl);
      const float4 v1 = *reinterpret_cast<const float4*>(vt + (x + u) * kLDF + 32 + 4 * cl);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = part4(ev[i], u);
        acc[i][0] = fmaf(e, v0.x, acc[i][0]);
        acc[i][1] = fmaf(e, v0.y, acc[i][1]);
        acc[i][2] = fmaf(e, v0.z, acc[i][2]);
        acc[i][3] = fmaf(e, v0.w, acc[i][3]);
        acc[i][4] = fmaf(e, v1.x, acc[i][4]);
        acc[i][5] = fmaf(e, v1.y, acc[i][5]);
        acc[i][6] = fmaf(e, v1.z, acc[i][6]);
        acc[i][7] = fmaf(e, v1.w, acc[i][7]);
      }
    }
  }
}

// B4's attention (B1's function on the FMA order), QK8 B11's (the int8
// score product), TWO B12's (keys and values from two sources), and ARGS
// the check of B11's codes and rescale (a.o = the exp2 arguments (B, H, Lq,
// Lk) of the int8 form's scores, before the clamp, by the same steps; no
// AV product). One block per (kFmaRows query rows, head, batch row), a warp
// per 16 of its rows; a warp whose rows all lie past Lq only helps load.
// Per key tile of 64: the warp's scores as 4 x 8 patches a thread (rows rl
// + 4 i, keys cl + 8 j; lane = 8 rl + cl), or in the int8 form as mma.sync
// m16n8k32 s8 on the codes; e into the warp's e rows; each row's sum of the
// tile's e as a pairwise tree (tile_sum), added to its den tile after tile;
// then the AV product as 4 x 8 patches (rows rl + 4 i, columns 4 cl + n and
// 32 + 4 cl + n). The score and AV products skip every eighth of keys past
// the last with a real key.
template <bool QK8, bool TWO, bool ARGS>
__global__ void __launch_bounds__(kFmaThreads, 2) fma_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem);
  float* qs = smem;
  float* ks = reinterpret_cast<float*>(sb + kFmaOffK);
  float* vs = reinterpret_cast<float*>(sb + kFmaOffV);
  float* sq = reinterpret_cast<float*>(sb + kFmaOffS);   // q row scales (times c / 127^2)
  float* sk = sq + kFmaRows;                              // key row scales
  int8_t* qc = reinterpret_cast<int8_t*>(sb + kFmaOffC);
  int8_t* kc = qc + kFmaRows * kLDC;
  const int b = blockIdx.z, h0 = blockIdx.y, q0 = blockIdx.x * kFmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = lane >> 3, cl = lane & 7, g = lane >> 2, t = lane & 3;
  float* ew = reinterpret_cast<float*>(sb + kFmaOffE) + warp * 16 * kLDE;
  const float* qw = qs + warp * 16 * kLDF;
  const bool active = q0 + warp * 16 < a.Lq;
  const long long hoff = static_cast<long long>(h0) * kHD;
  const long long kb = static_cast<long long>(b) * a.k_sb + hoff;
  const long long vb = static_cast<long long>(b) * a.v_sb + hoff;
  Rows krows = one_source(a.k + kb, a.Lk, a.k_sl), vrows = one_source(a.v + vb, a.Lk, a.v_sl);
  if (TWO) {
    krows = Rows{a.k + kb, a.k2 + static_cast<long long>(b) * a.k2_sb + hoff, a.k_sl, a.k2_sl,
                 a.L1, a.Lk};
    vrows = Rows{a.v + vb, a.v2 + static_cast<long long>(b) * a.v2_sb + hoff, a.v_sl, a.v2_sl,
                 a.L1, a.Lk};
  }
  rows_async(qs, one_source(a.q + static_cast<long long>(b) * a.q_sb + hoff, a.Lq, a.q_sl), q0,
             kFmaRows);
  rows_async(ks, krows, 0, kFmaKeys);
  tf32::cp_commit();

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n] = 0.f;
  float den = 0.f;
  uint32_t qa[2][4];   // the int8 form: the warp's q codes as m16n8k32 A fragments
  float qf[2];         // and the scales of the thread's rows g, g + 8
  const int nkt = (a.Lk + kFmaKeys - 1) / kFmaKeys;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kFmaKeys;
    const int nj = min(8, (a.Lk - k0 + 7) >> 3);   // eighths of the tile with a real key
    tf32::cp_wait_all();
    __syncthreads();   // key tile kt is in; every warp is done with the value tile and e
    if (!ARGS) rows_async(vs, vrows, k0, kFmaKeys);
    tf32::cp_commit();
    if (QK8) {
      if (kt == 0) quant_rows(qs, qc, sq, kFmaRows, a.cq);
      quant_rows(ks, kc, sk, kFmaKeys, 1.f);
      __syncthreads();   // the codes are in
      if (kt == 0) {
#pragma unroll
        for (int k32 = 0; k32 < 2; ++k32)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            qa[k32][r] = *reinterpret_cast<const uint32_t*>(
                qc + (warp * 16 + g + 8 * (r & 1)) * kLDC + 32 * k32 + 16 * (r >> 1) + 4 * t);
        qf[0] = sq[warp * 16 + g];
        qf[1] = sq[warp * 16 + g + 8];
      }
    }
    if (active) {
      if (QK8) {
        // the exact integer product (all its partial sums are integers below
        // 2^24, as the plain version's fp32 sums), then its rescale; every
        // eighth of the tile (its keys past Lk are zero rows)
#pragma unroll 2
        for (int nt = 0; nt < 8; ++nt) {
          int s32[4] = {0, 0, 0, 0};
          const int8_t* kr = kc + (8 * nt + g) * kLDC + 4 * t;
#pragma unroll
          for (int k32 = 0; k32 < 2; ++k32)
            tf32::mma_s8(s32, qa[k32], *reinterpret_cast<const uint32_t*>(kr + 32 * k32),
                         *reinterpret_cast<const uint32_t*>(kr + 32 * k32 + 16));
          const float2 kf = *reinterpret_cast<const float2*>(sk + 8 * nt + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = g + 8 * h, kl = 8 * nt + 2 * t;
            const float a0 = qk8_arg(static_cast<float>(s32[2 * h]), qf[h], kf.x);
            const float a1 = qk8_arg(static_cast<float>(s32[2 * h + 1]), qf[h], kf.y);
            if (ARGS) {
              const int row = q0 + warp * 16 + r;
              float* arow = a.o + ((static_cast<long long>(b) * a.H + h0) * a.Lq + row) * a.Lk;
              if (row < a.Lq && k0 + kl < a.Lk) arow[k0 + kl] = a0;
              if (row < a.Lq && k0 + kl + 1 < a.Lk) arow[k0 + kl + 1] = a1;
            } else {
              *reinterpret_cast<float2*>(ew + r * kLDE + kl) =
                  make_float2(k0 + kl < a.Lk ? ex2f(fminf(a0 * a.c, kClamp)) : 0.f,
                              k0 + kl + 1 < a.Lk ? ex2f(fminf(a1 * a.c, kClamp)) : 0.f);
            }
          }
        }
      } else {
        float s[4][8];
        if (nj == 8)
          scores_fma<true>(s, qw, ks, rl, cl, nj);
        else
          scores_fma<false>(s, qw, ks, rl, cl, nj);
        store_e(ew, s, rl, cl, k0, a.Lk, a.c);
      }
    }
    tf32::cp_wait_all();
    __syncthreads();   // the value tile is in; every warp is done with the key tile and wrote e
    if (kt + 1 < nkt) rows_async(ks, krows, k0 + kFmaKeys, kFmaKeys);
    tf32::cp_commit();
    if (ARGS || !active) continue;
    // den: the tiles' sums of row (lane & 15) of the warp added in order
    den += tile_sum(ew + (lane & 15) * kLDE + 32 * (lane >> 4));
    av_fma(acc, ew, vs, rl, cl, 8 * nj);
  }
  tf32::cp_wait_all();   // (no key tile: Lk 0)
  if (ARGS || !active) return;
  float* ob = a.o + static_cast<long long>(b) * a.o_sb + hoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = fmaxf(__shfl_sync(0xffffffffu, den, rl + 4 * i), 1e-30f);
    const int row = q0 + warp * 16 + rl + 4 * i;
    if (row >= a.Lq) continue;
    float* orow = ob + static_cast<long long>(row) * a.o_sl;
    *reinterpret_cast<float4*>(orow + 4 * cl) =
        make_float4(acc[i][0] / d, acc[i][1] / d, acc[i][2] / d, acc[i][3] / d);
    *reinterpret_cast<float4*>(orow + 32 + 4 * cl) =
        make_float4(acc[i][4] / d, acc[i][5] / d, acc[i][6] / d, acc[i][7] / d);
  }
}

struct BwdArgs {
  const float *q, *k, *v, *dout, *o;
  const float* rowstat;   // lse (B, H, Lq)
  float *dq, *dk, *dv;
  float* sd;              // scratch (2, B, H, Lq): each row's statistic, then its delta
  int B, Lq, Lk, H;
  int q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;   // do and o: (B, Lq, H*64) contiguous
  float scale, c;
  int causal;
};

// p of one score entry: exp2(s2 - lse log2 e) (st = lse * log2 e); 0 for a
// key past Lk, a row past Lq and a key the causal mask hides
__device__ __forceinline__ float prob(float s, float st, int key, int row, int Lq, int Lk,
                                      int causal, float c) {
  if (key >= Lk || row >= Lq) return 0.f;
  return causal && key > row ? 0.f : ex2f(s * c - st);
}

__global__ void __launch_bounds__(kThreads, 2) stream_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* dot = qt + kTileFloats;
  float* kt = dot + kTileFloats;
  float* kn = kt + kTileFloats;
  float* vt = kn + kTileFloats;
  float* dst = vt + kTileFloats;
  float* sst = dst + kTileFloats;
  float* sdl = sst + kT;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long D = static_cast<long long>(a.H) * kHD;
  const long long hoff = static_cast<long long>(h) * kHD;
  const float* qb = a.q + static_cast<long long>(b) * a.q_sb + hoff;
  const float* kb = a.k + static_cast<long long>(b) * a.k_sb + hoff;
  const float* vb = a.v + static_cast<long long>(b) * a.v_sb + hoff;
  const float* dob = a.dout + static_cast<long long>(b) * a.Lq * D + hoff;
  const float* obb = a.o + static_cast<long long>(b) * a.Lq * D + hoff;

  // each row's delta = rowsum(do * o) (4 threads a row, 16 columns each)
  // and its statistic, here and in the scratch for the dk / dv kernel
  {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = q0 + r;
    float d = 0.f;
    if (row < a.Lq) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const long long off = row * D + part * 16 + 4 * x;
        const float4 u = *reinterpret_cast<const float4*>(dob + off);
        const float4 w = *reinterpret_cast<const float4*>(obb + off);
        d = fmaf(u.x, w.x, d);
        d = fmaf(u.y, w.y, d);
        d = fmaf(u.z, w.z, d);
        d = fmaf(u.w, w.w, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      float st = 0.f;
      if (row < a.Lq) {
        const long long bh = static_cast<long long>(b) * a.H + h;
        st = a.rowstat[bh * a.Lq + row] * kLog2e;
        a.sd[bh * a.Lq + row] = st;
        a.sd[static_cast<long long>(a.B) * a.H * a.Lq + bh * a.Lq + row] = d;
      }
      sst[r] = st;
      sdl[r] = row < a.Lq ? d : 0.f;
    }
  }
  load_t(qt, qb, q0, a.Lq, a.q_sl);
  load_t(dot, dob, q0, a.Lq, D);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int kend = a.causal ? min(a.Lk, q0 + kT) : a.Lk;
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();
    load_t(kt, kb, k0, a.Lk, a.k_sl);
    load_n(kn, kb, k0, a.Lk, a.k_sl);
    load_t(vt, vb, k0, a.Lk, a.v_sl);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm64(s, qt, kt, ty, tx);    // q k^T
    mm64(dp, dot, vt, ty, tx);  // do v^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = prob(s[i][j], sst[r], k0 + 4 * tx + j, q0 + r, a.Lq, a.Lk, a.causal, a.c) *
                  (dp[i][j] - sdl[r]);   // ds
    }
    store_patch_t(dst, s, ty, tx);
    __syncthreads();
    mm64(acc, dst, kn, ty, tx);   // dq += ds k
  }
  float* dqb = a.dq + static_cast<long long>(b) * a.Lq * D + hoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < a.Lq)
      *reinterpret_cast<float4*>(dqb + row * D + 4 * tx) =
          make_float4(acc[i][0] * a.scale, acc[i][1] * a.scale, acc[i][2] * a.scale,
                      acc[i][3] * a.scale);
  }
}

__global__ void __launch_bounds__(kThreads, 1) stream_bwd_dkdv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;
  float* vt = kt + kTileFloats;
  float* qt = vt + kTileFloats;
  float* dot = qt + kTileFloats;
  float* qn = dot + kTileFloats;
  float* don = qn + kTileFloats;
  float* ps = don + kTileFloats;
  float* dss = ps + kTileFloats;
  float* sst = dss + kTileFloats;
  float* sdl = sst + kT;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long D = static_cast<long long>(a.H) * kHD;
  const long long hoff = static_cast<long long>(h) * kHD;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float* qb = a.q + static_cast<long long>(b) * a.q_sb + hoff;
  const float* kb = a.k + static_cast<long long>(b) * a.k_sb + hoff;
  const float* vb = a.v + static_cast<long long>(b) * a.v_sb + hoff;
  const float* dob = a.dout + static_cast<long long>(b) * a.Lq * D + hoff;
  const float* sdd = a.sd + static_cast<long long>(a.B) * a.H * a.Lq;
  load_t(kt, kb, k0, a.Lk, a.k_sl);
  load_t(vt, vb, k0, a.Lk, a.v_sl);

  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;
  // under the causal mask the query tiles before this key tile's own see
  // none of its keys
  for (int q0 = a.causal ? k0 : 0; q0 < a.Lq; q0 += kT) {
    __syncthreads();
    load_t(qt, qb, q0, a.Lq, a.q_sl);
    load_t(dot, dob, q0, a.Lq, D);
    load_n(qn, qb, q0, a.Lq, a.q_sl);
    load_n(don, dob, q0, a.Lq, D);
    if (threadIdx.x < kT) {
      const int row = q0 + threadIdx.x;
      sst[threadIdx.x] = row < a.Lq ? a.sd[bh * a.Lq + row] : 0.f;
      sdl[threadIdx.x] = row < a.Lq ? sdd[bh * a.Lq + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm64(s, qt, kt, ty, tx);    // q k^T: rows are queries, columns keys
    mm64(dp, dot, vt, ty, tx);  // do v^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = prob(s[i][j], sst[r], k0 + 4 * tx + j, q0 + r, a.Lq, a.Lk, a.causal, a.c);
        dp[i][j] = s[i][j] * (dp[i][j] - sdl[r]);
      }
      *reinterpret_cast<float4*>(ps + r * kLD + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(dss + r * kLD + 4 * tx) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    __syncthreads();
    mm64(dv, ps, don, ty, tx);   // dv += p^T do
    mm64(dk, dss, qn, ty, tx);   // dk += ds^T q
  }
  float* dkb = a.dk + static_cast<long long>(b) * a.Lk * D + hoff;
  float* dvb = a.dv + static_cast<long long>(b) * a.Lk * D + hoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= a.Lk) continue;
    *reinterpret_cast<float4*>(dkb + key * D + 4 * tx) =
        make_float4(dk[i][0] * a.scale, dk[i][1] * a.scale, dk[i][2] * a.scale,
                    dk[i][3] * a.scale);
    *reinterpret_cast<float4*>(dvb + key * D + 4 * tx) =
        make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

FwdArgs make_fwd(const void* q, const void* k, const void* v, void* o, void* stat, int Lq,
                 int Lk, int H, int q_sb, int q_sl, int k_sb, int k_sl, int v_sb, int v_sl,
                 int o_sb, int o_sl, float c, int causal) {
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.stat = static_cast<float*>(stat);
  a.Lq = Lq; a.Lk = Lk; a.H = H;
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl; a.o_sb = o_sb; a.o_sl = o_sl;
  a.c = c;
  a.causal = causal;
  a.cq = 0.f;
  a.k2 = a.v2 = nullptr;
  a.L1 = Lk;
  a.k2_sb = a.k2_sl = a.v2_sb = a.v2_sl = 0;
  return a;
}

// one launch of packed_fwd_kernel: B1 / B6a, or (STREAM) B7's forward; a
// block per (kFwdRows query rows, head, batch row), as
// ops/flash_attention.attention_f32_plan's 'fwd'
template <bool STREAM = false>
cudaError_t launch_packed_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(packed_fwd_kernel<STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kPFwdSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kFwdRows - 1) / kFwdRows, a.H, B);
  packed_fwd_kernel<STREAM><<<grid, kFwdThreads, kPFwdSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// one launch of fma_fwd_kernel: a block per (kFmaRows query rows, head,
// batch row), as ops/flash_attention.attention_fma_plan, at any key length
template <bool QK8, bool TWO, bool ARGS = false>
cudaError_t launch_fma_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fma_fwd_kernel<QK8, TWO, ARGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kFmaSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kFmaRows - 1) / kFmaRows, a.H, B);
  fma_fwd_kernel<QK8, TWO, ARGS><<<grid, kFmaThreads, kFmaSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// the w8a8 fusion's attention in its int8-score form (c = 1, the scales
// carry cq) or with fp32 scores
template <bool TWO>
cudaError_t launch_fma_int8_or_not(FwdArgs a, int B, int int8_qk, float c,
                                   cudaStream_t stream) {
  if (int8_qk) {
    a.c = 1.f;
    a.cq = c;
    return launch_fma_fwd<true, TWO>(a, B, stream);
  }
  a.c = c;
  return launch_fma_fwd<false, TWO>(a, B, stream);
}

PBwdArgs make_pbwd(const void* q, const void* k, const void* v, const void* dout,
                   const void* o, const void* rowstat, void* dq, void* dk, void* dv, void* scratch,
                   int B, int Lq, int Lk, int H, int q_sb, int q_sl, int k_sb, int k_sl,
                   int v_sb, int v_sl, int lq_pad, int acc_in_smem, float scale) {
  PBwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.o = static_cast<const float*>(o);
  a.rowstat = static_cast<const float*>(rowstat);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.scratch = static_cast<float*>(scratch);
  a.B = B; a.Lq = Lq; a.Lk = Lk; a.H = H; a.lq_pad = lq_pad; a.acc_in_smem = acc_in_smem;
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl;
  a.scale = scale;
  a.c = scale * kLog2e;
  a.causal = 0;
  return a;
}

// One launch of the plan that ops/flash_attention.attention_f32_plan
// computes from attention_f32_layout: smem_bytes is kBwdFixedBytes, plus
// acc_floats(lq_pad) * 4 when the accumulator is in shared memory.
template <bool STREAM>
cudaError_t launch_packed_bwd(const PBwdArgs& a, int grid, int smem_bytes,
                              cudaStream_t stream) {
  if (a.lq_pad < a.Lq || a.lq_pad % 16 != 0 || grid < 1 || smem_bytes > kMaxSmem ||
      smem_bytes < kBwdFixedBytes + (a.acc_in_smem ? 4 * acc_floats(a.lq_pad) : 0) ||
      (!a.acc_in_smem && a.scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(packed_bwd_kernel<STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  packed_bwd_kernel<STREAM><<<grid, kBwdThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

// the dq kernel (which also writes the row statistics), then the dk / dv
// kernel, on one stream
cudaError_t launch_stream_bwd(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stream_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDqSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stream_bwd_dkdv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  stream_bwd_dq_kernel<<<dim3((a.Lq + kT - 1) / kT, a.H, a.B), kThreads, kDqSmemBytes,
                         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stream_bwd_dkdv_kernel<<<dim3((a.Lk + kT - 1) / kT, a.H, a.B), kThreads, kDkvSmemBytes,
                           stream>>>(a);
  return cudaGetLastError();
}

BwdArgs make_bwd(const void* q, const void* k, const void* v, const void* dout,
                 const void* o, const void* rowstat, void* dq, void* dk, void* dv,
                 void* scratch, int B, int Lq, int Lk, int H, int q_sb, int q_sl, int k_sb,
                 int k_sl, int v_sb, int v_sl, float scale, int causal) {
  BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.o = static_cast<const float*>(o);
  a.rowstat = static_cast<const float*>(rowstat);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.sd = static_cast<float*>(scratch);
  a.B = B; a.Lq = Lq; a.Lk = Lk; a.H = H;
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl;
  a.scale = scale;
  a.c = scale * kLog2e;
  a.causal = causal;
  return a;
}

inline int bad_args(int Dh, const void* p) {
  return Dh != kHD || p == nullptr;
}

}  // namespace

// Strides are in elements; the last dim is contiguous and rows are 16-byte
// aligned (checked by the Python wrapper). Each entry returns
// cudaGetLastError() after its launches: 0 when they were accepted.

// B1: o (B, Lq, H*64) fp32; c = Dh^-0.5 * log2(e)
extern "C" int packed_attention_f32(const void* q, const void* k, const void* v, void* o,
                                    int B, int Lq, int Lk, int H, int Dh, int q_sb, int q_sl,
                                    int k_sb, int k_sl, int v_sb, int v_sl, int o_sb,
                                    int o_sl, float c, void* stream) {
  if (bad_args(Dh, o)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_packed_fwd(
      make_fwd(q, k, v, o, nullptr, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl,
               c, 0),
      B, static_cast<cudaStream_t>(stream)));
}

// B4's attention: B1's function and arguments, as fp32 FMA in the plain
// version's summation order (fma_fwd_kernel)
extern "C" int packed_attention_fma_f32(const void* q, const void* k, const void* v, void* o,
                                        int B, int Lq, int Lk, int H, int Dh, int q_sb,
                                        int q_sl, int k_sb, int k_sl, int v_sb, int v_sl,
                                        int o_sb, int o_sl, float c, void* stream) {
  if (bad_args(Dh, o)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fma_fwd<false, false>(
      make_fwd(q, k, v, o, nullptr, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl,
               c, 0),
      B, static_cast<cudaStream_t>(stream)));
}

// B6a: the same, which also writes den (B, Lq, H) fp32 contiguous
extern "C" int packed_attention_den_f32(const void* q, const void* k, const void* v, void* o,
                                        void* den, int B, int Lq, int Lk, int H, int Dh,
                                        int q_sb, int q_sl, int k_sb, int k_sl, int v_sb,
                                        int v_sl, int o_sb, int o_sl, float c, void* stream) {
  if (bad_args(Dh, den)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_packed_fwd(
      make_fwd(q, k, v, o, den, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl, c,
               0),
      B, static_cast<cudaStream_t>(stream)));
}

// B11's attention: B1 with the int8 score product; cq = Dh^-0.5 *
// log2(e) / 127^2
extern "C" int packed_attention_qk8_f32(const void* q, const void* k, const void* v, void* o,
                                        int B, int Lq, int Lk, int H, int Dh, int q_sb,
                                        int q_sl, int k_sb, int k_sl, int v_sb, int v_sl,
                                        int o_sb, int o_sl, float cq, void* stream) {
  if (bad_args(Dh, o)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fma_int8_or_not<false>(
      make_fwd(q, k, v, o, nullptr, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl,
               0.f, 0),
      B, 1, cq, static_cast<cudaStream_t>(stream)));
}

// B12's attention: B1 (int8_qk 0; c = Dh^-0.5 * log2(e)) or B11 (int8_qk 1;
// c / 127^2) over the keys [k1 (B, L1, H*64); k2 (B, L2, H*64)] and the
// values [v1; v2], each source at its own strides
extern "C" int packed_attention_2src_f32(const void* q, const void* k1, const void* v1,
                                         const void* k2, const void* v2, void* o, int B, int Lq,
                                         int L1, int L2, int H, int Dh, int q_sb, int q_sl,
                                         int k1_sb, int k1_sl, int v1_sb, int v1_sl, int k2_sb,
                                         int k2_sl, int v2_sb, int v2_sl, int o_sb, int o_sl,
                                         float c, int int8_qk, void* stream) {
  if (bad_args(Dh, o) || L1 < 0 || L2 < 0 || L1 + L2 < 1 || (L2 > 0 && (k2 == nullptr ||
                                                                      v2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a = make_fwd(q, k1, v1, o, nullptr, Lq, L1 + L2, H, q_sb, q_sl, k1_sb, k1_sl, v1_sb,
                       v1_sl, o_sb, o_sl, c, 0);
  a.k2 = static_cast<const float*>(k2);
  a.v2 = static_cast<const float*>(v2);
  a.L1 = L1;
  a.k2_sb = k2_sb; a.k2_sl = k2_sl; a.v2_sb = v2_sb; a.v2_sl = v2_sl;
  return static_cast<int>(
      launch_fma_int8_or_not<true>(a, B, int8_qk, c, static_cast<cudaStream_t>(stream)));
}

// The check of B11's codes and rescale: args (B, H, Lq, Lk) fp32, the exp2
// arguments of the int8 form's scores, by the steps of
// packed_attention_qk8_f32's kernel (its ARGS form); cq as that entry's
extern "C" int attention_f32_qk8_args(const void* q, const void* k, void* args, int B, int Lq,
                                      int Lk, int H, int Dh, int q_sb, int q_sl, int k_sb,
                                      int k_sl, float cq, void* stream) {
  if (bad_args(Dh, args)) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a = make_fwd(q, k, k, args, nullptr, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, k_sb, k_sl, 0,
                       0, 1.f, 0);
  a.cq = cq;
  return static_cast<int>(
      launch_fma_fwd<true, false, true>(a, B, static_cast<cudaStream_t>(stream)));
}

// B6b: dq, dk, dv from do and o (B, Lq, H*64) contiguous and den (B, Lq,
// H), one launch of the plan (lq_pad, grid, acc_in_smem, smem_bytes);
// scratch (the plan's global form) holds grid * acc_floats(lq_pad) floats
extern "C" int packed_attention_bwd_f32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* o, const void* den,
                                        void* dq, void* dk, void* dv, void* scratch, int B,
                                        int Lq, int Lk, int H, int Dh, int q_sb, int q_sl,
                                        int k_sb, int k_sl, int v_sb, int v_sl, int lq_pad,
                                        int grid, int acc_in_smem, int smem_bytes, float scale,
                                        void* stream) {
  if (Dh != kHD) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Lq == 0 || Lk == 0) return 0;
  return static_cast<int>(launch_packed_bwd<false>(
      make_pbwd(q, k, v, dout, o, den, dq, dk, dv, scratch, B, Lq, Lk, H, q_sb, q_sl, k_sb,
                k_sl, v_sb, v_sl, lq_pad, acc_in_smem, scale),
      grid, smem_bytes, static_cast<cudaStream_t>(stream)));
}

// B8: the packed forward (o and den into o_scratch (B, Lq, H*64) and
// den_scratch (B, Lq, H)), then B6b's kernel on them
extern "C" int packed_attention_bwd_recompute_f32(
    const void* q, const void* k, const void* v, const void* dout, void* o_scratch,
    void* den_scratch, void* dq, void* dk, void* dv, void* scratch, int B, int Lq, int Lk,
    int H, int Dh, int q_sb, int q_sl, int k_sb, int k_sl, int v_sb, int v_sl, int lq_pad,
    int grid, int acc_in_smem, int smem_bytes, float scale, void* stream) {
  if (Dh != kHD || o_scratch == nullptr || den_scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Lq == 0 || Lk == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * kHD;
  cudaError_t err = launch_packed_fwd(
      make_fwd(q, k, v, o_scratch, den_scratch, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb,
               v_sl, Lq * D, D, scale * kLog2e, 0),
      B, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_packed_bwd<false>(
      make_pbwd(q, k, v, dout, o_scratch, den_scratch, dq, dk, dv, scratch, B, Lq, Lk, H, q_sb,
                q_sl, k_sb, k_sl, v_sb, v_sl, lq_pad, acc_in_smem, scale),
      grid, smem_bytes, st));
}

// B7 forward: o (B, Lq, H*64) fp32 and lse (B, H, Lq) fp32
extern "C" int streaming_attention_f32(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int B, int Lq, int Lk, int H,
                                       int Dh, int q_sb, int q_sl, int k_sb, int k_sl,
                                       int v_sb, int v_sl, int o_sb, int o_sl, float scale,
                                       int causal, void* stream) {
  if (bad_args(Dh, lse)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_packed_fwd<true>(
      make_fwd(q, k, v, o, lse, Lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, o_sb, o_sl,
               scale * kLog2e, causal),
      B, static_cast<cudaStream_t>(stream)));
}

// B7 backward: from do and o (B, Lq, H*64) contiguous and lse (B, H, Lq),
// in the form of ops/flash_attention.attention_f32_plan's 'bwd': one_launch
// (the 3xTF32 backward's streaming form, a block per (batch row, head), its
// dq accumulator in shared memory at lq_pad rows, smem_bytes the plan's; no
// scratch) or the two FMA kernels (scratch holds 2 * B * H * Lq floats;
// lq_pad and smem_bytes unused)
extern "C" int streaming_attention_bwd_f32(const void* q, const void* k, const void* v,
                                           const void* dout, const void* o, const void* lse,
                                           void* dq, void* dk, void* dv, void* scratch, int B,
                                           int Lq, int Lk, int H, int Dh, int q_sb, int q_sl,
                                           int k_sb, int k_sl, int v_sb, int v_sl,
                                           float scale, int causal, int one_launch, int lq_pad,
                                           int smem_bytes, void* stream) {
  if (bad_args(Dh, lse)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Lq == 0 || Lk == 0) return 0;
  if (one_launch) {
    PBwdArgs a = make_pbwd(q, k, v, dout, o, lse, dq, dk, dv, nullptr, B, Lq, Lk, H, q_sb, q_sl,
                           k_sb, k_sl, v_sb, v_sl, lq_pad, 1, scale);
    a.causal = causal;
    return static_cast<int>(
        launch_packed_bwd<true>(a, B * H, smem_bytes, static_cast<cudaStream_t>(stream)));
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_stream_bwd(
      make_bwd(q, k, v, dout, o, lse, dq, dk, dv, scratch, B, Lq, Lk, H, q_sb, q_sl, k_sb,
               k_sl, v_sb, v_sl, scale, causal),
      static_cast<cudaStream_t>(stream)));
}

// The layout the launch plans are computed from: the FMA tiles' rows,
// threads a block and the dynamic shared bytes of B7's backward past 128
// rows, its dq kernel and dk / dv kernel; the 3xTF32 forward's (B1 / B6a and
// B7's) query rows a block, threads and shared bytes; the 3xTF32 backward's
// threads, fixed shared bytes, floats a query row of its accumulator and row
// statistics, and the most dynamic shared memory a block may take; the most
// query rows and keys of the streaming backward's one-launch form; the w8a8
// fusion's forward's query rows a block, threads and shared bytes.
extern "C" void attention_f32_layout(int* out) {
  out[0] = kT;
  out[1] = kThreads;
  out[2] = kDqSmemBytes;
  out[3] = kDkvSmemBytes;
  out[4] = kFwdRows;
  out[5] = kFwdThreads;
  out[6] = kPFwdSmemBytes;
  out[7] = kBwdThreads;
  out[8] = kBwdFixedBytes;
  out[9] = static_cast<int>(acc_floats(1));
  out[10] = kMaxSmem;
  out[11] = kStreamBwdRows;
  out[12] = kFmaRows;
  out[13] = kFmaThreads;
  out[14] = kFmaSmemBytes;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
