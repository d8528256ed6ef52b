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
// first. What matters is that neither the score tile nor the fp32 attention
// output reaches device memory.
//
// The hard part: the per-row quant needs all H heads of a row, and a
// block of csrc/packed_attention.cu sees one head. Design: one block of 8
// warps per (32-row q tile, frame row) loops over the heads, four heads at
// a time (two warps of 16 query rows per head, K/V of the four heads staged
// through shared memory in 64-key tiles, mma.sync m16n8k16 bf16 as in the
// bf16 kernel), and writes each head's fp32 output into a 32 x (H*64 + 16)
// fp32 tile in dynamic shared memory (100,352 bytes at H = 12). Then a warp
// per row quantizes the fp32 row, writing the codes in place over the
// row's first H*64 bytes, and the block runs the int8 out-projection over
// them (mma.sync m16n8k32 s8; each warp owns 48 output columns, so no two
// warps share a weight fragment and each loads its own from W^T straight
// into registers, gemm_direct) with the bias and the residual in the
// epilogue. Head dim 64 only; H*64 <= 1024.
//
// The int8 QK^T form (a template flag; TPU: the int8_qk branch of
// _onepass_softmax_av_masked inside the same pallas_call) quantizes each
// head's 64-wide slice of a query row and of a key row per row,
//     qs = max(max |q_h|, 1e-6),  qq = rint(q_h * (127 / qs))   (same for k)
// runs the score product as s8 mma.sync m16n8k32 and folds the scales into
// the exp2 argument in this order of multiplication:
//     e = bf16(exp2(min(((float)(qq . kq) * (qs * c2)) * ks, 110)))
// with c2 = c / 127^2 handed over by the caller. The AV product, the
// denominator and everything after stay as above. The query codes are made
// in registers from the bf16 A fragments; a thread per (head, key) row
// quantizes the keys of a tile straight from device memory into the head's
// K area of shared memory, in the k order in which the query codes sit (a
// permutation of k applied to both operands: the int32 sums are exact).

#include "w8a8_common.cuh"

namespace {

using namespace w8a8;

constexpr int kHD = 64;            // head dim
constexpr int kBM = 32;            // query rows per block
constexpr int kSlots = 4;          // heads in flight: 2 warps (16 rows each) per head
constexpr int kTileK = 64;         // keys per staged K/V tile
constexpr int kLDS = kHD + 8;      // padded bf16 row of a staged K/V tile
constexpr int kSlotElems = 2 * kTileK * kLDS;  // K then V of one head
constexpr int kBN = 384;           // out-projection columns per pass, 48 per warp
constexpr int kMT = 2, kNT = 6;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

template <bool kInt8QK>
__global__ void __launch_bounds__(kThreads, 1)
attention_out_int8_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int8_t* __restrict__ Wt,
                          const float* __restrict__ s, const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ r, __nv_bfloat16* __restrict__ o,
                          int lq, int Lk, int H, int q_sb, int q_sl, int k_sb, int k_sl,
                          int v_sb, int v_sl, float c, bool fast) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = H * kHD;
  // floats per row of the attention tile: the in-place codes' rows are
  // then 64 bytes (mod 128) apart, as gemm_direct's 16-byte loads want
  const int ast = D + 16;
  float* af = reinterpret_cast<float*>(smem);
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(af + kBM * ast);
  float* xs = reinterpret_cast<float*>(kv + kSlots * kSlotElems);

  const int b = blockIdx.y, q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp >> 1, lr0 = (warp & 1) * 16 + g, lr1 = lr0 + 8;  // tile rows
  const int r0 = q0 + lr0, r1 = q0 + lr1;

  const __nv_bfloat16* qb = q + static_cast<long long>(b) * q_sb;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * k_sb;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * v_sb;
  __nv_bfloat16* ks = kv + slot * kSlotElems;
  __nv_bfloat16* vs = ks + kTileK * kLDS;
  // int8 QK^T: the head's K area holds kTileK x 64 codes, then kTileK scales
  const int8_t* kq = reinterpret_cast<const int8_t*>(ks);
  const float* ksc = reinterpret_cast<const float*>(kq + kTileK * kHD);

  // ---- attention, kSlots heads at a time, fp32 outputs into af ----------
  for (int hb = 0; hb < H; hb += kSlots) {
    const int head = hb + slot;
    const bool active = head < H;
    const long long hoff = static_cast<long long>(head) * kHD;
    constexpr int KD = kHD / 16, NS = kTileK / 8, ND = kHD / 8;
    uint32_t qa[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int col = kk * 16 + t * 2;
      const __nv_bfloat16* p0 = qb + static_cast<long long>(r0) * q_sl + hoff + col;
      const __nv_bfloat16* p1 = qb + static_cast<long long>(r1) * q_sl + hoff + col;
      const bool ok0 = active && r0 < lq, ok1 = active && r1 < lq;
      qa[kk][0] = ok0 ? ld2(p0) : 0u;
      qa[kk][1] = ok1 ? ld2(p1) : 0u;
      qa[kk][2] = ok0 ? ld2(p0 + 8) : 0u;
      qa[kk][3] = ok1 ? ld2(p1 + 8) : 0u;
    }
    // int8 QK^T: the rows' codes as A fragments of two m16n8k32 steps; a
    // thread's 16 values of a row fill its k slots 4t..4t+3 and 16+4t..
    // of each step in the order kk = 2 * step, 2 * step + 1
    uint32_t qi[2][4];
    float rq[2];   // qs * c2 of rows g and g + 8
    if constexpr (kInt8QK) {
      float mx0 = 0.f, mx1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mx0 = absmax_pair(qa[kk][2], absmax_pair(qa[kk][0], mx0));
        mx1 = absmax_pair(qa[kk][3], absmax_pair(qa[kk][1], mx1));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float qs0 = fmaxf(mx0, 1e-6f), qs1 = fmaxf(mx1, 1e-6f);
      const float inv0 = __fdiv_rn(127.0f, qs0), inv1 = __fdiv_rn(127.0f, qs1);
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kk = 2 * st + hf;
          qi[st][2 * hf] = quant_pair(qa[kk][0], inv0) | (quant_pair(qa[kk][2], inv0) << 16);
          qi[st][2 * hf + 1] = quant_pair(qa[kk][1], inv1) | (quant_pair(qa[kk][3], inv1) << 16);
        }
      rq[0] = __fmul_rn(qs0, c);
      rq[1] = __fmul_rn(qs1, c);
    }
    float acc[ND][4];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float rsum[2] = {0.f, 0.f};

    for (int k0 = 0; k0 < Lk; k0 += kTileK) {
      __syncthreads();  // every warp is done with the previous tiles
      constexpr int VPR = kHD / 8;  // 16-byte vectors per staged row
      for (int idx = threadIdx.x; idx < kSlots * kTileK * VPR; idx += kThreads) {
        const int sl = idx / (kTileK * VPR), rem = idx % (kTileK * VPR);
        const int row = rem / VPR, cv = (rem % VPR) * 8;
        const int hd = hb + sl;
        uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
        if (hd < H && k0 + row < Lk) {
          const long long off = static_cast<long long>(hd) * kHD + cv;
          kx = *reinterpret_cast<const uint4*>(kb + static_cast<long long>(k0 + row) * k_sl + off);
          vx = *reinterpret_cast<const uint4*>(vb + static_cast<long long>(k0 + row) * v_sl + off);
        }
        __nv_bfloat16* kd = kv + sl * kSlotElems;
        if constexpr (!kInt8QK) *reinterpret_cast<uint4*>(kd + row * kLDS + cv) = kx;
        *reinterpret_cast<uint4*>(kd + kTileK * kLDS + row * kLDS + cv) = vx;
      }
      if constexpr (kInt8QK) {
        // thread (head slot, key row): the row's 64 values -> scale and codes
        static_assert(kThreads == kSlots * kTileK, "one thread per staged key row");
        const int sl = threadIdx.x / kTileK, row = threadIdx.x % kTileK;
        const int hd = hb + sl;
        uint4 raw[VPR];
#pragma unroll
        for (int i = 0; i < VPR; ++i) raw[i] = make_uint4(0u, 0u, 0u, 0u);
        if (hd < H && k0 + row < Lk) {
          const uint4* src = reinterpret_cast<const uint4*>(
              kb + static_cast<long long>(k0 + row) * k_sl + static_cast<long long>(hd) * kHD);
#pragma unroll
          for (int i = 0; i < VPR; ++i) raw[i] = src[i];
        }
        float mx = 0.f;
#pragma unroll
        for (int i = 0; i < VPR; ++i)
          mx = absmax_pair(raw[i].w, absmax_pair(raw[i].z, absmax_pair(raw[i].y,
                                                           absmax_pair(raw[i].x, mx))));
        const float kscale = fmaxf(mx, 1e-6f);
        const float inv = __fdiv_rn(127.0f, kscale);
        // codes in natural order, four to a word: word w holds dims 4w..4w+3
        uint32_t nat[kHD / 4];
#pragma unroll
        for (int i = 0; i < VPR; ++i) {
          nat[2 * i] = quant_pair(raw[i].x, inv) | (quant_pair(raw[i].y, inv) << 16);
          nat[2 * i + 1] = quant_pair(raw[i].z, inv) | (quant_pair(raw[i].w, inv) << 16);
        }
        // thread t of a quad reads bytes 16t..16t+15 of the row: word kk of
        // them holds dims kk*16 + 2t, +1 and kk*16 + 8 + 2t, +1
        int8_t* kqd = reinterpret_cast<int8_t*>(kv + sl * kSlotElems);
        float* kscd = reinterpret_cast<float*>(kqd + kTileK * kHD);
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          const uint32_t sel = (tt & 1) ? 0x7632u : 0x5410u;
          uint4 w;
          w.x = __byte_perm(nat[0 + tt / 2], nat[2 + tt / 2], sel);
          w.y = __byte_perm(nat[4 + tt / 2], nat[6 + tt / 2], sel);
          w.z = __byte_perm(nat[8 + tt / 2], nat[10 + tt / 2], sel);
          w.w = __byte_perm(nat[12 + tt / 2], nat[14 + tt / 2], sel);
          *reinterpret_cast<uint4*>(kqd + row * kHD + 16 * tt) = w;
        }
        kscd[row] = kscale;
      }
      __syncthreads();
      if (!active) continue;

      float sc[NS][4];
      if constexpr (kInt8QK) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          int si[4] = {0, 0, 0, 0};
          const uint4 kw = *reinterpret_cast<const uint4*>(kq + (n * 8 + g) * kHD + 16 * t);
          mma_s8(si, qi[0], kw.x, kw.y);
          mma_s8(si, qi[1], kw.z, kw.w);
          const float2 kscale = *reinterpret_cast<const float2*>(ksc + n * 8 + t * 2);
          // ((float)s32 * (qs * c2)) * ks, in this order
          sc[n][0] = __fmul_rn(__fmul_rn(__int2float_rn(si[0]), rq[0]), kscale.x);
          sc[n][1] = __fmul_rn(__fmul_rn(__int2float_rn(si[1]), rq[0]), kscale.y);
          sc[n][2] = __fmul_rn(__fmul_rn(__int2float_rn(si[2]), rq[1]), kscale.x);
          sc[n][3] = __fmul_rn(__fmul_rn(__int2float_rn(si[3]), rq[1]), kscale.y);
        }
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const __nv_bfloat16* kp = ks + (n * 8 + g) * kLDS + kk * 16 + t * 2;
            mma_16816(sc[n], qa[kk], ld2(kp), ld2(kp + 8));
          }
      }
      // e rounded to bf16 feeds both the AV product and the denominator
      uint32_t pa[kTileK / 16][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        __nv_bfloat16 eb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + n * 8 + t * 2 + (i & 1);
          const float arg = kInt8QK ? sc[n][i] : sc[n][i] * c;
          const float e = key < Lk ? exp2f(fminf(arg, 110.f)) : 0.f;
          eb[i] = __float2bfloat16(e);
          rsum[i >> 1] += __bfloat162float(eb[i]);
        }
        pa[n / 2][(n % 2) * 2 + 0] = pack2(eb[0], eb[1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack2(eb[2], eb[3]);
      }
#pragma unroll
      for (int kc = 0; kc < kTileK / 16; ++kc)
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const __nv_bfloat16* vp = vs + (kc * 16 + t * 2) * kLDS + d * 8 + g;
          mma_16816(acc[d], pa[kc], pack2(vp[0], vp[kLDS]), pack2(vp[8 * kLDS], vp[9 * kLDS]));
        }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      }
      const float d0 = fmaxf(rsum[0], 1e-30f), d1 = fmaxf(rsum[1], 1e-30f);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int col = head * kHD + d * 8 + t * 2;
        *reinterpret_cast<float2*>(af + lr0 * ast + col) =
            make_float2(acc[d][0] / d0, acc[d][1] / d0);
        *reinterpret_cast<float2*>(af + lr1 * ast + col) =
            make_float2(acc[d][2] / d1, acc[d][3] / d1);
      }
    }
  }
  __syncthreads();

  // ---- per-row quant over the whole fp32 row, codes in place ------------
  for (int rr = warp; rr < kBM; rr += kWarps) {
    float* row = af + rr * ast;
    float vals[kMaxRowPerLane];
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowPerLane; ++i) {
      const int cc = lane + 32 * i;
      vals[i] = cc < D ? row[cc] : 0.f;
      mx = fmaxf(mx, fabsf(vals[i]));
    }
    const float scale = quant_scale(warp_max(mx));
    const float inv = __fdiv_rn(1.0f, scale);
    if (lane == 0) xs[rr] = scale;
    __syncwarp();  // every value of the row is read before a code lands
    int8_t* codes = reinterpret_cast<int8_t*>(row);
#pragma unroll
    for (int i = 0; i < kMaxRowPerLane; ++i) {
      const int cc = lane + 32 * i;
      if (cc < D) codes[cc] = quant_code(vals[i], inv);
    }
  }

  __syncthreads();

  // ---- int8 out-projection + bias + residual ----------------------------
  const int8_t* ac = reinterpret_cast<const int8_t*>(af);
  const long long ob = static_cast<long long>(b) * lq;
  for (int n0 = 0; n0 < D; n0 += kBN) {
    int acc[kMT][kNT][4];
    gemm_direct<kMT, kNT>(acc, ac, ast * 4, 0, Wt, D, D, n0 + warp * kNT * 8, fast);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = i * 16 + g + 8 * h, m = q0 + rr;
        if (m >= lq) continue;
        const float xr = xs[rr];
        const __nv_bfloat16* rrow = r + (ob + m) * D;
        __nv_bfloat16* orow = o + (ob + m) * D;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int n = n0 + warp * kNT * 8 + j * 8 + t * 2;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < D)
              orow[n + e] = __float2bfloat16(__fadd_rn(
                  epilogue(acc[i][j][2 * h + e], xr, s[n + e], bias[n + e]),
                  __bfloat162float(rrow[n + e])));
        }
      }
  }
}

template <bool kInt8QK>
int launch(const void* q, const void* k, const void* v, const void* Wt, const void* s,
           const void* bias, const void* r, void* o, int B, int lq, int Lk, int H, int q_sb,
           int q_sl, int k_sb, int k_sl, int v_sb, int v_sl, float c, void* stream) {
  const int D = H * kHD;
  if (H <= 0 || D > kMaxRowPerLane * 32 || B <= 0 || lq <= 0 || Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(kBM) * (D + 16) * sizeof(float) +
                       static_cast<size_t>(kSlots) * kSlotElems * sizeof(__nv_bfloat16) +
                       kBM * sizeof(float);
  auto kernel = attention_out_int8_kernel<kInt8QK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool fast = aligned16(Wt);  // D = H * 64
  const dim3 grid((lq + kBM - 1) / kBM, B);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int8_t*>(Wt),
      static_cast<const float*>(s), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(r), static_cast<__nv_bfloat16*>(o), lq, Lk, H, q_sb,
      q_sl, k_sb, k_sl, v_sb, v_sl, c, fast);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v strides in elements, last dim contiguous, rows 16-byte aligned
// (checked by the Python wrapper); W^T (D, D) int8 (the out-projection
// kernel transposed, k contiguous), s, bias (D) fp32;
// r, o (B, lq, D) bf16 contiguous, D = H * 64; c = 64^-0.5 * log2(e).
// Returns cudaGetLastError() after the launch.
extern "C" int attention_out_int8_bf16(const void* q, const void* k, const void* v,
                                       const void* Wt, const void* s, const void* bias,
                                       const void* r, void* o, int B, int lq, int Lk, int H,
                                       int q_sb, int q_sl, int k_sb, int k_sl, int v_sb,
                                       int v_sl, float c, void* stream) {
  return launch<false>(q, k, v, Wt, s, bias, r, o, B, lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb,
                       v_sl, c, stream);
}

// The int8 QK^T form: the same arguments, except that the constant is
// c2 = fp32(c / 127^2).
extern "C" int attention_out_int8_qk8_bf16(const void* q, const void* k, const void* v,
                                           const void* Wt, const void* s, const void* bias,
                                           const void* r, void* o, int B, int lq, int Lk,
                                           int H, int q_sb, int q_sl, int k_sb, int k_sl,
                                           int v_sb, int v_sl, float c2, void* stream) {
  return launch<true>(q, k, v, Wt, s, bias, r, o, B, lq, Lk, H, q_sb, q_sl, k_sb, k_sl, v_sb,
                      v_sl, c2, stream);
}
