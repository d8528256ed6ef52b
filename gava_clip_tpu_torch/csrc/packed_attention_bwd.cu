// Packed whole-row attention backward for Hopper (sm_90a), bf16, from the
// saved forward output and per-head denominators.
//
// Replaces the TPU kernel gava_clip_tpu/ops/flash_attention.py:
// _attention_bwd_kernel (reached through _packed_backward's pl.pallas_call)
// and computes its function with its rounding points, not its block
// structure (the TPU kernel holds one whole row and all heads in VMEM):
//
//   q, do, o (B, Lq, H*64), k, v (B, Lk, H*64) bf16, den (B, Lq, H) fp32
//   -> dq (B, Lq, H*64), dk, dv (B, Lk, H*64) bf16. Per head:
//     inv_d = 1 / max(den, 1e-30)          delta = rowsum(do * o)   (fp32)
//     e     = bf16(exp2(min(q k^T * c, 110)))   c = Dh^-0.5 * log2(e)
//     ds    = bf16((e * inv_d) * (do v^T - delta))
//     dq = (ds k) * scale   dk = (ds^T q) * scale   dv = e^T bf16(do * inv_d)
//   with fp32 accumulation, the scale applied after the dot and one cast at
//   the store.
//
// What bounds it on an H100 SXM (data-sheet figures), per layer at the
// training shape B = 128 frame rows, Lq = 197, Lk = 214, H = 12: it reads q,
// do, o, k, v and den and writes dq, dk, dv, about 323 MB, so about 97 us at
// 3.35 TB/s; its five products are about 41 GFLOP, about 42 us at the
// 989 TFLOP/s bf16 dense peak: bandwidth-bound as long as the score tile
// stays on the chip. The two-kernel design (attention_bwd.cuh) rebuilds the
// score tile once per kernel from operands that sit in L2, which costs
// tensor-core work the bound does not count but keeps every sum inside one
// block: no atomics, bit-identical runs.

#include "attention_bwd.cuh"

// do and o are (B, Lq, H*64) contiguous, den (B, Lq, H) contiguous; q, k, v
// have element strides (batch, row) with a contiguous last dim and 16-byte
// aligned rows (checked by the Python wrapper). Returns cudaGetLastError()
// after the launches: 0 when both were accepted.
extern "C" int packed_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* den, void* dq, void* dk, void* dv, int B, int Lq,
    int Lk, int H, int Dh, int q_sb, int q_sl, int k_sb, int k_sl, int v_sb,
    int v_sl, float scale, void* stream) {
  if (Dh != attn::kHD) return static_cast<int>(cudaErrorInvalidValue);
  attn::BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.rowstat = static_cast<const float*>(den);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.Lq = Lq; a.Lk = Lk; a.H = H;
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl;
  a.scale = scale;
  a.c = scale * attn::kLog2e;
  a.causal = 0;
  return attn::launch_bwd<false>(a, B, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
