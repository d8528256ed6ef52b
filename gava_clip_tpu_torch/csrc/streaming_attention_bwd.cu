// Streaming (online-softmax) attention backward for Hopper (sm_90a), bf16.
//
// Replaces the backward kernels of the stock TPU flash attention that
// gava_clip_tpu/ops/flash_attention.py:_streaming_flash wraps
// (jax.experimental.pallas.ops.tpu.flash_attention: dq and dk/dv kernels),
// for the causal text tower (L = 77) and for non-causal keys beyond the
// packed kernel's length. From q, k, v, the forward output o and the saved
// per-row log-sum-exp:
//
//   p     = exp(q k^T * scale - lse)        masked / invisible keys give 0
//   delta = rowsum(do * o)
//   ds    = bf16(p * (do v^T - delta) * scale)
//   dq = ds k    dk = ds^T q    dv = bf16(p)^T do       (fp32 accumulation)
//
// At the text tower's shape (15 x 77 x 512, causal) the whole problem is a
// few hundred KB and a few MFLOP: latency-bound. There one launch does it
// all, a block per (batch row, head) with every row of the head in shared
// memory, each score tile formed once. At long L it is compute-bound (5
// products of 2 * Lq * Lk * 64 per head; causal tiles above the diagonal
// are skipped), and a block per (row, head) would leave most SMs idle: a
// dq kernel and a dk/dv kernel that each own their output tile, no
// atomics. Design of both forms in attention_bwd.cuh; the Python launch
// plan (ops/flash_attention.streaming_bwd_plan) picks the form from the
// layout exported below.

#include "attention_bwd.cuh"

// do and o are (B, Lq, H*64) contiguous, lse (B, H, Lq) contiguous fp32.
// form 1 is the one-launch form (smem_bytes: the layout's), form 0 the two
// kernels.
extern "C" int streaming_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* lse, void* dq, void* dk, void* dv, int B, int Lq,
    int Lk, int H, int Dh, int q_sb, int q_sl, int k_sb, int k_sl, int v_sb,
    int v_sl, float scale, int causal, int form, int smem_bytes, void* stream) {
  if (Dh != attn::kHD) return static_cast<int>(cudaErrorInvalidValue);
  attn::BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.o = static_cast<const __nv_bfloat16*>(o);
  a.rowstat = static_cast<const float*>(lse);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.Lq = Lq; a.Lk = Lk; a.H = H;
  a.q_sb = q_sb; a.q_sl = q_sl; a.k_sb = k_sb; a.k_sl = k_sl;
  a.v_sb = v_sb; a.v_sl = v_sl;
  a.scale = scale;
  a.c = scale * attn::kLog2e;
  a.causal = causal;
  return attn::launch_bwd(a, B, form, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The layout the launch plan is computed from: the most query rows and keys
// of the one-launch form, its dynamic shared bytes, its threads a block.
extern "C" void streaming_attention_bwd_layout(int* out) {
  out[0] = attn::kFRows;
  out[1] = attn::kFSmemBytes;
  out[2] = attn::kFThreads;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
