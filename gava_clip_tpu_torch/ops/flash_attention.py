"""Packed whole-row attention forward (port of the short-L, non-causal part of
gava_clip_tpu/ops/flash_attention.py).

q is (B, Lq, H*Dh), k/v are (B, Lk, H*Dh), packed as the projections emit
them — no head relayout. The softmax is the JAX kernel's one-pass form
(`_onepass_softmax_av_masked`), which is a different function from a
standard softmax once scores pass the clamp:

  * the scale folds into the exp2 constant: e = exp2(min(s * c, 110)) with
    c = Dh**-0.5 * log2(e) and s the fp32 score;
  * there is no max subtraction — the clamp at exp2-argument 110 is the
    semantics, not an optimisation;
  * e is cast to v's dtype BEFORE both the AV product and the denominator
    (on the TPU the denominator is the ones column of the same dot);
  * out = (e @ v) / max(sum(e), 1e-30), cast to the output dtype.

`flash_attention` dispatches on the tensor's device: a CPU tensor runs
`packed_attention_plain`; a CUDA tensor runs the hand-written kernel in
csrc/packed_attention.cu or raises. There is no fallback between the two.

`flash_attention_out_int8` is the w8a8 serving fusion (TPU
`_attention_out_kernel` + `_int8_outproj_epilogue`): the same attention
over the first `lq` query rows and all keys, kept in fp32, then a per-row
int8 quant over the whole H*Dh-wide row, the int8 out-projection, bias and
the residual add (csrc/attention_out_int8.cu; plain version
`attention_out_int8_plain`).
"""

from typing import Dict, Optional

import torch

_LOG2E = 1.4426950408889634
_CLAMP = 110.0
# above this key length the JAX package switches to the streaming kernel
# (ROADMAP B7), which is not ported yet
_PACKED_MAX_LK = 640
_KERNEL_HEAD_DIM = 64     # the only head width the kernel is built for

# launches of each hand-written kernel since the last reset; a run reads
# these to show that its main path went through the kernels
launch_counts = {"packed_attention": 0, "attention_out_int8": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, num_heads, D // num_heads).transpose(1, 2)


def _onepass_attention_f32(q, k, v, num_heads: int) -> torch.Tensor:
    """The one-pass clamp softmax attention, (B, Lq, H*Dh) fp32 output."""
    B, Lq, D = q.shape
    Dh = D // num_heads
    c = Dh ** -0.5 * _LOG2E
    qh = _heads(q, num_heads).float()
    kh = _heads(k, num_heads).float()
    vh = _heads(v, num_heads)
    s = qh @ kh.transpose(-1, -2)                     # (B, H, Lq, Lk) fp32
    e = torch.exp2(torch.clamp(s * c, max=_CLAMP)).to(v.dtype).float()
    num = e @ vh.float()
    den = e.sum(dim=-1, keepdim=True)
    out = num / torch.clamp(den, min=1e-30)
    return out.transpose(1, 2).reshape(B, Lq, D)


def packed_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the packed attention kernel (same math as
    `_onepass_softmax_av_masked` in the JAX package)."""
    return _onepass_attention_f32(q, k, v, num_heads).to(q.dtype)


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, causal: bool = False) -> torch.Tensor:
    """Standard-softmax oracle: equal to the one-pass form while every scaled
    score stays below the clamp."""
    B, Lq, D = q.shape
    Dh = D // num_heads
    qh = _heads(q, num_heads) * (Dh ** -0.5)
    kh, vh = _heads(k, num_heads), _heads(v, num_heads)
    scores = qh.float() @ kh.float().transpose(-1, -2)
    if causal:
        mask = torch.ones(Lq, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype) @ vh
    return out.transpose(1, 2).reshape(B, Lq, D)


def _check_kernel_args(q, k, v, num_heads):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("packed attention kernel needs q, k, v on one "
                         "CUDA device")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("packed attention kernel takes bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q/k/v must be (B, L, H*Dh)")
    B, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D % num_heads:
        raise ValueError(f"width {D} not divisible by {num_heads} heads")
    if D // num_heads != _KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {D // num_heads}: the kernel is built "
                         f"for {_KERNEL_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} last dim must be contiguous")
        # the kernel moves 16-byte vectors of 8 bf16 values
        if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
            raise ValueError(f"{name} rows must be 16-byte aligned")


def packed_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Launch csrc/packed_attention.cu on the current stream (no sync)."""
    from ._cuda import load_library
    _check_kernel_args(q, k, v, num_heads)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    Dh = D // num_heads
    lib = load_library("packed_attention")
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    if B == 0 or Lq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.packed_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Lq, Lk, num_heads, Dh,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            Dh ** -0.5 * _LOG2E, stream)
    if err != 0:
        raise RuntimeError(f"packed_attention kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    launch_counts["packed_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int = 12, causal: bool = False) -> torch.Tensor:
    """Self-attention over packed (B, L, H*Dh) q/k/v (JAX `flash_attention`).

    Non-causal with Lk <= 640 is the packed whole-row path. The streaming
    path (causal, or longer keys) is not ported yet and raises on every
    device."""
    if causal or k.shape[1] > _PACKED_MAX_LK:
        raise NotImplementedError(
            "causal / Lk > 640 attention needs the streaming kernel, not "
            "ported yet (ROADMAP B7)")
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, num_heads)
    if q.device.type == "cuda":
        return packed_attention_cuda(q, k, v, num_heads)
    raise ValueError(f"no packed attention for device {q.device}")


# ---------------------------------------------------------------------------
# w8a8 serving fusion: attention + int8 out-projection + residual
# ---------------------------------------------------------------------------

def attention_out_int8_plain(q, k, v, num_heads: int, out_params: Dict,
                             residual: torch.Tensor,
                             lq: Optional[int] = None) -> torch.Tensor:
    """Plain version of csrc/attention_out_int8.cu: residual +
    w8a8_linear(attention(q[:, :lq], k, v)) with the attention output kept
    in fp32 up to its per-row quant."""
    from .int8_matmul import int_matmul, quant_rows, rescale
    lq = q.shape[1] if lq is None else lq
    a = _onepass_attention_f32(q[:, :lq], k, v, num_heads)
    codes, xs = quant_rows(a)
    kernel = out_params["kernel"]
    y = rescale(int_matmul(codes, kernel["qa"]), xs, kernel["scale"],
                out_params["bias"])
    return (y + residual.float()).to(residual.dtype)


def attention_out_int8_cuda(q, k, v, num_heads: int, out_params: Dict,
                            residual: torch.Tensor,
                            lq: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/attention_out_int8.cu on the current stream (no sync)."""
    from ._cuda import load_library
    _check_kernel_args(q, k, v, num_heads)
    B, Lq_arr, D = q.shape
    lq = Lq_arr if lq is None else lq
    if not 0 <= lq <= Lq_arr:
        raise ValueError(f"lq {lq} outside 0..{Lq_arr}")
    from .int8_matmul import _kernel_weight
    kernel = out_params["kernel"]
    wt = _kernel_weight("attention_out_int8", kernel, D, D)
    scale, bias = kernel["scale"], out_params["bias"]
    for name, t in (("out kernel", wt), ("scale", scale), ("bias", bias),
                    ("residual", residual)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if tuple(residual.shape) != (B, lq, D) or residual.dtype != q.dtype:
        raise ValueError(f"residual {residual.dtype} "
                         f"{tuple(residual.shape)}, expected ({B}, {lq}, "
                         f"{D}) {q.dtype}")
    scale = scale.reshape(-1).float().contiguous()
    bias = bias.reshape(-1).float().contiguous()
    r = residual.contiguous()
    out = torch.empty((B, lq, D), dtype=q.dtype, device=q.device)
    if B == 0 or lq == 0:
        return out
    lib = load_library("attention_out_int8")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.attention_out_int8_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wt.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), r.data_ptr(), out.data_ptr(),
            B, lq, k.shape[1], num_heads, q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            (D // num_heads) ** -0.5 * _LOG2E, stream)
    if err != 0:
        raise RuntimeError(f"attention_out_int8 kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    launch_counts["attention_out_int8"] += 1
    return out


def flash_attention_out_int8(q, k, v, num_heads: int, out_params: Dict,
                             residual: torch.Tensor,
                             lq: Optional[int] = None,
                             impl: str = "kernel") -> torch.Tensor:
    """residual + Linear_w8a8(attention(q[:, :lq], k, v)) (JAX
    `flash_attention_out_int8`). q may be longer than lq (the full kv-row
    projection); the output has lq rows. impl='plain' runs the plain
    version on any device; 'kernel' the plain version on the CPU and the
    CUDA kernel on a card."""
    if k.shape[1] > _PACKED_MAX_LK:
        raise NotImplementedError(
            "Lk > 640 attention needs the streaming kernel, not ported yet "
            "(ROADMAP B7)")
    if impl == "plain" or q.device.type == "cpu":
        return attention_out_int8_plain(q, k, v, num_heads, out_params,
                                        residual, lq)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if q.device.type == "cuda":
        return attention_out_int8_cuda(q, k, v, num_heads, out_params,
                                       residual, lq)
    raise ValueError(f"no attention kernel for device {q.device}")
