"""Multi-head attention (port of gava_clip_tpu/ops/attention.py).

Two implementations share one parameter layout
({"q", "k", "v", "out"}, each {"kernel" (in, out), "bias"}):

  * impl="xla": plain attention, fp32 softmax. Like the JAX einsum path it
    multiplies q by the scale in the compute dtype before the score product.
  * impl="flash": the attention kernels (ops/flash_attention.py), which
    scale the fp32 scores instead. Non-causal with at most 640 keys is the
    packed kernel with the one-pass exp2-clamp softmax; causal=True (the
    text tower) or longer keys the streaming kernel with a standard online
    softmax. Both are differentiable. The implementations round
    differently; each is held against its own JAX counterpart. The "xla"
    path is the differentiable oracle for all of them.
"""

from typing import Dict, Optional

import torch

from .flash_attention import flash_attention
from .linear import linear


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, mask: Optional[torch.Tensor] = None,
                   impl: str = "xla", causal: bool = False,
                   keep: Optional[Dict] = None) -> torch.Tensor:
    """Scaled dot-product attention over projected (B, L, H*Dh) q/k/v.
    mask: additive, broadcastable to (Lq, Lk), applied in fp32. keep: see
    `flash_attention` (the other implementation ignores it)."""
    if impl == "flash" and mask is None:
        return flash_attention(q, k, v, num_heads, causal=causal, keep=keep)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    Dh = D // num_heads
    if causal and mask is None:
        mask = torch.zeros(Lq, Lk, device=q.device).masked_fill(
            ~torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril(),
            float("-inf"))
    qh = q.reshape(B, Lq, num_heads, Dh).transpose(1, 2)
    kh = k.reshape(B, Lk, num_heads, Dh).transpose(1, 2)
    vh = v.reshape(B, Lk, num_heads, Dh).transpose(1, 2)
    # (B, H, Lq, Lk) fp32 scores from compute-dtype operands
    scores = (qh * Dh ** -0.5).float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype) @ vh
    return out.transpose(1, 2).reshape(B, Lq, D)


def multi_head_attention(params: Dict, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, num_heads: int,
                         mask: Optional[torch.Tensor] = None,
                         impl: str = "xla", causal: bool = False,
                         int8_impl: str = "kernel") -> torch.Tensor:
    """Full attention module: project q/k/v, attend, project out.
    int8_impl reaches the projections' quantized leaves (ops/linear.py)."""
    out = attention_core(linear(params["q"], q, int8_impl),
                         linear(params["k"], k, int8_impl),
                         linear(params["v"], v, int8_impl), num_heads,
                         mask=mask, impl=impl, causal=causal)
    return linear(params["out"], out, int8_impl)
