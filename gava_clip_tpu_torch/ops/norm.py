"""LayerNorm with an fp32 island (port of gava_clip_tpu/ops/norm.py).

Normalizes in float32 whatever the activation dtype (biased variance,
eps 1e-5), then casts back to the input dtype.
"""

import torch


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)
