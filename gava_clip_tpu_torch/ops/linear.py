"""Linear / MLP primitives (port of gava_clip_tpu/ops/linear.py).

Parameters are dicts of tensors in the JAX layout: kernels are stored
(in_dim, out_dim), so application is `x @ kernel`. Only plain weights are
handled; quantized leaves belong to the w8a8 serving slice.
"""

from typing import Callable, Dict, Optional

import torch

from .norm import layer_norm


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    kernel = params["kernel"]
    if isinstance(kernel, dict):
        raise NotImplementedError(
            "quantized linear leaves are not ported yet (ROADMAP A5)")
    y = x @ kernel.to(x.dtype)
    bias = params.get("bias")
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def mlp(params: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor,
        act: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Two-layer MLP: fc1 -> act -> fc2."""
    return linear(params["fc2"], act(linear(params["fc1"], x)))


def mlp_block(params: Dict, norm_params: Dict, x: torch.Tensor,
              act: Callable[[torch.Tensor], torch.Tensor],
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm MLP: [residual +] fc2(act(fc1(LayerNorm(x))))."""
    out = mlp(params, layer_norm(x, norm_params["scale"],
                                 norm_params["bias"]), act)
    return out if residual is None else residual + out
