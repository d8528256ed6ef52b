"""Linear / MLP primitives (port of gava_clip_tpu/ops/linear.py).

Parameters are dicts of tensors in the JAX layout: kernels are stored
(in_dim, out_dim), so application is `x @ kernel`. A w8a8 kernel leaf
{'qa': int8, 'scale': fp32} runs through the fused int8 kernels
(ops/int8_matmul.py), a weight-only leaf {'q': int8, 'scale': fp32}
through the w8 dequant GEMM (`quantized_linear`), a frozen-training leaf
{'qt': int8, 'scale': fp32} (`--int8_frozen`) through the straight-through
int8 ops (an int8 forward, dx alone in the backward); `int8_impl` picks
the kernels ('kernel') or their plain versions on any device ('plain').
"""

from typing import Callable, Dict, Optional

import torch

from .norm import layer_norm


def quant_kind(kernel) -> Optional[str]:
    """'qa' / 'q' / 'qt' for a quantized kernel leaf, None for a tensor."""
    if isinstance(kernel, torch.Tensor):
        return None
    for key in ("qa", "q", "qt"):
        if key in kernel:
            return key
    raise TypeError(f"unknown kernel leaf with keys {list(kernel)}")


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor,
           int8_impl: str = "kernel") -> torch.Tensor:
    kernel = params["kernel"]
    kind = quant_kind(kernel)
    if kind == "qa":
        from .int8_matmul import w8a8_matmul
        y = w8a8_matmul(x.reshape(-1, x.shape[-1]), kernel,
                        params.get("bias"), impl=int8_impl)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if kind == "q":
        from .int8_matmul import quantized_linear
        return quantized_linear(params, x, impl=int8_impl)
    if kind == "qt":
        from .int8_matmul import int8_linear_st
        return int8_linear_st(x, kernel, params.get("bias"), impl=int8_impl)
    y = x @ kernel.to(x.dtype)
    bias = params.get("bias")
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def mlp(params: Dict[str, Dict[str, torch.Tensor]], x: torch.Tensor,
        act: Callable[[torch.Tensor], torch.Tensor],
        int8_impl: str = "kernel") -> torch.Tensor:
    """Two-layer MLP: fc1 -> act -> fc2."""
    return linear(params["fc2"], act(linear(params["fc1"], x, int8_impl)),
                  int8_impl)


def mlp_block(params: Dict, norm_params: Dict, x: torch.Tensor,
              act: Callable[[torch.Tensor], torch.Tensor],
              residual: Optional[torch.Tensor] = None,
              int8_impl: str = "kernel") -> torch.Tensor:
    """Pre-norm MLP: [residual +] fc2(act(fc1(LayerNorm(x)))).

    With w8a8 kernels the whole block is ONE fused op (`w8a8_mlp_res`, or
    `w8a8_mlp` without a residual: LN, both int8 GEMMs, QuickGELU on the
    fp32 hidden and the residual add); it assumes `act` is QuickGELU, the
    only activation of the model, as the JAX fused path does. Frozen-training
    'qt' leaves with a residual are one straight-through op over the same
    fused forward (`int8_mlp_st`); without one (the text tower's MLP) they
    take the plain branch, each `linear` through `int8_linear_st`, as in
    the JAX package. Weight-only 'q' leaves take the plain branch, each
    `linear` through the w8 GEMM."""
    kind = quant_kind(params["fc1"]["kernel"])
    if kind == "qt" and residual is not None:
        from .int8_matmul import int8_mlp_st
        y = int8_mlp_st(x.reshape(-1, x.shape[-1]), params["fc1"],
                        params["fc2"],
                        (norm_params["scale"], norm_params["bias"]),
                        residual.reshape(-1, residual.shape[-1]),
                        impl=int8_impl)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if kind == "qa":
        from .int8_matmul import w8a8_mlp, w8a8_mlp_res
        x2 = x.reshape(-1, x.shape[-1])
        ln = (norm_params["scale"], norm_params["bias"])
        if residual is not None:
            y = w8a8_mlp_res(x2, params["fc1"], params["fc2"], ln,
                             residual.reshape(-1, residual.shape[-1]),
                             impl=int8_impl)
        else:
            y = w8a8_mlp(x2, params["fc1"], params["fc2"], ln=ln,
                         impl=int8_impl)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    out = mlp(params, layer_norm(x, norm_params["scale"],
                                 norm_params["bias"]), act, int8_impl)
    return out if residual is None else residual + out
