"""Linear / MLP primitives (port of gava_clip_tpu/ops/linear.py).

Parameters are dicts of tensors in the JAX layout: kernels are stored
(in_dim, out_dim), so application is `x @ kernel`. A w8a8 kernel leaf
{'qa': int8, 'scale': fp32} runs through the fused int8 kernels
(ops/int8_matmul.py); `int8_impl` picks the kernels ('kernel') or their
plain versions on any device ('plain'). Weight-only 'q' leaves (ROADMAP
B9), frozen-int8 training 'qt' leaves (ROADMAP A9) and a w8a8 MLP block
without a residual (ROADMAP B5a) are not ported.
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


def _not_ported(kind: str):
    if kind == "qa":
        return NotImplementedError(
            "a w8a8 MLP block without a residual needs the fused w8a8_mlp "
            "kernel, not ported yet (ROADMAP B5a)")
    if kind == "q":
        return NotImplementedError(
            "weight-only int8 ('q') leaves need the w8 dequant GEMM, not "
            "ported yet (ROADMAP B9)")
    return NotImplementedError(
        "frozen-int8 training ('qt') leaves come with the int8 training "
        "slice (ROADMAP A9)")


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor,
           int8_impl: str = "kernel") -> torch.Tensor:
    kernel = params["kernel"]
    kind = quant_kind(kernel)
    if kind == "qa":
        from .int8_matmul import w8a8_matmul
        y = w8a8_matmul(x.reshape(-1, x.shape[-1]), kernel,
                        params.get("bias"), impl=int8_impl)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if kind is not None:
        raise _not_ported(kind)
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

    With w8a8 kernels and a residual the whole block is ONE fused op
    (`w8a8_mlp_res`: LN, both int8 GEMMs, QuickGELU on the fp32 hidden and
    the residual add); it assumes `act` is QuickGELU, the only activation
    of the model, as the JAX fused path does. Without a residual that is
    the JAX `w8a8_mlp` kernel (ROADMAP B5a), not ported: it raises rather
    than round the hidden to the activation dtype between two GEMMs."""
    kind = quant_kind(params["fc1"]["kernel"])
    if kind == "qa" and residual is not None:
        from .int8_matmul import w8a8_mlp_res
        D = x.shape[-1]
        y = w8a8_mlp_res(x.reshape(-1, D), params["fc1"], params["fc2"],
                         (norm_params["scale"], norm_params["bias"]),
                         residual.reshape(-1, residual.shape[-1]),
                         impl=int8_impl)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if kind is not None:
        raise _not_ported(kind)
    out = mlp(params, layer_norm(x, norm_params["scale"],
                                 norm_params["bias"]), act, int8_impl)
    return out if residual is None else residual + out
