"""Int8 quantization of the serving weights (port of gava_clip_tpu/ops/quant.py).

Per-output-channel symmetric int8 weights with fp32 scales. Only the
projection kernels under `/attn/` or `/mlp/` are quantized (attention
q/k/v/out, MLP fc1/fc2); `summary_attn`, `cls_proj`, `proj`, the
embeddings and the LayerNorms stay float.

act_quant=True (w8a8, throughput serving) makes each targeted kernel
{'qa': int8 (K, N), 'scale': fp32 (1, N)}, which `ops.linear` and the
vision tower run through the fused int8 kernels (ops/int8_matmul.py,
ops/flash_attention.py), and adds the int8 sidecar `kernel_q8` beside the
float patch-embed kernel for the patch-major input path.
act_quant=False (w8) makes {'q', 'scale'} leaves; nothing in the port
consumes them yet: they need the weight-only int8 GEMM (ROADMAP B9).

Trees are the port's nested dicts (blocks as a per-layer list); the result
is bit-equal to the JAX function on the same weights.
"""

from typing import Dict, Optional, Tuple

import torch

QUANT_KEY_FRAGMENTS = ("attn", "mlp")
QUANT_KEYS = ("q", "qa", "qt")


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) kernel -> (int8 values, fp32 per-output-channel scales
    (1, out)): scale = absmax / 127 (1 where the column is all zero),
    values rounded half to even and clipped to +-127."""
    w = w.detach().float()
    scale = w.abs().amax(dim=-2, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_visit(tree, path: str, key: str):
    if isinstance(tree, dict):
        return {k: _quantize_visit(v, f"{path}/{k}", key)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_quantize_visit(v, f"{path}/{i}", key)
                for i, v in enumerate(tree)]
    if path.endswith("kernel") and tree.dim() >= 2 and \
            any(f"/{k}/" in path for k in QUANT_KEY_FRAGMENTS):
        q, scale = quantize_weight(tree)
        return {key: q, "scale": scale}
    return tree


def quantize_tower_params(params: Dict, act_quant: bool = False) -> Dict:
    """Quantize the projection kernels of a nested param dict; returns a new
    tree (the input is not mutated). With act_quant the patch embed also
    gets its int8 sidecar `kernel_q8` (quantize AFTER folding the
    normalization, so the sidecar holds the folded W')."""
    params = _quantize_visit(params, "", "qa" if act_quant else "q")
    pe = params.get("visual", {}).get("patch_embed")
    if act_quant and isinstance(pe, dict) and \
            isinstance(pe.get("kernel"), torch.Tensor):
        q, scale = quantize_weight(pe["kernel"])
        visual = dict(params["visual"])
        visual["patch_embed"] = dict(pe, kernel_q8={"qa": q, "scale": scale})
        params = dict(params, visual=visual)
    return params


def _quant_values(x) -> Optional[torch.Tensor]:
    """The int8 payload of a quantized leaf dict ('q', 'qa' or 'qt' beside
    'scale'), or None."""
    if isinstance(x, dict) and "scale" in x and len(x) == 2:
        for k in QUANT_KEYS:
            if k in x:
                return x[k]
    return None


def dequantize_tree(params, dtype=torch.bfloat16):
    """Float kernels (values * scale in `dtype`) in place of every quantized
    leaf; the patch-embed sidecar `kernel_q8` is dropped (the float kernel
    beside it is the real one)."""
    q = _quant_values(params)
    if q is not None:
        return q.to(dtype) * params["scale"].to(dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()
                if k != "kernel_q8"}
    if isinstance(params, list):
        return [dequantize_tree(v, dtype) for v in params]
    return params
