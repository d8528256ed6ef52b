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
act_quant=False (w8, weight-only) makes {'q', 'scale'} leaves, which
`ops.linear` runs through the dequant GEMM (`int8_matmul.quantized_linear`).
`quantize_frozen_for_train` makes {'qt', 'scale'} leaves of the frozen
half of a train state (`--int8_frozen`), which `ops.linear` and the vision
tower run through the straight-through int8 ops (int8 forward through the
w8a8 kernels, dx only in the backward).

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


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """int8 values times their scales, both cast to `dtype` first (JAX
    `dequantize_weight`: two roundings in a low-precision dtype)."""
    return q.to(dtype) * scale.to(dtype)


def _quantize_visit(tree, path: str, key: str, quantize=quantize_weight):
    if isinstance(tree, dict):
        return {k: _quantize_visit(v, f"{path}/{k}", key, quantize)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_quantize_visit(v, f"{path}/{i}", key, quantize)
                for i, v in enumerate(tree)]
    if tree is not None and path.endswith("kernel") and tree.dim() >= 2 and \
            any(f"/{k}/" in path for k in QUANT_KEY_FRAGMENTS):
        q, scale = quantize(tree)
        return {key: q, "scale": scale}
    return tree


def _quantize_frozen_weight(w: torch.Tensor):
    """JAX `quantize_frozen_for_train`'s per-leaf formula: the scale is 1
    where a column's absmax is 0, else absmax / 127; the values are
    w / scale rounded half to even and clipped to +-127. (`quantize_weight`
    tests the scale for 0 instead, which differs where absmax / 127
    underflows.)"""
    w = w.detach().float()
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_frozen_for_train(frozen: Dict) -> Dict:
    """The frozen half of a train state with its projection kernels (ndim
    >= 2, under `/attn/` or `/mlp/`) as {'qt': int8 (K, N), 'scale': fp32
    (1, N)} leaves; None placeholders and every other leaf pass through.
    Bit-equal to the JAX function on the same weights. The trainable half
    must never pass through here: its leaves need their own gradients."""
    return _quantize_visit(frozen, "", "qt", _quantize_frozen_weight)


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
    """The int8 payload of a quantized leaf dict (exactly 'q', 'qa' or 'qt'
    beside 'scale', and at most the kernel-layout copy `<key>_t` that
    `int8_matmul.with_kernel_layout` adds), or None."""
    if isinstance(x, dict):
        for k in QUANT_KEYS:
            if x.keys() - {k + "_t"} == {k, "scale"}:
                return x[k]
    return None


def prepare_inference_params(params: Dict, quantize: str = "",
                             compute_dtype=None) -> Dict:
    """Eval / serving param prep: optionally int8-quantize the projection
    kernels (quantize in {'', 'w8', 'w8a8'}) and cast the remaining float
    leaves to compute_dtype. The scales of quantized leaves (exactly
    {'q' | 'qa' | 'qt', 'scale'}; a LayerNorm's {'scale', 'bias'} is not
    one) stay fp32: every kernel's contract."""
    if quantize not in ("", "w8", "w8a8"):
        raise ValueError(f"quantize must be '', 'w8' or 'w8a8', got "
                         f"{quantize!r}")
    if quantize:
        params = quantize_tower_params(params, act_quant=quantize == "w8a8")
    if compute_dtype is None or compute_dtype == torch.float32:
        return params

    def cast(x):
        if _quant_values(x) is not None:
            return x
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cast(v) for v in x]
        return x.to(compute_dtype) if x.is_floating_point() else x

    return cast(params)


def _flat_leaves(tree, path=()):
    """{path: leaf} with quantized leaf dicts kept whole."""
    if _quant_values(tree) is not None or not isinstance(tree, (dict, list)):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_leaves(v, path + (str(k),)))
    return out


def quantization_error(params: Dict, quantized: Dict) -> float:
    """Max relative Frobenius error over the quantized kernels, one per
    layer in the port's tree (a diagnostic). Every leaf form counts ('q' /
    'qa' / 'qt'); the patch-embed sidecar has no float counterpart and is
    skipped. A tree with no quantized leaf raises: it must never read as
    0.0."""
    flat_p = _flat_leaves(params)
    errs = []
    for path, leaf in _flat_leaves(quantized).items():
        q = _quant_values(leaf)
        if q is None or path not in flat_p:
            continue
        orig = flat_p[path].float()
        deq = q.float() * leaf["scale"].float()
        errs.append((torch.linalg.norm(deq - orig)
                     / torch.linalg.norm(orig)).item())
    if not errs:
        raise ValueError("quantization_error: no quantized leaves found; "
                         "refusing to report 0.0 for a non-quantized tree")
    return float(max(errs))


def dequantize_tree(params, dtype=torch.bfloat16):
    """Float kernels (values * scale in `dtype`) in place of every quantized
    leaf; the patch-embed sidecar `kernel_q8` is dropped (the float kernel
    beside it is the real one)."""
    q = _quant_values(params)
    if q is not None:
        return dequantize_weight(q, params["scale"], dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()
                if k != "kernel_q8"}
    if isinstance(params, list):
        return [dequantize_tree(v, dtype) for v in params]
    return params
