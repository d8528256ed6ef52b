"""Vita-CLIP vision tower (port of gava_clip_tpu/models/vision.py: the bf16
and the w8a8 serving paths, and the bf16 / fp32 training path).

Per-frame ViT with summary, local and global prompt tokens; the prompt
tokens are attention KEYS only (queries are [cls, patches]), as in the JAX
tower. Parameters are a nested dict (or `ParamTree`) in the JAX layout,
except that `blocks` is a list with one dict per layer where the JAX tree
stacks the layers on a leading axis. The JAX `lax.scan` over the blocks is
a Python loop here.

w8a8 serving (kernels quantized by ops/quant.quantize_tower_params) runs
each block through three fused int8 ops: LN1 + q/k/v
(`w8a8_matmul3_cat`), attention + out-projection + residual
(`flash_attention_out_int8`) and LN2 + MLP + residual (`w8a8_mlp_res`);
the patch-major embed runs its int8 sidecar through `w8a8_matmul`. With
the switch `ops.extras_kernel.set_fused_extras` on, the prompt extras in
front of the qkv op are one fused launch too (`fused_extras`, fp32
arithmetic) instead of about ten stock ops. In the w8 mode (weight-only
'q' leaves) the block is the bf16 one with every projection through the w8
dequant GEMM. The
TPU's 8-row padded layout is not ported, only its semantics: the queries
are the first Lx rows, the keys all Lx + Le rows with the extras in the
order [global, summary, local], and LN1 and the quant act on every kv row.

Training runs the same bf16 `_block` under autograd: the gradient reaches
the prompts (global, local, summary) only through the keys-only extra rows
of the attention kernel's dk / dv, and `time_embed` through dx of all the
frozen blocks. `remat="full"` recomputes each block in the backward
(`torch.utils.checkpoint`); the JAX package's named policies keep part of a
block (`_block_remat`): `save_attn` the attention output and denominators,
`save_attn_qkv` also q, k, v, `save_attn_mlp` also the fc1 pre-activation,
`dots` the outputs of the GEMMs. Under the three `save_attn*` policies the
attention forward kernel is not launched again in the backward.
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import extras_kernel
from ..ops.activations import quick_gelu
from ..ops.attention import attention_core, multi_head_attention
from ..ops.flash_attention import flash_attention_out_int8
from ..ops.int8_matmul import w8a8_matmul, w8a8_matmul3_cat
from ..ops.linear import linear, mlp_block, quant_kind
from ..ops.norm import layer_norm
from .common import (init_attention, init_layer_norm, init_linear, normal,
                     prompt_init_limit, uniform)


@dataclass(frozen=True)
class VisionConfig:
    input_size: Tuple[int, int] = (224, 224)
    num_frames: int = 8
    feature_dim: int = 768
    patch_size: Tuple[int, int] = (16, 16)
    heads: int = 12
    layers: int = 12
    mlp_factor: float = 4.0
    embed_dim: int = 512
    use_summary_token: bool = False
    use_local_prompts: bool = False
    use_global_prompts: bool = False
    num_global_prompts: int = 8

    @property
    def num_patches(self) -> int:
        return (self.input_size[0] // self.patch_size[0]) * \
               (self.input_size[1] // self.patch_size[1])


def init_vision_params(gen: Optional[torch.Generator], cfg: VisionConfig,
                       device=None):
    """Random vision-tower params (the JAX init's distributions). With
    device='meta' only the shapes are made (gen may be None)."""
    D = cfg.feature_dim
    hidden = round(cfg.mlp_factor * D)
    lim = prompt_init_limit(cfg.patch_size, D)

    def one_block():
        blk = {
            "attn": init_attention(gen, D, device=device),
            "norm1": init_layer_norm(D, device),
            "mlp": {"fc1": init_linear(gen, D, hidden, bias_std=1e-6,
                                       device=device),
                    "fc2": init_linear(gen, hidden, D, bias_std=1e-6,
                                       device=device)},
            "norm2": init_layer_norm(D, device),
        }
        if cfg.use_summary_token or cfg.use_local_prompts:
            blk["cls_proj"] = init_linear(gen, D, D, xavier=False,
                                          device=device)
        if cfg.use_summary_token:
            blk["summary_ln"] = init_layer_norm(D, device)
            blk["summary_attn"] = init_attention(gen, D, device=device)
        if cfg.use_local_prompts:
            blk["local_prompts"] = uniform(gen, (1, cfg.num_frames, D),
                                           -lim, lim, device)
        return blk

    params = {
        "patch_embed": init_linear(gen, cfg.patch_size[0]
                                   * cfg.patch_size[1] * 3, D, xavier=False,
                                   device=device),
        "cls_token": normal(gen, (D,), 0.02, device),
        "pos_embed": normal(gen, (cfg.num_patches + 1, D), 0.02, device),
        "time_embed": normal(gen, (cfg.num_frames, D), 0.02, device),
        "blocks": [one_block() for _ in range(cfg.layers)],
        "ln_pre": init_layer_norm(D, device),
        "ln_post": init_layer_norm(D, device),
        "proj": normal(gen, (D, cfg.embed_dim), D ** -0.5, device),
    }
    if cfg.use_global_prompts:
        params["global_prompts"] = uniform(
            gen, (cfg.layers, cfg.num_global_prompts, D), -lim, lim, device)
    return params


def patchify(x, patch_size: Tuple[int, int]):
    """(B, T, H, W, C) -> (B, T, N, ph*pw*C) patch-major rows, for a numpy
    array (host side) or a tensor."""
    B, T, H, W, C = x.shape
    ph, pw = patch_size
    x = x.reshape(B, T, H // ph, ph, W // pw, pw, C)
    order = (0, 1, 2, 4, 3, 5, 6)
    x = x.permute(order) if isinstance(x, torch.Tensor) else \
        x.transpose(order)
    return x.reshape(B, T, (H // ph) * (W // pw), ph * pw * C)


def patch_embed(params, x: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """(BT, H, W, 3) -> (BT, N, D): the stride == kernel patch conv as a
    patch relayout and one matmul against the (ph*pw*3, D) kernel (the same
    math as the JAX NHWC/HWIO conv, without cuDNN)."""
    BT = x.shape[0]
    rows = patchify(x.reshape(1, BT, *x.shape[1:]), cfg.patch_size)[0]
    return linear({"kernel": params["kernel"], "bias": params.get("bias")},
                  rows)


def fold_normalize_into_patch_embed(pe_params, mean: Sequence[float],
                                    std: Sequence[float],
                                    patch_size=(16, 16)):
    """Fold the uint8 -> normalized-float preprocessing into the patch-embed
    weights, so the device consumes raw uint8 patch rows:
        W'[i, :] = W[i, :] / (255 * std[c(i)])
        b'       = b - sum_i (mean[c(i)] / std[c(i)]) * W[i, :]
    with c(i) = i % 3 (patchify keeps (ph, pw, C) order). Float32."""
    kernel = pe_params["kernel"].float()
    P = kernel.shape[0]
    mean = torch.tensor(np.tile(np.asarray(mean, np.float32), P // 3),
                        device=kernel.device)
    std = torch.tensor(np.tile(np.asarray(std, np.float32), P // 3),
                       device=kernel.device)
    b = pe_params.get("bias")
    b = torch.zeros(kernel.shape[1], device=kernel.device) if b is None \
        else b.float()
    out = dict(pe_params)
    out["kernel"] = kernel / (255.0 * std)[:, None]
    out["bias"] = b - ((mean / std)[:, None] * kernel).sum(dim=0)
    return out


def patch_embed_patches(params, x: torch.Tensor, compute_dtype,
                        int8_impl: str = "kernel") -> torch.Tensor:
    """Patch-major embed: (BT, N, ph*pw*C) -> (BT, N, D), one matmul; with
    the int8 sidecar `kernel_q8` (w8a8 serving) the fused w8a8 GEMM."""
    q8 = params.get("kernel_q8")
    if q8 is not None:
        BT, N, P = x.shape
        y = w8a8_matmul(x.reshape(BT * N, P).to(compute_dtype), q8,
                        params.get("bias"), impl=int8_impl)
        return y.reshape(BT, N, y.shape[-1])
    return linear({"kernel": params["kernel"], "bias": params.get("bias")},
                  x.to(compute_dtype))


def resize_time_embed(time_embed: torch.Tensor, T: int) -> torch.Tensor:
    """Nearest-neighbour resize of (T_train, D) to (T, D)
    (F.interpolate(mode='nearest'))."""
    T_train = time_embed.shape[0]
    if T == T_train:
        return time_embed
    idx = (torch.arange(T, device=time_embed.device) * T_train) // T
    return time_embed[idx]


def prompt_extras(p, g_prompt: Optional[torch.Tensor], x: torch.Tensor,
                  cfg: VisionConfig):
    """The prompt rows of one block from stock ops, in x's dtype: ([global
    (BT, G, D)], [summary (BT, 1, D)], [local (BT, Tb, D)]) for the prompt
    kinds that are on, and the summary tokens (Bb, Tb, D) or None."""
    BT, _, D = x.shape
    G = cfg.num_global_prompts
    Tb = cfg.num_frames
    Bb = BT // Tb
    summary = None
    extras = []
    if cfg.use_summary_token or cfg.use_local_prompts:
        cls_proj = linear(p["cls_proj"], x[:, 0].reshape(Bb, Tb, D))
    if cfg.use_global_prompts:
        extras.append(g_prompt[None].to(x.dtype).expand(BT, G, D))
    if cfg.use_summary_token:
        s_norm = layer_norm(cls_proj, p["summary_ln"]["scale"],
                            p["summary_ln"]["bias"])
        summary = cls_proj + multi_head_attention(
            p["summary_attn"], s_norm, s_norm, s_norm, cfg.heads, impl="xla")
        extras.append(summary.reshape(BT, 1, D))
    if cfg.use_local_prompts:
        lp = p["local_prompts"].to(x.dtype) + cls_proj          # (Bb, Tb, D)
        # every frame row of a pseudo-video attends over the same Tb prompts
        extras.append(lp[:, None].expand(Bb, Tb, Tb, D).reshape(BT, Tb, D))
    return extras, summary


def _block(p, g_prompt: Optional[torch.Tensor], x: torch.Tensor,
           cfg: VisionConfig, attn_impl: str, int8_impl: str = "kernel"):
    """One prompt-aware transformer block over per-frame token rows.

    x: (B*T, 1+N, D) = [cls, patches]. Returns (x, summary | None). The
    global prompts, the summary token and the local prompts are appended
    as attention keys only. Like the reference, the summary/local grouping
    uses the TRAIN-time frame count cfg.num_frames."""
    BT, Lx, D = x.shape
    G = cfg.num_global_prompts
    Tb = cfg.num_frames

    w8a8 = quant_kind(p["attn"]["q"]["kernel"]) == "qa"
    fused_out = attn_impl == "flash" and \
        quant_kind(p["attn"]["out"]["kernel"]) == "qa"
    # the whole prompt branch in one launch: the w8a8 block with the fused
    # out-projection and all three prompt kinds on (the switch is read here,
    # at every call)
    use_fused_extras = (extras_kernel.FUSED_EXTRAS and w8a8 and fused_out
                        and cfg.use_summary_token and cfg.use_local_prompts
                        and cfg.use_global_prompts)

    if use_fused_extras:
        fused_e, summary = extras_kernel.fused_extras(
            x[:, 0], p, g_prompt, Tb=Tb, num_heads=cfg.heads,
            le_pad=G + 1 + Tb, impl=int8_impl)
        extras = [fused_e]
    else:
        extras, summary = prompt_extras(p, g_prompt, x, cfg)
    if w8a8:
        # LN1 + one shared quant + the three int8 projections over the
        # per-clip rows [x; extras], the concatenation never materialised
        names = ("q", "k", "v")
        e = None if not extras else (extras[0] if len(extras) == 1
                                     else torch.cat(extras, dim=1))
        qp, kp, vp = w8a8_matmul3_cat(
            x, e, [p["attn"][n]["kernel"] for n in names],
            [p["attn"][n]["bias"] for n in names],
            (p["norm1"]["scale"], p["norm1"]["bias"]), impl=int8_impl)
        if fused_out:
            # the first Lx kv rows are the queries; the fp32 attention
            # output never leaves the kernel
            x = flash_attention_out_int8(qp, kp, vp, cfg.heads,
                                         p["attn"]["out"], x, lq=Lx,
                                         impl=int8_impl)
        else:
            attn = attention_core(qp[:, :Lx], kp, vp, cfg.heads,
                                  impl=attn_impl)
            x = x + linear(p["attn"]["out"], attn, int8_impl)
    else:
        kv = torch.cat([x] + extras, dim=1) if extras else x
        kv_n = layer_norm(kv, p["norm1"]["scale"], p["norm1"]["bias"])
        x = x + multi_head_attention(p["attn"], kv_n[:, :Lx], kv_n, kv_n,
                                     cfg.heads, impl=attn_impl,
                                     int8_impl=int8_impl)
    x = mlp_block(p["mlp"], p["norm2"], x, quick_gelu, residual=x,
                  int8_impl=int8_impl)
    return x, summary


_NAMED_REMAT = ("dots", "save_attn", "save_attn_qkv", "save_attn_mlp")


def _remat_policy(remat) -> Optional[str]:
    """None for False / 'none', 'full' for True / 'full', the name of a
    named policy; anything else raises."""
    if remat in (False, None, "none"):
        return None
    if remat in (True, "full"):
        return "full"
    if remat in _NAMED_REMAT:
        return remat
    raise ValueError(f"unknown remat policy {remat!r}")


def _pre_attention(p, g_prompt, x, cfg: VisionConfig, int8_impl: str):
    """Everything of a float block in front of the attention call: prompt
    extras, LN1 over [x; extras], the three projections. Returns q (the
    first Lx rows only), k, v and the summary tokens."""
    Lx = x.shape[1]
    extras, summary = prompt_extras(p, g_prompt, x, cfg)
    kv = torch.cat([x] + extras, dim=1) if extras else x
    kv_n = layer_norm(kv, p["norm1"]["scale"], p["norm1"]["bias"])
    return (linear(p["attn"]["q"], kv_n[:, :Lx], int8_impl),
            linear(p["attn"]["k"], kv_n, int8_impl),
            linear(p["attn"]["v"], kv_n, int8_impl), summary)


def _mlp_hidden(p, x, attn, int8_impl: str):
    """Out-projection + residual, then LN2 and fc1: (x, pre-activation)."""
    x = x + linear(p["attn"]["out"], attn, int8_impl)
    h = layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"])
    return x, linear(p["mlp"]["fc1"], h, int8_impl)


def _post_attention(p, x, attn, int8_impl: str):
    """Everything of a float block behind the attention call."""
    x, h = _mlp_hidden(p, x, attn, int8_impl)
    return x + linear(p["mlp"]["fc2"], quick_gelu(h), int8_impl)


_GEMM_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_gemm_outputs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat='dots': the products without a
    batch dimension (the projections) keep their outputs, everything else
    (LayerNorm, activations, concatenations, the attention) is recomputed."""
    return CheckpointPolicy.MUST_SAVE if op in _GEMM_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _block_remat(policy: str, p, g_prompt, x, cfg: VisionConfig,
                 attn_impl: str, int8_impl: str):
    """`_block` with part of its activations dropped after the forward and
    rebuilt in the backward (the JAX package's `jax.checkpoint` policies).
    A custom autograd.Function is opaque to torch's op-level selective
    checkpointing, so the `save_attn*` policies cut the block into
    checkpointed segments around the attention call instead:

      full           one segment: the whole block is recomputed, the
                     attention forward kernel with it;
      save_attn      [extras, LN1, q/k/v, attention] is one segment whose
                     recomputation takes the attention's kept output and
                     denominators (`keep` of `flash_attention`) instead of
                     launching the forward again; q, k, v are rebuilt;
      save_attn_qkv  the attention call stands outside the segments, so its
                     own saved q, k, v, output and denominators stay and
                     nothing in front of its backward is recomputed;
      save_attn_mlp  save_attn_qkv, and the segment behind the attention is
                     cut after fc1, whose output stays;
      dots           one segment under a selective policy that keeps the
                     GEMM outputs; the attention is recomputed.

    Float leaves only: the int8 paths are inference paths."""
    if quant_kind(p["attn"]["q"]["kernel"]) is not None:
        raise NotImplementedError(
            "remat policies apply to float blocks; the int8 leaves are "
            "inference-only")
    ck = dict(use_reentrant=False)
    if policy == "full":
        return checkpoint(_block, p, g_prompt, x, cfg, attn_impl, int8_impl,
                          **ck)
    if policy == "dots":
        return checkpoint(
            _block, p, g_prompt, x, cfg, attn_impl, int8_impl,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _save_gemm_outputs), **ck)
    if policy == "save_attn":
        keep: dict = {}

        def attend(x_):
            q, k, v, summary = _pre_attention(p, g_prompt, x_, cfg, int8_impl)
            return attention_core(q, k, v, cfg.heads, impl=attn_impl,
                                  keep=keep), summary

        attn, summary = checkpoint(attend, x, **ck)
    else:
        q, k, v, summary = checkpoint(_pre_attention, p, g_prompt, x, cfg,
                                      int8_impl, **ck)
        attn = attention_core(q, k, v, cfg.heads, impl=attn_impl)
    if policy == "save_attn_mlp":
        x, h = checkpoint(_mlp_hidden, p, x, attn, int8_impl, **ck)
        x = checkpoint(
            lambda x_, h_: x_ + linear(p["mlp"]["fc2"], quick_gelu(h_),
                                       int8_impl), x, h, **ck)
    else:
        x = checkpoint(_post_attention, p, x, attn, int8_impl, **ck)
    return x, summary


def vision_encoder(params, x: torch.Tensor, cfg: VisionConfig,
                   compute_dtype=torch.float32, attn_impl: str = "xla",
                   input_format: str = "frames", int8_impl: str = "kernel",
                   remat="none"):
    """Encode video -> (video_features (B, embed_dim), summary (B, D) | None).

    input_format: 'frames' = (B, T, H, W, 3) pixels; 'patches' =
    (B, T, N, ph*pw*3) patch-major rows (see patchify). int8_impl: the w8a8
    ops' kernels ('kernel') or their plain versions on any device
    ('plain'). remat: False / 'none' keeps every activation for the
    backward; True / 'full' keeps only each block's input and recomputes
    the block in the backward (lowest memory); 'save_attn',
    'save_attn_qkv', 'save_attn_mlp' and 'dots' keep part of each block
    (see `_block_remat`)."""
    policy = _remat_policy(remat)
    D = cfg.feature_dim
    if input_format == "patches":
        B, T, N, P = x.shape
        x = patch_embed_patches(params["patch_embed"],
                                x.reshape(B * T, N, P), compute_dtype,
                                int8_impl)
    else:
        B, T, H, W, C = x.shape
        x = x.reshape(B * T, H, W, C).to(compute_dtype)
        x = patch_embed(params["patch_embed"], x, cfg)
    cls = params["cls_token"].to(x.dtype).expand(B * T, 1, D)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    # row b*T + t gets the embedding of frame t
    te = resize_time_embed(params["time_embed"], T).to(x.dtype)
    x = x + te.repeat(B, 1)[:, None, :]
    x = layer_norm(x, params["ln_pre"]["scale"], params["ln_pre"]["bias"])

    g_prompts = params.get("global_prompts")
    summary = None
    for i, p in enumerate(params["blocks"]):
        g = None if g_prompts is None else g_prompts[i]
        if policy is not None and torch.is_grad_enabled():
            x, summary = _block_remat(policy, p, g, x, cfg, attn_impl,
                                      int8_impl)
        else:
            x, summary = _block(p, g, x, cfg, attn_impl, int8_impl)

    cls_x = layer_norm(x[:, 0], params["ln_post"]["scale"],
                       params["ln_post"]["bias"])
    cls_x = cls_x @ params["proj"].to(cls_x.dtype)
    video_features = cls_x.reshape(B, T, cfg.embed_dim).mean(dim=1)
    if cfg.use_summary_token:
        return video_features, summary.mean(dim=1)
    return video_features, None
