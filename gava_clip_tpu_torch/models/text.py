"""CLIP text tower (port of gava_clip_tpu/models/text.py).

12 x width-512, 8-head pre-LN transformer with a causal mask, fp32
LayerNorm islands, QuickGELU MLP, EOT-token pooling through a
(width, embed_dim) projection. The whole (n_cls * n_kv) prompt batch is
encoded in one call. Parameters are a nested dict in the JAX layout, except
that `blocks` is a list with one dict per layer where the JAX tree stacks
the layers on a leading axis; the JAX `lax.scan` is a Python loop here.
Quantized block leaves ('qa' serving, 'qt' frozen-int8 training) reach
their int8 ops through `ops.attention` and `ops.linear`; `int8_impl` picks
the kernels or their plain versions there.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.activations import quick_gelu
from ..ops.attention import multi_head_attention
from ..ops.linear import mlp
from ..ops.norm import layer_norm
from ..parallel.mesh import copy_to_group, parallel_attention, parallel_mlp
from .common import init_attention, init_layer_norm, init_linear, normal


@dataclass(frozen=True)
class TextConfig:
    embed_dim: int = 512
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12


def init_text_params(gen: Optional[torch.Generator], cfg: TextConfig,
                     device=None):
    """Random text-tower params (the JAX init's distributions). With
    device='meta' only the shapes are made (gen may be None)."""
    width = cfg.width

    def one_block():
        return {
            "attn": init_attention(gen, width, device=device),
            "ln_1": init_layer_norm(width, device),
            "mlp": {"fc1": init_linear(gen, width, width * 4, device=device),
                    "fc2": init_linear(gen, width * 4, width, device=device)},
            "ln_2": init_layer_norm(width, device),
        }

    return {
        "token_embedding": normal(gen, (cfg.vocab_size, width), 0.02, device),
        "positional_embedding": normal(gen, (cfg.context_length, width),
                                       0.01, device),
        "blocks": [one_block() for _ in range(cfg.layers)],
        "ln_final": init_layer_norm(width, device),
        "text_projection": normal(gen, (width, cfg.embed_dim),
                                  width ** -0.5, device),
    }


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask (upper triangle = -inf)."""
    return torch.full((length, length), float("-inf"),
                      device=device).triu(1)


def text_transformer(params, x: torch.Tensor, cfg: TextConfig,
                     attn_impl: str = "xla",
                     maple_prompts: Optional[torch.Tensor] = None,
                     int8_impl: str = "kernel", tp=None) -> torch.Tensor:
    """Run the causal transformer stack over embedded prompts (N, L, W).

    maple_prompts: optional (layers-1, P, W) MaPLe-style per-layer prompts:
    from the second block on, tokens [1:1+P] are replaced by that layer's
    learned prompts before the block. tp: the 'model' process group where
    the blocks hold Megatron shards (`parallel.mesh.tower_groups`): they
    run Megatron's attention and MLP (parallel/mesh.py)."""
    def block_fn(h, p):
        if tp is not None:
            return _parallel_block(h, p, tp)
        hn = layer_norm(h, p["ln_1"]["scale"], p["ln_1"]["bias"])
        # causal=True sends the flash impl through the streaming kernel's
        # in-kernel causal mask; the xla impl builds the additive mask
        h = h + multi_head_attention(p["attn"], hn, hn, hn, cfg.heads,
                                     impl=attn_impl, causal=True,
                                     int8_impl=int8_impl)
        hn = layer_norm(h, p["ln_2"]["scale"], p["ln_2"]["bias"])
        return h + mlp(p["mlp"], hn, quick_gelu, int8_impl)

    def _parallel_block(h, p, group):
        hn = copy_to_group(layer_norm(h, p["ln_1"]["scale"],
                                      p["ln_1"]["bias"]), group)
        h = h + parallel_attention(p["attn"], hn, cfg.heads, group,
                                   impl=attn_impl, causal=True)
        hn = copy_to_group(layer_norm(h, p["ln_2"]["scale"],
                                      p["ln_2"]["bias"]), group)
        return h + parallel_mlp(p["mlp"], hn, quick_gelu, group)

    blocks = list(params["blocks"])
    if maple_prompts is None:
        for p in blocks:
            x = block_fn(x, p)
        return x

    x = block_fn(x, blocks[0])
    n_p = maple_prompts.shape[1]
    for p, mp in zip(blocks[1:], maple_prompts):
        ctx = mp[None].to(x.dtype).expand(x.shape[0], n_p, x.shape[-1])
        x = torch.cat([x[:, :1], ctx, x[:, 1 + n_p:]], dim=1)
        x = block_fn(x, p)
    return x


def encode_text_embeds(params, prompt_embeds: torch.Tensor,
                       eot_idx: torch.Tensor, cfg: TextConfig,
                       compute_dtype=torch.float32,
                       attn_impl: str = "xla",
                       int8_impl: str = "kernel", tp=None) -> torch.Tensor:
    """Encode pre-embedded prompts (N, L, W) -> pooled features
    (N, embed_dim): + positional embedding, transformer, ln_final, gather
    at the EOT position, project. `eot_idx` (N,) is the EOT column per
    row. tp: see `text_transformer`."""
    x = prompt_embeds.to(compute_dtype) + \
        params["positional_embedding"].to(compute_dtype)
    x = text_transformer(params, x, cfg, attn_impl=attn_impl,
                         int8_impl=int8_impl, tp=tp)
    x = layer_norm(x, params["ln_final"]["scale"], params["ln_final"]["bias"])
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_idx.long()]
    return pooled @ params["text_projection"].to(pooled.dtype)


def encode_text_tokens(params, tokens: torch.Tensor, cfg: TextConfig,
                       compute_dtype=torch.float32,
                       attn_impl: str = "xla") -> torch.Tensor:
    """Encode raw token ids (N, L): embed, then pool at EOT (the argmax of
    the EOT id per row; padding is 0, so each row has exactly one EOT)."""
    embeds = params["token_embedding"][tokens.long()]
    eot_idx = (tokens == cfg.vocab_size - 1).int().argmax(dim=-1)
    return encode_text_embeds(params, embeds, eot_idx, cfg,
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl)
