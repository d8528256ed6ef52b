"""MemoryPromptLearner (port of gava_clip_tpu/models/memory_prompt.py): the
KEPLER memory projected into an "X is X" token template through the frozen
text tower.

Counterpart of reference training/memory_head.py:10-77, which keeps it out
of its live path (VitaCLIP_model.py:15,164-166). As in the JAX package the
per-class projectors are stacked and the whole (n_cls * B * sublen, 77)
prompt batch is ONE text-tower call. On the card that call runs the causal
attention kernel (csrc/streaming_attention.cu, 12 launches for the 12
layers) in bf16; on the CPU the plain attention in fp32.
"""

from typing import Dict, Optional

import numpy as np
import torch

from ..text import tokenize
from .text import TextConfig, encode_text_embeds

TEMPLATE = "X is X"


def init_memory_prompt_params(gen: Optional[torch.Generator],
                              num_classes: int, inp_dim: int = 768,
                              out_dim: int = 512, split_mlp: bool = True,
                              device=None) -> Dict[str, torch.Tensor]:
    """Projector MLP inp_dim -> out_dim//2 -> Tanh -> out_dim, a class-wise
    stacked bank when split_mlp (reference memory_head.py:33-47): weights
    uniform in +-1/sqrt(fan_in) drawn from `gen`, zero biases."""
    h = out_dim // 2

    def lin(fan_in, shape):
        bound = 1.0 / np.sqrt(fan_in)
        w = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (w * (2 * bound) - bound).to(device)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    lead = (num_classes,) if split_mlp else ()
    return {"w1": lin(inp_dim, lead + (inp_dim, h)), "b1": zeros(lead + (h,)),
            "w2": lin(h, lead + (h, out_dim)), "b2": zeros(lead + (out_dim,))}


def template_slots(text_params, context_length: int = 77):
    """Token embeddings of the 'X is X' template split around the two X
    slots: (tokens (L,) numpy, pre (1,W), is (1,W), post (L-4,W)), the
    embeddings on the text tower's device."""
    tokens = tokenize([TEMPLATE], context_length)[0]  # [SOT, X, is, X, EOT, 0..]
    emb = text_params["token_embedding"][torch.from_numpy(
        tokens.astype(np.int64)).to(text_params["token_embedding"].device)]
    return tokens, emb[:1], emb[2:3], emb[4:]


def memory_prompt_features(params: Dict, text_params: Dict, m: torch.Tensor,
                           v: torch.Tensor,
                           text_cfg: Optional[TextConfig] = None,
                           split_mlp: bool = True, compute_dtype=None,
                           attn_impl: Optional[str] = None) -> torch.Tensor:
    """m (B, sublen, inp_dim) memory features, v (B, sublen, out_dim) value
    features -> gait-parameter set embeddings: (n_cls, B, out_dim) when
    split_mlp else (B, out_dim) (reference memory_head.py:57-77, the
    sublen mean included).

    `attn_impl` None is the attention kernel ('flash') for tensors on the
    card and the plain attention ('xla') on the CPU; `compute_dtype` None
    is bf16 on the card (the kernel's operand type) and fp32 on the CPU,
    the JAX function's default."""
    text_cfg = text_cfg or TextConfig()
    cuda = m.device.type == "cuda"
    attn_impl = attn_impl or ("flash" if cuda else "xla")
    compute_dtype = compute_dtype or (torch.bfloat16 if cuda
                                      else torch.float32)
    B, S, _ = m.shape
    mf = m.reshape(B * S, -1).float()
    vf = v.reshape(B * S, 1, -1).float()

    if split_mlp:
        h = torch.tanh(torch.einsum("me,ceh->cmh", mf, params["w1"])
                       + params["b1"][:, None])
        mem = torch.einsum("cmh,cho->cmo", h, params["w2"]) \
            + params["b2"][:, None]                       # (C, B*S, W)
        C = mem.shape[0]
        mem = mem.reshape(C * B * S, 1, -1)
        vf = vf.repeat(C, 1, 1)      # class-major, as jnp.tile(vf, (C, 1, 1))
    else:
        hid = torch.tanh(mf @ params["w1"] + params["b1"])
        mem = (hid @ params["w2"] + params["b2"]).reshape(B * S, 1, -1)

    tokens, pre, is_e, post = template_slots(text_params,
                                             text_cfg.context_length)
    n = mem.shape[0]

    def rep(x):
        return x.to(mem.dtype)[None].expand((n,) + tuple(x.shape))

    prompt = torch.cat([rep(pre), mem, rep(is_e), vf, rep(post)],
                       dim=1)                             # (n, 77, W)
    eot_idx = torch.full((n,), int(np.argmax(tokens)), dtype=torch.int32,
                         device=mem.device)
    feats = encode_text_embeds(text_params, prompt, eot_idx, text_cfg,
                               compute_dtype=compute_dtype,
                               attn_impl=attn_impl).float()
    if split_mlp:
        return feats.reshape(C, B, S, -1).mean(dim=2)
    return feats.reshape(B, S, -1).mean(dim=1)
