"""Text prompt learning: CoOp-style learnable contexts + KAPT knowledge heads
(port of gava_clip_tpu/models/prompts.py).

  * a host-side asset constructor (tokenize prompts, slice frozen prefix/suffix
    embeddings, load knowledge files) producing padded dense numpy arrays
    (ragged n_kv per class is padded to max_kv with a validity mask), and
  * plain functions on tensors assembling (n_cls, max_kv, 77, W) prompt
    tensors; the per-class projector MLP bank is stacked weights + one
    einsum.

Kept quirk (intentional, as in the JAX package): in knowledge-aware mode
the text features are pooled at the EOT position of the *tokenized* prompt
even though the assembled sequence is shifted right by n_ctx learned
tokens.

Knowledge-file formats:
  data/ke_<type>/EntityEmb_<kv>.npy   (n_cls, 768) KEPLER class embeddings
  data/ke_<type>/simQdesc_<kv>.txt    one description line per class
  data/ke_<type>/descriptor_<c>.txt   descriptor lines for class c
  data/ke_<type>/descriptor_<c>.npy   per-descriptor embeddings for class c
  data/ke_<type>/all.npy              (n_cls, 768) overall class embeddings
"""

import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..text import tokenize
from ..text.tokenizer import EOT_TOKEN
from .common import normal


@dataclass(frozen=True)
class PromptConfig:
    n_cls: int
    n_ctx: int = 8                      # --text_num_prompts
    ctx_dim: int = 512                  # text transformer width
    inp_dim: int = 768                  # KEPLER embedding dim
    emb_dim: int = 128                  # projector hidden (ctx_dim // 4)
    init: str = ""                      # '' | subset of {split,uni,cntn,disc} joined by _
    csc: bool = False                   # class-specific contexts
    cls_type: str = "updrs"
    knowledge_versions: Tuple[str, ...] = ()
    use_descriptor: bool = False
    token_wise_mlp: bool = False
    knowledge_dir: str = ""             # default ./data/ke_<type-prefix>
    context_length: int = 77

    @property
    def knowledge_aware(self) -> bool:
        return self.init != ""

    @property
    def use_cntn(self) -> bool:
        return "cntn" in self.init.split("_")

    @property
    def cntn_split(self) -> bool:
        return "split" in self.init.split("_")

    @property
    def uni_mlp(self) -> bool:
        return "uni" in self.init.split("_")

    @property
    def use_disc(self) -> bool:
        return "disc" in self.init.split("_")

    def resolved_knowledge_dir(self) -> str:
        if self.knowledge_dir:
            return self.knowledge_dir
        return f"./data/ke_{self.cls_type.lower().split('_')[0]}"


def _read_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [line.strip() for line in f]


def load_knowledge(cfg: PromptConfig) -> Tuple[List[np.ndarray], List[List[str]]]:
    """Load per-class continuous embeddings and discrete descriptions.

    Returns (cntn per class: list of (n_kv_c, 768) float arrays or empty,
    disc per class: list of n_kv_c strings).
    """
    kdir = cfg.resolved_knowledge_dir()
    n_cls = cfg.n_cls
    cntn: List[np.ndarray] = [np.zeros((0, cfg.inp_dim), np.float32) for _ in range(n_cls)]
    disc: List[List[str]] = [[] for _ in range(n_cls)]

    if cfg.use_descriptor:
        ent_base = np.load(osp.join(kdir, "all.npy"))[:n_cls]
        for c in range(n_cls):
            lines = _read_lines(osp.join(kdir, f"descriptor_{c}.txt"))
            disc[c] = lines
            if cfg.use_cntn:
                if cfg.cntn_split:
                    cntn[c] = np.load(osp.join(kdir, f"descriptor_{c}.npy")).astype(np.float32)
                else:
                    cntn[c] = np.broadcast_to(
                        ent_base[c][None].astype(np.float32), (len(lines), cfg.inp_dim)).copy()
    else:
        if cfg.use_cntn and not cfg.cntn_split:
            ent0 = np.load(osp.join(kdir, "EntityEmb_v0.npy"))[:n_cls].astype(np.float32)
        for kv in cfg.knowledge_versions:
            if cfg.use_cntn:
                if cfg.cntn_split:
                    ent = np.load(osp.join(kdir, f"EntityEmb_{kv}.npy"))[:n_cls].astype(np.float32)
                else:
                    ent = ent0
                for c in range(n_cls):
                    cntn[c] = np.concatenate([cntn[c], ent[c][None]], axis=0)
            if cfg.use_disc:
                lines = _read_lines(osp.join(kdir, f"simQdesc_{kv}.txt"))
                for c in range(n_cls):
                    disc[c].append(lines[c])
            else:
                for c in range(n_cls):
                    disc[c].append("")
    return cntn, disc


@dataclass
class PromptAssets:
    """Frozen (non-trainable) buffers consumed by prompt assembly and the
    text tower. All arrays are dense, padded over the kv axis."""
    tokenized: np.ndarray       # (n_cls, max_kv, 77) int32
    kv_mask: np.ndarray         # (n_cls, max_kv) float32, 1 = valid
    pool_idx: np.ndarray        # (n_cls, max_kv) int32 — the EOT quirk
    token_prefix: np.ndarray    # (n_cls, max_kv, 1, W)
    token_suffix: np.ndarray    # (n_cls, max_kv, 77-1-n_ctx, W)
    cntn_embeds: Optional[np.ndarray]  # (n_cls, max_kv, 768) or None
    prompt_texts: List[List[str]]      # for logging / analysis


def build_prompt_assets(classnames: Sequence[str], cfg: PromptConfig,
                        token_embedding: np.ndarray) -> PromptAssets:
    """Host-side: tokenize per-class prompt texts and precompute the frozen
    prefix/suffix embedding slices. numpy only; equal to the JAX package's
    arrays bit for bit on the same inputs."""
    n_cls = cfg.n_cls
    assert len(classnames) == n_cls
    classnames = [name.replace("_", " ") for name in classnames]

    cntn_list: List[np.ndarray] = []
    if cfg.knowledge_aware:
        cntn, disc = load_knowledge(cfg)
        prompts = [[d + " " + classnames[c] for d in disc[c]] for c in range(n_cls)]
        cntn_list = cntn
    else:
        prefix = " ".join(["X"] * cfg.n_ctx)
        prompts = [[prefix + " " + name + "."] for name in classnames]

    max_kv = max(len(p) for p in prompts)
    L = cfg.context_length
    W = token_embedding.shape[1]

    tokenized = np.zeros((n_cls, max_kv, L), np.int32)
    kv_mask = np.zeros((n_cls, max_kv), np.float32)
    for c in range(n_cls):
        # tokenize at the CONFIGURED context length — the tokenizer default
        # is 77 and a non-77 cfg.context_length would make the assignment
        # below shape-mismatch (or silently mis-slice the suffix)
        toks = tokenize(prompts[c], context_length=L)
        tokenized[c, :len(prompts[c])] = toks
        kv_mask[c, :len(prompts[c])] = 1.0
        # every prompt must actually carry its EOT (argmax on an all-False
        # row would silently pool at column 0)
        assert (toks == EOT_TOKEN).any(axis=-1).all(), \
            f"class {c}: tokenized prompt lost its EOT (too long?)"

    pool_idx = np.argmax(tokenized == EOT_TOKEN, axis=-1).astype(np.int32)

    embeds = token_embedding[tokenized.reshape(-1)].reshape(n_cls, max_kv, L, W)
    token_prefix = embeds[:, :, :1, :]
    if cfg.knowledge_aware:
        token_suffix = embeds[:, :, 1:L - cfg.n_ctx, :]
    else:
        token_suffix = embeds[:, :, 1 + cfg.n_ctx:, :]

    cntn_embeds = None
    if cfg.knowledge_aware and cfg.use_cntn:
        cntn_embeds = np.zeros((n_cls, max_kv, cfg.inp_dim), np.float32)
        for c in range(n_cls):
            k = cntn_list[c].shape[0]
            if k:
                cntn_embeds[c, :k] = cntn_list[c]

    return PromptAssets(tokenized=tokenized, kv_mask=kv_mask, pool_idx=pool_idx,
                        token_prefix=np.asarray(token_prefix, np.float32),
                        token_suffix=np.asarray(token_suffix, np.float32),
                        cntn_embeds=cntn_embeds, prompt_texts=prompts)


def init_prompt_params(gen: Optional[torch.Generator], cfg: PromptConfig,
                       device=None) -> Dict:
    """Learnable prompt parameters. Zero-init ctx + zero-init projectors in
    knowledge-aware mode; std-0.02 normal otherwise."""
    W = cfg.ctx_dim
    params: Dict = {}
    if cfg.knowledge_aware:
        params["ctx"] = torch.zeros((cfg.n_cls, cfg.n_ctx, W), device=device)
        if cfg.use_cntn:
            params["projector"] = _init_projector(cfg, device)
    else:
        shape = (cfg.n_cls, cfg.n_ctx, W) if cfg.csc else (cfg.n_ctx, W)
        params["ctx"] = normal(gen, shape, 0.02, device)
    return params


def _init_projector(cfg: PromptConfig, device=None) -> Dict:
    """Zero-initialized projection MLP(s), 768 -> emb_dim -> ReLU -> ctx_dim.

    Variants: class-wise (stacked per class; the exercised "split_uni" path
    uses bias-free MLPs), token-wise (stacked per token), or class-wise
    per-token. All are stacked dense weights."""
    I, E, O = cfg.inp_dim, cfg.emb_dim, cfg.ctx_dim

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    if cfg.token_wise_mlp:
        n = cfg.n_ctx
        return {"w1": zeros(n, I, E), "b1": zeros(n, E),
                "w2": zeros(n, E, O), "b2": zeros(n, O)}
    if cfg.uni_mlp:
        return {"w1": zeros(cfg.n_cls, I, E), "w2": zeros(cfg.n_cls, E, O)}
    return {"w1": zeros(cfg.n_cls, cfg.n_ctx, I, E),
            "w2": zeros(cfg.n_cls, cfg.n_ctx, E, O)}


def _project_knowledge(proj: Dict, cntn: torch.Tensor,
                       cfg: PromptConfig) -> torch.Tensor:
    """Apply the (zero-init) knowledge projector.

    cntn: (n_cls, max_kv, 768) -> (n_cls, max_kv, n_ctx, ctx_dim) additive
    context."""
    relu = torch.relu
    if cfg.token_wise_mlp:
        # shared across classes: per-token MLPs
        h = relu(torch.einsum("ckd,tde->ckte", cntn, proj["w1"]) + proj["b1"])
        return torch.einsum("ckte,teo->ckto", h, proj["w2"]) + proj["b2"]
    if cfg.uni_mlp:
        # class-wise single MLP, broadcast over the n_ctx token positions
        h = relu(torch.einsum("ckd,cde->cke", cntn, proj["w1"]))
        out = torch.einsum("cke,ceo->cko", h, proj["w2"])
        return out[:, :, None, :].expand(*out.shape[:2], cfg.n_ctx,
                                         out.shape[-1])
    # class-wise per-token MLPs
    h = relu(torch.einsum("ckd,ctde->ckte", cntn, proj["w1"]))
    return torch.einsum("ckte,cteo->ckto", h, proj["w2"])


def assemble_prompts(params: Dict, buffers: Dict,
                     cfg: PromptConfig) -> torch.Tensor:
    """Build the embedded prompt tensor (n_cls, max_kv, 77, W):
    [SOS] + (ctx [+ projected knowledge]) + suffix, 'end' token position.
    `buffers` holds token_prefix / token_suffix / cntn_embeds as tensors."""
    prefix = buffers["token_prefix"]
    suffix = buffers["token_suffix"]
    n_cls, max_kv = prefix.shape[:2]

    ctx = params["ctx"]
    if not cfg.knowledge_aware and ctx.dim() == 2:
        ctx = ctx[None].expand(n_cls, *ctx.shape)
    # (n_cls, max_kv, n_ctx, W)
    ctx_kv = ctx[:, None].expand(n_cls, max_kv, *ctx.shape[1:])

    if cfg.knowledge_aware and cfg.use_cntn:
        ctx_kv = ctx_kv + _project_knowledge(params["projector"],
                                             buffers["cntn_embeds"], cfg)

    return torch.cat([prefix, ctx_kv, suffix], dim=-2)
