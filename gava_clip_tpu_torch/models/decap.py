"""DeCap gait-caption decoder (port of gava_clip_tpu/models/decap.py): a
small GPT-2-style LM with a CLIP-prefix projector and a number-token
vocabulary extension.

A 4-layer / 4-head width-768 causal transformer whose vocabulary is the CLIP
BPE vocab (49,408) extended with 500 number tokens; `clip_project` is a
bottleneck MLP 512 -> 256 -> 768 whose output is prepended as a prefix
token. The LM head is weight-tied to the token embedding. Parameters are a
nested dict in the JAX layout, except that `blocks` is a list with one dict
per layer where the JAX tree stacks the layers on a leading axis
(`utils.jax_bridge.decap_params_from_jax` / `params_to_jax` carry them
across). Attention is the plain one (`ops.attention`, 192-wide heads at the
full width): no kernel of the port takes that head width.

Training loss: token CE with ignore index 0 and label smoothing 0.1, plus
an ordinal-weighted CE on the number tokens (ordinal distance measured
inside the number sub-vocabulary).

Decoding: `greedy_decode` is the host loop (the whole transformer over the
buffer at every step); `make_greedy_decoder` keeps per-layer K/V caches
and runs one token a step; `make_batched_decoder` runs lanes of features
together, each lane freezing at its own EOT. Each step reads its argmax on
the host (one synchronisation a token). Number tokens are intercepted as
'?' (286) and their values returned beside the tokens.
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.attention import multi_head_attention
from ..ops.linear import linear
from ..ops.norm import layer_norm
from ..train.losses import focal_ordinal_weight
from ..utils.device import resolve_device, tree_to
from .common import init_attention, init_layer_norm, init_linear, normal
from .text import causal_mask

BASE_VOCAB = 49408
NUM_TOKENS = 500
QUESTION_TOKEN = 286     # '?', the placeholder of a decoded number


@dataclass(frozen=True)
class DecapConfig:
    vocab_size: int = BASE_VOCAB + NUM_TOKENS
    n_layer: int = 4
    n_head: int = 4
    n_embd: int = 768
    n_positions: int = 128
    prefix_size: int = 512
    base_vocab: int = BASE_VOCAB


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2 tanh-approximated GELU."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def init_decap_params(gen: Optional[torch.Generator],
                      cfg: DecapConfig = DecapConfig(), device=None) -> Dict:
    """Random decoder params (the JAX init's distributions), drawn on the
    host from `gen` and moved to the resolved device. device='meta' makes
    the shapes only (gen may be None)."""
    meta = device is not None and torch.device(device).type == "meta"
    host = "meta" if meta else None
    D = cfg.n_embd

    def one_block():
        return {
            "ln_1": init_layer_norm(D, host),
            "attn": init_attention(gen, D, device=host),
            "ln_2": init_layer_norm(D, host),
            "mlp": {"fc1": init_linear(gen, D, 4 * D, device=host),
                    "fc2": init_linear(gen, 4 * D, D, device=host)},
        }

    params = {
        "wte": normal(gen, (cfg.vocab_size, D), 0.02, host),
        "wpe": normal(gen, (cfg.n_positions, D), 0.01, host),
        "blocks": [one_block() for _ in range(cfg.n_layer)],
        "ln_f": init_layer_norm(D, host),
        "clip_project": {
            "fc1": init_linear(gen, cfg.prefix_size, D // 3, xavier=False,
                               device=host),
            "fc2": init_linear(gen, D // 3, D, xavier=False, device=host),
        },
    }
    return params if meta else tree_to(params, resolve_device(device))


def project_prefix(params: Dict, clip_features: torch.Tensor) -> torch.Tensor:
    """Bottleneck prefix projector with Tanh (decoder_train MLP)."""
    h = torch.tanh(linear(params["clip_project"]["fc1"], clip_features))
    return linear(params["clip_project"]["fc2"], h)


def decap_transformer(params: Dict, embeds: torch.Tensor,
                      cfg: DecapConfig) -> torch.Tensor:
    """Causal transformer over input embeddings (B, L, D) -> hidden states."""
    L = embeds.shape[1]
    mask = causal_mask(L, device=embeds.device)
    x = embeds + params["wpe"][:L].to(embeds.dtype)
    for p in params["blocks"]:
        hn = layer_norm(x, p["ln_1"]["scale"], p["ln_1"]["bias"])
        x = x + multi_head_attention(p["attn"], hn, hn, hn, cfg.n_head,
                                     mask=mask)
        hn = layer_norm(x, p["ln_2"]["scale"], p["ln_2"]["bias"])
        x = x + linear(p["mlp"]["fc2"],
                       gelu_new(linear(p["mlp"]["fc1"], hn)))
    return layer_norm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])


def decap_forward(params: Dict, clip_features: torch.Tensor,
                  tokens: torch.Tensor,
                  cfg: DecapConfig = DecapConfig()) -> torch.Tensor:
    """(B, prefix_size) clip features + (B, L) tokens -> (B, 1+L, V) logits.
    The projected prefix occupies position 0."""
    tok_emb = params["wte"][tokens.long()]
    prefix = project_prefix(params, clip_features)[:, None, :]
    h = decap_transformer(params, torch.cat([prefix, tok_emb], dim=1), cfg)
    return h @ params["wte"].T


def smoothed_ce(logits: torch.Tensor, targets: torch.Tensor,
                smoothing: float = 0.1) -> torch.Tensor:
    """Per-token CE with label smoothing (torch CrossEntropyLoss formula)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    smooth = -logp.mean(dim=-1)
    return (1.0 - smoothing) * nll + smoothing * smooth


def decap_loss(params: Dict, clip_features: torch.Tensor,
               tokens: torch.Tensor, cfg: DecapConfig = DecapConfig()
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token CE (ignore 0, smoothing .1) + ordinal-weighted CE on number
    tokens. tokens: (B, L) ints. The token term divides by every position,
    not by the valid count: the reference's CrossEntropyLoss(ignore_index=0,
    reduction='none') zeroes the ignored entries and the mean that follows
    divides by numel (decoder_train.py:214,275-278)."""
    logits = decap_forward(params, clip_features, tokens, cfg)[:, :-1]
    flat_logits = logits.reshape(-1, cfg.vocab_size)
    flat_tokens = tokens.reshape(-1).long()

    tok_loss = smoothed_ce(flat_logits, flat_tokens)
    valid = (flat_tokens != 0).float()
    loss_token = (tok_loss * valid).sum() / flat_tokens.shape[0]

    is_num = (flat_tokens >= cfg.base_vocab).float()
    num_logits = flat_logits[:, cfg.base_vocab:]
    num_targets = (flat_tokens - cfg.base_vocab).clamp(0, NUM_TOKENS - 1)
    ow = focal_ordinal_weight(num_logits, num_targets, gamma=2.0, alpha=0.0,
                              beta=0.2)
    loss_number = (ow * tok_loss * is_num).sum() / is_num.sum().clamp_min(1.0)

    loss = loss_token + loss_number
    acc = (((flat_logits.argmax(-1) == flat_tokens).float() * valid).sum()
           / valid.sum().clamp_min(1.0))
    return loss, {"loss_token": loss_token, "loss_number": loss_number,
                  "acc": acc}


def _feature_rows(params: Dict, features) -> torch.Tensor:
    """Host or device features as (N, prefix_size) fp32 on the params'
    device."""
    t = features if isinstance(features, torch.Tensor) else \
        torch.from_numpy(np.asarray(features, np.float32))
    return t.float().reshape(
        -1, params["clip_project"]["fc1"]["kernel"].shape[0]).to(
            params["wte"].device)


def make_greedy_step(params: Dict, cfg: DecapConfig = DecapConfig()):
    """step(embed_buf (1, max_len, D), pos) -> the argmax token id at row
    `pos` of the transformer over the whole buffer; only that row meets
    the vocabulary."""
    def step(embed_buf: torch.Tensor, pos: int) -> torch.Tensor:
        h = decap_transformer(params, embed_buf, cfg)
        return (h[0, pos] @ params["wte"].T).argmax(-1)
    return step


def greedy_decode(params: Dict, clip_feature: np.ndarray,
                  cfg: DecapConfig = DecapConfig(),
                  max_len: int = 77) -> Tuple[list, list]:
    """Greedy decode one prefix; returns (token_ids with number tokens
    replaced by '?' (286), raw number values). The reference's host loop
    (decode.py:88-125): the whole buffer through the transformer at every
    step."""
    max_len = min(max_len, cfg.n_positions - 1)
    wte = params["wte"]
    step = make_greedy_step(params, cfg)
    tokens, numbers = [], []
    with torch.inference_mode():
        buf = torch.zeros(1, max_len + 1, cfg.n_embd, device=wte.device)
        buf[0, 0] = project_prefix(params, _feature_rows(params,
                                                         clip_feature))[0]
        for pos in range(max_len):
            nxt = int(step(buf, pos))
            if nxt >= cfg.base_vocab:
                numbers.append(nxt - cfg.base_vocab)
                nxt = QUESTION_TOKEN
            tokens.append(nxt)
            if nxt == cfg.base_vocab - 1:  # EOT
                break
            buf[0, pos + 1] = wte[nxt]
    return tokens, numbers


def token_step(params: Dict, x: torch.Tensor, ck: torch.Tensor,
               cv: torch.Tensor, pos: int, cfg: DecapConfig) -> torch.Tensor:
    """One token a lane through every block against the K/V caches
    (n_layer, B, max_len, D), which get row `pos` written in place; x
    (B, D) is the token's embedding. Returns the vocabulary logits (B, V).
    The math of `decap_transformer` restricted to the live row: the scale
    on q, an fp32 softmax over the positions <= pos."""
    B, D = x.shape
    H = cfg.n_head
    hd = D // H
    h = x + params["wpe"][pos]
    for layer, p in enumerate(params["blocks"]):
        hn = layer_norm(h, p["ln_1"]["scale"], p["ln_1"]["bias"])
        q = linear(p["attn"]["q"], hn)
        ck[layer, :, pos] = linear(p["attn"]["k"], hn)
        cv[layer, :, pos] = linear(p["attn"]["v"], hn)
        qh = (q * hd ** -0.5).reshape(B, H, 1, hd)
        kh = ck[layer, :, :pos + 1].reshape(B, pos + 1, H, hd).transpose(1, 2)
        vh = cv[layer, :, :pos + 1].reshape(B, pos + 1, H, hd).transpose(1, 2)
        w = torch.softmax((qh @ kh.transpose(-1, -2)).float(), dim=-1)
        att = (w @ vh).reshape(B, D)
        h = h + linear(p["attn"]["out"], att)
        hn = layer_norm(h, p["ln_2"]["scale"], p["ln_2"]["bias"])
        h = h + linear(p["mlp"]["fc2"], gelu_new(linear(p["mlp"]["fc1"], hn)))
    h = layer_norm(h, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return h @ params["wte"].T


def _decode_lanes(params: Dict, cfg: DecapConfig, feats: torch.Tensor,
                  n_valid: int, max_len: int) -> List[Tuple[list, list]]:
    """Greedy decode of a batch of prefixes with K/V caches; lanes from
    `n_valid` on are padding and start finished. Every lane stops at its
    own EOT; the loop ends when all have or at max_len."""
    B = feats.shape[0]
    x = project_prefix(params, feats)
    ck = torch.zeros(cfg.n_layer, B, max_len, cfg.n_embd, device=x.device)
    cv = torch.zeros_like(ck)
    out = [([], []) for _ in range(B)]
    done = [b >= n_valid for b in range(B)]
    for pos in range(max_len):
        if all(done):
            break
        nxt = token_step(params, x, ck, cv, pos, cfg).argmax(-1)
        ids = nxt.tolist()
        for b, t in enumerate(ids):
            if done[b]:
                continue
            if t >= cfg.base_vocab:
                out[b][1].append(t - cfg.base_vocab)
                t = QUESTION_TOKEN
            out[b][0].append(t)
            ids[b] = t
            done[b] = t == cfg.base_vocab - 1      # EOT
        x = params["wte"][torch.tensor(ids, device=x.device)]
    return out[:n_valid]


def make_greedy_decoder(params: Dict, cfg: DecapConfig = DecapConfig(),
                        max_len: int = 77):
    """Greedy decoder with per-layer K/V caches: one token a step through
    every block (O(L) attention a token where `greedy_decode` re-runs the
    whole buffer). Returns fn(clip_feature) -> (tokens, numbers), exactly
    `greedy_decode`'s contract."""
    max_len = min(max_len, cfg.n_positions - 1)

    def run(clip_feature) -> Tuple[list, list]:
        with torch.inference_mode():
            return _decode_lanes(params, cfg,
                                 _feature_rows(params, clip_feature), 1,
                                 max_len)[0]
    return run


def make_batched_decoder(params: Dict, cfg: DecapConfig = DecapConfig(),
                         max_len: int = 77, batch: int = 8):
    """Batched form of make_greedy_decoder: `batch` captions decode
    together (a finished lane freezes while the others go on). Returns
    fn(features (N, prefix_size)) -> list of (tokens, numbers) per row; the
    last chunk's missing lanes are zero features that start finished."""
    max_len = min(max_len, cfg.n_positions - 1)

    def run(features) -> list:
        feats = _feature_rows(params, features)
        N = feats.shape[0]
        results = []
        with torch.inference_mode():
            for i in range(0, N, batch):
                chunk = feats[i:i + batch]
                n = chunk.shape[0]
                if n < batch:
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        batch - n, chunk.shape[1])])
                results += _decode_lanes(params, cfg, chunk, n, max_len)
        return results

    return run


def descale_number(n: float, entry: Dict, extra: Dict) -> float:
    """Invert the preprocess scaling (decode.py:165-177):
    value = ((n [- global_shift]) * graduated / weight - shift) * std + mean."""
    graduated = extra["graduated"]
    if extra.get("l2_norm") == "n/a":
        n = n - extra["global_shift"]
    return round((float(n) * graduated / entry["weight"] - entry["shift"])
                 * entry["std"] + entry["mean"], 3)
