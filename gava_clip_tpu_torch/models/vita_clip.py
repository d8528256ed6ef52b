"""VitaCLIP top-level model (port of gava_clip_tpu/models/vita_clip.py):
vision + text towers, prompt learning, and the support-memory / NTE
contrastive heads.

Two surfaces share the code below:
  * `VitaClipModel`: config + frozen-buffer holder with a pure `apply`
    (params, buffers, inputs) -> outputs, the JAX class `VitaClip`. The
    training step differentiates through it. The per-class text-tower loop
    of the original is one batched (n_cls*max_kv, 77) text forward with a
    kv mask, and the per-class memory projections are stacked weights +
    einsums, as in the JAX package.
  * `VitaClip` (nn.Module): the zero-shot serving branch around a fixed
    parameter tree and precomputed text features.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.linear import linear
from ..parallel.mesh import (copy_to_group, frame_group, gather_rows,
                             parallel_mlp, tower_groups)
from ..utils.device import resolve_device
from .common import ParamTree, init_linear
from .prompts import (PromptConfig, assemble_prompts, build_prompt_assets,
                      init_prompt_params)
from .text import TextConfig, encode_text_embeds, init_text_params
from .vision import VisionConfig, init_vision_params, vision_encoder


@dataclass(frozen=True)
class VitaClipConfig:
    """The JAX package's config. One default differs: `zeroshot_evaluation`
    is True here (the serving slices came first and build their config
    without it); the training constructors pass False."""
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    num_classes: int = 4
    cls_type: str = "updrs"
    use_text_prompt_learning: bool = False
    prompt: Optional[PromptConfig] = None
    zeroshot_evaluation: bool = True
    use_support_memory: bool = False
    detach_features: bool = False
    add_nte: bool = False
    use_sigmoid_loss: bool = False


def _l2norm(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    # eps > 0 guards an all-zero row (0/0 = NaN); the default 0.0 is the
    # unguarded x / x.norm()
    n = x.norm(dim=-1, keepdim=True)
    return x / (n.clamp_min(eps) if eps > 0 else n)


def _scalar(value: float, device=None) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def init_head_params(gen: Optional[torch.Generator], cfg: VitaClipConfig,
                     device=None) -> Dict:
    """Logit scales + NTE / memory head parameters."""
    E = cfg.text.embed_dim
    D = cfg.vision.feature_dim
    params: Dict = {}
    if cfg.use_sigmoid_loss:
        params["logit_scale"] = _scalar(math.log(math.log(10.0)), device)
        params["logit_bias"] = _scalar(-10.0, device)
    else:
        params["logit_scale"] = _scalar(math.log(1.0 / 0.07), device)
    if cfg.add_nte:
        params["sum_proj"] = init_linear(gen, D, E, xavier=False,
                                         device=device)
        params["logit_scale_vm"] = _scalar(
            math.log(10.0) if cfg.use_sigmoid_loss else 100.0, device)
    if cfg.use_support_memory:
        params["tf_project"] = {
            "fc1": init_linear(gen, E, E // 4, xavier=False, device=device),
            "fc2": init_linear(gen, E // 4, E // 8, xavier=False,
                               device=device)}
        n = cfg.num_classes
        mp1 = [init_linear(gen, E, E // 4, xavier=False, device=device)
               for _ in range(n)]
        mp2 = [init_linear(gen, E // 4, E // 8, xavier=False, device=device)
               for _ in range(n)]
        params["memory_project"] = {
            "w1": torch.stack([p["kernel"] for p in mp1]),
            "b1": torch.stack([p["bias"] for p in mp1]),
            "w2": torch.stack([p["kernel"] for p in mp2]),
            "b2": torch.stack([p["bias"] for p in mp2]),
        }
        params["logit_scale_mt"] = _scalar(
            math.log(10.0) if cfg.use_sigmoid_loss else 100.0, device)
        if cfg.use_sigmoid_loss:
            params["logit_bias_mt"] = _scalar(-10.0, device)
    return params


def init_vita_clip_params(gen: Optional[torch.Generator],
                          cfg: VitaClipConfig, device=None) -> Dict:
    """Random params of the whole model as cfg asks for it (the zero-shot
    config gives `visual` + `logit_scale` only); device='meta' gives the
    shapes only."""
    params: Dict = {"visual": init_vision_params(gen, cfg.vision, device)}
    if cfg.use_text_prompt_learning:
        params["textual"] = init_text_params(gen, cfg.text, device)
        params["prompt"] = init_prompt_params(gen, cfg.prompt, device)
    params.update(init_head_params(gen, cfg, device))
    return params


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _per_kv_text_features(cfg: VitaClipConfig, params, buffers,
                          compute_dtype, attn_impl: str = "xla",
                          int8_impl: str = "kernel", tp=None):
    """Shared text-branch core (apply and text_features_only must never
    diverge: the kv-masked mean and the EOT-pooling quirk are
    parity-sensitive): assemble prompts, batch-encode, l2-normalize.
    Returns (tf (n_cls, max_kv, E), kv_mask, kv_count)."""
    prompt_embeds = assemble_prompts(params["prompt"], buffers, cfg.prompt)
    n_cls, max_kv, L, W = prompt_embeds.shape
    tf = encode_text_embeds(params["textual"],
                            prompt_embeds.reshape(n_cls * max_kv, L, W),
                            buffers["pool_idx"].reshape(n_cls * max_kv),
                            cfg.text, compute_dtype=compute_dtype,
                            attn_impl=attn_impl, int8_impl=int8_impl, tp=tp)
    tf = _l2norm(tf.float()).reshape(n_cls, max_kv, -1)
    kv_mask = buffers["kv_mask"]
    kv_count = kv_mask.sum(-1, keepdim=True).clamp_min(1.0)
    return tf, kv_mask, kv_count


def apply(cfg: VitaClipConfig, params: Dict, buffers: Dict, x: torch.Tensor,
          memory: Optional[torch.Tensor] = None,
          video_nte: Optional[torch.Tensor] = None, desc_wise: bool = False,
          compute_dtype=torch.float32, attn_impl: str = "xla", remat="none",
          input_format: str = "frames",
          int8_impl: str = "kernel", mesh=None,
          pp=None) -> Dict[str, torch.Tensor]:
    """Forward pass (JAX `VitaClip.apply`).

    x: video (B, T, H, W, 3), or (B, T, N, ph*pw*3) patch-major rows with
    input_format='patches'; memory: (Bm, S, E); video_nte: (B, 70, E).
    Returns a dict with logits (B, n_cls), text_features (n_cls, E), and
    optionally summary (B, D), logits_mt (Bm, n_cls), logits_vm (B, B),
    desc_logits (B, n_cls, max_kv).

    mesh: a `parallel.mesh.Mesh`. Over 'data' each rank passes its rows,
    and the NTE head, the one term that is not per sample, is built over
    the global batch (its inputs gathered differentiably): logits_vm is
    then the global (B, B) matrix on every rank. Over 'model' the params
    are `shard_params_tensor_parallel`'s, and each part that holds shards
    (`tower_groups`) sums its products over the group. Over 'frame' each
    rank passes its frames [r*T/W, (r+1)*T/W) of every clip
    (`parallel.mesh.shard_batch`); the vision tower gathers what crosses
    frames, and the text tower, the heads and the NTE /
    memory terms run on every frame rank, which all get the same outputs.
    'frame' composes with 'model' (each rank's frames through its shards)
    and with pp. pp: (stages, microbatches), the vision block stack as a
    GPipe pipeline (parallel/pipeline.py)."""
    out: Dict[str, torch.Tensor] = {}
    fp = frame_group(mesh)
    tp = tower_groups(mesh, cfg)
    data = mesh.group("data") if mesh is not None else None
    video_features, summary = vision_encoder(
        params["visual"], x, cfg.vision, compute_dtype=compute_dtype,
        attn_impl=attn_impl, input_format=input_format, int8_impl=int8_impl,
        remat=remat, tp=tp["visual"], pp=pp, fp=fp)
    video_features = _l2norm(video_features.float())
    logit_scale = torch.exp(params["logit_scale"].float())

    if cfg.use_text_prompt_learning:
        tf, kv_mask, kv_count = _per_kv_text_features(
            cfg, params, buffers, compute_dtype, attn_impl, int8_impl,
            tp["textual"])
        sim = logit_scale * torch.einsum("be,cke->bck", video_features, tf)
        if desc_wise:
            out["desc_logits"] = sim                    # (B, n_cls, max_kv)
        logits = (sim * kv_mask[None]).sum(-1) / kv_count[None, :, 0]
        text_features = (tf * kv_mask[..., None]).sum(1) / kv_count
        text_features = _l2norm(text_features)
    else:
        text_features = _l2norm(buffers["text_features"].float())
        logits = (logit_scale * video_features) @ text_features.T

    if "logit_bias" in params:
        logits = logits + params["logit_bias"]
    out["logits"] = logits
    out["text_features"] = text_features
    if summary is not None:
        out["summary"] = summary

    if cfg.add_nte and video_nte is not None:
        sum_proj = _l2norm(linear(params["sum_proj"], summary.float()))
        valid = (video_nte.sum(dim=(-1, -2)) != 0).float()
        if data is not None:
            sum_proj = gather_rows(sum_proj, data)
            valid = gather_rows(valid, data)
            video_nte = gather_rows(video_nte, data)
        valid_mat = (valid[:, None] * valid[None, :]).detach()
        # safe norm: all-zero NTE rows (a missing .npy) stay zero instead of
        # 0/0 = NaN; they are masked by valid_mat anyway
        nte32 = video_nte.float()
        nte = nte32 / nte32.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        # mean over the NUM_COMB combination rows of <sum_i, nte_{j,m}>
        similarity = torch.einsum("ie,jme->ij", sum_proj, nte) / nte.shape[1]
        logits_mat = params["logit_scale_vm"] * (similarity * valid_mat)
        out["logits_vm"] = (torch.log_softmax(logits_mat, dim=-1)
                            + torch.log_softmax(logits_mat, dim=-2))

    if cfg.use_support_memory and memory is not None:
        tfm = text_features.detach() if cfg.detach_features else text_features
        mp = params["memory_project"]
        mem = memory.float().mean(dim=1)                        # (Bm, E)
        h = torch.tanh(torch.einsum("me,ceh->cmh", mem, mp["w1"])
                       + mp["b1"][:, None])
        memo = torch.einsum("cmh,chk->cmk", h, mp["w2"]) + mp["b2"][:, None]
        memo = _l2norm(memo)                            # (n_cls, Bm, E/8)
        tfp_params = params["tf_project"]
        group = tp["tf_project"]
        if group is None:
            tfp = linear(tfp_params["fc2"],
                         torch.tanh(linear(tfp_params["fc1"], tfm)))
        else:
            tfp = parallel_mlp(tfp_params, copy_to_group(tfm, group),
                               torch.tanh, group)
        tfp = _l2norm(tfp)                              # (n_cls, E/8)
        cols = torch.einsum("cmk,ck->mc", memo, tfp)
        logits_mt = torch.log_softmax(params["logit_scale_mt"] * cols, dim=-1)
        if "logit_bias_mt" in params:
            logits_mt = logits_mt + params["logit_bias_mt"]
        out["logits_mt"] = logits_mt

    return out


class VitaClipModel:
    """Config + frozen-buffer holder with a pure `apply` (the JAX class
    `VitaClip`). Construction follows the JAX flow: build the towers,
    derive the prompt buffers from the token embedding, add the heads.

    `params` and `buffers` are nested dicts of tensors on `device` (None
    means the card). Pass `params` / `buffers` to wrap existing trees (for
    example from `utils.jax_bridge`) instead of drawing new ones.
    `backbone_state` is a flat reference state dict
    (`utils.torch_convert.load_torch_state_dict`) laid over the drawn
    towers."""

    def __init__(self, cfg: VitaClipConfig,
                 classnames: Optional[Sequence[str]] = None,
                 backbone_state: Optional[Dict[str, np.ndarray]] = None,
                 zeroshot_text_features: Optional[np.ndarray] = None,
                 gen: Optional[torch.Generator] = None, device=None,
                 params: Optional[Dict] = None,
                 buffers: Optional[Dict] = None):
        if cfg.add_nte and not cfg.vision.use_summary_token:
            # the NTE branch consumes the vision tower's summary tokens
            raise ValueError("add_nte=True requires "
                             "vision.use_summary_token=True")
        if cfg.use_text_prompt_learning and cfg.prompt is None:
            raise ValueError("use_text_prompt_learning=True needs a "
                             "PromptConfig")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prompt_assets = None
        if params is None:
            # parameter init is thousands of small ops: on the host with a
            # CPU generator, then one move
            gen = gen if gen is not None else torch.Generator().manual_seed(0)
            params = init_vita_clip_params(gen, cfg)
            if backbone_state is not None:
                # overlay the CLIP backbone (non-strict) before the prompt
                # buffers are derived from the token embedding
                from ..utils.torch_convert import (convert_text_tower,
                                                   convert_vision_tower,
                                                   merge_pytrees,
                                                   strip_prefix)
                vis_sd = strip_prefix(backbone_state, "visual.")
                if vis_sd:
                    params["visual"] = merge_pytrees(
                        params["visual"],
                        convert_vision_tower(vis_sd, cfg.vision.layers))
                txt_sd = strip_prefix(backbone_state, "textual.")
                if txt_sd and cfg.use_text_prompt_learning:
                    params["textual"] = merge_pytrees(
                        params["textual"],
                        convert_text_tower(txt_sd, cfg.text.layers))
        if buffers is None:
            buffers = {}
            if cfg.use_text_prompt_learning:
                if classnames is None:
                    raise ValueError("text prompt learning needs classnames")
                token_embedding = params["textual"]["token_embedding"] \
                    .detach().cpu().numpy()
                assets = build_prompt_assets(classnames, cfg.prompt,
                                             token_embedding)
                self.prompt_assets = assets
                for name in ("token_prefix", "token_suffix", "kv_mask",
                             "pool_idx", "cntn_embeds"):
                    arr = getattr(assets, name)
                    if arr is not None:
                        buffers[name] = torch.from_numpy(np.array(arr))
            if cfg.zeroshot_evaluation and not cfg.use_text_prompt_learning:
                if zeroshot_text_features is None:
                    raise ValueError("zero-shot evaluation needs "
                                     "zeroshot_text_features")
                buffers["text_features"] = torch.from_numpy(
                    np.asarray(zeroshot_text_features, np.float32))
        self.params = _tree_to(params, self.device)
        self.buffers = _tree_to(buffers, self.device)

    def apply(self, params: Dict, buffers: Dict, x: torch.Tensor, **kw
              ) -> Dict[str, torch.Tensor]:
        """See the module-level `apply`."""
        return apply(self.cfg, params, buffers, x, **kw)

    def text_features_only(self, params: Dict, buffers: Dict,
                           compute_dtype=torch.float32) -> torch.Tensor:
        """Per-class text features without running the vision tower (the
        masked mean of the per-kv pooled features)."""
        if not self.cfg.use_text_prompt_learning:
            raise ValueError("text_features_only needs text prompt learning")
        tf, kv_mask, kv_count = _per_kv_text_features(
            self.cfg, params, buffers, compute_dtype)
        return _l2norm((tf * kv_mask[..., None]).sum(1) / kv_count)


def trainable_mask(params: Dict, cfg: VitaClipConfig) -> Dict:
    """True where a parameter is trainable (the original freezing rule):
    inside `visual`, only names containing summary / local / global /
    time_embed train; `textual` is fully frozen; everything else (prompt
    ctx / projector, heads, logit scales) trains. Same structure as
    params."""
    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, keys + (str(i),)) for i, v in enumerate(tree)]
        if keys[0] == "visual":
            name = "/".join(keys)
            return any(s in name for s in ("summary", "local", "global",
                                           "time_embed"))
        return keys[0] != "textual"

    return walk(params, ())


class VitaClip(nn.Module):
    """Zero-shot VitaCLIP. `params` is the nested dict of
    `init_vita_clip_params` (or of `utils.jax_bridge.params_from_jax`);
    `text_features` (n_cls, E) is a buffer, kept in its own dtype."""

    def __init__(self, cfg: VitaClipConfig, params: Dict,
                 text_features: torch.Tensor):
        super().__init__()
        if not cfg.zeroshot_evaluation or cfg.use_text_prompt_learning:
            raise ValueError(
                "VitaClip is the zero-shot serving module; text prompt "
                "learning and the NTE / memory heads run through "
                "VitaClipModel.apply")
        extra = set(params) - {"visual", "logit_scale"}
        if extra:
            raise ValueError(
                f"params outside the zero-shot branch: {sorted(extra)}")
        self.cfg = cfg
        self.visual = ParamTree(params["visual"])
        self.logit_scale = nn.Parameter(params["logit_scale"],
                                        requires_grad=False)
        self.register_buffer("text_features", text_features)

    def param_tree(self) -> Dict:
        return {"visual": self.visual.to_dict(),
                "logit_scale": self.logit_scale.data}

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32,
                attn_impl: str = "xla", input_format: str = "frames",
                int8_impl: str = "kernel", pp=None,
                mesh=None) -> Dict[str, torch.Tensor]:
        """x: (B, T, H, W, 3), or (B, T, N, ph*pw*3) with
        input_format='patches'. Returns logits (B, n_cls), text_features
        (n_cls, E) and, with the summary token, summary (B, D).
        int8_impl='plain' runs the w8a8 ops' plain versions on any device
        (held against the kernels on a card). pp: (stages, microbatches),
        the vision blocks as a GPipe pipeline (parallel/pipeline.py).
        mesh: a `parallel.mesh.Mesh` whose 'frame' axis splits the clips'
        frames: x then holds this rank's frames (see `apply`), also under
        pp, where each stage gathers its micro-batch's cls rows."""
        video_features, summary = vision_encoder(
            self.visual, x, self.cfg.vision, compute_dtype=compute_dtype,
            attn_impl=attn_impl, input_format=input_format,
            int8_impl=int8_impl, pp=pp, fp=frame_group(mesh))
        video_features = _l2norm(video_features.float())
        text_features = _l2norm(self.text_features.float())
        logit_scale = torch.exp(self.logit_scale).float()
        logits = (logit_scale * video_features) @ text_features.T
        out = {"logits": logits, "text_features": text_features}
        if summary is not None:
            out["summary"] = summary
        return out
