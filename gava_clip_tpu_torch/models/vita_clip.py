"""VitaCLIP, zero-shot branch (port of gava_clip_tpu/models/vita_clip.py).

Vision tower -> fp32 l2-normalised video features -> logits against
precomputed, l2-normalised text features, scaled by exp(logit_scale).
Text prompt learning, the NTE and the support-memory heads belong to the
training slice (ROADMAP A7) and are not ported yet.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch import nn

from .common import ParamTree
from .vision import VisionConfig, init_vision_params, vision_encoder


@dataclass(frozen=True)
class VitaClipConfig:
    vision: VisionConfig = field(default_factory=VisionConfig)
    num_classes: int = 4
    zeroshot_evaluation: bool = True


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def init_vita_clip_params(gen: Optional[torch.Generator],
                          cfg: VitaClipConfig, device=None) -> Dict:
    """Random zero-shot params; device='meta' gives the shapes only."""
    return {"visual": init_vision_params(gen, cfg.vision, device),
            "logit_scale": torch.tensor(math.log(1.0 / 0.07),
                                        dtype=torch.float32, device=device)}


class VitaClip(nn.Module):
    """Zero-shot VitaCLIP. `params` is the nested dict of
    `init_vita_clip_params` (or of `utils.jax_bridge.params_from_jax`);
    `text_features` (n_cls, E) is a buffer, kept in its own dtype."""

    def __init__(self, cfg: VitaClipConfig, params: Dict,
                 text_features: torch.Tensor):
        super().__init__()
        if not cfg.zeroshot_evaluation:
            raise NotImplementedError(
                "only the zero-shot branch is ported; text prompt learning "
                "and the NTE / memory heads come with the training slice "
                "(ROADMAP A7)")
        extra = set(params) - {"visual", "logit_scale"}
        if extra:
            raise NotImplementedError(
                f"params not ported yet: {sorted(extra)}")
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
                int8_impl: str = "kernel") -> Dict[str, torch.Tensor]:
        """x: (B, T, H, W, 3), or (B, T, N, ph*pw*3) with
        input_format='patches'. Returns logits (B, n_cls), text_features
        (n_cls, E) and, with the summary token, summary (B, D).
        int8_impl='plain' runs the w8a8 ops' plain versions on any device
        (held against the kernels on a card)."""
        video_features, summary = vision_encoder(
            self.visual, x, self.cfg.vision, compute_dtype=compute_dtype,
            attn_impl=attn_impl, input_format=input_format,
            int8_impl=int8_impl)
        video_features = _l2norm(video_features.float())
        text_features = _l2norm(self.text_features.float())
        logit_scale = torch.exp(self.logit_scale).float()
        logits = (logit_scale * video_features) @ text_features.T
        out = {"logits": logits, "text_features": text_features}
        if summary is not None:
            out["summary"] = summary
        return out
