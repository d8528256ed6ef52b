"""Model constructors (port of gava_clip_tpu/utils/flagship.py, the
zero-shot serving model). Loading a reference backbone `.pth` is not ported yet
(ROADMAP A10): the JAX converter imports JAX."""

from typing import Dict, Optional

import numpy as np
import torch

from ..models.vision import VisionConfig
from ..models.vita_clip import VitaClip, VitaClipConfig, init_vita_clip_params


def build_zero_shot(num_frames: int = 8, num_classes: int = 400,
                    input_size: int = 224,
                    text_features: Optional[np.ndarray] = None,
                    rng_seed: int = 0, device=None) -> VitaClip:
    """Zero-shot eval model: ViT-B/16 with summary, local and global
    prompts, random weights from a seeded torch.Generator, precomputed
    text features (the same seeded numpy draw as the JAX function when
    none are given)."""
    if text_features is None:
        rs = np.random.RandomState(rng_seed)
        text_features = rs.randn(num_classes, 512).astype(np.float32)
    cfg = VitaClipConfig(
        vision=VisionConfig(input_size=(input_size, input_size),
                            num_frames=num_frames, feature_dim=768,
                            patch_size=(16, 16), heads=12, layers=12,
                            mlp_factor=4.0, embed_dim=512,
                            use_summary_token=True, use_local_prompts=True,
                            use_global_prompts=True, num_global_prompts=8),
        num_classes=num_classes, zeroshot_evaluation=True)
    # init on the host with a CPU generator, then move
    gen = torch.Generator().manual_seed(rng_seed)
    params = init_vita_clip_params(gen, cfg)
    model = VitaClip(cfg, params, torch.from_numpy(
        np.asarray(text_features, np.float32)))
    return model.to(device) if device is not None else model


def inject_clip_pathologies(params: Dict, seed: int = 0,
                            ln_outlier_frac: float = 0.04,
                            ln_outlier_scale: float = 8.0,
                            w_heavy_frac: float = 0.02,
                            w_heavy_scale: float = 16.0) -> Dict:
    """Give a synthetic tower the int8 failure modes of real CLIP weights:
    LayerNorm outlier channels (norm1/norm2 gains scaled up) and
    heavy-tailed kernel input rows (attention and MLP kernels). Draws the
    same numpy random indices in the same order as the JAX function, so
    the same seed gives the same weights bit for bit. Returns a new tree;
    the input is not mutated."""
    rs = np.random.RandomState(seed)
    blocks = [dict(b) for b in params["visual"]["blocks"]]

    def scaled(t: torch.Tensor, axis_len: int, frac: float, scale: float):
        n = max(1, int(round(axis_len * frac)))
        idx = torch.from_numpy(rs.choice(axis_len, n, replace=False))
        t = t.float().clone()
        t[idx.to(t.device)] *= scale
        return t

    for ln in ("norm1", "norm2"):
        for blk in blocks:
            blk[ln] = dict(blk[ln])
            s = blk[ln]["scale"]
            blk[ln]["scale"] = scaled(s, s.shape[-1], ln_outlier_frac,
                                      ln_outlier_scale)
    for mod, names in (("attn", ("q", "k", "v", "out")),
                       ("mlp", ("fc1", "fc2"))):
        for blk in blocks:
            blk[mod] = dict(blk[mod])
        for nm in names:
            for blk in blocks:
                leaf = dict(blk[mod][nm])
                k = leaf["kernel"]
                leaf["kernel"] = scaled(k, k.shape[0], w_heavy_frac,
                                        w_heavy_scale)
                blk[mod][nm] = leaf
    visual = dict(params["visual"])
    visual["blocks"] = blocks
    out = dict(params)
    out["visual"] = visual
    return out
