"""Model constructors (port of gava_clip_tpu/utils/flagship.py).

`build_flagship` is the training model: ViT-B/16 with summary / local /
global prompts, KAPT split_uni prompts over 5 knowledge versions, support
memory and NTE heads. Where no knowledge files are given, synthetic
stand-ins with the right shapes are generated. `build_zero_shot` is the
serving model. Both put the model on the card unless a device is given,
and both lay a reference CLIP backbone `.pth` over the drawn weights when
`backbone_path` names one.
"""

import os.path as osp
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.prompts import PromptConfig
from ..models.text import TextConfig
from ..models.vision import VisionConfig
from ..models.vita_clip import (VitaClip, VitaClipConfig, VitaClipModel,
                                init_vita_clip_params)
from .device import resolve_device

UPDRS_3CLS_CLASSNAMES = ("normal", "slight difficulty", "moderate difficulty")
UPDRS_3CLS_LABELS = ("normal", "slight", "moderate")


def _vit_b16(num_frames: int, input_size: int) -> VisionConfig:
    return VisionConfig(input_size=(input_size, input_size),
                        num_frames=num_frames, feature_dim=768,
                        patch_size=(16, 16), heads=12, layers=12,
                        mlp_factor=4.0, embed_dim=512,
                        use_summary_token=True, use_local_prompts=True,
                        use_global_prompts=True, num_global_prompts=8)


def make_synthetic_knowledge_dir(n_cls: int, versions: Sequence[str],
                                 seed: int = 0) -> str:
    """Create a temp data/ke_* directory with synthetic KEPLER embeddings
    and class descriptions in the knowledge-file formats
    (models/prompts.py); the same seeded numpy draws as the JAX function."""
    kdir = tempfile.mkdtemp(prefix="gava_ke_")
    rs = np.random.RandomState(seed)
    np.save(osp.join(kdir, "EntityEmb_v0.npy"),
            rs.randn(n_cls, 768).astype(np.float32))
    np.save(osp.join(kdir, "all.npy"), rs.randn(n_cls, 768).astype(np.float32))
    for kv in versions:
        np.save(osp.join(kdir, f"EntityEmb_{kv}.npy"),
                rs.randn(n_cls, 768).astype(np.float32))
        with open(osp.join(kdir, f"simQdesc_{kv}.txt"), "w") as f:
            for c in range(n_cls):
                f.write(f"a person walking with gait pattern {kv} of severity "
                        f"level {c} showing step irregularities\n")
    return kdir


def _backbone_state(path: Optional[str]):
    if path and osp.isfile(path):
        from .torch_convert import load_torch_state_dict
        return load_torch_state_dict(path)
    return None


def build_flagship(num_frames: int = 8, num_classes: int = 3,
                   knowledge_versions: Sequence[str] = ("v1", "v2", "v3",
                                                        "v4", "v5"),
                   knowledge_dir: Optional[str] = None,
                   backbone_path: Optional[str] = None,
                   use_support_memory: bool = True, add_nte: bool = True,
                   input_size: int = 224, rng_seed: int = 0,
                   device=None) -> VitaClipModel:
    """ViT-B/16 Vita-CLIP with the full GaVA head stack, random weights
    from a seeded torch.Generator, on `device` (None means the card)."""
    device = resolve_device(device)
    if knowledge_dir is None:
        knowledge_dir = make_synthetic_knowledge_dir(num_classes,
                                                     knowledge_versions)
    cfg = VitaClipConfig(
        vision=_vit_b16(num_frames, input_size),
        text=TextConfig(embed_dim=512, width=512, heads=8, layers=12),
        num_classes=num_classes, cls_type="updrs",
        use_text_prompt_learning=True,
        prompt=PromptConfig(n_cls=num_classes, n_ctx=8, ctx_dim=512,
                            emb_dim=128, init="cntn_split_uni_disc", csc=True,
                            cls_type="updrs",
                            knowledge_versions=tuple(knowledge_versions),
                            knowledge_dir=knowledge_dir),
        zeroshot_evaluation=False,
        use_support_memory=use_support_memory, add_nte=add_nte)
    return VitaClipModel(cfg, classnames=list(UPDRS_3CLS_CLASSNAMES),
                         backbone_state=_backbone_state(backbone_path),
                         gen=torch.Generator().manual_seed(rng_seed),
                         device=device)


def build_zero_shot(num_frames: int = 8, num_classes: int = 400,
                    input_size: int = 224,
                    text_features: Optional[np.ndarray] = None,
                    backbone_path: Optional[str] = None,
                    rng_seed: int = 0, device=None) -> VitaClip:
    """Zero-shot eval model: ViT-B/16 with summary, local and global
    prompts, random weights from a seeded torch.Generator, precomputed
    text features (the same seeded numpy draw as the JAX function when
    none are given), on `device` (None means the card)."""
    device = resolve_device(device)
    if text_features is None:
        rs = np.random.RandomState(rng_seed)
        text_features = rs.randn(num_classes, 512).astype(np.float32)
    cfg = VitaClipConfig(
        vision=_vit_b16(num_frames, input_size),
        num_classes=num_classes, zeroshot_evaluation=True)
    # init on the host with a CPU generator, then move
    gen = torch.Generator().manual_seed(rng_seed)
    params = init_vita_clip_params(gen, cfg)
    backbone = _backbone_state(backbone_path)
    if backbone is not None:
        from .torch_convert import (convert_vision_tower, merge_pytrees,
                                    strip_prefix)
        vis_sd = strip_prefix(backbone, "visual.")
        if vis_sd:
            params["visual"] = merge_pytrees(
                params["visual"],
                convert_vision_tower(vis_sd, cfg.vision.layers))
    model = VitaClip(cfg, params, torch.from_numpy(
        np.asarray(text_features, np.float32)))
    return model.to(device)


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
