"""Build a VitaClipModel from the CLI argparse namespace (port of
gava_clip_tpu/models/factory.py): the equivalent of the reference's
VitaCLIP(...) constructor call in its training script."""

from typing import Optional, Sequence

import numpy as np

from .prompts import PromptConfig
from .text import TextConfig
from .vision import VisionConfig
from .vita_clip import VitaClipConfig, VitaClipModel


def model_config_from_args(args, num_classes: int) -> VitaClipConfig:
    prompt = None
    if args.use_text_prompt_learning:
        prompt = PromptConfig(
            n_cls=num_classes,
            n_ctx=args.text_num_prompts,
            ctx_dim=args.text_transformer_width,
            emb_dim=args.text_transformer_width // 4,
            init=args.text_prompt_init,
            csc=args.text_prompt_CSC,
            cls_type=args.type if hasattr(args, "type") else "updrs",
            knowledge_versions=tuple(args.knowledge_version),
            use_descriptor=args.use_descriptor,
            token_wise_mlp=args.token_wise_mlp,
            knowledge_dir=getattr(args, "knowledge_dir", ""),
            context_length=args.text_context_length)
    return VitaClipConfig(
        vision=VisionConfig(
            input_size=(args.spatial_size, args.spatial_size),
            num_frames=args.num_frames,
            feature_dim=args.feature_dim,
            patch_size=(args.patch_size, args.patch_size),
            heads=args.num_heads, layers=args.num_layers,
            mlp_factor=args.mlp_factor, embed_dim=args.embed_dim,
            use_summary_token=args.use_summary_token,
            use_local_prompts=args.use_local_prompts,
            use_global_prompts=args.use_global_prompts,
            num_global_prompts=args.num_global_prompts),
        text=TextConfig(
            embed_dim=args.embed_dim,
            context_length=args.text_context_length,
            vocab_size=args.text_vocab_size,
            width=args.text_transformer_width,
            heads=args.text_transformer_heads,
            layers=args.text_transformer_layers),
        num_classes=num_classes,
        cls_type=getattr(args, "type", "updrs"),
        use_text_prompt_learning=args.use_text_prompt_learning,
        prompt=prompt,
        zeroshot_evaluation=args.zeroshot_evaluation,
        use_support_memory=args.use_support_memory,
        detach_features=args.detach,
        add_nte=args.add_nte,
        use_sigmoid_loss=args.sigmoid_loss)


def build_model_from_args(args, num_classes: int,
                          classnames: Optional[Sequence[str]] = None,
                          zeroshot_text_features: Optional[np.ndarray] = None,
                          rng_seed: int = 0, device=None) -> VitaClipModel:
    """`device` None means the card; args.device is NOT read here."""
    import torch
    cfg = model_config_from_args(args, num_classes)

    backbone_state = None
    if getattr(args, "backbone_path", ""):
        import os.path as osp
        if not osp.isfile(args.backbone_path):
            # silently training a RANDOM backbone because of a mistyped
            # path gives garbage metrics with no signal; the reference's
            # torch.load raises here too
            raise FileNotFoundError(
                f"--backbone_path {args.backbone_path!r} does not exist")
        from ..utils.torch_convert import load_torch_state_dict
        backbone_state = load_torch_state_dict(args.backbone_path)

    if cfg.zeroshot_evaluation and zeroshot_text_features is None:
        path = getattr(args, "zeroshot_text_features_path", "")
        import os.path as osp
        if path and osp.isfile(path):
            from ..train.checkpoint import load_checkpoint
            ck = load_checkpoint(path)
            zeroshot_text_features = ck.get("text_features")

    return VitaClipModel(cfg, classnames=classnames,
                         backbone_state=backbone_state,
                         zeroshot_text_features=zeroshot_text_features,
                         gen=torch.Generator().manual_seed(rng_seed),
                         device=device)
