"""Zero-shot evaluation of a pretrained Vita-CLIP (port of
gava_clip_tpu/cli/zero_shot.py, the counterpart of the reference's
evaluation/zero_shot.py).

    python -m gava_clip_tpu_torch.cli.zero_shot [--device cpu] \\
        --backbone_path clip.pth --pretrained_vlm vlm.pth <data flags>

Encode the classnames (optionally prefixed with simQdesc_<kv> knowledge
descriptions) through the frozen CLIP text tower into a text-feature file;
build the model with all vision prompts ON and text prompt learning OFF;
load visual-only weights from the pretrained checkpoint; evaluate; write
the accuracy / F1 / weighted-F1 report. Under `python -m
torch.distributed.run --nproc_per_node N` rank 0 writes the text features,
each rank evaluates its share of the clips, the counts are summed once,
and rank 0 writes the report.
"""

import argparse
import os
import os.path as osp
from typing import List

import numpy as np
import torch

from ..data.loader import create_eval_loader
from ..data.video import parse_classes_file
from ..models.factory import build_model_from_args
from ..models.text import TextConfig, encode_text_tokens
from ..models.vita_clip import _tree_to
from ..text.tokenizer import tokenize
from ..train.checkpoint import load_checkpoint
from ..parallel import distributed as _dist
from ..utils.config import add_dist_args, build_train_parser
from ..utils.torch_convert import (adapt_frame_params, convert_text_tower,
                                   load_torch_state_dict, merge_pytrees,
                                   strip_prefix)
from .evaluate import inference_params
from .train import (_loaded_params, _log, _mean_std, _run_settings, evaluate,
                    sharded_val_loader, start_ranks)


def knowledge_to_text_features(args, cls_names: List[str], device) -> str:
    """Encode (knowledge-augmented) classnames with the frozen text tower
    loaded from the CLIP backbone; save to .npy."""
    sd = load_torch_state_dict(args.backbone_path)
    txt_sd = strip_prefix(sd, "textual.")
    cfg = TextConfig(embed_dim=args.embed_dim,
                     context_length=args.text_context_length,
                     vocab_size=args.text_vocab_size,
                     width=args.text_transformer_width,
                     heads=args.text_transformer_heads,
                     layers=args.text_transformer_layers)
    params = _tree_to(merge_pytrees({}, convert_text_tower(txt_sd, cfg.layers)),
                      device)

    cls_names = [name.replace("_", " ") for name in cls_names]
    if args.use_discrete_prompt:
        disc_file = osp.join(args.info_dir, f"ke_{args.type}",
                             f"simQdesc_{args.knowledge_version_single}.txt")
        with open(disc_file) as f:
            cls_disc = [line.strip() for line in f]
        assert len(cls_disc) == len(cls_names)
        cls_names = [f"{cls_disc[i]} {cls_names[i]}"
                     for i in range(len(cls_names))]

    tokens = torch.from_numpy(np.asarray(tokenize(cls_names))).to(device)
    with torch.no_grad():
        feats = encode_text_tokens(params, tokens, cfg).float().cpu().numpy()

    out_dir = osp.join(args.info_dir, f"ke_{args.type}")
    filename = osp.join(out_dir,
                        f"text_features_{args.knowledge_version_single}.npy")
    if _dist.is_main_process():
        os.makedirs(out_dir, exist_ok=True)
        np.save(filename, feats)
    _dist.barrier()             # the file is there for every rank
    return filename


def main(argv=None):
    parser = add_dist_args(build_train_parser())
    parser.add_argument("--pretrained_vlm", type=str,
                        default="./pretrained/ckpt_k400.pth")
    parser.add_argument("--use_discrete_prompt", action="store_true")
    parser.add_argument("--info_dir", type=str, default="./data")
    parser.add_argument("--knowledge_version_single", type=str, default="v0")
    args = parser.parse_args(argv)
    rank, _ = start_ranks(args, names=("batch_size",))
    device, compute_dtype, attn_impl = _run_settings(args)

    cls_names, cls_labels = parse_classes_file(args.text_prompt_classes_path)
    num_classes = len(cls_labels)

    tf_path = knowledge_to_text_features(args, cls_names, device)
    text_features = np.load(tf_path)

    args_zs = argparse.Namespace(**vars(args))
    args_zs.use_summary_token = True
    args_zs.use_local_prompts = True
    args_zs.use_global_prompts = True
    args_zs.num_global_prompts = 8
    args_zs.use_text_prompt_learning = False
    args_zs.zeroshot_evaluation = True
    args_zs.use_support_memory = False
    args_zs.add_nte = False
    model = build_model_from_args(args_zs, num_classes,
                                  zeroshot_text_features=text_features,
                                  device=device)

    params = model.params
    if args.pretrained_vlm and osp.isfile(args.pretrained_vlm):
        _log(f"Loading checkpoint from {args.pretrained_vlm}")
        ckpt = load_checkpoint(args.pretrained_vlm)
        loaded = _loaded_params(ckpt, argparse.Namespace(
            **{**vars(args), "text_prompt_init": ""}), num_classes,
            drop=("textual", "prompt"),
            drop_names=("textual", "prompt_learner"))
        loaded = adapt_frame_params(loaded, args.num_frames)
        params = merge_pytrees(params, loaded)

    mean, std = _mean_std(args)
    params = inference_params(params, args, compute_dtype)

    loader, batch, mesh = sharded_val_loader(args, make=create_eval_loader)
    acc, conf = evaluate(model, params, loader, num_classes, mean, std,
                         compute_dtype, batch, attn_impl=attn_impl,
                         device=device, mesh=mesh)
    performance = acc / 100.0
    _log(f"Evaluation accuracy: top1={performance * 100:.2f}%")
    if rank != 0:
        return performance, conf

    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = np.zeros(num_classes)
        wf1 = np.zeros(num_classes)
        weights = conf.sum(axis=1) / conf.sum()
        for ci in range(num_classes):
            f1[ci] = 2 * conf[ci, ci] / (conf[ci, :].sum()
                                         + conf[:, ci].sum())
            wf1[ci] = f1[ci] * weights[ci]
    f1 = np.nan_to_num(f1)
    wf1 = np.nan_to_num(wf1)

    os.makedirs("./eval_output", exist_ok=True)
    output_file = osp.join(
        "./eval_output",
        f"disc_{args.knowledge_version_single}.txt"
        if args.use_discrete_prompt else "class_name.txt")
    with open(output_file, "w") as f:
        f.write(f"Overall accuracy: {performance * 100:.2f}%\n")
        f.write("Overall confusion matrix:\n")
        for row in conf:
            f.write(" ".join(str(int(x)) for x in row) + "\n")
        f.write("----------------------------------------------------\n")
        f.write("\nF1-score per class: " + " ".join(f"{x:.4f}" for x in f1))
        f.write(f"\nAverage F1-score: {f1.mean():.4f}")
        f.write("\nWeighted F1-score per class: "
                + " ".join(f"{x:.4f}" for x in wf1))
        f.write(f"\nAverage weighted F1-score: {wf1.sum():.4f}")
    return performance, conf


if __name__ == "__main__":
    main()
    _dist.shutdown()
