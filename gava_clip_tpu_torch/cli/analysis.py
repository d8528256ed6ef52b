"""Per-descriptor analysis (port of gava_clip_tpu/cli/analysis.py, the
counterpart of the reference's training/analysis_segment.py).

    python -m gava_clip_tpu_torch.cli.analysis [--device cpu] \\
        --model_dir logs/<run> <data flags> [--output_dir DIR]

For each fold's best checkpoint, runs the desc_wise forward (per-descriptor
similarity logits, reference VitaCLIP_model.py:266-276: the vision tower
and the prompt-learned text tower, both through the attention kernels on
the card), predicts the class as the argmax of per-class max-descriptor
similarity, and accumulates per-descriptor precision: among eval clips
predicted as class c via descriptor d, the fraction predicted correctly
(analysis_segment.py:170-196). The argmaxes are taken on the host in
numpy, as the JAX program takes them, so ties go to the first index.
Writes a text report and, where matplotlib is installed, per-class bar
charts labeled with the descriptor texts themselves.
"""

import os
import os.path as osp
import time
from typing import Dict, List

import numpy as np
import torch

from ..data.device_preprocess import normalize_frames
from ..data.loader import create_val_loader
from ..data.video import parse_classes_file
from ..models.factory import build_model_from_args
from ..train.checkpoint import load_checkpoint
from ..utils.config import build_train_parser, load_config_into
from ..utils.device import resolve_device
from ..utils.torch_convert import merge_pytrees
from .train import (_loaded_params, _log, _mean_std, _run_settings,
                    loader_config_from_args)

# the last `main` call: forwards and seconds
last_run = {}


def main(argv=None):
    parser = build_train_parser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default="")
    parser.add_argument("--output_dir", type=str, default="./analysis_output")
    args = parser.parse_args(argv)
    resolve_device(args.device)     # no card and no --device cpu: raise now

    config_fp = osp.join(args.model_dir, "config.yaml")
    assert osp.isfile(config_fp), "config.yaml not found in model_dir"
    # device belongs to this run, not to the training run (cli/evaluate.py)
    keep = [k for k in vars(args) if "data" in k or "list_path" in k
            or k in ("model_dir", "output_dir", "batch_size", "device")]
    load_config_into(args, config_fp, skip=keep)

    classnames, cls_labels = parse_classes_file(args.text_prompt_classes_path)
    n_cls = len(cls_labels)
    mean, std = _mean_std(args)
    device, compute_dtype, attn_impl = _run_settings(args)

    model = build_model_from_args(args, n_cls, classnames=classnames,
                                  device=device)
    prompt_texts = model.prompt_assets.prompt_texts
    kv_mask = model.prompt_assets.kv_mask                 # (n_cls, max_kv)
    max_kv = kv_mask.shape[1]
    kv_valid = torch.as_tensor(np.asarray(kv_mask) > 0, device=device)

    @torch.no_grad()
    def desc_forward(params, video_u8):
        video = normalize_frames(video_u8, mean, std,
                                 compute_dtype=torch.float32)
        out = model.apply(params, model.buffers, video, desc_wise=True,
                          compute_dtype=compute_dtype, attn_impl=attn_impl)
        sim = out["desc_logits"].float()                  # (B, n_cls, max_kv)
        return torch.where(kv_valid[None], sim, float("-inf"))

    # per (class, descriptor): list of per-fold precisions
    per_desc: Dict[int, Dict[int, List[float]]] = {
        c: {d: [] for d in range(int(kv_mask[c].sum()))} for c in range(n_cls)}

    last_run.clear()
    last_run["forwards"] = 0
    t0 = time.perf_counter()
    for nf in range(args.nfold):
        ckpt_path = None
        for ext in (".ckpt", ".pth"):
            p = osp.join(args.model_dir, f"fold_{nf}", f"fold-{nf}-best{ext}")
            if osp.isfile(p):
                ckpt_path = p
                break
        if ckpt_path is None:
            _log(f"fold {nf}: checkpoint missing, skipped")
            continue
        ckpt = load_checkpoint(ckpt_path)
        params = merge_pytrees(model.params,
                               _loaded_params(ckpt, args, n_cls))

        lcfg = loader_config_from_args(args)
        if args.data_dir:
            lcfg.val_data_root = osp.join(args.data_dir, f"chunks_{nf}")
            lcfg.val_list_path = osp.join(lcfg.val_data_root,
                                          f"val_{args.type}.csv")
        loader = create_val_loader(lcfg)

        hits: Dict[int, Dict[int, List[int]]] = {
            c: {d: [] for d in range(max_kv)} for c in range(n_cls)}
        for batch in loader:
            video = batch["video"]
            n = video.shape[0]
            if n < args.batch_size:
                video = np.concatenate(
                    [video, np.repeat(video[-1:], args.batch_size - n, axis=0)])
            sim = desc_forward(params, torch.from_numpy(video).to(device))
            sim = sim.cpu().numpy()[:n]
            last_run["forwards"] += 1
            labels = np.asarray(batch["labels"])[:n]
            best_desc = sim.argmax(-1)                    # (B, n_cls)
            best_score = sim.max(-1)                      # (B, n_cls)
            pred_cls = best_score.argmax(-1)              # (B,)
            for b in range(n):
                c = int(pred_cls[b])
                d = int(best_desc[b, c])
                hits[c][d].append(1 if c == labels[b] else 0)
        for c in range(n_cls):
            for d in per_desc[c]:
                per_desc[c][d].append(
                    float(np.mean(hits[c][d])) if hits[c][d] else 0.0)
    last_run["seconds"] = time.perf_counter() - t0

    os.makedirs(args.output_dir, exist_ok=True)
    report = osp.join(args.output_dir, f"{args.type}_per_descriptor_precision.txt")
    with open(report, "w") as f:
        for c in range(n_cls):
            f.write(f"class {c} ({classnames[c]}):\n")
            for d, vals in per_desc[c].items():
                label = prompt_texts[c][d] if d < len(prompt_texts[c]) \
                    else f"Segment {d}"
                prec = float(np.mean(vals)) * 100 if vals else 0.0
                f.write(f"  [{prec:6.2f}%] {label}\n")
    last_run["report"] = report
    _log(f"wrote {report}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:   # the card's machine has no matplotlib
        return per_desc
    for c in range(n_cls):
        labels = [prompt_texts[c][d] if d < len(prompt_texts[c])
                  else f"Segment {d}" for d in per_desc[c]]
        precs = [float(np.mean(v)) * 100 if v else 0.0
                 for v in per_desc[c].values()]
        fig, ax = plt.subplots(figsize=(12, 8))
        ax.barh(range(len(precs)), precs)
        ax.set_yticks(range(len(precs)))
        ax.set_yticklabels([l[:60] for l in labels], fontsize=8)
        ax.set_xlabel("per-descriptor precision (%)")
        plt.tight_layout()
        plt.savefig(osp.join(args.output_dir,
                             f"{args.type}_{c}_per_descriptor_precision.png"))
        plt.close(fig)
    return per_desc


if __name__ == "__main__":
    main()
