"""Cross-fold re-evaluation of a training run directory (port of
gava_clip_tpu/cli/evaluate.py, the counterpart of the reference's
evaluation/evaluate.py).

    python -m gava_clip_tpu_torch.cli.evaluate [--device cpu] \\
        --checkpoint_dir logs/<run> <data flags> [--quantize_eval w8|w8a8]

Reloads the run's config.yaml as the source of truth (keeping the command
line's data_root / list_path / checkpoint overrides), then per fold loads
fold_<n>/fold-<n>-best.ckpt, builds the model in zero-shot mode with the
text_features saved inside the checkpoint, drops the memory-head
parameters, evaluates, and writes the accuracy / F1 / per-class-count
report and, where matplotlib and seaborn are installed, the
confusion-matrix heatmap. Reference torch .pth fold checkpoints are
accepted too (converted on load).
"""

import argparse
import glob
import os.path as osp

import numpy as np

from ..data.loader import create_val_loader
from ..data.video import parse_classes_file
from ..models.factory import build_model_from_args
from ..ops.int8_matmul import with_kernel_layout
from ..ops.quant import prepare_inference_params
from ..train.checkpoint import load_checkpoint
from ..train.metrics import f1_from_confusion
from ..utils.config import build_train_parser, load_config_into
from ..utils.torch_convert import merge_pytrees
from .train import (_loaded_params, _log, _mean_std, _run_settings,
                    _save_heatmap, evaluate, loader_config_from_args)

# the memory-head parameters, which the zero-shot model has no use for
_DROP = ("tf_project", "sum_proj", "memory_project", "logit_scale_mt",
         "logit_bias_mt", "logit_scale_vm")


def inference_params(params, args, compute_dtype):
    """`--quantize_eval` applied to a parameter tree: int8 leaves (with the
    layout the CUDA kernels read) and the compute-dtype cast."""
    return with_kernel_layout(prepare_inference_params(
        params, getattr(args, "quantize_eval", ""), compute_dtype))


def main(argv=None):
    parser = build_train_parser()
    args = parser.parse_args(argv)

    classnames, cls_labels = parse_classes_file(args.text_prompt_classes_path)
    num_classes = len(cls_labels)

    assert osp.isdir(args.checkpoint_dir), args.checkpoint_dir
    nfold = len(glob.glob(osp.join(args.checkpoint_dir, "fold*")))
    config_path = osp.join(args.checkpoint_dir, "config.yaml")
    if osp.isfile(config_path):
        # keep the command line's data paths and checkpoints, and the two
        # options that belong to this run, not to the training run:
        # device and quantize_eval (the saved config holds the training
        # run's empty quantize_eval, which would switch the option off)
        keep = [k for k in vars(args)
                if "data_root" in k or "list_path" in k or "checkpoint" in k
                or k in ("device", "quantize_eval")]
        load_config_into(args, config_path, skip=keep)

    device, compute_dtype, attn_impl = _run_settings(args)
    mean, std = _mean_std(args)
    lcfg = loader_config_from_args(args)
    lcfg.num_temporal_views = args.num_temporal_views

    performance = []
    conf_total = np.zeros((num_classes, num_classes), np.int64)
    for nf in range(nfold):
        ckpt_path = None
        for ext in (".ckpt", ".pth"):
            p = osp.join(args.checkpoint_dir, f"fold_{nf}",
                         f"fold-{nf}-best{ext}")
            if osp.isfile(p):
                ckpt_path = p
                break
        if ckpt_path is None:
            continue
        _log(f"Loading checkpoint from {ckpt_path}")
        ckpt = load_checkpoint(ckpt_path)
        assert ckpt.get("text_features") is not None, \
            "checkpoint lacks text_features: cannot zero-shot evaluate"

        # zero-shot model with the checkpoint's learned text features
        args_zs = argparse.Namespace(**vars(args))
        args_zs.use_text_prompt_learning = False
        args_zs.zeroshot_evaluation = True
        args_zs.use_support_memory = False
        args_zs.add_nte = False
        model = build_model_from_args(
            args_zs, num_classes,
            zeroshot_text_features=ckpt["text_features"], device=device)
        loaded = _loaded_params(ckpt, args, num_classes, drop=_DROP)
        # the zero-shot model holds the vision tower and the logit scale
        loaded = {k: v for k, v in loaded.items() if k in model.params}
        params = inference_params(merge_pytrees(model.params, loaded), args,
                                  compute_dtype)

        loader = create_val_loader(lcfg)
        acc, conf = evaluate(model, params, loader, num_classes, mean, std,
                             compute_dtype, args.batch_size,
                             attn_impl=attn_impl, device=device)
        conf_total += conf
        _log(f"Accuracy on evaluation set fold-{nf}: top1={acc:.2f}%")
        performance.append(acc / 100.0)

    _log(f"Overall accuracy: {np.mean(performance) * 100:.2f}%")
    f1 = f1_from_confusion(conf_total.astype(np.float64))
    f1_str = " ".join(f"{x:.4f}" for x in f1)
    _log(f"Per-class F1-score: {f1_str}")
    _log(f"Average F1-score: {f1.mean():.4f}")

    tag = args.data_root.split("datasets/")[-1].replace("/", "_")
    output_file = osp.join(args.checkpoint_dir, f"eval_{tag}.txt")
    seq_num = conf_total.sum(1)
    with open(output_file, "w") as f:
        f.write(f"Overall accuracy: {np.mean(performance) * 100:.2f}%\n")
        f.write(f"Overall F1-score: {f1_str}\n")
        f.write(f"Average F1-score: {f1.mean():.4f}\n")
        f.write("Per-class sequence number:\n")
        f.write(" ".join(str(int(x)) for x in seq_num) + "\n")
        f.write("Overall confusion matrix:\n")
        for row in conf_total:
            f.write(" ".join(str(int(x)) for x in row) + "\n")
    _save_heatmap(conf_total, output_file.replace(".txt", ".png"),
                  annot=False)
    return performance, conf_total


if __name__ == "__main__":
    main()
