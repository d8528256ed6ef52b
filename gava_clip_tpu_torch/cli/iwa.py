"""Importance-weighted aggregation of several trained runs (port of
gava_clip_tpu/cli/iwa.py, the counterpart of the reference's
evaluation/iwa.py).

    python -m gava_clip_tpu_torch.cli.iwa [--device cpu] \\
        --model_dirs logs/<run1> logs/<run2> ... <data flags>

Per fold, each model contributes (a) a source-fit scalar F measured on the
fold's train split and (b) target logit vectors G on the val split;
weights = pinv(Gram(G)) @ F; the fold is scored on the weighted sum of the
models' logits (reference iwa.py:200-322). Each model is the zero-shot
`VitaClip` with the text features saved in its checkpoint, built from its
run's config.yaml (the command line keeps the data paths, the checkpoints,
`device` and `quantize_eval`); its forward is the evaluation step's, the
attention kernel on the card. `--use_text_features` computes the weighted
text features and still scores with the logits, as the JAX program does
(ROADMAP C).
"""

import argparse
import glob
import os.path as osp
import time

import numpy as np
import torch

from ..data.device_preprocess import normalize_frames
from ..data.loader import create_val_loader
from ..data.video import parse_classes_file
from ..models.factory import build_model_from_args
from ..train.checkpoint import load_checkpoint
from ..train.metrics import f1_from_confusion
from ..utils.aggregation import (aggregate_logits, aggregate_text_features,
                                 aggregation_weights, source_fit_stats)
from ..utils.config import build_train_parser, load_config_into
from ..utils.device import resolve_device
from ..utils.torch_convert import merge_pytrees
from .evaluate import inference_params
from .train import (_loaded_params, _log, _mean_std, _run_settings,
                    loader_config_from_args)

# the memory heads and the text side, which the zero-shot model has no use
# for
_DROP = ("tf_project", "sum_proj", "memory_project", "logit_scale_mt",
         "logit_bias_mt", "logit_scale_vm", "textual", "prompt")

# the last `main` call: per-fold weights, forwards and seconds
last_run = {}


def _collect_model_stats(model, params, loader_src, loader_tgt, mean, std,
                         batch_size: int, compute_dtype, attn_impl: str,
                         device):
    """(source logits, labels, target logits, labels) of one model; the
    last batch of each split is padded to `batch_size` with its last clip
    (one shape), the pad rows dropped."""

    @torch.no_grad()
    def logits_fn(video_u8):
        video = normalize_frames(video_u8, mean, std,
                                 compute_dtype=torch.float32)
        out = model.apply(params, model.buffers, video,
                          compute_dtype=compute_dtype, attn_impl=attn_impl)
        return out["logits"].float()

    def run(loader):
        logits_all, labels_all = [], []
        for batch in loader:
            video = batch["video"]
            n = video.shape[0]
            if n < batch_size:
                video = np.concatenate(
                    [video, np.repeat(video[-1:], batch_size - n, axis=0)])
            lg = logits_fn(torch.from_numpy(video).to(device))
            logits_all.append(lg.cpu().numpy()[:n])
            labels_all.append(np.asarray(batch["labels"])[:n])
            last_run["forwards"] += 1
        return np.concatenate(logits_all), np.concatenate(labels_all)

    src_logits, src_labels = run(loader_src)
    tgt_logits, tgt_labels = run(loader_tgt)
    return src_logits, src_labels, tgt_logits, tgt_labels


def main(argv=None):
    parser = build_train_parser()
    parser.add_argument("--model_dirs", nargs="+", required=True,
                        help="run directories (each with fold_*/fold-*-best)")
    parser.add_argument("--rcond", type=float, default=1e-1)
    parser.add_argument("--use_text_features", action="store_true",
                        help="aggregate text features instead of logits")
    args = parser.parse_args(argv)
    resolve_device(args.device)     # no card and no --device cpu: raise now

    classnames, cls_labels = parse_classes_file(args.text_prompt_classes_path)
    n_classes = len(cls_labels)
    mean, std = _mean_std(args)

    nfold = min(len(glob.glob(osp.join(d, "fold_*"))) for d in args.model_dirs)
    performance = []
    conf = np.zeros((n_classes, n_classes), np.int64)
    last_run.clear()
    last_run.update(weights=[], forwards=0)
    t0 = time.perf_counter()

    for nf in range(nfold):
        g_list, f_list, tf_list = [], [], []
        tgt_labels = None
        for d in args.model_dirs:
            ckpt_path = osp.join(d, f"fold_{nf}", f"fold-{nf}-best.ckpt")
            if not osp.isfile(ckpt_path):
                ckpt_path = osp.join(d, f"fold_{nf}", f"fold-{nf}-best.pth")
            ckpt = load_checkpoint(ckpt_path)
            tf = ckpt["text_features"]
            assert tf is not None

            margs = argparse.Namespace(**vars(args))
            cfg_yaml = osp.join(d, "config.yaml")
            if osp.isfile(cfg_yaml):
                # device and quantize_eval belong to this run, not to the
                # training run whose config is read (cli/evaluate.py)
                keep = [k for k in vars(margs)
                        if "data_root" in k or "list_path" in k
                        or "checkpoint" in k
                        or k in ("model_dirs", "device", "quantize_eval")]
                load_config_into(margs, cfg_yaml, skip=keep)
            margs.use_text_prompt_learning = False
            margs.zeroshot_evaluation = True
            margs.use_support_memory = False
            margs.add_nte = False
            device, compute_dtype, attn_impl = _run_settings(margs)
            model = build_model_from_args(margs, n_classes,
                                          zeroshot_text_features=tf,
                                          device=device)
            loaded = _loaded_params(ckpt, margs, n_classes, drop=_DROP)
            loaded = {k: v for k, v in loaded.items() if k in model.params}
            params = inference_params(merge_pytrees(model.params, loaded),
                                      margs, compute_dtype)

            lcfg = loader_config_from_args(margs)
            lcfg.val_list_path = osp.join(margs.data_root,
                                          f"train_{margs.type}.csv")
            src_loader = create_val_loader(lcfg)
            tgt_loader = create_val_loader(loader_config_from_args(margs))

            s_lg, s_lb, t_lg, t_lb = _collect_model_stats(
                model, params, src_loader, tgt_loader, mean, std,
                margs.batch_size, compute_dtype, attn_impl, device)
            _, f_scalar = source_fit_stats(s_lg, s_lb, n_classes)
            g_list.append(t_lg)
            f_list.append(f_scalar)
            tf_list.append(np.asarray(tf))
            tgt_labels = t_lb

        weights = aggregation_weights(g_list, f_list, rcond=args.rcond)
        last_run["weights"].append(weights)
        _log(f"fold {nf} aggregation weights: {weights}")

        if args.use_text_features:
            # the JAX program's branch as it stands: the weighted text
            # features are computed and the logits are scored (ROADMAP C)
            agg_tf = aggregate_text_features(weights, tf_list)
            agg_tf = agg_tf / np.linalg.norm(agg_tf, axis=-1, keepdims=True)
            scores = aggregate_logits(weights, g_list)
        else:
            scores = aggregate_logits(weights, g_list)
        preds = scores.argmax(-1)
        hit1 = int((preds == tgt_labels).sum())
        tot = len(tgt_labels)
        np.add.at(conf, (tgt_labels, preds), 1)
        perf = hit1 / tot
        performance.append(perf)
        _log(f"Fold {nf} accuracy: {perf:.4f}")

    last_run["seconds"] = time.perf_counter() - t0
    f1 = f1_from_confusion(conf.astype(np.float64))
    _log(f"Overall accuracy: {np.mean(performance) * 100:.2f}%  "
         f"macro-F1: {f1.mean():.4f}")
    return performance, conf


if __name__ == "__main__":
    main()
