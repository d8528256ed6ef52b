"""Training program (port of gava_clip_tpu/cli/train.py, the counterpart of
the reference's training/train.py).

    python -m gava_clip_tpu_torch.cli.train [--device cpu] <flags>

Reproduces its behaviour: class count from '*' lines, per-fold
leave-one-subject-out loop with data-root remapping, AdamW + cosine
schedule, loss composition (CE x focal-ordinal + memory + NTE), periodic
evaluation with confusion-matrix macro-F1 best-model selection, checkpoints
carrying text_features, per-fold and aggregate reports (results.txt,
confusion matrices), config.yaml dump.

Execution: one eager train step (forward + losses + backward + AdamW, in
place) on one device, the card unless `--device cpu`, in fp32 or with
`--use_bf16` in bf16, the attention through the kernels of that dtype;
uint8 frames are normalized on the device; the host-to-device copy of the
next batch runs on a side CUDA stream. `--int8_frozen` runs the frozen
projections of both towers as int8 GEMMs through the w8a8 kernels, whose
fp32 or bf16 form follows the run's dtype
(`train.step.make_train_step(frozen_int8=True)`). Data parallelism
over several cards is not ported yet (ROADMAP A9, second half).
"""

import json
import os
import os.path as osp
import signal
import time
from datetime import datetime
from typing import List, Optional

import numpy as np
import torch

from ..data.device_prefetch import PinnedBatchCopier, prefetch_to_device
from ..data.device_preprocess import (make_train_augment, normalize_frames,
                                      step_generator)
from ..data.loader import (LoaderConfig, create_memory_loader,
                           create_train_loader, create_val_loader)
from ..data.video import parse_classes_file
from ..models.factory import build_model_from_args
from ..models.vita_clip import trainable_mask
from ..ops import flash_attention as _fa
from ..train import checkpoint as ckpt_lib
from ..train.metrics import (StepAnomalyDetector, f1_from_confusion,
                             summary_from_confusion)
from ..train.state import create_train_state, make_optimizer
from ..train.step import LossConfig, make_eval_step, make_train_step
from ..utils.config import (build_train_parser, remap_fold_data_root,
                            save_config)
from ..utils.device import resolve_device


def _log(msg: str):
    print(f"[{datetime.now().time()}] {msg}", flush=True)


def loader_config_from_args(args) -> LoaderConfig:
    return LoaderConfig(
        train_list_path=args.train_list_path, val_list_path=args.val_list_path,
        eval_list_path=args.eval_list_path, data_root=args.data_root,
        train_data_root=args.train_data_root, val_data_root=args.val_data_root,
        eval_data_root=args.eval_data_root, batch_size=args.batch_size,
        num_frames=args.num_frames, sampling_rate=args.sampling_rate,
        tsn_sampling=args.tsn_sampling, spatial_size=args.spatial_size,
        num_spatial_views=args.num_spatial_views,
        num_temporal_views=args.num_temporal_views,
        mean=args.mean, std=args.std, auto_augment=args.auto_augment,
        mirror=args.mirror, use_support_memory=args.use_support_memory,
        memory_data_path=args.memory_data_path,
        mem_batch_size=args.mem_batch_size, for_zero_shot=args.for_zero_shot,
        num_workers=args.num_workers, dummy_dataset=args.dummy_dataset,
        add_nte=args.add_nte, num_steps=args.num_steps or 0,
        type=args.type, nfold=args.nfold, embed_dim=args.embed_dim,
        eval_all_views=getattr(args, 'eval_all_views', False),
        allow_seek=getattr(args, 'allow_seek', True),
        cache_dir=getattr(args, 'decoded_cache_dir', '') or '')


def _mean_std(args):
    def norm3(v, default):
        if v is None:
            return (default,) * 3
        return tuple(v * 3) if len(v) == 1 else tuple(v)
    return norm3(args.mean, 0.45), norm3(args.std, 0.225)


def _run_settings(args):
    """(device, compute dtype, attention implementation) of a run: the
    attention kernels on the card, the plain attention on the host."""
    device = resolve_device(getattr(args, "device", None))
    compute_dtype = torch.bfloat16 if getattr(args, "bf16", False) \
        else torch.float32
    return device, compute_dtype, "flash" if device.type == "cuda" else "xla"


# seconds and clips of the last `evaluate` call
last_eval = {"seconds": 0.0, "clips": 0}


def evaluate(model, params, loader, num_classes: int, mean, std,
             compute_dtype, batch_size: int, attn_impl: str = "xla",
             device=None) -> tuple:
    """Evaluation loop through the confusion-matrix step (train/step.py).

    Batches are padded to `batch_size` (one shape); pad rows are excluded
    through the step's valid mask. The copy to the device runs on the
    prefetch thread (batch k+1 while the device evaluates batch k), and
    both the hit count and the confusion matrix accumulate ON THE DEVICE: a
    per-batch fetch would drain the queue at every step. One fetch per 50
    batches reports progress."""
    device = torch.device("cpu") if device is None else torch.device(device)
    copier = PinnedBatchCopier(device)

    def _to_device(batch):
        video = np.asarray(batch["video"])
        labels = np.asarray(batch["labels"], np.int32)
        n = video.shape[0]
        if n < batch_size:
            video = np.concatenate(
                [video, np.repeat(video[-1:], batch_size - n, axis=0)])
            labels = np.concatenate(
                [labels, np.zeros(batch_size - n, np.int32)])
        valid = np.arange(batch_size) < n
        if video.ndim == 6:  # multi-view eval: flatten views for the step
            B, V = video.shape[:2]
            video = video.reshape((B * V,) + video.shape[2:])
        else:
            V = 1
        dev = copier({"video": video, "labels": labels.astype(np.int64),
                      "valid": valid})
        return dev, n, V

    steps = {}
    conf_dev = hit_dev = None
    tot = n_batches = 0
    t0 = time.perf_counter()
    for dev, n, V in prefetch_to_device(iter(loader), _to_device, size=2,
                                        device=device):
        if V not in steps:
            steps[V] = make_eval_step(model, num_classes,
                                      compute_dtype=compute_dtype,
                                      attn_impl=attn_impl, mean=mean, std=std,
                                      num_views=V)
        h, c = steps[V](params, dev["video"], dev["labels"], dev["valid"])
        conf_dev = c if conf_dev is None else conf_dev + c
        hit_dev = h if hit_dev is None else hit_dev + h
        tot += n
        n_batches += 1
        if n_batches % 50 == 0:  # rare: each fetch drains the queue
            _log(f"[Evaluation] num_samples: {tot}  "
                 f"cumulative_acc1: {int(hit_dev) / tot * 100.:.2f}%")
    conf = (conf_dev.cpu().numpy().astype(np.int64) if conf_dev is not None
            else np.zeros((num_classes, num_classes), np.int64))
    hit1 = int(hit_dev) if hit_dev is not None else 0
    last_eval.update(seconds=time.perf_counter() - t0, clips=tot)
    acc = hit1 / max(tot, 1) * 100
    _log(f"Accuracy on validation set: top1={acc:.2f}%")
    return acc, conf


def train_one_fold(args, fold: int, classnames: List[str], num_classes: int,
                   logdir: Optional[str]) -> tuple:
    device, compute_dtype, attn_impl = _run_settings(args)
    if getattr(args, "debug_attn_clamp", False):
        _fa.enable_clamp_monitor(True)
    # rematerialize the vision blocks for long clips (the 70-frame recipe);
    # short clips keep their activations
    remat = getattr(args, "remat_policy", "save_attn_qkv") \
        if args.num_frames >= 16 else False
    mean, std = _mean_std(args)

    model = build_model_from_args(args, num_classes, classnames=classnames,
                                  device=device)
    mask = trainable_mask(model.params, model.cfg)
    optimizer = make_optimizer(args.lr, args.num_steps, args.weight_decay)
    state = create_train_state(model.params, mask, optimizer, device=device)

    state, resume_step, _ = ckpt_lib.resume_from_checkpoint(state, mask, args)

    lcfg = loader_config_from_args(args)
    val_loader = create_val_loader(lcfg)
    train_loader = create_train_loader(lcfg, resume_step=resume_step)
    memory_loader = create_memory_loader(lcfg, resume_step=resume_step)

    loss_cfg = LossConfig(
        num_classes=num_classes,
        focal_ordinal=args.focal_ordinal_loss,
        fo_beta=0.2 if "updrs" in args.type else 0.0,
        sigmoid_loss=args.sigmoid_loss,
        use_support_memory=args.use_support_memory,
        add_nte=args.add_nte,
        memory_loss_weight=args.memory_loss_weight,
        vnte_loss_weight=args.vnte_loss_weight)

    step_fn = make_train_step(model, loss_cfg, optimizer,
                              batch_split=args.batch_split,
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl, remat=remat,
                              frozen_int8=getattr(args, "int8_frozen", False))

    def text_features_fn(params):
        with torch.no_grad():
            return model.text_features_only(
                params, model.buffers,
                compute_dtype=compute_dtype).cpu().numpy()

    writer = None
    metrics_jsonl = None
    if logdir:
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(log_dir=osp.join(logdir, f"fold_{fold}"))
        except ImportError:
            pass
        args.checkpoint_dir = osp.join(logdir, f"fold_{fold}")
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        metrics_jsonl = osp.join(args.checkpoint_dir, "metrics.jsonl")

    best_perf, best_acc = 0.0, 0.0
    save_conf = np.zeros((num_classes, num_classes), np.int64)
    anomaly = StepAnomalyDetector()
    batch_st = time.time()

    # device-side augmentation (mirror) when requested, plain normalize
    # otherwise; the draws of step i depend on i alone, so a resumed run
    # repeats them
    use_aug = bool(args.auto_augment) or args.mirror
    augment = make_train_augment(args.auto_augment, args.mirror, mean, std) \
        if use_aug else None

    # preemption-safe checkpointing: a preemptible machine gets SIGTERM with
    # a grace window; catch it, finish the step in flight, write a resumable
    # checkpoint (the resume-exact sampler continues bit-identically) and
    # exit cleanly. The flag-and-check form keeps the signal handler trivial
    # and the save on the main thread.
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:          # not the main thread (tests run this inline)
        prev_handler = None

    # the copy of batch N+1 (uint8 video + labels / nte / memory) runs on
    # the prefetch thread and a side stream while the device executes step
    # N. The augmentation stays in the main loop: it is indexed by the step.
    copier = PinnedBatchCopier(device)

    def _to_device(pair):
        batch, mem_batch = pair
        host = {"video": batch["video"],
                "labels": np.asarray(batch["labels"], np.int64)}
        if args.add_nte:
            host["nte"] = batch["nte"]
        if args.use_support_memory:
            host["memory"] = mem_batch["memory"]
            host["mt_labels"] = np.asarray(mem_batch["mt_labels"], np.int64)
        return copier(host)

    pair_iter = zip(train_loader, memory_loader)
    n_prefetch = getattr(args, "device_prefetch", 2)
    if n_prefetch and n_prefetch > 0:
        device_iter = prefetch_to_device(pair_iter, _to_device,
                                         size=n_prefetch, device=device)
    else:
        device_iter = map(_to_device, pair_iter)

    profiler = None
    for i, db in enumerate(device_iter, start=resume_step):
        if preempted["flag"]:
            _log(f"[preempt] SIGTERM received: checkpointing at step {i} "
                 "and exiting")
            tf = text_features_fn(state.params) \
                if args.use_text_prompt_learning else None
            ckpt_lib.save_checkpoint(args.checkpoint_dir, state, i,
                                     text_features=tf)
            ckpt_lib.wait_for_saves()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            close = getattr(device_iter, "close", None)
            if close is not None:   # join the prefetch thread before exit
                close()
            raise SystemExit(0)
        if augment is not None:
            video = augment(step_generator(0, i), db["video"])
        else:
            video = normalize_frames(db["video"], mean, std)
        device_batch = dict(db)
        device_batch["video"] = video
        data_ed = time.time()

        if args.profile_dir and i == resume_step + 2:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        state, metrics = step_fn(state, device_batch)
        if profiler is not None and i == resume_step + 4:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                osp.join(args.profile_dir, f"trace_fold_{fold}.json"))
            profiler = None
            _log(f"profiler trace written to {args.profile_dir}")

        if i % args.print_freq == 0:
            loss_v = float(metrics["loss"])      # waits for the step
            acc1 = float(metrics["acc1"])
            batch_ed = time.time()
            slow = anomaly.check_step_time(batch_ed - batch_st)
            if slow:
                _log(f"[anomaly] {slow}")
            if not anomaly.check_loss(loss_v):
                _log(f"[anomaly] non-finite loss at step {i}")
                if getattr(args, "nan_recovery", False):
                    try:
                        # the rollback target may still be in flight
                        ckpt_lib.wait_for_saves()
                    except Exception as e:
                        # a stale write failure (a full disk, say) must not
                        # abort the recovery itself: log and roll back to
                        # whatever checkpoint did land
                        _log(f"[anomaly] async checkpoint write failed: "
                             f"{e!r}")
                    rollback = ckpt_lib.find_autoresume_path(
                        args.checkpoint_dir)
                    if rollback:
                        ck = ckpt_lib.load_checkpoint(rollback)
                        ckpt_lib.load_params_into(state, ck["params"])
                        _log(f"[anomaly] rolled back weights to {rollback}")
            txt = (f"step {i}  batch_time: {batch_ed - batch_st:.3f}  "
                   f"data_time: {data_ed - batch_st:.3f}  "
                   f"loss: {loss_v:.6f}  acc1: {acc1 * 100:.2f}%")
            if getattr(args, "debug_attn_clamp", False):
                m = _fa.read_clamp_stats()["max_exp2_arg"]
                txt += f"  attn_max_exp2_arg: {m:.1f}"
                if m >= 0.8 * _fa._CLAMP:
                    _log(f"[anomaly] attention logits at {m:.1f} approaching "
                         f"the exp2 clamp ({_fa._CLAMP}): the softmax will "
                         "flatten silently past it")
            if "loss_mt" in metrics:
                txt += f"  loss_mt: {float(metrics['loss_mt']):.6f}"
            if "loss_vm" in metrics:
                txt += f"  loss_vm: {float(metrics['loss_vm']):.6f}"
            _log(txt)
            if writer is not None:
                writer.add_scalar("train/accuracy", acc1, i + 1)
                writer.add_scalar("train/loss", loss_v, i + 1)
            if metrics_jsonl:
                # "t" (wall clock) lets offline tools compute the SUSTAINED
                # rate between print steps: batch_time_s alone only times
                # the print step itself, which pays the device sync for the
                # whole queued window
                rec = {"step": i, "loss": loss_v, "acc1": acc1,
                       "t": round(batch_ed, 3),
                       "batch_time_s": round(batch_ed - batch_st, 4),
                       "data_time_s": round(data_ed - batch_st, 4)}
                for k in ("loss_mt", "loss_vm"):
                    if k in metrics:
                        rec[k] = float(metrics[k])
                with open(metrics_jsonl, "a") as mf:
                    mf.write(json.dumps(rec) + "\n")

        if (i + 1) % args.eval_freq == 0:
            _log(f"Start model evaluation at step {i + 1}")
            params = state.params
            eval_acc, conf = evaluate(model, params, val_loader, num_classes,
                                      mean, std, compute_dtype,
                                      args.batch_size, attn_impl=attn_impl,
                                      device=device)
            eval_perf = float(f1_from_confusion(conf).mean())
            if writer is not None:
                writer.add_scalar("test/accuracy", eval_acc, i + 1)
            if metrics_jsonl:
                with open(metrics_jsonl, "a") as mf:
                    mf.write(json.dumps({"step": i + 1, "eval_acc": eval_acc,
                                         "eval_macro_f1": eval_perf,
                                         "t": round(time.time(), 3)}) + "\n")
            if eval_perf >= best_perf:
                best_perf, best_acc = eval_perf, eval_acc
                save_conf = conf
                tf = text_features_fn(params) \
                    if args.use_text_prompt_learning else None
                ckpt_lib.save_checkpoint(args.checkpoint_dir, state, i + 1,
                                         text_features=tf, is_best=True,
                                         name=f"fold-{fold}",
                                         async_write=True)

        if (i + 1) % args.save_freq == 0:
            tf = text_features_fn(state.params) \
                if args.use_text_prompt_learning else None
            # the fetch to the host is synchronous (the step updates the
            # state in place); the pickle + disk write overlaps the next
            # steps
            ckpt_lib.save_checkpoint(args.checkpoint_dir, state, i + 1,
                                     text_features=tf, async_write=True)
        batch_st = time.time()

    ckpt_lib.wait_for_saves()   # fold end: all checkpoints on disk
    if prev_handler is not None:
        signal.signal(signal.SIGTERM, prev_handler)
    if writer is not None:
        writer.close()
    return best_acc, save_conf


def _loaded_params(ckpt, args, num_classes, drop=(), drop_names=None):
    """A checkpoint's weights as an overlay for `merge_pytrees`: the
    `params` tree of a .ckpt without its top-level entries in `drop`, or a
    reference .pth converted, without the state-dict names that contain one
    of `drop_names` (default: `drop`)."""
    if "torch_state_dict" in ckpt:
        from ..utils.torch_convert import convert_vita_clip
        names = drop if drop_names is None else drop_names
        sd = {k: v for k, v in ckpt["torch_state_dict"].items()
              if not any(d in k for d in names)}
        variant = "class_uni" if args.text_prompt_init else None
        return convert_vita_clip(sd, vision_layers=args.num_layers,
                                 text_layers=args.text_transformer_layers,
                                 num_classes=num_classes,
                                 prompt_variant=variant)
    return {k: v for k, v in ckpt["params"].items() if k not in drop}


def eval_only_fold(args, fold: int, classnames: List[str], num_classes: int):
    """--eval_only: load the fold's best checkpoint into the full model and
    evaluate on the val split."""
    from ..utils.torch_convert import merge_pytrees
    device, compute_dtype, attn_impl = _run_settings(args)
    mean, std = _mean_std(args)

    ckpt_path = args.checkpoint_path
    if not ckpt_path or not osp.isfile(ckpt_path):
        for base in (args.checkpoint_dir or "",
                     osp.join(args.checkpoint_dir or "", f"fold_{fold}")):
            for ext in (".ckpt", ".pth"):
                p = osp.join(base, f"fold-{fold}-best{ext}")
                if osp.isfile(p):
                    ckpt_path = p
                    break
            if ckpt_path and osp.isfile(ckpt_path):
                break
    assert ckpt_path and osp.isfile(ckpt_path), "Checkpoint file not found."
    _log(f"eval_only: loading {ckpt_path}")

    model = build_model_from_args(args, num_classes, classnames=classnames,
                                  device=device)
    ckpt = ckpt_lib.load_checkpoint(ckpt_path)
    params = merge_pytrees(model.params,
                           _loaded_params(ckpt, args, num_classes))

    lcfg = loader_config_from_args(args)
    val_loader = create_val_loader(lcfg)
    acc, conf = evaluate(model, params, val_loader, num_classes, mean, std,
                         compute_dtype, args.batch_size, attn_impl=attn_impl,
                         device=device)
    return acc, conf


def main(argv=None):
    parser = build_train_parser()
    args = parser.parse_args(argv)
    resolve_device(args.device)     # no card and no --device cpu: raise now

    classnames, cls_labels = parse_classes_file(args.text_prompt_classes_path)
    num_classes = len(cls_labels)

    logdir = None
    all_conf = np.zeros((num_classes, num_classes), np.int64)
    performances = []
    if not args.eval_only:
        root_tag = osp.basename(args.data_root.rstrip("/")) \
            if args.data_root else ""
        postfix = ("_" + root_tag + "_") if root_tag else ""
        if args.text_prompt_init:
            postfix += args.text_prompt_init.replace("_", "-") + "_" + \
                "-".join(args.knowledge_version)
        postfix += "_NTE" if args.use_support_memory else ""
        postfix += "_clL" if args.add_nte else ""
        if postfix and postfix[0] != "_":
            postfix = "_" + postfix
        logdir = (f"./logs/{args.type.lower()}"
                  f"{'-zs' if args.for_zero_shot else ''}_"
                  f"{time.strftime('%m%d-%H%M')}{postfix}/")
        os.makedirs(logdir, exist_ok=True)
        save_config(args, osp.join(logdir, "config.yaml"))
        result_file = osp.join(logdir, "results.txt")

    for n in range(args.nfold):
        if args.eval_only:
            best_acc, conf = eval_only_fold(args, n, classnames, num_classes)
        else:
            remap_fold_data_root(args, n)
            best_acc, conf = train_one_fold(args, n, classnames, num_classes,
                                            logdir)
        performances.append(best_acc)
        all_conf += conf
        if logdir:
            np.savetxt(osp.join(logdir, f"confusion_matrix_fold-{n}.txt"),
                       conf, fmt="%d")
            with open(result_file, "w") as f:
                f.write(" ".join(f"fold-{i} {x}"
                                 for i, x in enumerate(performances)))

    if args.eval_only:
        # aggregate eval report
        os.makedirs("./eval_output", exist_ok=True)
        tag = f"{args.type.split('_')[0]}_eval"
        avg = float(np.mean(performances)) if performances else 0.0
        _log(f"Eval top-1 accuracy: {avg:.4f}%")
        with open(osp.join("./eval_output", f"{tag}.txt"), "w") as f:
            f.write("  ".join(f"fold-{fi} {x}"
                              for fi, x in enumerate(performances)) + "\n")
            f.write(f"Eval top-1 accuracy: {avg:.4f}%.\n")
            f.write("Confusion matrix:\n")
            for row in all_conf:
                f.write(" ".join(str(int(x)) for x in row) + "\n")
        return performances, all_conf

    if logdir:
        s = summary_from_confusion(all_conf)
        min_max = (max(performances) - min(performances)) \
            if performances else 0.0
        with open(result_file, "a") as f:
            f.write(f"\nTotal average accuracy for {args.nfold}-fold "
                    f"{args.type}: {np.mean(performances):.4f}")
            f.write("\nF1-score per class: " +
                    " ".join(f"{x:.4f}" for x in s["f1_per_class"]))
            f.write(f"\nPrecision: {s['precision']:.4f}")
            f.write(f"\nRecall: {s['recall']:.4f}")
            f.write(f"\nAverage F1-score: {s['f1_mean']:.4f}")
            f.write("\nWeighted F1-score per class: " +
                    " ".join(f"{x:.4f}" for x in s["wf1_per_class"]))
            f.write(f"\nAverage weighted F1-score: {s['wf1_sum']:.4f}")
            f.write(f"\nMin-Max difference: {min_max:.4f}")
        np.savetxt(osp.join(logdir, "confusion_matrix_total.txt"),
                   all_conf, fmt="%d")
        _save_heatmap(all_conf, osp.join(logdir, "confusion_matrix_total.png"),
                      annot=True, labels=True)
        _log(f"Total average accuracy: {np.mean(performances):.4f}")


def _save_heatmap(conf, path: str, annot: bool, labels: bool = False):
    """Confusion-matrix heatmap where matplotlib and seaborn are installed
    (both optional)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError:
        return
    plt.figure(figsize=(10, 10))
    sns.heatmap(conf.astype(int), annot=annot, fmt="d", cmap="Blues",
                cbar=True)
    if labels:
        plt.xlabel("prediction")
        plt.ylabel("ground truth")
    plt.savefig(path)
    plt.close()


if __name__ == "__main__":
    main()
