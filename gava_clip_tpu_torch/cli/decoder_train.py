"""DeCap decoder training (port of gava_clip_tpu/cli/decoder_train.py, the
counterpart of the reference's training/decoder_train.py).

    python -m gava_clip_tpu_torch.cli.decoder_train --train_data BANK.pkl \
        [--device cpu] ...

Trains the GPT-2-style gait-caption decoder on the memory-bank pickle
(tokens + mean sentence embeddings): AdamW with optax.adamw's defaults
(weight decay 1e-4, eps 1e-8), a linear warm-up then linear decay whose
rate at the first update is 0 (optax.linear_schedule(0, lr, warmup) at
count 0), token CE (ignore 0, smoothing .1) + ordinal number loss, and the
best epoch's weights kept. One eager step (forward, loss, backward, AdamW
in place) on one device, the card unless `--device cpu`. The checkpoint is
the JAX package's: a pickle of {"params": numpy tree with the blocks
stacked, "config": the DecapConfig's fields}, so either package loads the
other's.
"""

import argparse
import os
import os.path as osp
import pickle
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..models.decap import DecapConfig, decap_loss, init_decap_params
from ..train.state import tree_leaves
from ..utils.device import resolve_device
from ..utils.jax_bridge import params_to_jax
from .train import _log

# step, loss, acc of every print of the last `train_decoder` call, and its
# seconds of training (the epochs' loops, host clock)
last_run = {"prints": [], "seconds": 0.0, "steps": 0}


class ClipGaitDataset:
    """tokens (N, 77) + unit-normalized mean sentence embeddings (N, 512)
    from the memory-bank pickle (decoder_train.py:32-118)."""

    def __init__(self, data_path: str):
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        self.tokens = np.asarray(data["tokens"], np.int32)
        embeds = np.asarray(data["embeds"], np.float32)
        if embeds.ndim == 3:
            embeds = embeds.mean(-2)
        self.embeds = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
        if len(self.tokens) != len(self.embeds):
            raise ValueError(f"{data_path}: {len(self.tokens)} token rows, "
                             f"{len(self.embeds)} embedding rows")

    def __len__(self):
        return len(self.tokens)


def linear_warmup_schedule(lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """The rate of update `count` (0 first): 0 -> lr over warmup_steps,
    then lr -> 0 over the rest, held at the ends — optax.join_schedules of
    two optax.linear_schedule."""
    decay = max(total_steps - warmup_steps, 1)

    def rate(count: int) -> float:
        if count < warmup_steps:
            return lr * count / warmup_steps
        return lr * (1.0 - min(count - warmup_steps, decay) / decay)
    return rate


def make_optimizer(params: Dict, lr: float, warmup_steps: int,
                   total_steps: int):
    """(AdamW, LambdaLR) over every leaf of `params`, with optax.adamw's
    defaults; the schedule's factor of update k is rate(k) / lr."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    rate = linear_warmup_schedule(lr, warmup_steps, total_steps)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: rate(count) / lr if lr else 0.0)
    return opt, sched


def make_train_step(params: Dict, cfg: DecapConfig, opt, sched):
    """step(embeds (B, P), tokens (B, L)) on the params' device: loss,
    backward, one AdamW update at the schedule's rate. Returns (loss,
    metrics) as tensors (no synchronisation)."""
    def step(embeds: torch.Tensor, tokens: torch.Tensor):
        opt.zero_grad(set_to_none=True)
        loss, metrics = decap_loss(params, embeds, tokens, cfg)
        loss.backward()
        opt.step()
        sched.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}
    return step


def save_decap(path: str, params: Dict, cfg: DecapConfig) -> str:
    with open(path, "wb") as f:
        pickle.dump({"params": params_to_jax(params),
                     "config": dict(cfg.__dict__)}, f)
    return path


def train_decoder(args) -> str:
    device = resolve_device(getattr(args, "device", None))
    cfg = DecapConfig(prefix_size=args.prefix_size,
                      vocab_size=args.vocab_size + 500,
                      base_vocab=args.vocab_size)
    params = init_decap_params(torch.Generator().manual_seed(42), cfg,
                               device=device)

    train_ds = ClipGaitDataset(args.train_data)
    val_ds = ClipGaitDataset(args.valid_data) if args.valid_data else None

    steps_per_epoch = len(train_ds) // args.bs
    total_steps = args.epochs * steps_per_epoch
    opt, sched = make_optimizer(params, args.lr, args.warmup_steps,
                                total_steps)
    train_step = make_train_step(params, cfg, opt, sched)

    def batch(ds, idx):
        return (torch.from_numpy(ds.embeds[idx]).to(device),
                torch.from_numpy(ds.tokens[idx]).to(device))

    os.makedirs(args.output_dir, exist_ok=True)
    best_acc = 0.0
    best_path = osp.join(args.output_dir, "decap-best.ckpt")
    rs = np.random.RandomState(42)
    step = 0
    last_run.update(prints=[], seconds=0.0, steps=0)
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        order = rs.permutation(len(train_ds))
        accs = []
        for i in range(steps_per_epoch):
            idx = order[i * args.bs:(i + 1) * args.bs]
            loss, metrics = train_step(*batch(train_ds, idx))
            accs.append(metrics["acc"])
            step += 1
            if step % args.print_freq == 0:
                loss_v, acc_v = float(loss), float(metrics["acc"])
                last_run["prints"].append((step, loss_v, acc_v))
                _log(f"epoch {epoch} step {step} loss {loss_v:.4f} "
                     f"acc {acc_v:.4f}")
        epoch_acc = float(torch.stack(accs).mean()) if accs else 0.0
        if val_ds is not None:
            v_accs = []
            with torch.no_grad():
                for i in range(0, len(val_ds) - args.bs + 1, args.bs):
                    idx = np.arange(i, i + args.bs)
                    v_accs.append(float(decap_loss(
                        params, *batch(val_ds, idx), cfg)[1]["acc"]))
            epoch_acc = float(np.mean(v_accs)) if v_accs else epoch_acc
        _log(f"epoch {epoch}: acc {epoch_acc:.4f}")
        if epoch_acc >= best_acc:
            best_acc = epoch_acc
            save_decap(best_path, params, cfg)
    last_run.update(seconds=time.perf_counter() - t0, steps=step)
    return best_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_data", type=str, required=True)
    parser.add_argument("--valid_data", type=str, default="")
    parser.add_argument("--output_dir", type=str, default="./decap/ckpt")
    parser.add_argument("--bs", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--warmup_steps", type=int, default=1000)
    parser.add_argument("--vocab_size", type=int, default=49408)
    parser.add_argument("--prefix_size", type=int, default=512)
    parser.add_argument("--print_freq", type=int, default=50)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    resolve_device(args.device)     # no card and no --device cpu: raise now
    return train_decoder(args)


if __name__ == "__main__":
    main()
