"""Train / eval steps (port of gava_clip_tpu/train/step.py).

One function holds the full pipeline: vision tower + batched text tower +
heads + loss composition + gradients + AdamW update. PyTorch runs it
eagerly; there is no counterpart of `jax.jit` or of its `donate` flag (the
update is in place, so nothing is copied that donation would save).

Micro-batching (`batch_split`) is a loop over micro-batches whose
gradients accumulate in `.grad`: each micro-batch's loss is divided by
`batch_split`, which averages the gradients as the JAX `lax.scan` does.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.device_preprocess import normalize_frames
from .losses import cross_entropy, focal_ordinal_weight, sigmoid_focal_loss
from .state import TrainState, combine_params, tree_leaves


@dataclass(frozen=True)
class LossConfig:
    num_classes: int
    focal_ordinal: bool = False
    fo_beta: float = 0.2               # 0.2 for updrs tasks, 0 otherwise
    sigmoid_loss: bool = False
    use_support_memory: bool = False
    add_nte: bool = False
    memory_loss_weight: float = 0.1
    vnte_loss_weight: float = 0.05


def compute_losses(outputs: Dict, labels: torch.Tensor,
                   mt_labels: Optional[torch.Tensor],
                   cfg: LossConfig) -> Tuple[torch.Tensor, Dict]:
    """Loss composition of the training loop. Returns (total, metrics);
    the metrics are detached."""
    logits = outputs["logits"]
    loss = cross_entropy(logits, labels)
    if cfg.focal_ordinal:
        loss = loss * focal_ordinal_weight(logits, labels, gamma=2.0,
                                           alpha=0.25, beta=cfg.fo_beta)
    loss = loss.mean()
    total = loss
    metrics = {"loss": loss}

    if cfg.use_support_memory and "logits_mt" in outputs:
        if cfg.sigmoid_loss:
            # NB: the original applies memory_loss_weight twice in this
            # branch (inside the criterion AND outside); reproduced
            loss_mt = cfg.memory_loss_weight * sigmoid_focal_loss(
                outputs["logits_mt"], mt_labels, use_focal=False,
                scale=cfg.memory_loss_weight).mean()
        else:
            loss_mt = cfg.memory_loss_weight * cross_entropy(
                outputs["logits_mt"], mt_labels).mean()
        total = total + loss_mt
        metrics["loss_mt"] = loss_mt

    if cfg.add_nte and "logits_vm" in outputs:
        loss_vm = -cfg.vnte_loss_weight * \
            torch.diagonal(outputs["logits_vm"]).mean()
        total = total + loss_vm
        metrics["loss_vm"] = loss_vm

    metrics["hit1"] = (logits.argmax(dim=-1) == labels).sum()
    metrics["total"] = total
    return total, {k: v.detach() for k, v in metrics.items()}


def make_loss_fn(model, loss_cfg: LossConfig, compute_dtype=torch.float32,
                 attn_impl: str = "xla", remat="none",
                 frozen_int8: bool = False) -> Callable:
    """(trainable, frozen, batch) -> (loss, metrics): the differentiable
    core of make_train_step, exposed for tests and custom loops."""
    if frozen_int8:
        raise NotImplementedError(
            "frozen_int8: int8 forwards of the frozen GEMMs ('qt' leaves) "
            "come with the int8 training slice (ROADMAP A9)")

    def loss_fn(trainable, frozen, batch):
        params = combine_params(trainable, frozen)
        outputs = model.apply(params, model.buffers, batch["video"],
                              memory=batch.get("memory"),
                              video_nte=batch.get("nte"),
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl, remat=remat)
        return compute_losses(outputs, batch["labels"],
                              batch.get("mt_labels"), loss_cfg)

    return loss_fn


def make_train_step(model, loss_cfg: LossConfig, optimizer=None,
                    batch_split: int = 1, compute_dtype=torch.float32,
                    attn_impl: str = "xla", remat="none",
                    frozen_int8: bool = False) -> Callable:
    """Build the train step: (state, batch) -> (state, metrics).

    The optimizer lives in the state (`create_train_state`); the argument
    is kept so that a call reads like the JAX one. The step updates
    `state` in place and returns it. remat: False / 'none' | True /
    'full' | 'save_attn' | 'save_attn_qkv' | 'save_attn_mlp' | 'dots'
    (see models/vision.py `_block_remat`).

    batch = {'video': (B,T,H,W,3), 'labels': (B,), 'nte': (B,70,E)?,
             'memory': (Bm,S,E)?, 'mt_labels': (Bm,)?}
    """
    loss_fn = make_loss_fn(model, loss_cfg, compute_dtype=compute_dtype,
                           attn_impl=attn_impl, remat=remat,
                           frozen_int8=frozen_int8)

    def split(x):
        return x.reshape(batch_split, x.shape[0] // batch_split,
                         *x.shape[1:])

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        state.optimizer.zero_grad(set_to_none=True)
        if batch_split == 1:
            total, metrics = loss_fn(state.trainable, state.frozen, batch)
            total.backward()
        else:
            micro = {k: split(v) for k, v in batch.items()}
            metrics: Dict = {}
            for i in range(batch_split):
                mb = {k: v[i] for k, v in micro.items()}
                total, m = loss_fn(state.trainable, state.frozen, mb)
                (total / batch_split).backward()
                for k, v in m.items():
                    metrics[k] = metrics[k] + v if k in metrics else v
            for k in metrics:
                if k != "hit1":
                    metrics[k] = metrics[k] / batch_split
        # a trainable leaf that the loss did not reach still gets its
        # weight decay, as optax gives a zero gradient its update
        for p in tree_leaves(state.trainable):
            if p is not None and p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics["acc1"] = metrics["hit1"] / batch["labels"].shape[0]
        return state, metrics

    return step


def make_eval_step(model, num_classes: int, compute_dtype=torch.float32,
                   attn_impl: str = "xla", mean=None, std=None,
                   num_views: int = 1) -> Callable:
    """Eval step: (params, video, labels[, valid]) -> (hit1, conf_mat (C,C)).

    The confusion matrix (rows = true class, cols = prediction) is built
    on the device. mean / std: when given, `video` is uint8 and is
    normalized in the step. num_views > 1: `video` is (B*V, ...)
    view-flattened and the per-view probabilities are averaged before the
    argmax. valid: optional (B,) bool mask excluding batch padding rows
    from both hit1 and the confusion matrix."""

    @torch.no_grad()
    def step(params, video, labels, valid=None):
        if mean is not None:
            video = normalize_frames(video, mean, std,
                                     compute_dtype=torch.float32)
        outputs = model.apply(params, model.buffers, video,
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl)
        probs = torch.softmax(outputs["logits"], dim=-1)
        if num_views > 1:
            probs = probs.reshape(labels.shape[0], num_views, -1).mean(dim=1)
        preds = probs.argmax(dim=-1)
        w = torch.ones_like(labels, dtype=torch.float32) if valid is None \
            else valid.float()
        onehot_t = F.one_hot(labels.long(), num_classes).float() * w[:, None]
        onehot_p = F.one_hot(preds, num_classes).float()
        conf = torch.einsum("bi,bj->ij", onehot_t, onehot_p)
        hit1 = ((preds == labels).float() * w).sum()
        return hit1, conf

    return step
