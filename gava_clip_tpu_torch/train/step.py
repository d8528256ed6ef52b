"""Train / eval steps (port of gava_clip_tpu/train/step.py).

One function holds the full pipeline: vision tower + batched text tower +
heads + loss composition + gradients + AdamW update. PyTorch runs it
eagerly; there is no counterpart of `jax.jit` or of its `donate` flag (the
update is in place, so nothing is copied that donation would save).

Micro-batching (`batch_split`) is a loop over micro-batches whose
gradients accumulate in `.grad`: each micro-batch's loss is divided by
`batch_split`, which averages the gradients as the JAX `lax.scan` does.

`frozen_int8` (`--int8_frozen`) runs the frozen projection kernels of both
towers as 'qt' leaves (ops/quant.quantize_frozen_for_train): int8 forwards
through the w8a8 kernels, dx alone in the backward. The JAX step
requantizes the frozen tree inside every step; the loss here quantizes it
once and again only when a frozen leaf is replaced or written in place
(the same bits: the frozen leaves do not change).

Under a data axis (`mesh`, parallel/mesh.py; one process per card under
torch.distributed.run) each rank passes its rows of the global batch, and
the step computes what the JAX step computes over the whole global batch:
the NTE head over the gathered batch (models/vita_clip.apply), the
per-sample terms as means of equal-sized local means, the gradients
averaged over 'data' in one bucket before AdamW (`all_reduce_grads`, the
all-reduce XLA inserts), the metrics reduced likewise. With `batch_split`
each rank's rows must be those of `parallel.mesh.local_rows`, so that the
gathered micro-batch i is the JAX step's micro-batch i.

Under a frame axis each rank passes its frames of every clip
(`parallel.mesh.shard_batch`) and the step computes the JAX step on the
frame-sharded video: the vision tower's trainable leaves hold
per-frame partial gradients, which `all_reduce_grads` sums over 'frame'
before the mean over 'data'; the leaves behind the temporal mean hold the
whole gradient on every frame rank already. The metrics stay reduced over
'data' alone.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.device_preprocess import normalize_frames
from ..ops.int8_matmul import with_kernel_layout
from ..ops.quant import quantize_frozen_for_train
from ..parallel.mesh import all_reduce_grads, reduce_metrics
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


def quantize_frozen(frozen: Dict) -> Dict:
    """The frozen tree of a train state as `frozen_int8` runs it: 'qt'
    leaves, with the W^T copies the CUDA kernels read."""
    return with_kernel_layout(quantize_frozen_for_train(frozen))


class _QuantizedFrozen:
    """`quantize_frozen` of a frozen tree, made again only when one of its
    leaves was replaced or written in place (a leaf's version counter moves
    then, as under a checkpoint load)."""

    def __init__(self):
        self.key, self.leaves, self.tree = None, None, None

    def __call__(self, frozen: Dict) -> Dict:
        leaves = [t for t in tree_leaves(frozen) if t is not None]
        key = [(id(t), t._version) for t in leaves]
        if key != self.key:
            # the leaves are held, so no id is reused while the key stands
            self.key, self.leaves = key, leaves
            self.tree = quantize_frozen(frozen)
        return self.tree


def make_loss_fn(model, loss_cfg: LossConfig, compute_dtype=torch.float32,
                 attn_impl: str = "xla", remat="none",
                 frozen_int8: bool = False,
                 int8_impl: str = "kernel", mesh=None) -> Callable:
    """(trainable, frozen, batch) -> (loss, metrics): the differentiable
    core of make_train_step, exposed for tests and custom loops. With
    frozen_int8 the frozen tree is quantized at the first call and again
    only after one of its leaves changed (see the module docstring);
    int8_impl 'plain' runs the int8 ops' plain versions on any device.
    mesh: see `make_train_step` (the loss and metrics are this rank's)."""
    frozen_of = _QuantizedFrozen() if frozen_int8 else (lambda f: f)

    def loss_fn(trainable, frozen, batch):
        params = combine_params(trainable, frozen_of(frozen))
        outputs = model.apply(params, model.buffers, batch["video"],
                              memory=batch.get("memory"),
                              video_nte=batch.get("nte"),
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl, remat=remat,
                              int8_impl=int8_impl, mesh=mesh)
        return compute_losses(outputs, batch["labels"],
                              batch.get("mt_labels"), loss_cfg)

    return loss_fn


def make_train_step(model, loss_cfg: LossConfig, optimizer=None,
                    batch_split: int = 1, compute_dtype=torch.float32,
                    attn_impl: str = "xla", remat="none",
                    frozen_int8: bool = False, mesh=None) -> Callable:
    """Build the train step: (state, batch) -> (state, metrics).

    The optimizer lives in the state (`create_train_state`); the argument
    is kept so that a call reads like the JAX one. The step updates
    `state` in place and returns it. remat: False / 'none' | True /
    'full' | 'save_attn' | 'save_attn_qkv' | 'save_attn_mlp' | 'dots'
    (see models/vision.py `_block_remat`). frozen_int8: the frozen
    projections as int8 ('qt') leaves, quantized once (see the module
    docstring); the trainable leaves never pass through the quantizer.
    mesh: a `parallel.mesh.Mesh`; `batch` then holds this rank's rows (and,
    over 'frame', its frames; see the module docstring), the gradients and
    metrics are reduced over 'data', the vision tower's gradients summed
    over 'frame' first, and tensor-parallel shards run over 'model'.

    batch = {'video': (B,T,H,W,3), 'labels': (B,), 'nte': (B,70,E)?,
             'memory': (Bm,S,E)?, 'mt_labels': (Bm,)?}
    """
    loss_fn = make_loss_fn(model, loss_cfg, compute_dtype=compute_dtype,
                           attn_impl=attn_impl, remat=remat,
                           frozen_int8=frozen_int8, mesh=mesh)
    n_data = 1 if mesh is None else mesh.axis_size("data")

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
        if mesh is not None:
            all_reduce_grads(state.trainable, mesh)
            metrics = reduce_metrics(metrics, mesh)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics["acc1"] = metrics["hit1"] / (batch["labels"].shape[0]
                                             * n_data)
        return state, metrics

    return step


def make_eval_step(model, num_classes: int, compute_dtype=torch.float32,
                   attn_impl: str = "xla", mean=None, std=None,
                   num_views: int = 1, mesh=None) -> Callable:
    """Eval step: (params, video, labels[, valid]) -> (hit1, conf_mat (C,C)).

    The confusion matrix (rows = true class, cols = prediction) is built
    on the device. mean / std: when given, `video` is uint8 and is
    normalized in the step. num_views > 1: `video` is (B*V, ...)
    view-flattened and the per-view probabilities are averaged before the
    argmax. valid: optional (B,) bool mask excluding batch padding rows
    from both hit1 and the confusion matrix. mesh: tensor-parallel shards
    run over its 'model' axis; the step itself reduces nothing over 'data'
    (the evaluation loop sums its ranks' counts once, at its end)."""

    @torch.no_grad()
    def step(params, video, labels, valid=None):
        if mean is not None:
            video = normalize_frames(video, mean, std,
                                     compute_dtype=torch.float32)
        outputs = model.apply(params, model.buffers, video,
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl, mesh=mesh)
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
