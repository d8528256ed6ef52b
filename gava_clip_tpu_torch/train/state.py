"""Train state: trainable / frozen parameter partition + AdamW with a
cosine schedule (port of gava_clip_tpu/train/state.py).

The JAX package splits the parameter tree in two and hands only the
trainable half to `jax.grad` and optax. Here the same split decides
`requires_grad`: a frozen leaf has `requires_grad=False`, so autograd
computes dx through the frozen towers but no dW of a frozen GEMM, and the
optimizer holds state for trainable leaves only.

optax `adamw(cosine_decay_schedule)` is `torch.optim.AdamW` (b1 0.9, b2
0.999, eps 1e-8 outside the square root, decoupled weight decay on every
trainable leaf, scalars included) with a `LambdaLR` that gives update t
(counted from 0) the rate lr * 0.5 * (1 + cos(pi * min(t, T) / T)).
"""

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..utils.device import resolve_device


def _map2(fn, a, b):
    """fn over the leaves of two same-structure trees (dicts / lists)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def tree_leaves(tree) -> List:
    """Leaves in the tree's own order (None placeholders included)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def partition_params(params: Dict, mask: Dict) -> Tuple[Dict, Dict]:
    """Split a tree into (trainable, frozen) by a same-structure bool tree.
    Non-selected leaves become None placeholders."""
    return (_map2(lambda p, m: p if m else None, params, mask),
            _map2(lambda p, m: None if m else p, params, mask))


def combine_params(trainable: Dict, frozen: Dict) -> Dict:
    return _map2(lambda t, f: t if t is not None else f, trainable, frozen)


def cosine_lr(lr: float, num_steps: int) -> Callable[[int], float]:
    """Learning rate of update t (CosineAnnealingLR(T_max=num_steps),
    optax cosine_decay_schedule with alpha 0)."""
    def schedule(t: int) -> float:
        return lr * 0.5 * (1.0 + math.cos(math.pi * min(t, num_steps)
                                          / num_steps))
    return schedule


@dataclass(frozen=True)
class OptimizerConfig:
    """What `make_optimizer` returns: the optimizer is built when the train
    state is, because torch.optim needs the trainable leaves."""
    lr: float
    num_steps: int
    weight_decay: float = 0.2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def build(self, leaves: List[torch.Tensor]):
        opt = torch.optim.AdamW(leaves, lr=self.lr, betas=(self.b1, self.b2),
                                eps=self.eps, weight_decay=self.weight_decay)
        rate = cosine_lr(1.0, self.num_steps)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, rate)


def make_optimizer(lr: float, num_steps: int,
                   weight_decay: float = 0.2) -> OptimizerConfig:
    """AdamW + cosine schedule of the training loop: betas (0.9, 0.999),
    eps 1e-8, decoupled weight decay."""
    return OptimizerConfig(lr=lr, num_steps=num_steps,
                           weight_decay=weight_decay)


@dataclass
class TrainState:
    """step counts the updates taken; trainable / frozen are the two halves
    of the parameter tree (None placeholders in each); optimizer and
    scheduler hold AdamW's moments and the schedule's position. A train
    step updates the trainable leaves and the optimizer IN PLACE."""
    step: int
    trainable: Dict
    frozen: Dict
    optimizer: Any
    scheduler: Any

    @property
    def params(self) -> Dict:
        return combine_params(self.trainable, self.frozen)


def create_train_state(params: Dict, mask: Dict, optimizer: OptimizerConfig,
                       device=None) -> TrainState:
    """Place the parameters on `device` (None means the card) and split
    them. Trainable leaves are fp32 copies that require a gradient (the
    model's own tensors are left alone); frozen leaves are shared, detached
    and require none."""
    device = resolve_device(device)
    trainable, frozen = partition_params(params, mask)

    def own(t):
        return None if t is None else \
            t.detach().to(device).clone().requires_grad_(True)

    def share(t):
        return None if t is None else t.detach().to(device)

    trainable = _map2(lambda t, _: own(t), trainable, trainable)
    frozen = _map2(lambda t, _: share(t), frozen, frozen)
    leaves = [t for t in tree_leaves(trainable) if t is not None]
    opt, sched = optimizer.build(leaves)
    return TrainState(step=0, trainable=trainable, frozen=frozen,
                      optimizer=opt, scheduler=sched)
