"""Pipeline parallelism (GPipe) over a stack of identical blocks (port of
gava_clip_tpu/parallel/pipeline.py).

The JAX package runs one SPMD program over a 'pipe' mesh axis; the port
keeps that one-process design: stage s holds layers [s*L/S, (s+1)*L/S) on
the device `stages[s]`, and one process drives all of them.

  * the schedule is GPipe's fill and drain: M + S - 1 steps, in which
    stage s runs micro-batch t - s (bubble fraction (S-1)/(M+S-1));
  * a micro-batch's activation hops to the next stage's device with
    `.to(stages[s+1], non_blocking=True)` (nothing moves when two stages
    share a device);
  * autograd records the schedule, so a backward through `pipeline_scan`
    is GPipe's backward: the hops reversed, each stage's weight gradient
    summed over the micro-batches;
  * remat=True keeps only each stage's input per micro-batch and runs the
    stage's layers again in the backward (`torch.utils.checkpoint`), the
    GPipe activation budget.

The CLIP towers fit one card: the pipeline is here to match the JAX
package, and on one card (every stage on it) it runs the same code path.
"""

from typing import Callable, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint


def restage(layers: Sequence, n_stages: int) -> List[List]:
    """The per-layer parameters cut into `n_stages` equal runs of layers;
    an uneven layer count raises."""
    L = len(layers)
    if L % n_stages != 0:
        raise ValueError(f"stage_params: layer count {L} not divisible by "
                         f"{n_stages} pipeline stages")
    n = L // n_stages
    return [list(layers[s * n:(s + 1) * n]) for s in range(n_stages)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def stage_params(layers: Sequence, stages: Sequence) -> List[List]:
    """`restage` over len(stages) stages, each stage's layers moved to its
    device (leaves already there are not copied)."""
    staged = restage(layers, len(stages))
    return [_tree_map(lambda t, d=torch.device(dev): t.to(d), st)
            for st, dev in zip(staged, stages)]


def _leaves(carry):
    return list(carry) if isinstance(carry, (tuple, list)) else [carry]


def _pack(carry, leaves):
    return tuple(leaves) if isinstance(carry, (tuple, list)) else leaves[0]


def pipeline_scan(block_fn: Callable, staged: Sequence[Sequence], carry,
                  stages: Sequence, microbatches: int = 1,
                  remat: bool = False):
    """Run `carry` through every layer of `staged` with GPipe scheduling.

    block_fn(carry, layer_params) -> carry: the body a sequential loop over
    the layers would run (carry: a tensor or a tuple of tensors whose
    leading dimension is the batch and divides by `microbatches`).
    staged: `stage_params(layers, stages)`. Returns the carry after all
    layers, on the last stage's device: the sequential loop's values, in
    the same per-layer order."""
    S, M = len(stages), microbatches
    if len(staged) != S:
        raise ValueError(f"{len(staged)} staged runs of layers for {S} "
                         f"stages")
    devices = [torch.device(d) for d in stages]

    def split(x):
        if x.shape[0] % M != 0:
            raise ValueError(f"batch leaf {tuple(x.shape)} not divisible by "
                             f"{M} microbatches")
        return list(x.chunk(M))

    chunks = [split(x) for x in _leaves(carry)]
    micro = [[c[m] for c in chunks] for m in range(M)]

    def run_stage(s, leaves):
        def run(*hs):
            h = _pack(carry, list(hs))
            for layer in staged[s]:
                h = block_fn(h, layer)
            return tuple(_leaves(h))
        if remat and torch.is_grad_enabled():
            return list(checkpoint(run, *leaves, use_reentrant=False))
        return list(run(*leaves))

    inbox = [None] * S
    outs = [None] * M
    for t in range(M + S - 1):
        # the later stages first: stage s reads what stage s-1 sent in
        # step t-1 before stage s-1 overwrites it in step t
        for s in reversed(range(S)):
            m = t - s
            if not 0 <= m < M:
                continue
            leaves = [h.to(devices[0], non_blocking=True)
                      for h in micro[m]] if s == 0 else inbox[s]
            y = run_stage(s, leaves)
            if s == S - 1:
                outs[m] = y
            else:
                inbox[s + 1] = [h.to(devices[s + 1], non_blocking=True)
                                for h in y]
    return _pack(carry, [torch.cat([o[i] for o in outs])
                         for i in range(len(outs[0]))])
