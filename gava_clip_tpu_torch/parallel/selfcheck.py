"""The parallel layer's multi-process check: one train step (or a few) and
the sharded evaluation under a data or a model axis, run by every rank of
a process group.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m gava_clip_tpu_torch.parallel.selfcheck --model M.pt \\
        --batch B.npz --out R.pt [--device cpu] [--scenarios dp,tp,...]

M.pt: torch.save({"cfg": VitaClipConfig, "params": ..., "buffers": ...});
B.npz: the GLOBAL batch (video, labels, nte, memory, mt_labels) and, for
the evaluation scenarios, eval_video / eval_labels. Each scenario builds
its mesh over the ranks, cuts the rank's rows of the global batch
(`shard_batch`) and, under 'model', the rank's shards of the parameters
(`shard_params_tensor_parallel`), runs `--steps` train steps and writes,
on rank 0, the metrics of every step, the gradients of the first step
after the all-reduce and the trainable leaves after the last step (shards
gathered: full leaves, the port's layout) into R.pt. Scenarios:

  dp / tp            mesh (W, 1) / (1, W);
  dp_split<S>        dp with batch_split S (the rows of `local_rows`);
  dp:local_nte       a mutant: the NTE head over the rank's rows alone;
  dp:local_grad_nte  a mutant: the gathered NTE inputs keep only the
                     rank's own slice's gradient (the usual feature-gather
                     trick, off by a factor of W);
  eval_dp / eval_tp  `cli.train.evaluate` over the ranks' clips (dp) or
                     every clip under tensor parallelism (tp).

--reference also runs the first step in this process without a mesh on
the whole global batch (with the scenario's batch_split) and records the
largest loss and gradient differences (the check on a card, where JAX is
absent). Imports no JAX.
"""

import argparse
import contextlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models import vita_clip
from ..models.vita_clip import VitaClipModel, trainable_mask
from ..train.state import create_train_state, make_optimizer, tree_leaves
from ..train.step import LossConfig, make_train_step
from . import distributed as _dist
from .mesh import (create_mesh, gather_tensor_parallel, shard_batch,
                   shard_params_tensor_parallel)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def _cpu(tree):
    return _map(lambda t: t.detach().cpu().clone(), tree)


def _local_nte(x, group):
    return x


def _local_grad_nte(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    parts[dist.get_rank(group)] = x
    return torch.cat(parts)


@contextlib.contextmanager
def _mutant(name):
    """A broken NTE gather in place of `gather_rows` for one scenario."""
    if not name:
        yield
        return
    fn = {"local_nte": _local_nte, "local_grad_nte": _local_grad_nte}[name]
    keep = vita_clip.gather_rows
    vita_clip.gather_rows = fn
    try:
        yield
    finally:
        vita_clip.gather_rows = keep


def _model(saved, params, device):
    return VitaClipModel(saved["cfg"], params=params,
                         buffers=saved["buffers"], device=device)


def _grads(trainable):
    return _map(lambda t: t.grad, trainable)


def _rel_l2(got, want):
    """Relative L2 error of each leaf, floored at 1e-3 of the largest
    leaf's norm (chip_smoke's rule)."""
    pairs = [(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want))
             if b is not None]
    scale = max(b.norm().item() for _, b in pairs)
    return [((a - b).norm() / b.norm().clamp_min(1e-3 * scale)).item()
            for a, b in pairs]


def _split(name: str) -> int:
    kind = name.partition(":")[0]
    return int(kind[len("dp_split"):]) if kind.startswith("dp_split") else 1


def run_step_scenario(name, saved, batch, args, device, reference=None):
    kind, _, mutant = name.partition(":")
    split = _split(name)
    world = _dist.world()[1]
    shape = (1, world) if kind == "tp" else (world, 1)
    mesh = create_mesh(("data", "model"), shape)
    cfg = saved["cfg"]
    params = shard_params_tensor_parallel(saved["params"], mesh, cfg)
    model = _model(saved, params, device)
    opt = make_optimizer(args.lr, 50, 0.1)
    state = create_train_state(model.params,
                               trainable_mask(model.params, cfg), opt,
                               device=device)
    loss_cfg = LossConfig(**args.loss)
    step = make_train_step(model, loss_cfg, opt, batch_split=split,
                           mesh=mesh, attn_impl=args.attn_impl)
    local = {k: v.to(device) for k, v in
             shard_batch(batch, mesh, batch_split=split).items()}
    out = {"metrics": []}
    ms = []
    with _mutant(mutant):
        for i in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step(state, local)
            metrics = {k: v.item() for k, v in metrics.items()}
            ms.append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append(metrics)
            if i == 0:
                out["grads"] = _cpu(gather_tensor_parallel(
                    _grads(state.trainable), mesh, cfg))
    out["trainable"] = _cpu(gather_tensor_parallel(state.trainable, mesh,
                                                   cfg))
    out["ms"] = ms
    if reference is not None:
        loss_r, grads_r = reference
        rel = _rel_l2(out["grads"], grads_r)
        out["check"] = {"loss": out["metrics"][0]["total"],
                        "loss_ref": loss_r,
                        "loss_diff": abs(out["metrics"][0]["total"] - loss_r),
                        "max_grad_rel_err": max(rel),
                        "median_grad_rel_err": float(np.median(rel)),
                        "leaves": len(rel)}
    return out


def reference_step(saved, batch, args, device, split=1):
    """The first step in this process, without a mesh, on the whole global
    batch (in `split` micro-batches): (total loss, the gradients)."""
    model = _model(saved, saved["params"], device)
    opt = make_optimizer(args.lr, 50, 0.1)
    state = create_train_state(model.params,
                               trainable_mask(model.params, saved["cfg"]),
                               opt, device=device)
    step = make_train_step(model, LossConfig(**args.loss), opt,
                           batch_split=split, attn_impl=args.attn_impl)
    state, metrics = step(state, {k: v.to(device) for k, v in batch.items()})
    return metrics["total"].item(), _cpu(_grads(state.trainable))


def run_eval_scenario(name, saved, batch, args, device):
    from ..cli.train import evaluate
    from ..data.sampler import eval_sampler
    world = _dist.world()[1]
    mesh = create_mesh(("data", "model"),
                       (1, world) if name == "eval_tp" else (world, 1))
    cfg = saved["cfg"]
    params = shard_params_tensor_parallel(saved["params"], mesh, cfg)
    model = _model(saved, params, device)
    video, labels = batch["eval_video"].numpy(), batch["eval_labels"].numpy()
    order = eval_sampler(len(video), mesh.axis_index("data"),
                         mesh.axis_size("data"))
    loader = [{"video": video[order[i:i + args.eval_batch]],
               "labels": labels[order[i:i + args.eval_batch]]}
              for i in range(0, len(order), args.eval_batch)]
    acc, conf = evaluate(model, model.params, loader, cfg.num_classes,
                         None, None, torch.float32, args.eval_batch,
                         attn_impl=args.attn_impl, device=device, mesh=mesh)
    return {"acc": acc, "conf": conf}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--batch", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--scenarios", default="dp,tp")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval_batch", type=int, default=2)
    ap.add_argument("--attn_impl", default=None)
    ap.add_argument("--loss", default='{"num_classes": 3}',
                    help="LossConfig keywords as JSON")
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args(argv)
    args.loss = json.loads(args.loss)
    rank, world = _dist.init_distributed(backend=args.backend,
                                         device=args.device)
    if world < 2:
        raise SystemExit("selfcheck: start it with torch.distributed.run "
                         "and at least 2 processes")
    from ..utils.device import resolve_device
    device = resolve_device(args.device)
    args.attn_impl = args.attn_impl or (
        "flash" if device.type == "cuda" else "xla")
    saved = torch.load(args.model, weights_only=False)
    batch = {k: torch.from_numpy(v) for k, v in np.load(args.batch).items()}
    train_batch = {k: v for k, v in batch.items()
                   if not k.startswith("eval_")}
    references = {}
    results = {}
    for name in args.scenarios.split(","):
        t0 = time.perf_counter()
        if name.startswith("eval_"):
            results[name] = run_eval_scenario(name, saved, batch, args,
                                              device)
        else:
            split = _split(name)
            if args.reference and split not in references:
                references[split] = reference_step(saved, train_batch, args,
                                                   device, split)
            results[name] = run_step_scenario(name, saved, train_batch, args,
                                              device, references.get(split))
        results[name]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            summary = {k: v for k, v in results[name].items()
                       if k in ("check", "ms", "seconds", "acc")}
            print(f"[selfcheck] {name}: {json.dumps(summary)}", flush=True)
    if rank == 0:
        torch.save(results, args.out)
    _dist.shutdown()


if __name__ == "__main__":
    main()
