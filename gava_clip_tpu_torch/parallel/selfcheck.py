"""The parallel layer's multi-process check: one train step (or a few) and
the sharded evaluation under a data, a model or a frame axis, run by every
rank of a process group.

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
                     every clip under tensor parallelism (tp);
  fp / fp_remat      mesh (1, W, 1) over ('data', 'frame', 'model'): each
                     rank passes its frames of every clip (`shard_batch`),
                     remat 'none' / 'full'; `rank_spread` is the largest
                     difference of any rank's trainable leaves from rank
                     0's after the steps;
(every step scenario records rank 0's kernel launches of its first step,
`launches`: the nonzero counts)
  fp:local_grad_frames  a mutant: the gathered cls rows keep only the
                     rank's own frames' gradient;
  fp:local_T_mean    a mutant: the temporal means divided by T/W;
  fp:local_time_embed  a mutant: every rank's frames take the temporal
                     embedding of frames 0, 1, ...;
  fp_eval            the frame-sharded forward (no step) of the batch's
                     clips and of the eval clips (`eval_video`, T a
                     multiple of the model's frames): logits, summary and
                     the heads' outputs, and their `rank_spread`;
  fp_serve           the zero-shot classifier (`build_zero_shot`, seeded
                     weights; SERVE_SIZES) frame-sharded against the same
                     forward in one process, in bf16 and then w8a8 +
                     patch-major with the fused prompt extras: the largest
                     |logit| difference and the bf16 ulp of the largest
                     |logit|, each rank's kernel launches, host-clock ms
                     of each (needs no --model / --batch);
  fp_serve:local_time_embed  the same forwards under that mutant (untimed).
  fm / fm_remat      mesh (1, W/2, 2) over ('data', 'frame', 'model'): each
                     rank passes its frames of every clip through its
                     Megatron shards, remat 'none' / 'full'; the first
                     step's gradients and the leaves gathered over 'model'
                     (`gather_tensor_parallel`), `rank_spread` of the
                     gathered leaves;
  fm:grads_over_world  a mutant: the frame-partial gradients summed over
                     every rank, not the 'frame' group, which mixes the
                     different shards of the two 'model' ranks;
  fm_eval            fp_eval on that mesh, the parameters sharded;
  fm_serve           the zero-shot classifier's bf16 weights through
                     `vita_clip.apply` on that mesh against one process's
                     bf16 forward, and one process's fp32 forward on the
                     same weights (`f32_diff`: how far bf16 rounding alone
                     moves the logits), with launches and times as
                     fp_serve;
  fpp_serve          the zero-shot classifier's forward on the (1, W)
                     frame mesh with its blocks as a pipeline of
                     PP_SERVE_STAGES stages on this rank's device and
                     PP_SERVE_MICRO micro-batches (PP_SERVE_SIZES), in bf16
                     and in fp32 (the model's fp32 weights; the logits
                     kept for the check against JAX), against the forward
                     in one process without the pipeline;
  fpp:no_gather      a mutant: fpp_serve with stages that pass no
                     FrameShard, so each rank's summary attention and
                     local prompts see only its own frames (untimed).

--reference also runs the first step on rank 0 without a mesh on the whole
global batch (with the scenario's batch_split; the other ranks wait) and
records the largest loss and gradient differences and both steps' times
on the host's clock (the check on a card, where JAX is absent). Imports
no JAX.
"""

import argparse
import contextlib
import json
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models import vision, vita_clip
from ..models.vita_clip import VitaClipModel, trainable_mask
from ..train.state import create_train_state, make_optimizer, tree_leaves
from ..train.step import LossConfig, make_train_step
from . import distributed as _dist
from . import mesh as _mesh
from .mesh import (create_mesh, frame_mean, gather_tensor_parallel,
                   local_frames, shard_batch, shard_params_tensor_parallel)


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


def _local_grad_frames(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    parts[dist.get_rank(group)] = x
    return torch.cat(parts, dim=1)


def _local_T_mean(x, group, T, span=None):
    return frame_mean(x, group, T, span) * dist.get_world_size(group)


def _local_time_embed(time_embed, T, fs=None):
    return vision.resize_time_embed(time_embed,
                                    T if fs is None else fs.total)[:T]


def _grads_over_world(mesh):
    return None if mesh is None or mesh.axis_size("frame") == 1 \
        else dist.group.WORLD


_PIPELINED_BLOCKS = vision._pipelined_blocks


def _no_gather(*args, fs=None):
    return _PIPELINED_BLOCKS(*args)


# the mutants: (module, the function they replace there, the broken one)
_MUTANTS = {"local_nte": (vita_clip, "gather_rows", _local_nte),
            "local_grad_nte": (vita_clip, "gather_rows", _local_grad_nte),
            "local_grad_frames": (vision, "gather_frames",
                                  _local_grad_frames),
            "local_T_mean": (vision, "frame_mean", _local_T_mean),
            "local_time_embed": (vision, "time_embed_rows",
                                 _local_time_embed),
            "grads_over_world": (_mesh, "frame_group", _grads_over_world),
            "no_gather": (vision, "_pipelined_blocks", _no_gather)}


@contextlib.contextmanager
def _mutant(name):
    """A broken collective in place of the real one for one scenario."""
    if not name:
        yield
        return
    module, attr, fn = _MUTANTS[name]
    keep = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, keep)


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


def _rank_spread(tree) -> float:
    """The largest |difference| of any leaf of `tree` on any rank from rank
    0's (0.0 where every rank holds the same values)."""
    leaves = [t.detach().float().contiguous() for t in tree_leaves(tree)
              if t is not None]
    worst = torch.zeros((), device=leaves[0].device)
    for t in leaves:
        ref = t.clone()
        dist.broadcast(ref, src=0)
        worst = torch.maximum(worst, (t - ref).abs().max())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return worst.item()


def _frame_mesh(model: int = 1):
    """(1, W / model, model) over ('data', 'frame', 'model')."""
    world = _dist.world()[1]
    if world % model:
        raise SystemExit(f"selfcheck: a 'model' axis of {model} needs a "
                         f"multiple of {model} processes, have {world}")
    return create_mesh(("data", "frame", "model"),
                       (1, world // model, model))


def _model_ranks(kind: str) -> int:
    """The 'model' axis of a frame scenario: 2 for the fm ones."""
    return 2 if kind.startswith("fm") else 1


def run_step_scenario(name, saved, batch, args, device, reference=None):
    kind, _, mutant = name.partition(":")
    split = _split(name)
    world = _dist.world()[1]
    frames = kind.startswith(("fp", "fm"))
    if frames:
        mesh = _frame_mesh(_model_ranks(kind))
    else:
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
                           mesh=mesh, attn_impl=args.attn_impl,
                           remat="full" if kind.endswith("_remat")
                           else "none")
    local = {k: v.to(device) for k, v in
             shard_batch(batch, mesh, batch_split=split).items()}
    out = {"metrics": []}
    ms = []
    _reset_launches()
    with _mutant(mutant):
        for i in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step(state, local)
            metrics = {k: v.item() for k, v in metrics.items()}
            ms.append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append(metrics)
            if i == 0:
                out["launches"] = {k: n for k, n in _launches().items()
                                   if n}
                out["grads"] = _cpu(gather_tensor_parallel(
                    _grads(state.trainable), mesh, cfg))
    full = gather_tensor_parallel(state.trainable, mesh, cfg)
    out["trainable"] = _cpu(full)
    out["ms"] = ms
    if frames:
        out["rank_spread"] = _rank_spread(full)
    if reference is not None:
        loss_r, grads_r, ms_r = reference
        rel = _rel_l2(out["grads"], grads_r)
        out["check"] = {"loss": out["metrics"][0]["total"],
                        "loss_ref": loss_r,
                        "loss_diff": abs(out["metrics"][0]["total"] - loss_r),
                        "max_grad_rel_err": max(rel),
                        "median_grad_rel_err": float(np.median(rel)),
                        "leaves": len(rel), "ms_reference": ms_r}
    return out


def reference_step(saved, batch, args, device, split=1):
    """The first step in this process, without a mesh, on the whole global
    batch (in `split` micro-batches), then a second one: (the first's
    total loss and gradients, each step's ms on the host's clock)."""
    model = _model(saved, saved["params"], device)
    opt = make_optimizer(args.lr, 50, 0.1)
    state = create_train_state(model.params,
                               trainable_mask(model.params, saved["cfg"]),
                               opt, device=device)
    step = make_train_step(model, LossConfig(**args.loss), opt,
                           batch_split=split, attn_impl=args.attn_impl)
    batch = {k: v.to(device) for k, v in batch.items()}
    ms = []
    for i in range(2):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        total = metrics["total"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = total, _cpu(_grads(state.trainable))
    return (*first, ms)


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


def run_frame_eval(saved, batch, args, device, model_ranks=1):
    """The frame-sharded forward of the batch's clips (with the NTE and
    memory inputs) and of the eval clips, with `model_ranks` > 1 on the
    rank's Megatron shards: the outputs and their largest difference
    across the ranks."""
    mesh = _frame_mesh(model_ranks)
    model = _model(saved, shard_params_tensor_parallel(
        saved["params"], mesh, saved["cfg"]), device)
    index, count = mesh.axis_index("frame"), mesh.axis_size("frame")
    out = {}
    with torch.no_grad():
        for name, kw in (
                ("train", dict(x=batch["video"], memory=batch.get("memory"),
                               video_nte=batch.get("nte"))),
                ("eval", dict(x=batch["eval_video"]))):
            kw = {k: None if v is None else v.to(device)
                  for k, v in kw.items()}
            kw["x"] = local_frames(kw["x"], index, count)
            res = model.apply(model.params, model.buffers,
                              attn_impl=args.attn_impl, mesh=mesh, **kw)
            out[name] = _cpu(res)
            out[f"{name}_rank_spread"] = _rank_spread(res)
    return out


# fp_serve's classifier (input size, clips, vision layers): ViT-B/16 whole
# on the card; on the CPU, where the plain versions run, cut to a size a
# test can afford; each forward then timed SERVE_TURNS times
SERVE_SIZES = {"cuda": (224, 16, 12), "cpu": (32, 2, 2)}
SERVE_TURNS = 3


def _serve_model(device, S, L):
    """`build_zero_shot` (seeded weights, 8 frames, 400 classes) at input
    size S, cut to L blocks."""
    import dataclasses
    from ..models.vita_clip import VitaClip
    from ..utils.flagship import build_zero_shot
    model = build_zero_shot(num_frames=8, num_classes=400, input_size=S,
                            rng_seed=0, device="cpu")
    if L == model.cfg.vision.layers:
        return model.to(device)
    params = model.param_tree()
    params["visual"] = dict(params["visual"],
                            blocks=params["visual"]["blocks"][:L],
                            global_prompts=params["visual"]
                            ["global_prompts"][:L].clone())
    cfg = dataclasses.replace(
        model.cfg, vision=dataclasses.replace(model.cfg.vision, layers=L))
    return VitaClip(cfg, params, model.text_features).to(device)


def _launches():
    from ..ops import extras_kernel, flash_attention, int8_matmul
    return {**flash_attention.launch_counts, **int8_matmul.launch_counts,
            **extras_kernel.launch_counts}


def _reset_launches():
    from ..ops import extras_kernel, flash_attention, int8_matmul
    for m in (flash_attention, int8_matmul, extras_kernel):
        m.reset_launch_counts()


def _host_ms(fn, device, alone: bool = False) -> float:
    """One call of fn on the host's clock, the ranks started together; with
    alone=True rank 0 runs it while the others wait."""
    dist.barrier()
    ms = 0.0
    if not alone or dist.get_rank() == 0:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    dist.barrier()
    return ms


def _serve_clips(S: int, B: int) -> np.ndarray:
    """The seeded uint8 clips of the serving scenarios, (B, 8, S, S, 3)."""
    return np.random.RandomState(0).randint(0, 256, (B, 8, S, S, 3),
                                            dtype=np.uint8)


def _every_rank(launches: dict, device) -> list:
    """Every rank's nonzero launch counts, in one all-gather."""
    names = sorted(launches)
    mine = torch.tensor([launches[k] for k in names], device=device)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return [{k: int(n) for k, n in zip(names, e) if n} for e in every]


def _serve_record(sharded, one, launches, device, ms, ms_one) -> dict:
    top = one.float().abs().max().item()
    return {
        "max_abs_diff": (sharded.float() - one.float()).abs().max().item(),
        "max_abs_logit": top,
        # the spacing of bf16 values at the largest |logit|
        "logit_ulp": 2.0 ** (math.floor(math.log2(top)) - 7),
        "finite": bool(torch.isfinite(sharded).all()),
        "shape": tuple(sharded.shape),
        "rank_spread": _rank_spread([sharded]),
        "launches": _every_rank(launches, device),
        "ms": ms, "ms_one_process": ms_one}


def _sharded_and_one(forward, device, mutant):
    """forward(True) (the sharded forward, under `mutant`, its launches
    counted) and forward(False) (one process), then, without a mutant, both
    timed SERVE_TURNS times in turns: (the `_serve_record`, the sharded
    logits, one process's)."""
    one = forward(False)
    _reset_launches()
    with _mutant(mutant):
        sharded = forward(True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_launches())
    ms, ms_one = [], []
    for _ in range(0 if mutant else SERVE_TURNS):
        ms.append(_host_ms(lambda: forward(True), device))
        ms_one.append(_host_ms(lambda: forward(False), device, alone=True))
    return _serve_record(sharded, one, launches, device, ms, ms_one), \
        sharded, one


def run_frame_serve(device, mutant=""):
    """The zero-shot classifier's forward, frame-sharded (under `mutant`,
    if one is named) against one process's on the same clips, in bf16 and
    then w8a8 + patch-major with the fused prompt extras."""
    from ..data.device_preprocess import normalize_frames
    from ..ops import extras_kernel
    from ..serve import VideoClassifier
    mesh = _frame_mesh()
    index, count = mesh.axis_index("frame"), mesh.axis_size("frame")
    S, B, L = SERVE_SIZES[device.type]
    model = _serve_model(device, S, L)
    classes = [f"class {i}" for i in range(model.text_features.shape[0])]
    clips = _serve_clips(S, B)
    out = {}
    for mode, kw, fused in (
            ("bf16", {}, False),
            ("w8a8", dict(quantize="w8a8", patch_major=True), True)):
        clf = VideoClassifier.from_model(model, classes, batch_size=B,
                                         device=device, **kw)
        u8 = clf._prepare(clips)

        def forward(frames, clf=clf, u8=u8):
            with torch.inference_mode():
                if clf.patch_major:
                    x, fmt = u8.to(clf.compute_dtype), "patches"
                else:
                    x, fmt = normalize_frames(u8, clf._mean, clf._std), \
                        "frames"
                if frames:
                    x = local_frames(x, index, count)
                return clf.net(x, compute_dtype=clf.compute_dtype,
                               attn_impl=clf.attn_impl, input_format=fmt,
                               mesh=mesh if frames else None)["logits"]

        extras_kernel.set_fused_extras(fused)
        try:
            out[mode] = _sharded_and_one(forward, device, mutant)[0]
        finally:
            extras_kernel.set_fused_extras(False)
        del clf
    return out


def run_model_frame_serve(device):
    """The zero-shot classifier's bf16 weights through `vita_clip.apply`
    on the (1, W/2, 2) ('data', 'frame', 'model') mesh, each rank its
    frames and its Megatron shards of the tower, against one process's
    bf16 forward on the same weights; `f32_diff` is the largest |logit|
    difference of that forward from one process's fp32 forward on the
    same weights, the distance bf16 rounding alone puts between two
    forwards."""
    from ..data.device_preprocess import normalize_frames
    from ..serve import VideoClassifier
    mesh = _frame_mesh(2)
    index, count = mesh.axis_index("frame"), mesh.axis_size("frame")
    S, B, L = SERVE_SIZES[device.type]
    model = _serve_model(device, S, L)
    classes = [f"class {i}" for i in range(model.text_features.shape[0])]
    clf = VideoClassifier.from_model(model, classes, batch_size=B,
                                     device=device)
    net = clf.net
    params = net.param_tree()
    shards = shard_params_tensor_parallel(params, mesh, net.cfg)
    buffers = {"text_features": net.text_features}
    x = normalize_frames(clf._prepare(_serve_clips(S, B)), clf._mean,
                         clf._std)

    def apply(p, x, dtype, mesh=None):
        with torch.inference_mode():
            return vita_clip.apply(net.cfg, p, buffers, x,
                                   compute_dtype=dtype,
                                   attn_impl=clf.attn_impl,
                                   mesh=mesh)["logits"]

    f32 = apply(params, x, torch.float32)
    record, _, one = _sharded_and_one(
        lambda sharded: apply(shards, local_frames(x, index, count),
                              torch.bfloat16, mesh) if sharded
        else apply(params, x, torch.bfloat16), device, "")
    record["f32_diff"] = (one.float() - f32).abs().max().item()
    return {"bf16": record}


# fpp_serve: the blocks in PP_SERVE_STAGES stages on the rank's device and
# PP_SERVE_MICRO micro-batches of whole clips; (input size, clips, vision
# layers), the clips even in number a micro-batch on the CPU, so that the
# no_gather mutant's pseudo-videos of 8 rows fill
PP_SERVE_STAGES = 2
PP_SERVE_MICRO = 2
PP_SERVE_SIZES = {"cuda": (224, 16, 12), "cpu": (32, 4, 2)}


def run_pipelined_frame_serve(device, mutant=""):
    """The zero-shot classifier's forward frame-sharded with its blocks as
    a pipeline (under `mutant`, if one is named), against one process's
    forward without the pipeline: in bf16 (the classifier's weights) and
    in fp32 (the model's), whose logits are kept."""
    from ..data.device_preprocess import normalize_frames
    from ..serve import VideoClassifier
    mesh = _frame_mesh()
    index, count = mesh.axis_index("frame"), mesh.axis_size("frame")
    S, B, L = PP_SERVE_SIZES[device.type]
    model = _serve_model(device, S, L)
    classes = [f"class {i}" for i in range(model.text_features.shape[0])]
    clf = VideoClassifier.from_model(model, classes, batch_size=B,
                                     device=device)
    x = normalize_frames(clf._prepare(_serve_clips(S, B)), clf._mean,
                         clf._std)
    pp = ([device] * PP_SERVE_STAGES, PP_SERVE_MICRO)
    out = {}
    for mode, net, dtype in (("bf16", clf.net, torch.bfloat16),
                             ("fp32", model, torch.float32)):
        def forward(sharded, net=net, dtype=dtype):
            with torch.inference_mode():
                if sharded:
                    return net(local_frames(x, index, count),
                               compute_dtype=dtype, attn_impl=clf.attn_impl,
                               pp=pp, mesh=mesh)["logits"]
                return net(x, compute_dtype=dtype,
                           attn_impl=clf.attn_impl)["logits"]

        out[mode], sharded, _ = _sharded_and_one(forward, device, mutant)
        out[f"{mode}_logits"] = sharded.float().cpu()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model")
    ap.add_argument("--batch")
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
    scenarios = args.scenarios.split(",")
    serve = ("fp_serve", "fm_serve", "fpp")
    if not (args.model and args.batch) and any(
            not s.startswith(serve) for s in scenarios):
        raise SystemExit("selfcheck: --model and --batch are needed for "
                         "every scenario but fp_serve, fm_serve and fpp")
    saved = batch = train_batch = None
    if args.model:
        saved = torch.load(args.model, weights_only=False)
        batch = {k: torch.from_numpy(v)
                 for k, v in np.load(args.batch).items()}
        train_batch = {k: v for k, v in batch.items()
                       if not k.startswith("eval_")}
    references = {}
    results = {}
    for name in scenarios:
        t0 = time.perf_counter()
        if name.startswith("fp_serve"):
            results[name] = run_frame_serve(device, name.partition(":")[2])
        elif name == "fm_serve":
            results[name] = run_model_frame_serve(device)
        elif name.startswith("fpp"):
            results[name] = run_pipelined_frame_serve(
                device, name.partition(":")[2])
        elif name in ("fp_eval", "fm_eval"):
            results[name] = run_frame_eval(saved, batch, args, device,
                                           _model_ranks(name))
        elif name.startswith("eval_"):
            results[name] = run_eval_scenario(name, saved, batch, args,
                                              device)
        else:
            split = _split(name)
            if args.reference and split not in references:
                # on rank 0 alone (its check is the one written), so that
                # its time is one process's
                references[split] = reference_step(
                    saved, train_batch, args, device, split) \
                    if rank == 0 else None
                dist.barrier()
            results[name] = run_step_scenario(name, saved, train_batch, args,
                                              device, references.get(split))
        results[name]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            summary = {k: v for k, v in results[name].items()
                       if k in ("check", "ms", "seconds", "acc",
                                "rank_spread", "bf16", "w8a8", "fp32")}
            print(f"[selfcheck] {name}: {json.dumps(summary)}", flush=True)
    if rank == 0:
        torch.save(results, args.out)
    _dist.shutdown()


if __name__ == "__main__":
    main()
