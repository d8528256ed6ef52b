"""Process mesh, the data axis, the frame axis and tensor parallelism (port
of gava_clip_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a device mesh: the batch is
sharded on 'data', the parameters are replicated, and XLA inserts the
gradient all-reduce. PyTorch runs one process per card, so here the mesh
is a set of process groups over the ranks of `torch.distributed`, and the
collectives that XLA would insert are explicit:

  * `replicate` broadcasts rank 0's weights, so every rank starts equal;
  * `shard_batch` takes a rank's rows of a global batch;
  * `all_reduce_grads` averages the trainable leaves' gradients over
    'data' in one flattened bucket (the all-reduce XLA inserts);
  * `gather_rows` is the differentiable all-gather of a batch-wide term
    (the NTE head's B x B matrix): forward all-gather, backward all-reduce
    (sum) of the gradient and the rank's slice;
  * over 'frame' each rank passes its frames of every clip
    (`local_frames`, `shard_batch`); the vision tower gathers the cls rows
    of every frame for the cross-frame prompt extras (`gather_frames`) and
    takes the temporal means with one all-reduce (`frame_mean`), the
    collectives GSPMD inserts for the JAX tower's frame-sharded video
    (`P(None, "frame")`); `all_reduce_grads` sums the vision tower's
    per-frame partial gradients over 'frame'
    (`frame_partial_mask`). The frame axis composes with 'model' (each
    frame group's ranks hold one Megatron shard) and with the pipeline
    (each stage gathers its micro-batch's cls rows);
  * `tensor_parallel_spec` / `shard_params_tensor_parallel` give and cut
    Megatron's column / row shards over 'model', and `copy_to_group` /
    `reduce_from_group` are Megatron's two operators that the towers run
    around the sharded projections.

A mesh over a world of one process, or with no process group, runs no
collective at all, except where a group of one was started on purpose:
then each collective runs over that one rank (and changes no bit).
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.attention import attention_core
from ..ops.linear import linear, quant_kind


@dataclass
class Mesh:
    """Named axes over the ranks (the last axis varies fastest, as the JAX
    mesh's device array is reshaped). `groups[axis]` is the process group
    of the ranks that share every other coordinate with this one, or None
    without a process group."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object] = field(default_factory=dict)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)


def create_mesh(axis_names: Sequence[str] = ("data",),
                mesh_shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the process group's ranks (or over the one process
    without a group). mesh_shape defaults to (world_size, 1, ...); its
    product must equal the world size."""
    axis_names = tuple(axis_names)
    on = dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if on else (0, 1)
    if mesh_shape is None:
        mesh_shape = (world,) + (1,) * (len(axis_names) - 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"create_mesh: mesh_shape {mesh_shape} does not "
                         f"match the axes {axis_names}")
    want = int(np.prod(mesh_shape))
    if want != world:
        raise ValueError(
            f"create_mesh: mesh_shape {mesh_shape} needs {want} processes, "
            f"have {world} (start them with python -m "
            f"torch.distributed.run --nproc_per_node {want})")
    ranks = np.arange(world).reshape(mesh_shape)
    coords = dict(zip(axis_names, (int(c) for c in
                                   np.unravel_index(rank, mesh_shape))))
    groups: Dict[str, object] = {}
    if on:
        for a, name in enumerate(axis_names):
            # every rank creates every group, in the same order
            lines = np.moveaxis(ranks, a, -1).reshape(-1, mesh_shape[a])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return Mesh(axis_names, dict(zip(axis_names, mesh_shape)), coords,
                groups)


# ----- the data axis --------------------------------------------------------

def local_rows(x, index: int, count: int, batch_split: int = 1):
    """This rank's rows of a global leaf (numpy array or tensor): with
    `batch_split` S micro-batches, rank r of W holds rows
    [i*B/S + r*B/(S*W), i*B/S + (r+1)*B/(S*W)) of every micro-batch i, so
    that gathering micro-batch i over the ranks gives the global
    micro-batch i (S = 1: the r-th contiguous block)."""
    if count == 1:
        return x
    B = x.shape[0]
    if B % (batch_split * count) != 0:
        raise ValueError(f"a batch of {B} rows does not split into "
                         f"{batch_split} micro-batch(es) over {count} ranks")
    n, rest = B // (batch_split * count), tuple(x.shape[1:])
    x = x.reshape(batch_split, count, n, *rest)[:, index]
    return x.reshape(batch_split * n, *rest)


def shard_batch(batch: Dict, mesh: Mesh, per_host: bool = False,
                batch_split: int = 1) -> Dict:
    """per_host=False: every leaf is the GLOBAL batch; returns this rank's
    rows on 'data' (`local_rows`). per_host=True: the loader already
    sliced it (`data.sampler.step_sampler(rank, world_size)`); returned as
    it is. On a mesh whose 'frame' axis has more than one rank the video
    (the one leaf with a frame axis) is then cut to this rank's frames
    (`local_frames`); the labels, NTE and memory rows are passed whole."""
    if not per_host:
        i, n = mesh.axis_index("data"), mesh.axis_size("data")
        batch = {k: local_rows(v, i, n, batch_split)
                 for k, v in batch.items()}
    if mesh.axis_size("frame") > 1 and "video" in batch:
        batch = dict(batch, video=local_frames(
            batch["video"], mesh.axis_index("frame"),
            mesh.axis_size("frame")))
    return batch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Broadcast every tensor leaf of `tree` from rank 0, in place, so that
    every rank holds rank 0's values. Returns the tree."""
    if not dist.is_initialized():
        return tree
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor):
            buf = t if t.is_contiguous() else t.contiguous()
            dist.broadcast(buf, src=0)
            if buf is not t:
                t.copy_(buf)
    return tree


def _all_reduce_buckets(grads, group, n: int) -> None:
    """Sum `grads` over `group` in one flattened bucket for each dtype and
    divide by n, in place."""
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        bucket = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(bucket, group=group)
        if n != 1:
            bucket /= n
        off = 0
        for g in same:
            g.copy_(bucket[off:off + g.numel()].view_as(g))
            off += g.numel()


@torch.no_grad()
def all_reduce_grads(trainable, mesh: Mesh) -> None:
    """The gradient reduction XLA inserts, in place: over a 'frame' axis
    the leaves of `frame_partial_mask` (per-frame partial sums) summed over
    'frame' (with a 'model' axis too, each shard with the same shard of
    the other frame ranks: `frame_group`); then the `.grad` of every
    trainable leaf averaged over 'data'. One flattened bucket for each
    dtype and collective."""
    frame = frame_group(mesh)
    if frame is not None:
        partial = [p.grad for p, m in zip(_leaves(trainable),
                                          _leaves(frame_partial_mask(
                                              trainable)))
                   if m and p.grad is not None]
        _all_reduce_buckets(partial, frame, 1)
    group = mesh.group("data")
    if group is None:
        return
    _all_reduce_buckets([p.grad for p in _leaves(trainable)
                         if p.grad is not None], group,
                        mesh.axis_size("data"))


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A step's scalar metrics over 'data' in one all-reduce: the hit count
    summed, the others averaged (means of equal-sized local means)."""
    group = mesh.group("data")
    if group is None:
        return metrics
    names = sorted(metrics)
    vec = torch.stack([metrics[k].float().reshape(()) for k in names])
    dist.all_reduce(vec, group=group)
    n = mesh.axis_size("data")
    return {k: (v if k == "hit1" else v / n).to(metrics[k].dtype)
            for k, v in zip(names, vec)}


@torch.no_grad()
def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `t` over 'data' (a copy; `t` itself without a group)."""
    group = mesh.group("data")
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather along the rows; the backward sums every rank's gradient of
    the gathered tensor and returns this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank of `group`, in rank order, differentiably.
    Every rank then computes the same batch-wide term; the backward's sum
    gives each rank W times its rows' share of that term's gradient, and
    the data-axis mean of `all_reduce_grads` divides the W back out: the
    global batch's gradient. The ranks' tensors are concatenated whole,
    rank after rank, on dim 0: right for the rows of 'data', but ranks
    that hold frames [r*T/W, (r+1)*T/W) of each of B > 1 clips would come
    out clip-interleaved, so the frame axis has `gather_frames`."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)


# ----- the frame axis -------------------------------------------------------

def local_frames(x, index: int, count: int):
    """This rank's frames of a leaf (B, T, ...) (numpy array or tensor):
    rank r of W holds frames [r*T/W, (r+1)*T/W) of every clip. A slice,
    so autograd gives its backward (the gradient in the rank's frames,
    zeros elsewhere). T not divisible by W raises."""
    if count == 1:
        return x
    T = x.shape[1]
    if T % count != 0:
        raise ValueError(f"a clip of {T} frames (a leaf of shape "
                         f"{tuple(x.shape)}) does not split over {count} "
                         f"frame ranks")
    n = T // count
    return x[:, index * n:(index + 1) * n]


@dataclass(frozen=True)
class FrameShard:
    """A rank's share of the frame axis, as the vision tower threads it:
    the 'frame' `group`, this rank's `index` in it of `count`, and the
    `frames` of each clip that the rank holds (T / count)."""
    group: object
    index: int
    count: int
    frames: int

    @property
    def total(self) -> int:
        """The clip's global frame count T."""
        return self.frames * self.count

    def own_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(B*T, ...) rows of whole clips in global frame order -> this
        rank's (B*T/W, ...), clip by clip."""
        rest = tuple(t.shape[1:])
        return local_frames(t.reshape(-1, self.total, *rest), self.index,
                            self.count).reshape(-1, *rest)


def frame_shard(group, frames: int) -> Optional[FrameShard]:
    """The FrameShard of a rank that holds `frames` frames of each clip
    over the 'frame' `group` (None without one)."""
    if group is None:
        return None
    return FrameShard(group, dist.get_rank(group),
                      dist.get_world_size(group), frames)


def frame_group(mesh: Optional[Mesh]):
    """The 'frame' process group where the mesh splits the frame axis over
    more than one rank, else None. On a ('data', 'frame', 'model') mesh it
    holds the ranks that share this rank's 'data' and 'model' indices,
    which hold the same Megatron shards: the frame collectives then meet
    the same shard on every rank of the group, never another."""
    if mesh is None or mesh.axis_size("frame") == 1:
        return None
    return mesh.group("frame")


class _GatherFrames(torch.autograd.Function):
    """All-gather along the frames (dim 1); the backward sums every rank's
    gradient of the gathered tensor and returns this rank's frames of
    it."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.rank, ctx.frames = group, dist.get_rank(group), \
            x.shape[1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = ctx.frames
        return g[:, ctx.rank * n:(ctx.rank + 1) * n], None


def gather_frames(x: torch.Tensor, group) -> torch.Tensor:
    """(B, T/W, ...) of every rank of the 'frame' `group` -> (B, T, ...) in
    global frame order, differentiably. Every rank then computes the same
    cross-frame term; each must use only its own frames' rows of it, so
    that the backward's sum over the ranks counts each use once."""
    if group is None:
        return x
    return _GatherFrames.apply(x, group)


def frame_mean(x: torch.Tensor, group, T: int,
               span: Optional[int] = None) -> torch.Tensor:
    """The mean over each run of `span` consecutive frames of a clip (all
    T of them by default): x (B, T/W, ...) holds this rank's frames of the
    'frame' `group`; returns (B*T/span, ...), the same on every rank.
    Without a group x holds all T frames and this is its plain mean.
    Over a group the rank's frames are summed in fp32 into their runs,
    summed over the ranks with one all-reduce (Megatron's g: its backward
    is the identity, so each rank's frames get the whole upstream
    gradient / span), divided by span and cast back to x's dtype."""
    span = T if span is None else span
    B, rest = x.shape[0], tuple(x.shape[2:])
    if group is None:
        return x.reshape(B * T // span, span, *rest).mean(dim=1)
    n, r = x.shape[1], dist.get_rank(group)
    x32 = x.float()
    full = torch.cat([x32.new_zeros((B, r * n, *rest)), x32,
                      x32.new_zeros((B, T - (r + 1) * n, *rest))], dim=1)
    sums = full.reshape(B * T // span, span, *rest).sum(dim=1)
    return (reduce_from_group(sums, group) / span).to(x.dtype)


def frame_partial_mask(tree) -> Dict:
    """True on the leaves of `tree` (a parameter or trainable tree, None
    placeholders kept) whose gradient is a per-frame partial sum under
    frame sharding: those of the vision tower, every one of which acts
    before the temporal mean. The leaves behind the mean (text prompts,
    projector, heads, logit scales) see the same whole-clip features on
    every frame rank and so hold the whole gradient already."""
    def walk(t, partial):
        if isinstance(t, dict):
            return {k: walk(v, partial) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, partial) for v in t]
        return None if t is None else partial

    return {k: walk(v, k == "visual") for k, v in tree.items()}


# ----- tensor parallelism ---------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def local_heads(num_heads: int, group) -> int:
    """The attention heads whose q / k / v columns a rank holds: all of
    them, or on a 'model' group its whole heads' share."""
    return num_heads if group is None else \
        num_heads // dist.get_world_size(group)


def row_parallel_linear(params: Dict, x: torch.Tensor, group) -> torch.Tensor:
    """A row-sharded projection: the partial product, summed over the
    group, then the (replicated) bias, added once."""
    y = reduce_from_group(x @ params["kernel"].to(x.dtype), group)
    bias = params.get("bias")
    return y if bias is None else y + bias.to(y.dtype)


def parallel_attention(params: Dict, x: torch.Tensor, num_heads: int,
                       group, impl: str = "xla",
                       causal: bool = False) -> torch.Tensor:
    """Self-attention whose q / k / v kernels hold this rank's columns (its
    `local_heads`) and whose out kernel holds the matching rows. x already
    passed `copy_to_group`."""
    q, k, v = (linear(params[n], x) for n in ("q", "k", "v"))
    out = attention_core(q, k, v, local_heads(num_heads, group), impl=impl,
                         causal=causal)
    return row_parallel_linear(params["out"], out, group)


def parallel_mlp(params: Dict, x: torch.Tensor, act: Callable,
                 group) -> torch.Tensor:
    """fc1 column-sharded, fc2 row-sharded; x already passed
    `copy_to_group`."""
    return row_parallel_linear(params["fc2"], act(linear(params["fc1"], x)),
                               group)


_COLUMN = ("q", "k", "v")


def tensor_parallel_spec(path: Sequence, shape: Sequence[int],
                         mesh: Optional[Mesh] = None) -> Tuple:
    """Megatron's rule for the CLIP towers over a 'model' axis, the JAX
    function's leaf for leaf: column-shard the up-projections (attention
    q/k/v, MLP fc1) and their biases, row-shard the down-projections
    (attention out, MLP fc2), replicate everything else. Returns one entry
    per dimension of the leaf ('model' or None), or () for a replicated
    leaf, as the JAX PartitionSpec reads."""
    name = "/".join(str(p) for p in path)
    ndim = len(shape)

    def spec(*tail):
        return (None,) * (ndim - len(tail)) + tail

    column = any(f"/{k}/" in name for k in _COLUMN) or "fc1" in name
    if "kernel" in name and ndim >= 2:
        if column:
            return spec(None, "model")
        if "/out/" in name or "fc2" in name:
            return spec("model", None)
    if "bias" in name and ndim >= 1 and column:
        return spec("model")
    return ()


def _tp_units(cfg, tp: int) -> Dict[str, bool]:
    """Which parts of the model take shards: a tower whose heads and MLP
    width both divide by `tp` (the summary attention shares the vision
    tower's heads), the memory head's tf_project where its hidden width
    does. The JAX package replicates a single leaf that does not divide,
    the port the whole part; GSPMD computes the same values either way."""
    v = cfg.vision
    hidden = round(v.mlp_factor * v.feature_dim)
    return {"visual": v.heads % tp == 0 and hidden % tp == 0,
            "textual": cfg.text.heads % tp == 0
            and (4 * cfg.text.width) % tp == 0,
            "tf_project": (cfg.text.embed_dim // 4) % tp == 0}


def tower_groups(mesh: Optional[Mesh], cfg) -> Dict[str, object]:
    """For each part of `_tp_units` (visual, textual, tf_project): the
    'model' group where it holds Megatron shards, else None (a part that
    runs no collective). Over a 'model' axis of more than one rank the
    parameters must be `shard_params_tensor_parallel`'s."""
    tp = 1 if mesh is None else mesh.axis_size("model")
    units = _tp_units(cfg, tp)
    group = mesh.group("model") if tp > 1 else None
    return {u: group if on else None for u, on in units.items()}


def _map_tp(tree, units: Dict[str, bool], fn, path=()):
    """fn(leaf, dim) on every leaf that takes a shard on dimension `dim`
    (`units` from `_tp_units`); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _map_tp(v, units, fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tp(v, units, fn, path + (i,))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    unit = next((u for u in units if u in path), None)
    if unit is None or not units[unit]:
        return tree
    spec = tensor_parallel_spec(path, tree.shape)
    if "model" not in spec:
        return tree
    return fn(tree, spec.index("model"))


def _check_float(tree, path=""):
    if isinstance(tree, dict):
        if "kernel" in tree and quant_kind(tree["kernel"]) is not None:
            raise NotImplementedError(
                f"tensor parallelism takes float towers only; {path} holds "
                f"a quantized ('{quant_kind(tree['kernel'])}') kernel")
        for k, v in tree.items():
            _check_float(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _check_float(v, f"{path}/{i}")


def shard_params_tensor_parallel(params: Dict, mesh: Mesh, cfg) -> Dict:
    """This rank's shards of a full parameter tree over the mesh's 'model'
    axis (the `tensor_parallel_spec` of each leaf; `cfg` is the
    VitaClipConfig, whose head counts decide which parts take shards). A
    tree with quantized ('q' / 'qa' / 'qt') kernels raises."""
    tp = mesh.axis_size("model")
    if tp == 1:
        return params
    _check_float(params)
    i = mesh.axis_index("model")
    return _map_tp(params, _tp_units(cfg, tp),
                   lambda t, d: t.chunk(tp, dim=d)[i].contiguous())


@torch.no_grad()
def gather_tensor_parallel(tree, mesh: Mesh, cfg):
    """The inverse of `shard_params_tensor_parallel` (for a parameter or a
    gradient tree): every sharded leaf gathered over 'model'."""
    tp = mesh.axis_size("model")
    group = mesh.group("model")
    if tp == 1 or group is None:
        return tree

    def gather(t, d):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(tp)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=d)

    return _map_tp(tree, _tp_units(cfg, tp), gather)
