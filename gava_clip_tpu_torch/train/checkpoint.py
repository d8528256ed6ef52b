"""Checkpointing with the reference's resume triad (port of
gava_clip_tpu/train/checkpoint.py): --backbone_path (CLIP weights at model
build), --pretrain (weights only, non-strict), --auto_resume /
--resume_path (full state + next_step).

A checkpoint is one pickle of numpy arrays, Python scalars and plain
containers: {params, opt_state, next_step, text_features}. The
text_features slot is what makes zero-shot re-evaluation of a training run
work. `params` is written in the JAX package's layout (blocks stacked on a
leading layer axis, `utils.jax_bridge.params_to_jax`) and read back through
`utils.torch_convert.merge_pytrees`, so either package reads the other's
`params`, `next_step` and `text_features`. The optimizer state is the
port's own: {"format", "step", "exp_avg", "exp_avg_sq", "scheduler"} with
AdamW's two moments as lists, one array per trainable leaf in the tree's
own order (None for a leaf that has not been updated); a resume from a file
whose `opt_state` has another format raises. Reference torch `.pth`
checkpoints are read through utils/torch_convert.
"""

import os
import os.path as osp
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.jax_bridge import params_to_jax
from .state import TrainState, tree_leaves

CKPT_PREFIX = "checkpoint-"
OPT_STATE_FORMAT = "gava_clip_tpu_torch/adamw-1"

# async checkpoint writes: the device-to-host fetch stays SYNCHRONOUS (the
# train step updates the state in place, so the fetch must complete before
# the next step), but the pickle + disk write overlaps training on one
# writer thread. One worker keeps writes ordered (a later save of the same
# path never loses to an earlier one).
_WRITER = None
_PENDING = []
# seconds of the last save: the fetch to the host and the write apart
last_save_seconds = {"fetch": 0.0, "write": 0.0}


def _writer():
    global _WRITER
    if _WRITER is None:
        from concurrent.futures import ThreadPoolExecutor
        _WRITER = ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="ckpt-writer")
    return _WRITER


def wait_for_saves() -> None:
    """Block until ALL async checkpoint writes landed, then re-raise the
    first failure (every future is joined first: a stale error must not
    leave later writes unchecked). Call before loading a just-saved
    checkpoint (NaN rollback), at fold end, and before process exit."""
    global _PENDING
    pending, _PENDING = _PENDING, []
    first_err = None
    for fut in pending:
        try:
            fut.result()
        except Exception as e:
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def _write_payload(payload, path: str) -> str:
    import time
    t0 = time.perf_counter()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    last_save_seconds["write"] = time.perf_counter() - t0
    return path


def _trainable_leaves(state: TrainState):
    return [p for p in tree_leaves(state.trainable) if p is not None]


def opt_state_to_numpy(state: TrainState) -> Dict:
    """AdamW's moments per trainable leaf, its step count and the
    scheduler's state."""
    per_leaf = [state.optimizer.state.get(p, {})
                for p in _trainable_leaves(state)]

    def moment(name):
        return [s[name].detach().cpu().numpy() if name in s else None
                for s in per_leaf]

    steps = [float(s["step"]) for s in per_leaf if "step" in s]
    return {"format": OPT_STATE_FORMAT,
            "step": int(max(steps)) if steps else 0,
            "exp_avg": moment("exp_avg"), "exp_avg_sq": moment("exp_avg_sq"),
            "scheduler": state.scheduler.state_dict()}


def save_checkpoint(checkpoint_dir: str, state: TrainState, next_step: int,
                    text_features: Optional[np.ndarray] = None,
                    is_best: bool = False, name: str = "checkpoint",
                    async_write: bool = False) -> str:
    """Write a checkpoint.

    async_write: fetch to the host now, write on the background writer
    thread (wait_for_saves() joins). The returned path is where the file
    WILL be."""
    if not checkpoint_dir:
        return ""
    import time
    t0 = time.perf_counter()
    os.makedirs(checkpoint_dir, exist_ok=True)
    payload = {
        "params": params_to_jax(state.params),
        "opt_state": opt_state_to_numpy(state),
        "next_step": int(next_step),
        "text_features": None if text_features is None
        else np.asarray(text_features),
    }
    last_save_seconds["fetch"] = time.perf_counter() - t0
    fname = f"{name}-best.ckpt" if is_best else f"{name}-{next_step}.ckpt"
    path = osp.join(checkpoint_dir, fname)
    if async_write:
        _PENDING.append(_writer().submit(_write_payload, payload, path))
        return path
    return _write_payload(payload, path)


def _orbax_not_ported():
    # orbax needs JAX, which the port never imports (ROADMAP A10b)
    return NotImplementedError(
        "Orbax checkpoint directories are not read by the port (they need "
        "JAX; ROADMAP A10b). Convert one on a machine with JAX: payload = "
        "gava_clip_tpu.train.checkpoint.load_checkpoint(DIR), then "
        "pickle.dump(payload, open('NAME.ckpt', 'wb')); the port loads the "
        ".ckpt")


def save_checkpoint_orbax(*args, **kwargs) -> str:
    raise _orbax_not_ported()


def load_checkpoint_orbax(*args, **kwargs) -> Dict[str, Any]:
    raise _orbax_not_ported()


def load_checkpoint(path: str) -> Dict[str, Any]:
    if path.endswith(".orbax") or osp.isdir(path):
        raise _orbax_not_ported()
    if path.endswith(".pth"):  # reference torch checkpoint
        raw = torch.load(path, map_location="cpu", weights_only=False)
        sd = raw.get("model", raw)
        sd = {k[len("module."):] if k.startswith("module.") else k:
              np.asarray(v.detach().cpu().numpy()) if hasattr(v, "detach")
              else v for k, v in sd.items()}
        return {"torch_state_dict": sd,
                "next_step": raw.get("next_step", 0),
                "text_features": (np.asarray(raw["text_features"])
                                  if "text_features" in raw else None)}
    with open(path, "rb") as f:
        return _Unpickler(f).load()


class _Opaque:
    """Stands in for an object whose class cannot be imported here."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    """A checkpoint of the JAX package pickles its optimizer state as
    optax objects. Where that library is not installed they load as opaque
    placeholders, so that `params`, `next_step` and `text_features` of such
    a file can still be read (--pretrain, cli.evaluate)."""

    def _import(self, module, name):
        return super().find_class(module, name)

    def find_class(self, module, name):
        try:
            return self._import(module, name)
        except (ImportError, AttributeError):
            return _Opaque


def find_autoresume_path(checkpoint_dir: str) -> Optional[str]:
    """Highest checkpoint-<N> in the dir."""
    if not checkpoint_dir or not osp.isdir(checkpoint_dir):
        return None
    best = None
    for fn in os.listdir(checkpoint_dir):
        m = re.fullmatch(rf"{CKPT_PREFIX}(\d+)\.ckpt", fn)
        if m:
            step = int(m.group(1))
            if best is None or step > best[0]:
                best = (step, osp.join(checkpoint_dir, fn))
    return best[1] if best else None


def load_params_into(state: TrainState, params: Dict) -> None:
    """Copy `params` (a checkpoint's tree, JAX layout or the port's; a
    partial tree for a non-strict overlay) into the state's leaves IN
    PLACE, trainable and frozen alike. A leaf of another shape raises."""
    from ..utils.torch_convert import merge_pytrees
    current = state.params
    merged = merge_pytrees(current, params)
    with torch.no_grad():
        for cur, new in zip(tree_leaves(current), tree_leaves(merged)):
            if new is cur:
                continue
            if tuple(new.shape) != tuple(cur.shape):
                raise ValueError(f"checkpoint leaf of shape "
                                 f"{tuple(new.shape)}, the model's is "
                                 f"{tuple(cur.shape)}")
            cur.copy_(new.to(cur.dtype))


def _load_opt_state(state: TrainState, opt_state, path: str) -> None:
    if not isinstance(opt_state, dict) or \
            opt_state.get("format") != OPT_STATE_FORMAT:
        raise ValueError(
            f"{path}: its opt_state is not this package's "
            f"({OPT_STATE_FORMAT}): a run can resume only from a checkpoint "
            f"written by gava_clip_tpu_torch; pass the file as --pretrain to "
            f"take its weights alone")
    opt, leaves = state.optimizer, _trainable_leaves(state)
    if len(opt_state["exp_avg"]) != len(leaves):
        raise ValueError(f"{path}: moments for "
                         f"{len(opt_state['exp_avg'])} leaves, the model "
                         f"trains {len(leaves)}")
    step = float(opt_state["step"])
    for p, m1, m2 in zip(leaves, opt_state["exp_avg"],
                         opt_state["exp_avg_sq"]):
        if m1 is None:
            continue
        if m1.shape != tuple(p.shape):
            raise ValueError(f"{path}: a moment of shape {m1.shape} for a "
                             f"leaf of shape {tuple(p.shape)}")
        opt.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.from_numpy(m1).to(p.device, p.dtype),
            "exp_avg_sq": torch.from_numpy(m2).to(p.device, p.dtype)}
    state.scheduler.load_state_dict(opt_state["scheduler"])
    # the schedule's rate of the next update, as the scheduler left it
    for group, lr in zip(opt.param_groups, state.scheduler.get_last_lr()):
        group["lr"] = lr


def resume_from_checkpoint(state: TrainState, mask, args
                           ) -> Tuple[TrainState, int, Optional[np.ndarray]]:
    """Apply the pretrain / resume policy. Updates `state` in place and
    returns (state, resume_step, text_features). `mask` is kept so that a
    call reads like the JAX one."""
    if getattr(args, "pretrain", None):
        ckpt = load_checkpoint(args.pretrain)
        if "params" in ckpt:
            load_params_into(state, ckpt["params"])

    resume_path = getattr(args, "resume_path", None)
    if getattr(args, "auto_resume", False) and resume_path is None:
        resume_path = find_autoresume_path(args.checkpoint_dir)
    if resume_path is None:
        return state, 0, None

    ckpt = load_checkpoint(resume_path)
    _load_opt_state(state, ckpt.get("opt_state"), resume_path)
    load_params_into(state, ckpt["params"])
    next_step = int(ckpt["next_step"])
    state.step = next_step
    return state, next_step, ckpt.get("text_features")
