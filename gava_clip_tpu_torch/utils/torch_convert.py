"""Reference PyTorch checkpoint -> the port's parameter tree (port of
gava_clip_tpu/utils/torch_convert.py; needs no JAX).

Understands the reference checkpoint layouts:
  * CLIP backbone `clip_pretrained.pth`: flat state dict with `visual.*` /
    `textual.*` prefixes;
  * training checkpoints: {'model': DDP `module.`-prefixed state dict,
    'optimizer', 'lr_sched', 'loss_scaler', 'next_step', 'text_features'}.

Kernels are transposed to (in_dim, out_dim); the patch conv is reshaped to
the GEMM layout used by models/vision.py; packed nn.MultiheadAttention
in-projections are split into q/k/v. The converters return numpy leaves in
the port's layout: `blocks` is a list with one dict per layer (the JAX
package stacks the layers on a leading axis). `merge_pytrees` overlays
such a tree, or one in the JAX layout (a checkpoint's `params`), on the
port's tensors.
"""

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth file into a flat {name: np.ndarray} dict (on the host)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt and isinstance(ckpt["model"], dict):
        ckpt = ckpt["model"]
    return {k: _np(v) for k, v in ckpt.items() if hasattr(v, "shape")}


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _lin(sd, name) -> Dict[str, np.ndarray]:
    p = {"kernel": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        p["bias"] = sd[f"{name}.bias"]
    return p


def _ln(sd, name) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _attn_separate(sd, name) -> Dict:
    """Reference vision Attention: separate q/k/v/out projections."""
    return {"q": _lin(sd, f"{name}.q_proj"), "k": _lin(sd, f"{name}.k_proj"),
            "v": _lin(sd, f"{name}.v_proj"), "out": _lin(sd, f"{name}.out_proj")}


def _attn_packed(sd, name) -> Dict:
    """torch nn.MultiheadAttention: packed (3W, W) in-projection."""
    w = sd[f"{name}.in_proj_weight"]
    b = sd[f"{name}.in_proj_bias"]
    d = w.shape[1]
    return {
        "q": {"kernel": w[:d].T, "bias": b[:d]},
        "k": {"kernel": w[d:2 * d].T, "bias": b[d:2 * d]},
        "v": {"kernel": w[2 * d:].T, "bias": b[2 * d:]},
        "out": _lin(sd, f"{name}.out_proj"),
    }


def convert_vision_tower(sd: Dict[str, np.ndarray], num_layers: int) -> Dict:
    """Convert a `visual.`-stripped reference state dict to the port's
    tree (`blocks` a per-layer list)."""
    conv_w = sd["patch_embed.proj.weight"]          # (D, 3, ph, pw)
    D = conv_w.shape[0]
    kernel = conv_w.transpose(2, 3, 1, 0).reshape(-1, D)  # (ph*pw*3, D)
    patch = {"kernel": kernel}
    if "patch_embed.proj.bias" in sd:
        patch["bias"] = sd["patch_embed.proj.bias"]
    else:
        patch["bias"] = np.zeros((D,), kernel.dtype)

    blocks = []
    for i in range(num_layers):
        b = f"blocks.{i}"
        blk = {
            "attn": _attn_separate(sd, f"{b}.attn"),
            "norm1": _ln(sd, f"{b}.norm1"),
            "mlp": {"fc1": _lin(sd, f"{b}.mlp.fc1"), "fc2": _lin(sd, f"{b}.mlp.fc2")},
            "norm2": _ln(sd, f"{b}.norm2"),
        }
        if f"{b}.cls_proj.weight" in sd:
            blk["cls_proj"] = _lin(sd, f"{b}.cls_proj")
        if f"{b}.summary_ln.weight" in sd:
            blk["summary_ln"] = _ln(sd, f"{b}.summary_ln")
            blk["summary_attn"] = _attn_separate(sd, f"{b}.summary_attn_layer")
        if f"{b}.local_prompts" in sd:
            blk["local_prompts"] = sd[f"{b}.local_prompts"]
        blocks.append(blk)

    params = {
        "patch_embed": patch,
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "time_embed": sd["time_embed"],
        "blocks": blocks,
        "ln_pre": _ln(sd, "ln_pre"),
        "ln_post": _ln(sd, "ln_post"),
        "proj": sd["proj"],
    }
    if "global_prompts" in sd:
        params["global_prompts"] = sd["global_prompts"]
    return params


def convert_text_tower(sd: Dict[str, np.ndarray], num_layers: int) -> Dict:
    """Convert a `textual.`-stripped reference state dict to the port's
    tree (`blocks` a per-layer list)."""
    blocks = []
    for i in range(num_layers):
        b = f"transformer.resblocks.{i}"
        blocks.append({
            "attn": _attn_packed(sd, f"{b}.attn"),
            "ln_1": _ln(sd, f"{b}.ln_1"),
            "mlp": {"fc1": _lin(sd, f"{b}.mlp.c_fc"), "fc2": _lin(sd, f"{b}.mlp.c_proj")},
            "ln_2": _ln(sd, f"{b}.ln_2"),
        })
    return {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "blocks": blocks,
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }


def convert_vita_clip(sd: Dict[str, np.ndarray], *, vision_layers: int,
                      text_layers: int, num_classes: int,
                      prompt_variant: Optional[str] = None) -> Dict:
    """Convert a full reference VitaCLIP state dict (``module.`` already
    stripped) into the port's parameter tree.

    prompt_variant: None (no KAPT projector), 'class_uni' (the exercised
    "split_uni" path: per-class bias-free MLPs), or 'plain_uni' (a single
    MLP with bias).
    """
    params: Dict = {}
    vis = strip_prefix(sd, "visual.")
    if vis:
        params["visual"] = convert_vision_tower(vis, vision_layers)
    txt = strip_prefix(sd, "textual.")
    if txt:
        params["textual"] = convert_text_tower(txt, text_layers)

    if "prompt_learner.ctx" in sd:
        prompt: Dict = {"ctx": sd["prompt_learner.ctx"]}
        pfx = "prompt_learner.context_prompt_learner.projector"
        if prompt_variant == "class_uni":
            prompt["projector"] = {
                "w1": np.stack([sd[f"{pfx}.{c}.0.weight"].T for c in range(num_classes)]),
                "w2": np.stack([sd[f"{pfx}.{c}.2.weight"].T for c in range(num_classes)]),
            }
        elif prompt_variant == "plain_uni":
            prompt["projector"] = {
                "w1": sd[f"{pfx}.0.weight"].T, "b1": sd[f"{pfx}.0.bias"],
                "w2": sd[f"{pfx}.2.weight"].T, "b2": sd[f"{pfx}.2.bias"],
            }
        params["prompt"] = prompt

    for scale in ("logit_scale", "logit_bias", "logit_scale_vm",
                  "logit_scale_mt", "logit_bias_mt"):
        if scale in sd:
            params[scale] = sd[scale]
    if "sum_proj.weight" in sd:
        params["sum_proj"] = _lin(sd, "sum_proj")
    if "tf_project.0.weight" in sd:
        params["tf_project"] = {
            "fc1": {"kernel": sd["tf_project.0.weight"].T, "bias": sd["tf_project.0.bias"]},
            "fc2": {"kernel": sd["tf_project.2.weight"].T, "bias": sd["tf_project.2.bias"]},
        }
    if "memory_project.0.0.weight" in sd:
        params["memory_project"] = {
            "w1": np.stack([sd[f"memory_project.{c}.0.weight"].T for c in range(num_classes)]),
            "b1": np.stack([sd[f"memory_project.{c}.0.bias"] for c in range(num_classes)]),
            "w2": np.stack([sd[f"memory_project.{c}.2.weight"].T for c in range(num_classes)]),
            "b2": np.stack([sd[f"memory_project.{c}.2.bias"] for c in range(num_classes)]),
        }
    return params


def adapt_frame_params(tree: Dict, num_frames: int) -> Dict:
    """Adapt frame-indexed params loaded from a checkpoint trained at a
    different num_frames to an eval model built at `num_frames`.

    Only `local_prompts` needs this: its frame axis is baked into the param
    shape. When divisible, tile by T // T_train (the reference's
    token_multiplier semantics); otherwise nearest-resize like time_embed.
    time_embed itself needs NO adaptation: resize_time_embed reads the
    param shape at run time. Works on numpy trees in either layout (the
    frame axis is the last but one)."""
    if isinstance(tree, list):
        return [adapt_frame_params(v, num_frames) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = adapt_frame_params(v, num_frames)
        elif k == "local_prompts" and v.shape[-2] != num_frames:
            t_train = v.shape[-2]
            if num_frames % t_train == 0:
                reps = [1] * v.ndim
                reps[-2] = num_frames // t_train
                out[k] = np.tile(np.asarray(v), reps)
            else:
                idx = (np.arange(num_frames) * t_train) // num_frames
                out[k] = np.asarray(v)[..., idx, :]
        else:
            out[k] = v
    return out


def _leaf(v, like) -> torch.Tensor:
    """An overlay leaf as a tensor on the base leaf's device."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(np.asarray(v)))
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def _layer(tree, i: int):
    """Layer i of a subtree stacked on a leading axis (the JAX layout)."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def merge_pytrees(base: Dict, overlay: Mapping) -> Dict:
    """Non-strict overlay (the analogue of load_state_dict(strict=False)):
    leaves present in `overlay` replace those in `base`, recursively.
    `base` is the port's tree of tensors. `overlay` holds numpy arrays or
    tensors, with per-layer lists where `base` has them or, as a
    checkpoint's `params` do, one dict of arrays stacked on a leading layer
    axis in their place. New leaves are tensors on the device of the leaf
    they replace."""
    out = dict(base)
    for k, v in overlay.items():
        cur = out.get(k)
        if isinstance(cur, list):
            layers = v if isinstance(v, list) else \
                [_layer(v, i) for i in range(len(cur))]
            if len(layers) != len(cur):
                raise ValueError(f"{k}: {len(layers)} layers in the overlay, "
                                 f"{len(cur)} in the model")
            out[k] = [merge_pytrees(c, l) if isinstance(c, dict)
                      else _leaf(l, c) for c, l in zip(cur, layers)]
        elif isinstance(cur, dict) and isinstance(v, Mapping):
            out[k] = merge_pytrees(cur, v)
        elif isinstance(v, Mapping):
            out[k] = merge_pytrees({}, v)
        elif isinstance(v, list):
            out[k] = [merge_pytrees({}, l) if isinstance(l, Mapping)
                      else _leaf(l, None) for l in v]
        else:
            out[k] = _leaf(v, cur)
    return out
