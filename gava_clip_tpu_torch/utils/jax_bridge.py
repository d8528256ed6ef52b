"""Parameters of the JAX package <-> parameters of the port.

The JAX `VitaClip.params` is a nested dict of numpy arrays whose vision
and text blocks are stacked on a leading layer axis; the port keeps one
dict per layer in a list. Every other path (`visual`, `textual`, `prompt`,
the heads, the scalar logit scales) and the (in, out) kernel layout are the
same. The buffers (`token_prefix`, `token_suffix`, `kv_mask`, `pool_idx`,
`cntn_embeds`, `text_features`) cross as they are. Gradients and a train
state go back to the JAX layout with None where the JAX partition has None,
so that a test can set `jax.grad`'s tree beside the port's leaf by leaf.
The text tower alone and the DeCap decoder cross the same way
(`text_params_from_jax`, `decap_params_from_jax`; `params_to_jax` takes
any of the port's trees back). Neither direction needs JAX.

Quantized trees (ops/quant.py) go across both ways: a w8a8 leaf
{'qa': int8 (L, K, N), 'scale': fp32 (L, 1, N)}, a weight-only leaf
{'q', 'scale'} or a frozen-training leaf {'qt', 'scale'} becomes per-layer
leaves of the same keys, and the patch-embed sidecar `kernel_q8` goes with
it; int8 stays int8 and scales stay fp32. The W^T copies the CUDA kernels
read are added where the weights are placed
(`ops.int8_matmul.with_kernel_layout`), not here.
"""

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.decap import DecapConfig, init_decap_params
from ..models.text import TextConfig, init_text_params
from ..models.vita_clip import VitaClipConfig, init_vita_clip_params


def _take(src, i: int, n: int, path: str):
    """Layer i of a stacked (n, ...) subtree."""
    if isinstance(src, Mapping):
        return {k: _take(v, i, n, f"{path}.{k}") for k, v in src.items()}
    arr = np.asarray(src)
    if arr.shape[:1] != (n,):
        raise ValueError(f"{path}: expected a leading layer axis of {n}, "
                         f"got shape {arr.shape}")
    return arr[i]


def _convert_quant(src, expected, path: str, device):
    """A quantized kernel leaf whose float form has expected's shape."""
    keys = set(src)
    key = next((k for k in ("qa", "q", "qt") if keys == {k, "scale"}), None)
    if key is None:
        raise KeyError(f"{path}: not a quantized leaf: keys {sorted(keys)}")
    q, scale = np.asarray(src[key]), np.asarray(src["scale"])
    K, N = tuple(expected.shape)
    if q.dtype != np.int8 or q.shape != (K, N) or \
            scale.shape != (1, N) or scale.dtype != np.float32:
        raise ValueError(f"{path}: {key} {q.dtype} {q.shape} / scale "
                         f"{scale.dtype} {scale.shape}, expected int8 "
                         f"({K}, {N}) / float32 (1, {N})")
    return {key: torch.from_numpy(np.array(q)).to(device),
            "scale": torch.from_numpy(np.array(scale)).to(device)}


def _convert(src, expected, path: str, device):
    if isinstance(expected, list):
        return [_convert(_take(src, i, len(expected), path), e,
                         f"{path}.{i}", device)
                for i, e in enumerate(expected)]
    if isinstance(expected, dict):
        if not isinstance(src, Mapping):
            raise TypeError(f"{path}: expected a dict, got {type(src)}")
        missing = sorted(set(expected) - set(src))
        unused = sorted(set(src) - set(expected))
        if unused == ["kernel_q8"] and "kernel" in expected:
            out = _convert({k: v for k, v in src.items() if k != unused[0]},
                           expected, path, device)
            out["kernel_q8"] = _convert_quant(
                src["kernel_q8"], expected["kernel"],
                f"{path}.kernel_q8".lstrip("."), device)
            return out
        if missing:
            raise KeyError(f"{path or 'params'}: missing leaves {missing}")
        if unused:
            raise KeyError(f"{path or 'params'}: unused leaves {unused}")
        return {k: _convert(src[k], expected[k], f"{path}.{k}".lstrip("."),
                            device)
                for k in expected}
    if isinstance(src, Mapping):
        return _convert_quant(src, expected, path, device)
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(expected.shape):
        raise ValueError(f"{path}: shape {arr.shape}, expected "
                         f"{tuple(expected.shape)}")
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(params: Mapping, cfg: VitaClipConfig,
                    device=None) -> Dict:
    """JAX VitaClip params (the whole tree that cfg asks for) -> the port's
    params, every shape checked; a missing or unused leaf raises."""
    expected = init_vita_clip_params(None, cfg, device="meta")
    return _convert(params, expected, "", device)


def text_params_from_jax(params: Mapping, cfg: TextConfig,
                         device=None) -> Dict:
    """A JAX `init_text_params` tree (the text tower alone, blocks stacked)
    -> the port's `models/text.py` params; every shape checked, a missing or
    unused leaf raises."""
    expected = init_text_params(None, cfg, device="meta")
    return _convert(params, expected, "", device)


def decap_params_from_jax(params: Mapping, cfg: DecapConfig,
                          device=None) -> Dict:
    """JAX DeCap params (blocks stacked) -> the port's `models/decap.py`
    params (one dict a layer); every shape checked, a missing or unused
    leaf raises. `params_to_jax` takes them back."""
    expected = init_decap_params(None, cfg, device="meta")
    return _convert(params, expected, "", device)


def params_to_jax(params: Mapping) -> Dict:
    """The port's params -> the JAX layout (numpy, stacked blocks). Every
    leaf keeps its dtype (int8 stays int8), except bf16, which numpy lacks:
    it becomes float32."""
    def to_np(x):
        if x is None:
            return None
        if isinstance(x, Mapping):
            return {k: to_np(v) for k, v in x.items()}
        if isinstance(x, list):
            return _stack([to_np(v) for v in x])
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    def _stack(layers):
        if isinstance(layers[0], dict):
            return {k: _stack([l[k] for l in layers]) for k in layers[0]}
        if layers[0] is None:       # a leaf frozen in every layer
            return None
        return np.stack(layers)

    return to_np(params)


_BUFFERS = ("token_prefix", "token_suffix", "kv_mask", "pool_idx",
            "cntn_embeds", "text_features")


def buffers_from_jax(buffers: Mapping, device=None) -> Dict:
    """JAX `VitaClip.buffers` -> tensors; an unknown buffer raises."""
    unknown = sorted(set(buffers) - set(_BUFFERS))
    if unknown:
        raise KeyError(f"buffers: unused leaves {unknown}")
    return {k: torch.from_numpy(np.array(np.asarray(v))).to(device)
            for k, v in buffers.items()}


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def grads_to_jax(trainable: Mapping) -> Dict:
    """The `.grad` of every leaf of a TrainState's trainable tree, in the
    JAX layout (numpy, stacked blocks); None where the leaf is frozen. A
    trainable leaf without a gradient raises."""
    def grad(t):
        if t is None:
            return None
        if t.grad is None:
            raise ValueError("a trainable leaf has no gradient")
        return t.grad
    return params_to_jax(_map(grad, trainable))


def train_state_to_jax(state) -> Dict:
    """A TrainState in the JAX layout: step, the trainable and frozen
    halves (None placeholders as in the JAX partition) and AdamW's first
    and second moments `mu` / `nu` shaped like `trainable` (None for a
    leaf that has not been updated yet)."""
    def moment(name):
        def get(t):
            if t is None:
                return None
            return state.optimizer.state.get(t, {}).get(name)
        return params_to_jax(_map(get, state.trainable))
    return {"step": state.step,
            "trainable": params_to_jax(state.trainable),
            "frozen": params_to_jax(state.frozen),
            "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
