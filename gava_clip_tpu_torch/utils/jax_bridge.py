"""Parameters of the JAX package <-> parameters of the port.

The JAX `VitaClip.params` is a nested dict of numpy arrays whose vision
blocks are stacked on a leading layer axis; the port keeps one dict per
layer in a list. Every other path and the (in, out) kernel layout are the
same. Neither direction needs JAX.
"""

from typing import Dict, Mapping

import numpy as np
import torch

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
        if missing:
            raise KeyError(f"{path or 'params'}: missing leaves {missing}")
        if unused:
            raise KeyError(f"{path or 'params'}: unused leaves {unused}")
        return {k: _convert(src[k], expected[k], f"{path}.{k}".lstrip("."),
                            device)
                for k in expected}
    if isinstance(src, Mapping):
        raise NotImplementedError(
            f"{path}: quantized leaves are not ported yet (ROADMAP A5)")
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(expected.shape):
        raise ValueError(f"{path}: shape {arr.shape}, expected "
                         f"{tuple(expected.shape)}")
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(params: Mapping, cfg: VitaClipConfig,
                    device=None) -> Dict:
    """JAX zero-shot VitaClip params -> the port's params, every shape
    checked; a missing or unused leaf raises."""
    expected = init_vita_clip_params(None, cfg, device="meta")
    return _convert(params, expected, "", device)


def params_to_jax(params: Mapping) -> Dict:
    """The port's params -> the JAX layout (numpy, stacked blocks)."""
    def to_np(x):
        if isinstance(x, Mapping):
            return {k: to_np(v) for k, v in x.items()}
        if isinstance(x, list):
            return _stack([to_np(v) for v in x])
        return x.detach().float().cpu().numpy()

    def _stack(layers):
        if isinstance(layers[0], dict):
            return {k: _stack([l[k] for l in layers]) for k in layers[0]}
        return np.stack(layers)

    return to_np(params)
