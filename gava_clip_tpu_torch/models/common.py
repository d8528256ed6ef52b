"""Parameter-init helpers (port of gava_clip_tpu/models/common.py).

The same distributions as the JAX helpers, drawn from a `torch.Generator`
(so other numbers than `jax.random` gives for the same seed). Parameters
are dicts of tensors in the JAX layout: kernels (in_dim, out_dim).
"""

import math
from typing import Dict, Tuple

import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested parameter dict as a module, so that parameter names mirror
    the JAX pytree paths (`blocks.3.attn.q.kernel`). Dicts become child
    ParamTrees, lists (the per-layer blocks) `nn.ModuleList`s, tensors frozen
    `nn.Parameter`s. `tree["k"]`, `tree.get("k")` and `"k" in tree` read it
    like the dict it came from; `to_dict()` gives the dict back."""

    def __init__(self, tree: Dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def _keys(self):
        return list(self._parameters) + list(self._modules)

    def __getitem__(self, key):
        if key not in self._keys():
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._keys()

    def get(self, key, default=None):
        return getattr(self, key) if key in self else default

    def to_dict(self) -> Dict:
        out = {k: p.data for k, p in self._parameters.items()}
        for k, m in self._modules.items():
            out[k] = ([c.to_dict() for c in m] if isinstance(m, nn.ModuleList)
                      else m.to_dict())
        return out


def _on_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def uniform(gen: torch.Generator, shape, low: float, high: float,
            device=None) -> torch.Tensor:
    """U(low, high) float32; on the meta device only the shape is made."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t if _on_meta(device) else t.uniform_(low, high, generator=gen)


def normal(gen: torch.Generator, shape, std: float = 1.0,
           device=None) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t if _on_meta(device) else t.normal_(0.0, std, generator=gen)


def xavier_uniform(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return uniform(gen, shape, -limit, limit, device)


def init_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                bias_std: float = 0.0, xavier: bool = True,
                device=None) -> Dict[str, torch.Tensor]:
    """Linear params: xavier-uniform kernel (reference Attention/MLP init)
    or the torch nn.Linear default U(+-1/sqrt(in)) for kernel and bias."""
    if xavier:
        kernel = xavier_uniform(gen, (in_dim, out_dim), device)
    else:
        limit = 1.0 / math.sqrt(in_dim)
        kernel = uniform(gen, (in_dim, out_dim), -limit, limit, device)
    if bias_std > 0:
        bias = normal(gen, (out_dim,), bias_std, device)
    elif not xavier:
        limit = 1.0 / math.sqrt(in_dim)
        bias = uniform(gen, (out_dim,), -limit, limit, device)
    else:
        bias = torch.zeros(out_dim, device=device)
    return {"kernel": kernel, "bias": bias}


def init_layer_norm(dim: int, device=None) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def init_attention(gen: torch.Generator, dim: int,
                   device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    return {n: init_linear(gen, dim, dim, device=device)
            for n in ("q", "k", "v", "out")}


def prompt_init_limit(patch_size: Tuple[int, int], prompt_dim: int) -> float:
    """VPT-style xavier-uniform limit of the local/global prompt tokens."""
    return math.sqrt(6.0 / float(3 * patch_size[0] * patch_size[1]
                                 + prompt_dim))
