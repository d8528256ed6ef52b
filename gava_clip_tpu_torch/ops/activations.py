"""Elementwise activations (port of gava_clip_tpu/ops/activations.py)."""

import torch


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 * x) — CLIP's GELU approximation."""
    return x * torch.sigmoid(1.702 * x)
