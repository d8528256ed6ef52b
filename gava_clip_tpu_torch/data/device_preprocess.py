"""On-device preprocessing: uint8 frames -> normalized float (port of
gava_clip_tpu/data/device_preprocess.py, the serving part)."""

from typing import Sequence

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DEFAULT_MEAN = (0.45, 0.45, 0.45)   # loader defaults
DEFAULT_STD = (0.225, 0.225, 0.225)


def normalize_frames(frames: torch.Tensor,
                     mean: Sequence[float] = DEFAULT_MEAN,
                     std: Sequence[float] = DEFAULT_STD,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """uint8/float (..., 3) -> normalized float ((x/255 - mean) / std)."""
    x = frames.to(compute_dtype)
    if frames.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(mean, dtype=compute_dtype, device=frames.device)
    std = torch.tensor(std, dtype=compute_dtype, device=frames.device)
    return (x - mean) / std
