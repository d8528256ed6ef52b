"""On-device preprocessing: uint8 frames -> normalized float (port of
gava_clip_tpu/data/device_preprocess.py: the normalize and the mirror-only
training augmentation; RandAugment and random erasing wait for ROADMAP
A8)."""

from typing import Optional, Sequence

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


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one training step's augmentation, a function of
    (seed, step) alone: a resumed run repeats the draws of the run it
    continues (JAX: `fold_in(aug_key, step)`)."""
    return torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63 - 1))


def make_train_augment(auto_augment: Optional[str], mirror: bool,
                       mean=DEFAULT_MEAN, std=DEFAULT_STD,
                       erase_prob: float = 0.0):
    """Train-time augmentation on the device: uint8 (B, T, H, W, 3) + a
    generator -> normalized float batch: horizontal mirror per clip with
    probability 0.5, then normalize.

    augment(gen, frames_u8, flip=None): `gen` is a CPU `torch.Generator`
    (see `step_generator`); the B flip decisions are drawn on the host and
    applied on frames_u8's device. `flip` (B,) bool overrides the draw."""
    if auto_augment:
        raise NotImplementedError(
            "auto_augment: RandAugment on the device is not ported yet "
            "(ROADMAP A8)")
    if erase_prob > 0:
        raise NotImplementedError(
            "erase_prob > 0: random erasing on the device is not ported yet "
            "(ROADMAP A8)")

    def augment(gen: Optional[torch.Generator], frames_u8: torch.Tensor,
                flip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = frames_u8.float() / 255.0
        if mirror:
            if flip is None:
                flip = torch.rand(x.shape[0], generator=gen) < 0.5
            flip = flip.to(x.device, non_blocking=True)
            x = torch.where(flip[:, None, None, None, None], x.flip(3), x)
        m = torch.tensor(mean, dtype=x.dtype, device=x.device)
        s = torch.tensor(std, dtype=x.dtype, device=x.device)
        return (x - m) / s

    return augment
