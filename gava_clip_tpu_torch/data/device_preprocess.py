"""On-device preprocessing: uint8 frames -> normalized float (port of
gava_clip_tpu/data/device_preprocess.py): the normalize, the training
augmentation (RandAugment, horizontal mirror, random erasing, normalize,
on the frames' device), and the float validation path (keep-aspect
resize, center crop) of the reference's torch pipeline."""

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from .rand_augment import (draw_rand_augment, parse_rand_augment_config,
                           rand_augment_batch)
from .random_erasing import (RandomErasingConfig, draw_random_erasing,
                             random_erasing_batch)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DEFAULT_MEAN = (0.45, 0.45, 0.45)   # loader defaults
DEFAULT_STD = (0.225, 0.225, 0.225)


def _consts(values, like: torch.Tensor) -> torch.Tensor:
    """Host constants on like's device in like's dtype, copied without
    waiting for the device (a blocking copy drains the stream)."""
    return torch.tensor(values, dtype=like.dtype).to(like.device,
                                                     non_blocking=True)


def normalize_frames(frames: torch.Tensor,
                     mean: Sequence[float] = DEFAULT_MEAN,
                     std: Sequence[float] = DEFAULT_STD,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """uint8/float (..., 3) -> normalized float ((x/255 - mean) / std)."""
    x = frames.to(compute_dtype)
    if frames.dtype == torch.uint8:
        x = x / 255.0
    return (x - _consts(mean, x)) / _consts(std, x)


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
    generator -> normalized float batch. In JAX's order: RandAugment (when
    `auto_augment` names a policy, `rand-mN-nN-mstdF-inc1`), a horizontal
    mirror per clip with probability 0.5, random erasing (erase_prob > 0,
    in [0, 1] space), then the normalize.

    augment(gen, frames_u8, flip=None, draws=None): `gen` is a CPU
    `torch.Generator` (see `step_generator`); every decision is drawn on
    the host from it, in that order, and applied on frames_u8's device (the
    erasing fill is drawn there, from a generator seeded by `gen`).
    `augment.draw(gen, shape, device)` returns the draws of one batch
    ({'rand_augment', 'flip', 'erase'}, those that are on); `draws` hands
    them in in place of `gen`, and `flip` (B,) bool overrides the mirror's."""
    ra_cfg = parse_rand_augment_config(auto_augment) if auto_augment \
        else None
    er_cfg = RandomErasingConfig(probability=erase_prob) \
        if erase_prob > 0 else None

    def draw(gen: Optional[torch.Generator], shape, device) -> Dict:
        out = {}
        if ra_cfg is not None:
            out["rand_augment"] = draw_rand_augment(gen, shape[0], ra_cfg)
        if mirror:
            out["flip"] = torch.rand(shape[0], generator=gen) < 0.5
        if er_cfg is not None:
            out["erase"] = draw_random_erasing(gen, shape, device, er_cfg)
        return out

    def augment(gen: Optional[torch.Generator], frames_u8: torch.Tensor,
                flip: Optional[torch.Tensor] = None,
                draws: Optional[Dict] = None) -> torch.Tensor:
        if draws is None:
            draws = draw(gen, frames_u8.shape, frames_u8.device)
        x = frames_u8.float() / 255.0
        if ra_cfg is not None:
            x = rand_augment_batch(None, x, auto_augment,
                                   draws["rand_augment"])
        if mirror:
            flip = (draws["flip"] if flip is None else flip).to(
                x.device, non_blocking=True)
            x = torch.where(flip[:, None, None, None, None], x.flip(3), x)
        if er_cfg is not None:
            x = random_erasing_batch(None, x, er_cfg, draws["erase"])
        return (x - _consts(mean, x)) / _consts(std, x)

    augment.draw = draw
    return augment


def keep_aspect_resize(frames: torch.Tensor,
                       spatial_size: int) -> torch.Tensor:
    """Bilinear short-side resize of float frames (..., H, W, C), as
    `jax.image.resize(..., "bilinear")`: half-pixel centers, and when it
    downsamples a triangle filter widened by the scale (antialiased), which
    `F.interpolate(..., antialias=True)` computes too."""
    H, W = frames.shape[-3:-1]
    if H < W:
        new_h, new_w = spatial_size, W * spatial_size // H
    else:
        new_h, new_w = H * spatial_size // W, spatial_size
    lead = frames.shape[:-3]
    x = frames.reshape(-1, H, W, frames.shape[-1]).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).reshape(*lead, new_h, new_w,
                                         frames.shape[-1])


def center_crop(frames: torch.Tensor, size: int) -> torch.Tensor:
    H, W = frames.shape[-3:-1]
    h0, w0 = (H - size) // 2, (W - size) // 2
    return frames[..., h0:h0 + size, w0:w0 + size, :]


def val_preprocess_float(frames: torch.Tensor, spatial_size: int,
                         mean=DEFAULT_MEAN, std=DEFAULT_STD) -> torch.Tensor:
    """The reference's validation pipeline on float frames in [0, 1]:
    normalize -> keep-aspect resize -> center crop."""
    x = (frames - _consts(mean, frames)) / _consts(std, frames)
    x = keep_aspect_resize(x, spatial_size)
    return center_crop(x, spatial_size)
