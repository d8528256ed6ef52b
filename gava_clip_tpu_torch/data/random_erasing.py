"""RandomErasing on the device (port of
gava_clip_tpu/data/random_erasing.py): timm-style erase boxes over a batch
of clips, with Inception-style area / aspect sampling, `cube=True`
temporal consistency (the same box and noise erase every frame of a clip),
per-pixel gaussian fill ('rand' mode) and a per-clip probability.

The boxes and the application are drawn on the host from a CPU
`torch.Generator`; the gaussian fill is drawn on the clips' device from a
generator seeded by the host generator, so the draws of a step depend on
the host generator alone (a resumed run repeats them) and the fill never
crosses from the host. Boxes are realised as coordinate masks, so one set
of launches erases every clip of the batch.
"""

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class RandomErasingConfig:
    probability: float = 0.25
    min_area: float = 0.02
    max_area: float = 1.0 / 3.0
    min_aspect: float = 0.3
    max_aspect: float = 1.0 / 0.3
    mode: str = "rand"          # 'rand' (gaussian) | 'const' (zeros)
    min_count: int = 1
    max_count: int = 1
    cube: bool = True           # same box across the clip's frames


def box_size(u_area: torch.Tensor, u_ratio: torch.Tensor, H: int, W: int,
             cfg: RandomErasingConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, w) int32 of boxes from uniforms in [0, 1) for the area and the
    log aspect ratio, in float32 as JAX's `_sample_box` computes them."""
    lo = torch.tensor(math.log(cfg.min_aspect), dtype=torch.float32)
    hi = torch.tensor(math.log(cfg.max_aspect), dtype=torch.float32)
    a_lo = torch.tensor(cfg.min_area, dtype=torch.float32)
    a_hi = torch.tensor(cfg.max_area, dtype=torch.float32)
    u_area, u_ratio = u_area.float(), u_ratio.float()
    target = (H * W) * (a_lo + u_area * (a_hi - a_lo))
    ratio = torch.exp(lo + u_ratio * (hi - lo))
    h = torch.clamp(torch.sqrt(target * ratio).to(torch.int32), 1, H)
    w = torch.clamp(torch.sqrt(target / ratio).to(torch.int32), 1, W)
    return h, w


def _sample_box(gen: Optional[torch.Generator], n: int, H: int, W: int,
                cfg: RandomErasingConfig) -> torch.Tensor:
    """(n, 4) int64 boxes (top, left, h, w) drawn on the host."""
    u = torch.rand(n, 4, generator=gen)
    h, w = box_size(u[:, 0], u[:, 1], H, W, cfg)
    top = (u[:, 2] * torch.clamp(H - h, min=1)).long()
    left = (u[:, 3] * torch.clamp(W - w, min=1)).long()
    return torch.stack([top, left, h.long(), w.long()], 1)


def draw_random_erasing(gen: Optional[torch.Generator],
                        shape: Tuple[int, ...], device,
                        cfg: RandomErasingConfig = RandomErasingConfig()
                        ) -> Dict[str, torch.Tensor]:
    """The draws of a batch of clips (B, T, H, W, C): {'apply' (B,) bool,
    'count' (B,) int64, 'boxes' (B, max_count, 4) int64 (top, left, h, w)
    on the host; 'noise' (B, max_count, 1 or T, H, W, C) float32 on
    `device` ('rand' mode; None in 'const' mode), drawn there from a
    generator seeded by `gen`}."""
    B, T, H, W, C = shape
    apply = torch.rand(B, generator=gen) < cfg.probability
    count = torch.randint(cfg.min_count, cfg.max_count + 1, (B,),
                          generator=gen)
    boxes = _sample_box(gen, B * cfg.max_count, H, W, cfg).reshape(
        B, cfg.max_count, 4)
    noise = None
    if cfg.mode == "rand":
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        dev_gen = torch.Generator(device=device).manual_seed(seed)
        noise = torch.randn(B, cfg.max_count, 1 if cfg.cube else T, H, W, C,
                            generator=dev_gen, device=device)
    return {"apply": apply, "count": count, "boxes": boxes, "noise": noise}


def random_erasing_batch(gen: Optional[torch.Generator], clips: torch.Tensor,
                         cfg: RandomErasingConfig = RandomErasingConfig(),
                         draws: Optional[Dict[str, torch.Tensor]] = None
                         ) -> torch.Tensor:
    """Erase each clip of (B, T, H, W, C) with probability cfg.probability;
    `draws` (as `draw_random_erasing` returns them) override the draw from
    `gen`."""
    B, T, H, W, C = clips.shape
    if draws is None:
        draws = draw_random_erasing(gen, clips.shape, clips.device, cfg)
    dev = clips.device
    # the host's draws copied without waiting for the device
    active_b = draws["apply"].to(dev, non_blocking=True)
    count = draws["count"].to(dev, non_blocking=True)
    boxes = draws["boxes"].to(dev, non_blocking=True)
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    out = clips
    for i in range(boxes.shape[1]):
        top, left, h, w = (boxes[:, i, j].reshape(B, 1, 1) for j in range(4))
        mask = ((yy >= top) & (yy < top + h) &
                (xx >= left) & (xx < left + w))            # (B, H, W)
        active = active_b & (i < count)
        mask = mask & active.reshape(B, 1, 1)
        if draws["noise"] is not None:
            fill = draws["noise"][:, i].to(device=dev, dtype=clips.dtype)
        else:
            fill = torch.zeros((), dtype=clips.dtype, device=dev)
        out = torch.where(mask[:, None, :, :, None], fill, out)
    return out


def erase_clip(gen: Optional[torch.Generator], clip: torch.Tensor,
               cfg: RandomErasingConfig = RandomErasingConfig(),
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Erase one clip (T, H, W, C) with probability cfg.probability:
    `random_erasing_batch` on a batch of one (`draws` with a batch axis of
    one)."""
    return random_erasing_batch(gen, clip[None], cfg, draws)[0]
