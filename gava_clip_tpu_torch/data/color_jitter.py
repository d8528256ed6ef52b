"""The colour-jitter family on the device (port of
gava_clip_tpu/data/color_jitter.py): brightness / contrast / saturation
jitter in a random order, grayscale, PCA lighting jitter and hue rotation,
as stock torch ops over float clips (T, H, W, C) in [0, 1] on the clip's
device. Random strengths and orders come from a CPU `torch.Generator`, or
from `draws`. No program calls these yet, in either package.
"""

from typing import Dict, Optional

import torch

# ITU-R 601 luma weights
_LUMA = (0.299, 0.587, 0.114)

# ImageNet PCA eigenvalues / vectors (the lighting jitter's defaults)
_EIG_VAL = (0.225, 0.224, 0.229)
_EIG_VEC = ((-0.5675, 0.7192, 0.4009),
            (-0.5808, -0.0045, -0.8140),
            (-0.5836, -0.6948, 0.4203))


def _t(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype).to(like.device,
                                                         non_blocking=True)


def grayscale(clip: torch.Tensor) -> torch.Tensor:
    """RGB -> 3-channel luma."""
    g = (clip * _t(_LUMA, clip)).sum(-1, keepdim=True)
    return g.expand_as(clip)


def _alpha(var: float, u, clip: torch.Tensor) -> torch.Tensor:
    return 1.0 + var * (2.0 * _t(u, clip) - 1.0)


def brightness_jitter(var: float, u, clip: torch.Tensor) -> torch.Tensor:
    """Blend with black, alpha = 1 + var (2u - 1) ~ U(1 - var, 1 + var)."""
    return torch.clamp(clip * _alpha(var, u, clip), 0.0, 1.0)


def contrast_jitter(var: float, u, clip: torch.Tensor) -> torch.Tensor:
    """Blend with the mean gray frame."""
    alpha = _alpha(var, u, clip)
    mean = grayscale(clip).mean(dim=(-3, -2), keepdim=True)
    return torch.clamp(clip * alpha + mean * (1.0 - alpha), 0.0, 1.0)


def saturation_jitter(var: float, u, clip: torch.Tensor) -> torch.Tensor:
    """Blend with grayscale."""
    alpha = _alpha(var, u, clip)
    return torch.clamp(clip * alpha + grayscale(clip) * (1.0 - alpha), 0.0,
                       1.0)


def hue_rotate(degrees, clip: torch.Tensor) -> torch.Tensor:
    """Rotate the hue by `degrees` around the luma axis in RGB space (the
    YIQ rotation of torchvision's tensor hue adjustment)."""
    theta = torch.deg2rad(torch.as_tensor(degrees, dtype=torch.float32))
    cos, sin = torch.cos(theta), torch.sin(theta)
    rgb2yiq = torch.tensor([[0.299, 0.587, 0.114],
                            [0.595716, -0.274453, -0.321263],
                            [0.211456, -0.522591, 0.311135]])
    yiq2rgb = torch.tensor([[1.0, 0.9563, 0.6210],
                            [1.0, -0.2721, -0.6474],
                            [1.0, -1.1070, 1.7046]])
    one, zero = torch.ones(()), torch.zeros(())
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, cos, -sin]),
                       torch.stack([zero, sin, cos])])
    m = (yiq2rgb @ rot @ rgb2yiq).to(device=clip.device, dtype=clip.dtype,
                                     non_blocking=True)
    return torch.clamp(clip @ m.T, 0.0, 1.0)


def lighting_jitter(gen: Optional[torch.Generator], clip: torch.Tensor,
                    alphastd: float = 0.1, eig_val=_EIG_VAL,
                    eig_vec=_EIG_VEC,
                    alphas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AlexNet-style PCA lighting noise, one draw of three alphas per clip
    (`alphas` (3,) overrides it)."""
    if alphas is None:
        alphas = alphastd * torch.randn(3, generator=gen)
    rgb = (_t(eig_vec, clip) * _t(alphas, clip)
           * _t(eig_val, clip)).sum(-1)
    return torch.clamp(clip + rgb, 0.0, 1.0)


_JITTERS = {"b": brightness_jitter, "c": contrast_jitter,
            "s": saturation_jitter}


def color_jitter(gen: Optional[torch.Generator], clip: torch.Tensor,
                 img_brightness: float = 0.0, img_contrast: float = 0.0,
                 img_saturation: float = 0.0,
                 draws: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Apply the enabled jitters in a random order with random strengths:
    `draws` {'order' (n,) int64, a permutation of the n enabled jitters in
    the order brightness, contrast, saturation; 'u' (n,) float32 in [0, 1),
    the strength of the i-th jitter applied} override the draw from
    `gen`."""
    enabled = [(tag, var) for tag, var in (("b", img_brightness),
                                           ("c", img_contrast),
                                           ("s", img_saturation)) if var != 0]
    if not enabled:
        return clip
    if draws is None:
        draws = {"order": torch.randperm(len(enabled), generator=gen),
                 "u": torch.rand(len(enabled), generator=gen)}
    for i, j in enumerate(draws["order"].tolist()):
        tag, var = enabled[j]
        clip = _JITTERS[tag](var, draws["u"][i], clip)
    return clip
