"""RandAugment on the device (port of gava_clip_tpu/data/rand_augment.py).

The reference applies timm's PIL RandAugment per frame on the host. Here
the same policy runs as stock torch ops over whole clips on the clip's
device: the op choices, levels and signs are drawn on the host from a CPU
`torch.Generator` (or handed in as `draws`), and the clips that drew the
same op in one layer go through it in one batched call, so the launches
grow with the distinct ops drawn, not with the batch.

The 15 ops keep the JAX names and semantics (timm's op set, the
magnitude -> argument map with the `inc1` increasing variants, the config
string `rand-mN-nN-mstdF-inc1`). Every op takes float clips (G, T, H, W, C)
in [0, 1] and one argument a clip, a (G,) tensor; the same op and argument
apply to every frame of a clip. Geometric ops resample bilinearly with the
gray (128) fill used by timm.

The level L is float32, as JAX's (`jnp.clip` makes it an array even
without magnitude noise), and every argument is computed from it in
float32 in JAX's order.
"""

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

_MAX_LEVEL = 10.0
_FILL = 0.5  # timm fills geometric ops with mid-gray (128/255)


def _dev(t: torch.Tensor, img: torch.Tensor, dtype=None) -> torch.Tensor:
    """A host tensor on img's device (in img's dtype unless given), copied
    without waiting for the device: a blocking copy would drain the stream,
    and with it the training step queued before the augmentation."""
    return t.to(device=img.device, dtype=dtype or img.dtype,
                non_blocking=True)


def _per_clip(arg: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """A (G,) argument as float32 on img's device, broadcast over (G, T, H,
    W, C)."""
    return _dev(arg, img).reshape(-1, 1, 1, 1, 1)


# ---------- pixel ops -------------------------------------------------------

def _blend(a, b, factor):
    return torch.clamp(b + factor * (a - b), 0.0, 1.0)


def invert(img, _):
    return 1.0 - img


def auto_contrast(img, _):
    """Per-channel remap so min->0, max->1 (PIL autocontrast, no cutoff),
    per frame."""
    lo = img.amin(dim=(-3, -2), keepdim=True)
    hi = img.amax(dim=(-3, -2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.ones_like(hi))
    off = torch.where(hi > lo, lo, torch.zeros_like(lo))
    return torch.clamp((img - off) * scale, 0.0, 1.0)


def _quantize(img):
    """img * 255 truncated toward zero to int32 (JAX's astype), clipped to
    0..255."""
    return torch.clamp((img * 255.0).to(torch.int32), 0, 255)


def equalize(img, _):
    """Histogram equalization on the 256-level quantization, PIL's lookup
    construction, per channel over the whole clip. A channel whose step is
    0 keeps its quantized values (q / 255, as JAX returns)."""
    G, T, H, W, C = img.shape
    q = _quantize(img).permute(0, 4, 1, 2, 3).reshape(G * C, -1).long()
    # one histogram per (clip, channel) by a scatter-add (torch.bincount
    # reads the largest value back to the host on a card)
    base = torch.arange(G * C, device=img.device)[:, None] * 256
    hist = torch.zeros(G * C * 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(0, (q + base).reshape(-1), torch.ones_like(q).reshape(-1))
    hist = hist.reshape(G * C, 256)
    # PIL: step = (total - count of the last non-empty level) // 255
    levels = torch.arange(256, device=img.device)
    last = (levels * (hist > 0)).amax(dim=1, keepdim=True)
    step = (hist.sum(1, keepdim=True) - hist.gather(1, last)) // 255
    cum = torch.cumsum(hist, dim=1)
    lut = torch.clamp(((cum - hist) + step // 2)
                      // torch.clamp(step, min=1), 0, 255)
    out = torch.where(step == 0, q, lut.gather(1, q))
    out = out.reshape(G, C, T, H, W).permute(0, 2, 3, 4, 1)
    return out.to(img.dtype) / 255.0


def posterize(img, bits):
    """Keep `bits` most-significant bits (PIL posterize)."""
    bits = torch.clamp(bits.to(torch.float32), 1, 8).to(torch.int32)
    shift = _dev(8 - bits, img, torch.int32).reshape(-1, 1, 1, 1, 1)
    q = _quantize(img)
    q = (q >> shift) << shift
    return q.to(img.dtype) / 255.0


def solarize(img, thresh):
    return torch.where(img >= _per_clip(thresh / 255.0, img), 1.0 - img,
                       img)


def solarize_add(img, add):
    below = img < 128.0 / 255.0
    return torch.where(below,
                       torch.clamp(img + _per_clip(add / 255.0, img), 0.0,
                                   1.0), img)


def _grayscale(img):
    w = _dev(torch.tensor([0.299, 0.587, 0.114]), img)
    return (img * w).sum(-1, keepdim=True)


def color(img, factor):
    """Saturation (PIL Color enhance)."""
    return _blend(img, _grayscale(img).expand_as(img), _per_clip(factor, img))


def contrast(img, factor):
    mean = _grayscale(img).mean(dim=(-3, -2), keepdim=True)
    return _blend(img, mean.expand_as(img), _per_clip(factor, img))


def brightness(img, factor):
    return _blend(img, torch.zeros_like(img), _per_clip(factor, img))


def sharpness(img, factor):
    """PIL Sharpness enhance: blend with a 3x3 smoothing filter (1 1 1 /
    1 5 1 / 1 1 1, over 13), the border left unfiltered. The filter is nine
    shifted products summed in fp32 on any device (a cuDNN convolution
    would take TF32 where a program allows it)."""
    H, W = img.shape[2:4]
    weights = torch.tensor([[1., 1., 1.], [1., 5., 1.], [1., 1., 1.]],
                           dtype=img.dtype) / 13.0
    smoothed = img.clone()
    if H > 2 and W > 2:
        acc = None
        for i in range(3):
            for j in range(3):
                term = weights[i, j].item() * img[:, :, i:H - 2 + i,
                                                  j:W - 2 + j]
                acc = term if acc is None else acc + term
        smoothed[:, :, 1:-1, 1:-1] = acc
    return _blend(img, smoothed, _per_clip(factor, img))


# ---------- geometric ops (bilinear affine resampling) -----------------------

def _affine(img, mat, offset):
    """Apply the inverse affine [a b; c d] + offset of each clip to its
    frames, bilinear, gray fill outside: mat (G, 4), offset (G, 2) float32
    on img's device."""
    G, T, H, W, C = img.shape
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=img.dtype, device=img.device),
        torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")

    def col(t, i):
        return t[:, i].reshape(G, 1, 1)
    src_x = col(mat, 0) * xx + col(mat, 1) * yy + col(offset, 0)
    src_y = col(mat, 2) * xx + col(mat, 3) * yy + col(offset, 1)
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    wx = src_x - x0
    wy = src_y - y0
    # a frame of the fill around each frame: a source pixel outside the
    # frame reads the fill from there (its coordinate clamped onto it)
    padded = F.pad(img, (0, 0, 1, 1, 1, 1), value=_FILL)
    flat = padded.reshape(G, T, (H + 2) * (W + 2), C)

    def gather(yi, xi):
        yc = (torch.clamp(yi, -1, H) + 1).long()
        xc = (torch.clamp(xi, -1, W) + 1).long()
        idx = (yc * (W + 2) + xc).reshape(G, 1, H * W, 1).expand(
            G, T, H * W, C)
        return flat.gather(2, idx).reshape(G, T, H, W, C)

    def w(t):
        return t[:, None, :, :, None]
    out = w((1 - wx) * (1 - wy)) * gather(y0, x0) \
        + w(wx * (1 - wy)) * gather(y0, x0 + 1) \
        + w((1 - wx) * wy) * gather(y0 + 1, x0) \
        + w(wx * wy) * gather(y0 + 1, x0 + 1)
    return torch.clamp(out, 0.0, 1.0)


def _mats(mag, *entries):
    """(G, n) float32 rows from per-clip tensors or constants."""
    return torch.stack([e if isinstance(e, torch.Tensor)
                        else torch.full_like(mag, e) for e in entries], 1)


def shear_x(img, mag):
    mag = _dev(mag, img)
    return _affine(img, _mats(mag, 1.0, mag, 0.0, 1.0), _mats(mag, 0.0, 0.0))


def shear_y(img, mag):
    mag = _dev(mag, img)
    return _affine(img, _mats(mag, 1.0, 0.0, mag, 1.0), _mats(mag, 0.0, 0.0))


def translate_x(img, frac):
    frac = _dev(frac, img)
    return _affine(img, _mats(frac, 1.0, 0.0, 0.0, 1.0),
                   _mats(frac, frac * img.shape[3], 0.0))


def translate_y(img, frac):
    frac = _dev(frac, img)
    return _affine(img, _mats(frac, 1.0, 0.0, 0.0, 1.0),
                   _mats(frac, 0.0, frac * img.shape[2]))


def rotate(img, degrees):
    G, T, H, W, C = img.shape
    degrees = _dev(degrees, img)
    theta = -degrees * math.pi / 180.0
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    # src = R @ (dst - c) + c
    offset_x = cx - cos * cx - sin * cy
    offset_y = cy + sin * cx - cos * cy
    return _affine(img, torch.stack([cos, sin, -sin, cos], 1),
                   torch.stack([offset_x, offset_y], 1))


# ---------- policy ----------------------------------------------------------

@dataclass(frozen=True)
class RandAugmentConfig:
    magnitude: float = 10.0
    num_layers: int = 2
    mag_std: float = 0.0
    increasing: bool = False


def parse_rand_augment_config(config_str: str) -> RandAugmentConfig:
    """Parse `rand-mN-nN-mstdF-inc1`."""
    parts = config_str.split("-")
    assert parts[0] == "rand", config_str
    m, n, mstd, inc = 10.0, 2, 0.0, False
    for p in parts[1:]:
        match = re.match(r"([a-z]+)([\d.]+)", p)
        if not match:
            continue
        key, val = match.group(1), match.group(2)
        if key == "m":
            m = float(val)
        elif key == "n":
            n = int(val)
        elif key == "mstd":
            mstd = float(val)
        elif key == "inc":
            inc = bool(int(val))
    return RandAugmentConfig(magnitude=m, num_layers=n, mag_std=mstd,
                             increasing=inc)


def _signed(sign, mag):
    """mag where sign is True, else -mag."""
    return torch.where(sign, mag, -mag)


def _posterize_bits(L, _, inc):
    return (4.0 - L * 4.0) if not inc else (4.0 - (1 - L) * 4.0 + 0 * L)


def _solarize_thresh(L, _, inc):
    return 256.0 - L * 256.0 if not inc else 256.0 * (1 - L)


def _enhance(L, sign, _):
    return 1.0 + _signed(sign, L * 0.9)


# (name, op, argument from the level L, the sign and `increasing`): the
# order and the magnitude -> argument maps of JAX's _op_table
OPS: List[Tuple[str, Callable, Callable]] = [
    ("AutoContrast", auto_contrast, lambda L, s, inc: torch.zeros_like(L)),
    ("Equalize", equalize, lambda L, s, inc: torch.zeros_like(L)),
    ("Invert", invert, lambda L, s, inc: torch.zeros_like(L)),
    ("Rotate", rotate, lambda L, s, inc: _signed(s, L * 30.0)),
    ("Posterize", posterize, _posterize_bits),
    ("Solarize", solarize, _solarize_thresh),
    ("SolarizeAdd", solarize_add, lambda L, s, inc: L * 110.0),
    ("Color", color, _enhance),
    ("Contrast", contrast, _enhance),
    ("Brightness", brightness, _enhance),
    ("Sharpness", sharpness, _enhance),
    ("ShearX", shear_x, lambda L, s, inc: _signed(s, L * 0.3)),
    ("ShearY", shear_y, lambda L, s, inc: _signed(s, L * 0.3)),
    ("TranslateX", translate_x, lambda L, s, inc: _signed(s, L * 0.45)),
    ("TranslateY", translate_y, lambda L, s, inc: _signed(s, L * 0.45)),
]


def op_argument(op: int, L: torch.Tensor, sign: torch.Tensor,
                increasing: bool) -> torch.Tensor:
    """The argument of op number `op` (index into OPS) at level L (in
    [0, 1]) and sign (True: positive), float32."""
    return OPS[op][2](L.to(torch.float32), sign, increasing)


def draw_rand_augment(gen: Optional[torch.Generator], batch: int,
                      cfg: RandAugmentConfig) -> Dict[str, torch.Tensor]:
    """The policy's draws for `batch` clips on the host: {'op' (B, n)
    int64, 'level' (B, n) float32, 'sign' (B, n) bool}."""
    n = cfg.num_layers
    op = torch.randint(0, len(OPS), (batch, n), generator=gen)
    sign = torch.rand(batch, n, generator=gen) < 0.5
    m = torch.full((batch, n), cfg.magnitude)
    if cfg.mag_std > 0:
        m = m + cfg.mag_std * torch.randn(batch, n, generator=gen)
    level = torch.clamp(m, 0.0, _MAX_LEVEL) / _MAX_LEVEL
    return {"op": op, "level": level, "sign": sign}


def rand_augment_batch(gen: Optional[torch.Generator], clips: torch.Tensor,
                       config_str: str,
                       draws: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
    """`num_layers` ops on each float clip of (B, T, H, W, C) in [0, 1],
    the same op and argument for every frame of a clip. `draws` ('op',
    'level', 'sign', each (B, num_layers) on the host) override the draw
    from `gen`. Layer after layer, the clips that drew one op go through it
    together."""
    cfg = parse_rand_augment_config(config_str)
    if draws is None:
        draws = draw_rand_augment(gen, clips.shape[0], cfg)
    ops = draws["op"].cpu()
    level, sign = draws["level"].cpu(), draws["sign"].cpu()
    x = clips
    for layer in range(cfg.num_layers):
        col = ops[:, layer]
        out = None
        for op in torch.unique(col).tolist():
            rows = (col == op).nonzero()[:, 0]
            arg = op_argument(op, level[rows, layer], sign[rows, layer],
                              cfg.increasing)
            fn = OPS[op][1]
            if len(rows) == len(col):
                out = fn(x, arg)
                break
            if out is None:
                out = torch.empty_like(x)
            idx = rows.to(x.device, non_blocking=True)
            out.index_copy_(0, idx, fn(x.index_select(0, idx), arg))
        x = out
    return x
