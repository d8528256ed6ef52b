"""Inference serving (port of gava_clip_tpu/serve.py: bf16, w8 and w8a8).

A classifier around the zero-shot path: uint8 clips in, class probabilities
out. Weights are moved to the device once: cast to bf16, or with
quantize="w8" / "w8a8" int8-quantized (ops/quant.py) with every other leaf
kept fp32, as the JAX classifier keeps them (a bf16-rounded LayerNorm gain
would move int8 codes). Requests are padded (repeating the last clip) to
the next power-of-two bucket up to the serving batch. On a CUDA device
attention (bf16, w8), the w8 dequant GEMM or the w8a8 ops run the
hand-written kernels; on the CPU their plain versions. The w8a8 classifier
honours the two kernel switches `ops.extras_kernel.set_fused_extras` and
`ops.flash_attention.set_int8_qk`, read at every forward.

    clf = VideoClassifier.from_model(model, classnames)   # on the card
    probs = clf.classify_clips(clips_u8)        # (N, T, S, S, 3) uint8
    label, probs = clf.classify_video("walk.mp4")

Data-parallel serving (`devices=[...]`, the JAX classifier's 'data' mesh):
one copy of the weights on each device, each batch cut into equal shards,
every shard's forward queued before any result is gathered on the first
device.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .data import video as V
from .data.device_preprocess import CLIP_MEAN, CLIP_STD, normalize_frames
from .models.vision import fold_normalize_into_patch_embed, patchify
from .models.vita_clip import VitaClip
from .ops.int8_matmul import with_kernel_layout
from .ops.quant import quantize_tower_params
from .utils.device import resolve_device


def _to_bf16(tree, device):
    if isinstance(tree, dict):
        return {k: _to_bf16(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_bf16(v, device) for v in tree]
    dtype = torch.bfloat16 if tree.is_floating_point() else tree.dtype
    return tree.to(device=device, dtype=dtype)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class VideoClassifier:

    def __init__(self, model: VitaClip, params: Dict,
                 classnames: Sequence[str], batch_size: int = 16,
                 mean=CLIP_MEAN, std=CLIP_STD, compute_dtype=None,
                 attn_impl: Optional[str] = None, quantize=False,
                 patch_major: bool = False, pad_buckets: bool = True,
                 device=None, devices: Optional[Sequence] = None):
        """model supplies the config and the text features; params (the
        nested dict of `model.param_tree()`, possibly edited) the weights.

        patch_major: ship clips as raw uint8 patch rows (patchify on the
        host) with the normalization folded into the patch-embed weights.
        pad_buckets: pad a partial batch to the next power of two instead
        of the full serving batch.
        quantize: '' / False (bf16 weights), True / 'w8' (weight-only
        int8: the projections run the dequant GEMM on bf16 activations;
        with patch_major the embed stays a float GEMM) or 'w8a8' (int8
        weights and per-row int8 activations).
        device: None means the card (and raises without one); pass 'cpu'
        to serve from the host.
        devices: serve data-parallel over these devices (in place of
        `device`): the batch size must divide by their number, and
        pad_buckets is off (a bucket would have to divide too), as in the
        JAX classifier over a mesh."""
        if quantize is True:
            quantize = "w8"
        if quantize not in ("", None, False, "w8", "w8a8"):
            raise ValueError(f"quantize must be '', 'w8' or 'w8a8', got "
                             f"{quantize!r}")
        self.quantize = quantize or ""
        if devices is not None:
            self.devices = [resolve_device(d) for d in devices]
            if not self.devices or batch_size % len(self.devices) != 0:
                raise ValueError(
                    f"serving batch {batch_size} must be divisible by the "
                    f"number of devices ({len(self.devices)})")
            pad_buckets = False
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        self.classnames = list(classnames)
        self.batch_size = batch_size
        self.num_frames = model.cfg.vision.num_frames
        self.spatial_size = model.cfg.vision.input_size[0]
        self.patch_major = patch_major
        self.pad_buckets = bool(pad_buckets)
        self._patch_size = model.cfg.vision.patch_size
        self._mean, self._std = mean, std
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.attn_impl = attn_impl or (
            "flash" if self.device.type == "cuda" else "xla")
        if patch_major:
            visual = dict(params["visual"])
            visual["patch_embed"] = fold_normalize_into_patch_embed(
                visual["patch_embed"], mean, std, self._patch_size)
            params = dict(params)
            params["visual"] = visual
        # weights on the device, once: quantize after the fold, so the
        # patch-embed sidecar quantizes the folded W'; in the quantized
        # modes nothing is cast to bf16, and each int8 weight gets the W^T
        # copy its CUDA kernel reads. The text features keep their dtype
        # (as the JAX classifier keeps its buffers)
        if self.quantize:
            host = quantize_tower_params(params,
                                         act_quant=self.quantize == "w8a8")
            place = [with_kernel_layout(_to_device(host, d))
                     for d in self.devices]
        else:
            place = [_to_bf16(params, d) for d in self.devices]
        self.nets = [VitaClip(model.cfg, p, model.text_features.to(d))
                     for p, d in zip(place, self.devices)]
        self.net = self.nets[0]

    @classmethod
    def from_model(cls, model: VitaClip, classnames: Sequence[str], **kw):
        return cls(model, model.param_tree(), classnames, **kw)

    def _forward_on(self, net, clips_u8: torch.Tensor) -> torch.Tensor:
        if self.patch_major:
            out = net(clips_u8.to(self.compute_dtype),
                      compute_dtype=self.compute_dtype,
                      attn_impl=self.attn_impl, input_format="patches")
        else:
            x = normalize_frames(clips_u8, self._mean, self._std)
            out = net(x, compute_dtype=self.compute_dtype,
                      attn_impl=self.attn_impl)
        return torch.softmax(out["logits"], dim=-1)

    def _forward(self, clips_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            # every shard's forward queued on its device first, then the
            # gather on the first device (one device: one shard, the batch)
            shards = clips_u8.chunk(len(self.nets))
            probs = [self._forward_on(net, x.to(d, non_blocking=True))
                     for net, x, d in zip(self.nets, shards, self.devices)]
            if len(probs) == 1:
                return probs[0]
            return torch.cat([p.to(self.device) for p in probs])

    def _buckets(self):
        if not self.pad_buckets:
            return [self.batch_size]
        out = []
        b = 1
        while b < self.batch_size:
            out.append(b)
            b *= 2
        return out + [self.batch_size]

    def _bucket(self, k: int) -> int:
        for b in self._buckets():
            if k <= b:
                return b
        return self.batch_size

    def _prepare(self, chunk: np.ndarray) -> torch.Tensor:
        if self.patch_major:
            chunk = patchify(np.ascontiguousarray(chunk), self._patch_size)
        return torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)

    def warmup(self):
        """Run every bucket once (builds the CUDA kernels on a card)."""
        for b in self._buckets():
            dummy = np.zeros((b, self.num_frames, self.spatial_size,
                              self.spatial_size, 3), np.uint8)
            self._forward(self._prepare(dummy)).cpu()
        return self

    def classify_clips(self, clips_u8: np.ndarray) -> np.ndarray:
        """(N, T, S, S, 3) uint8 -> (N, n_cls) float32 probabilities."""
        n = clips_u8.shape[0]
        probs = []
        for i in range(0, n, self.batch_size):
            chunk = clips_u8[i:i + self.batch_size]
            k = chunk.shape[0]
            b = self._bucket(k)
            if k < b:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - k, axis=0)])
            p = self._forward(self._prepare(chunk))
            probs.append(p.float().cpu().numpy()[:k])
        return np.concatenate(probs, axis=0)

    def prepare_video(self, path: str, sampling_rate: int = 1) -> np.ndarray:
        """Decode + sample + resize/crop one video to a serving clip."""
        n = V.video_num_frames(path)
        idx = V.temporal_crop_indices(n, self.num_frames, sampling_rate, 1)[0]
        frames = V.decode_frames(path, indices=idx)
        frames = V.keep_aspect_resize(frames, self.spatial_size)
        return V.center_crop(frames, self.spatial_size)

    def classify_video(self, path: str) -> Tuple[str, np.ndarray]:
        clip = self.prepare_video(path)
        probs = self.classify_clips(clip[None])[0]
        return self.classnames[int(np.argmax(probs))], probs
