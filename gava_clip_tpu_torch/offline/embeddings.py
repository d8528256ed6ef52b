"""Embedding preparation tools (port of gava_clip_tpu/offline/embeddings.py).

  * encode_text_file / encode_texts: text lines (or a JSON list) -> CLIP
    text embeddings saved as .npy; this is how the knowledge files
    data/ke_*/EntityEmb-style .npy assets are produced from description
    text when no KEPLER embeddings exist.
  * extract_class_text_features: replay a model's prompt learner + text
    tower to recover the learned per-class text features (the text_features
    slot of a checkpoint, recomputed from weights alone).
  * encode_videos_to_class_dict: run videos through the vision tower and
    group the embeddings by label.

The towers are the port's, in fp32 with the plain attention, on the
resolved device (or the model's own).
"""

import json
import os.path as osp
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.text import TextConfig
from ..text import tokenize
from ..utils.device import resolve_device, tree_to
from .preprocess import encode_tokens


def encode_texts(texts: Sequence[str], text_params: Dict,
                 text_cfg: Optional[TextConfig] = None, batch: int = 256,
                 device=None) -> np.ndarray:
    text_cfg = text_cfg or TextConfig()
    params = tree_to(text_params, resolve_device(device))
    outs = [encode_tokens(params, tokenize(list(texts[i:i + batch]),
                                           truncate=True), text_cfg)
            for i in range(0, len(texts), batch)]
    return np.concatenate(outs, axis=0)


def encode_text_file(path: str, text_params: Dict,
                     text_cfg: Optional[TextConfig] = None,
                     out_path: Optional[str] = None,
                     json_key: Optional[str] = None, device=None) -> str:
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        texts = data[json_key] if json_key else data
        if isinstance(texts, dict):
            texts = list(texts.values())
    else:
        with open(path) as f:
            texts = [line.strip() for line in f if line.strip()]
    feats = encode_texts(texts, text_params, text_cfg, device=device)
    out_path = out_path or osp.splitext(path)[0] + ".npy"
    np.save(out_path, feats)
    return out_path


_DIGITS = ["one", "two", "three", "four", "five", "six", "seven", "eight",
           "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
           "fifteen", "sixteen", "seventeen", "eighteen", "nineteen",
           "twenty"]
_TENS = ["twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty",
         "ninety"]

# graduated-adjective probe templates (reference prepare_embedding.py:57-72)
LEVEL_TEMPLATES = {
    "distance": ["the difference in distance covered between a left step and "
                 "a right step is {:s}",
                 "the distance covered from the first contact of right foot "
                 "to the first contact of the left foot is {:s}"],
    "percentage": ["the percentage of the duration when only the left foot "
                   "contacts the ground within one gait cycle is {:s}",
                   "the percentage of the duration when the left foot is off "
                   "the ground within the left walk cycle is {:s}"],
}
LEVEL_WORDS = {
    "speed": ["very slow", "slow", "quick", "fast"],
    "cadence": ["few", "limited", "minimal", "numerous", "maximal",
                "frequent"],
    "distance": ["close", "short", "small", "large", "long", "far"],
    "percentage": ["low", "small", "minor", "large", "high", "major"],
}


def number_words(n: int) -> Sequence[str]:
    """English words for 1..n-1 (reference prepare_embedding.py:41-57,
    with its multiples-of-ten bug fixed as in the JAX package: the
    reference renders 30 as 'thirty-twenty')."""
    if not 0 < n < 1000:
        raise ValueError(f"n must lie in (0, 1000), got {n}")
    out = []
    for i in range(1, n):
        if i < 21:
            out.append(_DIGITS[i - 1])
        elif i < 100:
            tens = _TENS[i // 10 - 2]
            out.append(tens if i % 10 == 0 else
                       f"{tens}-{_DIGITS[i % 10 - 1]}")
        else:
            rem = i % 100
            word = f"{_DIGITS[i // 100 - 1]} hundred"
            if rem:
                word += " " + number_words(rem + 1)[-1]
            out.append(word)
    return out


def _sim_and_dist(embeds: np.ndarray):
    normed = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
    sim = normed @ normed.T
    sq = (normed ** 2).sum(-1)
    dist = np.sqrt(np.maximum(sq[:, None] + sq[None] - 2 * (normed @ normed.T),
                              0.0))
    return sim, dist


def number_distance_study(text_params, text_cfg: Optional[TextConfig] = None,
                          n: int = 100, device=None) -> Dict:
    """How does the frozen CLIP text tower space out numeric words?
    (reference prepare_embedding.py:35-160). Returns cosine-similarity and
    euclidean-distance matrices for 'This image has <k> dogs' (k=1..n-1)
    plus per-template matrices for the graduated level words."""
    params = tree_to(text_params, resolve_device(device))
    texts = [f"This image has {t} dogs" for t in number_words(n)]
    sim, dist = _sim_and_dist(encode_texts(texts, params, text_cfg,
                                           device=device))
    out = {"numbers": {"similarity": sim, "distance": dist, "texts": texts}}
    for kind, templates in LEVEL_TEMPLATES.items():
        for ti, tf in enumerate(templates):
            level_texts = [tf.format(w) for w in LEVEL_WORDS[kind]]
            s, d = _sim_and_dist(encode_texts(level_texts, params,
                                              text_cfg, device=device))
            out[f"{kind}_{ti}"] = {"similarity": s, "distance": d,
                                   "texts": level_texts}
    return out


def pe_distance_study(text_params, text_cfg: Optional[TextConfig] = None,
                      n: int = 150, l2_norm: float = 0.5,
                      device=None) -> Dict:
    """Sinusoidal-PE numeric encoding geometry (reference
    prepare_embedding.py:162-238): one frozen sentence embedding
    ('the walking speed is X') is added to every row-normalized PE row;
    returns the cosine/euclidean matrices over the n shifted rows."""
    from .metadata import make_pe
    d_model = text_cfg.embed_dim if text_cfg is not None else 512
    pe = make_pe(n, d_model, l2_norm=l2_norm)
    base = encode_texts(["the walking speed is X"], text_params, text_cfg,
                        device=device)[0]
    sim, dist = _sim_and_dist(pe + base[None, :])
    return {"similarity": sim, "distance": dist}


def extract_class_text_features(model, params) -> np.ndarray:
    """Learned per-class text features (n_cls, E) from a model's params
    (a `VitaClipModel`; on the model's device)."""
    with torch.inference_mode():
        return model.text_features_only(params, model.buffers).cpu().numpy()


def encode_videos_to_class_dict(model, params, loader, mean, std,
                                batch_size: int) -> Dict[int, np.ndarray]:
    """{label: (N_label, embed_dim) L2-normalized video features}: the
    vision tower of `model` (a `VitaClipModel`) in fp32 with the plain
    attention, on the model's device; short batches are padded to
    `batch_size` with their last clip."""
    from ..data.device_preprocess import normalize_frames
    from ..models.vision import vision_encoder

    device = model.device
    grouped = defaultdict(list)
    with torch.inference_mode():
        for batch in loader:
            video = np.asarray(batch["video"])
            n = video.shape[0]
            if n < batch_size:
                video = np.concatenate(
                    [video, np.repeat(video[-1:], batch_size - n, axis=0)])
            x = normalize_frames(torch.from_numpy(video).to(device), mean, std)
            feats, _ = vision_encoder(params["visual"], x, model.cfg.vision)
            feats = (feats / feats.norm(dim=-1, keepdim=True))[:n]
            for f, lab in zip(feats.cpu().numpy(),
                              np.asarray(batch["labels"])[:n]):
                grouped[int(lab)].append(f[None])
    return {k: np.concatenate(v, axis=0) for k, v in grouped.items()}
