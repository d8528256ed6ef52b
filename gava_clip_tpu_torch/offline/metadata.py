"""Earlier-generation numeric text encoding, the slerp variant (port of
gava_clip_tpu/offline/metadata.py).

A normalized sinusoidal PE table (N=5000, L2 norm 2.0 — read by
cli/decode.py's PE probe), spherical linear interpolation between
"short ..."/"long ..." sentence embeddings weighted by the graduated
parameter value, and functions that emit the data_dict.pkl /
updrs_dict.pkl / diag_dict.pkl files the JAX package writes. The sentences
go through the port's text tower (fp32, plain attention) on the resolved
device; everything else is numpy on the host.
"""

import functools
import os
import os.path as osp
import pickle
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from ..models.text import TextConfig
from ..text import tokenize
from ..text.tokenizer import VOCAB_SIZE
from ..utils.device import resolve_device, tree_to
from .preprocess import encode_tokens

N_PE = 5000
D_MODEL = 512
L2_NORM = 2.0


def make_pe(n: int = N_PE, d_model: int = D_MODEL,
            l2_norm: float = L2_NORM) -> np.ndarray:
    pe = np.zeros((n, d_model))
    pos = np.arange(n)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe / np.linalg.norm(pe, axis=-1, keepdims=True) * l2_norm


@functools.lru_cache(maxsize=1)
def default_pe() -> np.ndarray:
    """`make_pe()`, the JAX module's `PE` constant, built on first use (20
    MB of float64 that importing this module does not pay for). Callers
    must not write to it."""
    return make_pe()


def slerp(v0: np.ndarray, v1: np.ndarray, weight=0.5,
          dot_thresh: float = 0.9995) -> np.ndarray:
    """Spherical linear interpolation between (unnormalized) vectors; the
    angle is measured on the normalized pair, the interpolation applied to
    the originals (reference metadata.py:54-96)."""
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    weight = np.atleast_1d(np.asarray(weight, np.float64))
    n0 = v0 / np.linalg.norm(v0, keepdims=True)
    n1 = v1 / np.linalg.norm(v1, keepdims=True)
    dot = np.sum(n0 * n1, axis=-1)
    if not np.abs(dot).max() < dot_thresh:
        raise ValueError("v0 and v1 are almost colinear")
    theta0 = np.arccos(dot)
    sin0 = np.sin(theta0)
    theta_w = theta0 * weight
    w0 = np.sin(theta0 - theta_w) / sin0
    w1 = np.sin(theta_w) / sin0
    return w0[:, None] * v0 + w1[:, None] * v1


# antonym map for graduated-sentence endpoints (reference metadata.py:29-36)
ADJ_DICT = {
    "short": "long",
    "slow": "fast",
    "minimal": "maximal",
    "close": "far",
    "minor": "major",
}
GRAD_SCALE = 1 / 99


def normalize_by_leg_length(gait_params: Dict[str, np.ndarray],
                            leg_lengths: np.ndarray) -> Dict[str, np.ndarray]:
    """Divide 'distance' (not 'difference') parameters by the left/right/mean
    leg length depending on which side the name references (reference
    metadata.py:125-135)."""
    out = dict(gait_params)
    for name in gait_params:
        if "distance" not in name or "difference" in name:
            continue
        v = np.asarray(gait_params[name], float)
        if "left" in name and "right" in name:
            out[name] = v / leg_lengths.mean(axis=1)
        elif "left" in name:
            out[name] = v / leg_lengths[:, 0]
        elif "right" in name:
            out[name] = v / leg_lengths[:, 1]
        else:
            out[name] = v / leg_lengths.mean(axis=1)
    return out


def _group_by_label(output: Dict, save_dir: str, suffix: str) -> Dict[str, str]:
    """updrs_dict / diag_dict pickles: the embeds grouped by label, updrs
    -1 dropped (reference metadata.py:350-379)."""
    paths = {}
    for key in ("updrs", "diag"):
        grouped = defaultdict(list)
        for i, lab in enumerate(output[key]):
            if key == "updrs" and lab < 0:
                continue
            grouped[int(lab)].append(output["embeds"][i][None])
        gdict = {k: np.concatenate(v, axis=0) for k, v in grouped.items()}
        p = osp.join(save_dir, f"{key}_dict{suffix}.pkl")
        with open(p, "wb") as f:
            pickle.dump(gdict, f)
        paths[key] = p
    return paths


def build_metadata_dicts(metadata: Dict[str, list],
                         text_params: Dict,
                         text_cfg: Optional[TextConfig] = None,
                         save_dir: str = "./data/gait/",
                         keep_length: bool = False,
                         dict_from_data: bool = True,
                         max_pairs: Optional[int] = None,
                         device=None) -> Dict[str, str]:
    """Full reference utils/metadata.py pipeline (:98-378): pairwise gait
    parameters -> antonym-endpoint slerp embeddings + extended-vocab tokens.

    metadata: column dict with 'updrs'/'diag' labels, 'left leg length' /
    'right leg length', and gait-parameter value columns whose last word has
    an ADJ_DICT antonym. For every parameter pair (k1, k2), b >= a:
      * sentence = "k1[ and k2]"; end-sentence swaps each name's last word
        for its antonym; both encoded through the frozen text tower.
      * per row, slerp(start, end, graduated weights) averaged over the
        pair dimension is the embedding; the tokens are the sentence words
        with each parameter's graduated value as extended-vocab token
        49408+v ('.'-terminated, zero-padded to 77).
    Emits data_dict[_raw].pkl, embed_dict[_raw].pkl (sorted de-graduated
    values per key + key_embeds) and — unless dict_from_data is False —
    updrs_dict/diag_dict pkls grouped by label (updrs -1 dropped).
    All sentences are encoded in one text-tower call. max_pairs bounds the
    quadratic pair count (None = all, the reference behavior).

    As in the JAX package, the slerp weight is the graduated value scaled
    back to [0, 1], where the reference passes the raw graduated ints
    (0..99) as angular weights (metadata.py:280-285).
    """
    text_cfg = text_cfg or TextConfig()
    params = tree_to(text_params, resolve_device(device))

    labels = {"updrs": list(metadata["updrs"]), "diag": list(metadata["diag"])}
    lleg, rleg = "left leg length", "right leg length"
    leg_lengths = np.stack([np.asarray(metadata[lleg], float),
                            np.asarray(metadata[rleg], float)], axis=1)
    skip = {"updrs", "diag", lleg, rleg, "vidname"}
    gait_params = {k: np.asarray(v, float) for k, v in metadata.items()
                   if k not in skip}
    if not keep_length:
        gait_params = normalize_by_leg_length(gait_params, leg_lengths)

    value_names = list(gait_params)
    graduated = {}
    embed_dict: Dict = {"key_embed": {}}
    for k, v in gait_params.items():
        g = (v - v.min()) / max(np.ptp(v), 1e-9)
        graduated[k] = (g / GRAD_SCALE).astype(int)          # 0..99
        embed_dict[k] = np.sort(graduated[k]) * GRAD_SCALE * np.ptp(v) + v.min()

    def end_name(k):
        last = k.split()[-1]
        return k.replace(last, ADJ_DICT.get(last, f"anti-{last}"))

    # one batched encode for every start/end sentence
    starts = value_names + [" and " + k for k in value_names]
    ends = [end_name(k) for k in value_names] + \
           [" and " + end_name(k) for k in value_names]
    toks = tokenize(starts + ends, truncate=True)
    embeds = encode_tokens(params, toks, text_cfg)
    embeds = embeds / np.linalg.norm(embeds, axis=-1, keepdims=True)
    n = len(value_names)
    start_emb = {(k, lead): embeds[i + lead * n]
                 for i, k in enumerate(value_names) for lead in (0, 1)}
    end_emb = {(k, lead): embeds[2 * n + i + lead * n]
               for i, k in enumerate(value_names) for lead in (0, 1)}
    start_tok = {(k, lead): np.asarray(toks[i + lead * n])
                 for i, k in enumerate(value_names) for lead in (0, 1)}
    for k in value_names:
        embed_dict["key_embed"][k] = start_emb[(k, 0)][None]

    tok_point = np.asarray(tokenize(["."])[0, 1:3])
    output = {"tokens": [], "embeds": [], "updrs": [], "diag": []}
    pairs = [(k1, k2) for a, k1 in enumerate(value_names)
             for k2 in value_names[a:]]
    if max_pairs is not None:
        pairs = pairs[:max_pairs]
    for k1, k2 in pairs:
        names = [(k1, 0)] + ([(k2, 1)] if k2 != k1 else [])
        s_emb = np.stack([start_emb[nm] for nm in names])
        e_emb = np.stack([end_emb[nm] for nm in names])
        weights = np.stack([graduated[nm[0]] for nm in names], axis=1)  # (R, P)
        for row in range(weights.shape[0]):
            w = weights[row] * GRAD_SCALE
            emb = np.stack([slerp(s_emb[i], e_emb[i], w[i])[0]
                            for i in range(len(names))]).mean(axis=0)
            # tokens: SOT + k1 words + <num1> [+ k2 words + <num2>] + '.'
            parts = []
            for i, nm in enumerate(names):
                t = start_tok[nm]
                eot = int(np.argmax(t))
                # first segment keeps its SOT; later segments strip theirs
                seg = t[:eot - 1] if i == 0 else t[1:eot - 1]
                parts.append(np.concatenate(
                    [seg, [VOCAB_SIZE + weights[row, i]]]))
            flat = np.concatenate(parts + [tok_point])
            padded = np.zeros(77, np.int64)
            padded[:len(flat)] = flat[:77]
            output["tokens"].append(padded[None])
            output["embeds"].append(emb[None].astype(np.float32))
            output["updrs"].append(int(labels["updrs"][row]))
            output["diag"].append(int(labels["diag"][row]))

    for k in ("tokens", "embeds"):
        output[k] = np.concatenate(output[k], axis=0)
    output["updrs"] = np.asarray(output["updrs"])
    output["diag"] = np.asarray(output["diag"])

    os.makedirs(save_dir, exist_ok=True)
    suffix = "_raw" if keep_length else ""
    paths = {}
    data_path = osp.join(save_dir, f"data_dict{suffix}.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(output, f)
    paths["data"] = data_path
    emb_path = osp.join(save_dir, f"embed_dict{suffix}.pkl")
    with open(emb_path, "wb") as f:
        pickle.dump(embed_dict, f)
    paths["embed"] = emb_path

    if dict_from_data:   # reference __main__ tail (:352-378)
        paths.update(_group_by_label(output, save_dir, suffix))
    return paths


def build_slerp_metadata(part1: Dict[str, list],
                         text_params: Dict,
                         text_cfg: Optional[TextConfig] = None,
                         save_dir: str = "./data/gait/",
                         graduated: int = 100,
                         device=None) -> Dict[str, str]:
    """Per parameter: embed "short <name>" and "long <name>" through the
    frozen text tower, slerp between them weighted by the graduated
    (0..1-normalized) value; tokens carry number words as extended-vocab ids
    (reference metadata.py:270-305 semantics)."""
    text_cfg = text_cfg or TextConfig()
    params = tree_to(text_params, resolve_device(device))

    other = ["vidname", "updrs", "diag", "leglength"]
    value_names = [k for k in part1 if k not in other]
    labels = {"updrs": list(part1["updrs"]), "diag": list(part1["diag"])}

    tok_point = tokenize(".")[0, 1:3]
    output = {"tokens": [], "embeds": [], "updrs": [], "diag": []}
    key_embeds = {}
    for name in value_names:
        v = np.asarray(part1[name], float)
        # graduated weight in (0, 1)
        w = (v - v.min()) / max(v.max() - v.min(), 1e-9)
        w = np.clip(w, 1e-3, 1 - 1e-3)
        toks = tokenize([f"short {name}", f"long {name}"])
        embeds = encode_tokens(params, toks, text_cfg)
        key_embeds[name] = embeds[0]
        interp = slerp(embeds[0], embeds[1], weight=w)   # (num_rows, E)
        scaled = (w * graduated).astype(int)

        eot0 = int(np.argmax(toks[0]))
        for i in range(len(v)):
            row = np.zeros(77, np.int64)
            head = toks[0, :eot0 - 1]                    # SOT + words, no EOT
            row[:len(head)] = head
            row[len(head)] = scaled[i] + VOCAB_SIZE
            row[len(head) + 1:len(head) + 3] = tok_point
            output["tokens"].append(row[None])
            output["embeds"].append(interp[i][None].astype(np.float32))
            output["updrs"].append(int(labels["updrs"][i]))
            output["diag"].append(int(labels["diag"][i]))

    for k in ("tokens", "embeds"):
        output[k] = np.concatenate(output[k], axis=0)
    output["updrs"] = np.asarray(output["updrs"])
    output["diag"] = np.asarray(output["diag"])
    output["key_embed"] = key_embeds

    os.makedirs(save_dir, exist_ok=True)
    data_path = osp.join(save_dir, "data_dict.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(output, f)
    return {"data": data_path, **_group_by_label(output, save_dir, "")}


def main(argv=None):
    """Build the metadata dicts from a .csv or a .pkl column table and a
    reference CLIP backbone (.pth):

        python -m gava_clip_tpu_torch.offline.metadata [--device cpu] ...

    The text tower runs on the card unless `--device cpu`."""
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--metadata_file", type=str,
                        default="./decap/metadata.csv")
    parser.add_argument("--save_dir", type=str, default="./data/gait/")
    parser.add_argument("--keep_length", action="store_true")
    parser.add_argument("--no_dict_from_data", action="store_true")
    parser.add_argument("--backbone_path", type=str,
                        default="./pretrained/clip_pretrained.pth")
    parser.add_argument("--embed_dim", type=int, default=512)
    parser.add_argument("--text_width", type=int, default=512)
    parser.add_argument("--text_heads", type=int, default=8)
    parser.add_argument("--text_layers", type=int, default=12)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.metadata_file.endswith(".pkl"):
        with open(args.metadata_file, "rb") as f:
            metadata = pickle.load(f)
    else:
        import pandas as pd
        metadata = {c: s.tolist()
                    for c, s in pd.read_csv(args.metadata_file).items()}

    from ..utils.torch_convert import (convert_text_tower,
                                       load_torch_state_dict, strip_prefix)
    tcfg = TextConfig(embed_dim=args.embed_dim, width=args.text_width,
                      heads=args.text_heads, layers=args.text_layers)
    sd = strip_prefix(load_torch_state_dict(args.backbone_path), "textual.")
    text_params = convert_text_tower(sd, tcfg.layers)
    return build_metadata_dicts(metadata, text_params, tcfg,
                                save_dir=args.save_dir,
                                keep_length=args.keep_length,
                                dict_from_data=not args.no_dict_from_data,
                                device=device)


if __name__ == "__main__":
    main()
