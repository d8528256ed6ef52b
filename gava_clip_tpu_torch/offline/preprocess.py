"""Gait-parameter metadata -> support-memory bank + per-video NTE matrices
(port of gava_clip_tpu/offline/preprocess.py).

Normalizes each gait parameter against the healthy-subject mean,
leg-length-normalizes distance / speed / MOS values, encodes numbers either
as an orthogonal [NUM] embedding (SVD construction, the default) or as
scaled sinusoidal position encodings with an optimized L2 norm, enumerates
all C(n, 4) parameter combinations, renders each combination as four
"<param name> is <number>" sentence embeddings through the frozen CLIP
text tower, and writes:

  <save_dir>/<base>_dict_basic_4f.pkl    memory bank {embeds (N,4,E),
                                         updrs, diag, tokens, text}
  <save_dir>/<base>_scale_dict_basic_4f.pkl  de-scaling metadata
  <video_dir>/nte/<vid>.npy              per-video (n_comb, E) NTE

with the JAX package's keys and dtypes, so either package reads the
other's files. The text tower is the port's `models/text.py` in fp32 with
the plain attention, on the resolved device (the card unless the caller
asks for the CPU). Every sentence of every combination goes through it, in
the JAX package's order, as one stream cut into calls of
`PreprocessConfig.batch_rows` sentences; each sentence's two variable
token slots are filled on the device from index vectors.
"""

import math
import os
import os.path as osp
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.text import TextConfig, encode_text_embeds, encode_text_tokens
from ..text import tokenize
from ..text.tokenizer import EOT_TOKEN, VOCAB_SIZE
from ..utils.device import resolve_device, tree_to

N_LEVELS = 200          # number-token quantization levels (reference N)
SUBSET_LEN = 4
MAX_TEXT_LEN = 77


@dataclass
class PreprocessConfig:
    no_pe: bool = True          # True: orthogonal [NUM] embedding (default run)
    new_pe: bool = False
    l2_norm: Optional[float] = None
    separate: bool = True       # keep 4 per-sentence embeddings (SEPERATE)
    filter_correlated: bool = False
    d_model: int = 512
    batch_rows: int = 4096      # text-tower sentences per device call


def sinusoidal_pe(n: int, d_model: int) -> np.ndarray:
    """Row-normalized sinusoidal position table (reference :55-63)."""
    pe = np.zeros((n, d_model), np.float64)
    pos = np.arange(n)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe / np.linalg.norm(pe, axis=-1, keepdims=True)


def orthogonal_num_embedding(pe: np.ndarray) -> np.ndarray:
    """[NUM] embedding orthogonal to the PE rows via SVD (reference
    :185-194; https://arxiv.org/abs/2310.02989)."""
    d = pe.shape[1]
    a = np.vstack([pe[:d - 1], np.zeros((1, d))])
    u, s, vt = np.linalg.svd(a)
    ss = np.zeros((d, d))
    ss[-1, -1] = 1
    ne = (u @ ss @ vt)[-1]
    norm = np.linalg.norm(ne)
    if norm < 1e-12:
        # degenerate u[-1,-1]=0 case: take the null-space direction directly
        ne = vt[-1]
        norm = np.linalg.norm(ne)
    return ne / norm


def enumerate_combinations(n: int, k: int = SUBSET_LEN) -> List[np.ndarray]:
    """All size-k index subsets in the reference's meshgrid traversal order
    (:236-275) — the order defines NTE row identity."""
    index = np.arange(n)
    grid = np.array(np.meshgrid(*([index] * k))).T.reshape(-1, k)
    combos: List[np.ndarray] = []
    seen_set = set()
    for row in grid:
        key = frozenset(int(x) for x in row)
        if len(key) < k or key in seen_set:
            continue
        seen_set.add(key)
        combos.append(row.copy())
    if len(combos) != math.comb(n, k):
        raise AssertionError(f"{len(combos)} combinations of {n}, expected "
                             f"{math.comb(n, k)}")
    return combos


def load_metadata(path: str) -> Tuple[Dict[str, list], Dict[str, str]]:
    """Metadata table: .xlsx (sheets part1/unit — the reference format) or a
    .pkl {part1, unit} produced by offline/gait_params.save_metadata."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            d = pickle.load(f)
        return d["part1"], {k: (v if isinstance(v, str) else "")
                            for k, v in d["unit"].items()}
    import pandas as pd
    part1 = pd.read_excel(path, sheet_name="part1").to_dict(orient="list")
    unit = pd.read_excel(path, sheet_name="unit").to_dict(orient="list")
    unit = {k: (v[0] if isinstance(v[0], str) else "") for k, v in unit.items()}
    return part1, unit


def encode_tokens(params, tokens: np.ndarray, text_cfg: TextConfig
                  ) -> np.ndarray:
    """Token ids (N, 77) -> pooled fp32 features on the host, through the
    tower on the device of `params`."""
    device = params["token_embedding"].device
    with torch.inference_mode():
        return encode_text_tokens(
            params, torch.from_numpy(np.asarray(tokens)).to(device),
            text_cfg).cpu().numpy()


def number_rows(levels: torch.Tensor, no_pe: bool, ne: torch.Tensor,
                pe: torch.Tensor) -> torch.Tensor:
    """The number slot of each sentence: level x the [NUM] embedding, or the
    level's PE row; float64 products rounded to fp32 once, as numpy's
    float64 rows assigned into the JAX package's float32 batch."""
    if no_pe:
        return (levels.double()[:, None] * ne[None]).float()
    return pe[levels].float()


def encode_sentences(params, template: torch.Tensor, eot_pos: int,
                     name_embeds: torch.Tensor, name_idx: torch.Tensor,
                     levels: torch.Tensor, no_pe: bool, ne: torch.Tensor,
                     pe: torch.Tensor, text_cfg: TextConfig,
                     batch_rows: int) -> np.ndarray:
    """"<name> is <number>" sentences (N = len(name_idx)) through the text
    tower on the device of `params`: the template's token embeddings
    (L, W) with slot 1 <- name_embeds[name_idx[i]] and slot 3 <- the number
    row of levels[i], pooled at the EOT slot, in calls of `batch_rows`.
    Returns the pooled features (N, E) as fp32 on the host."""
    n = name_idx.shape[0]
    out = np.empty((n, text_cfg.embed_dim), np.float32)
    with torch.inference_mode():
        for s in range(0, n, batch_rows):
            e = min(n, s + batch_rows)
            batch = template[None].repeat(e - s, 1, 1)
            batch[:, 1] = name_embeds[name_idx[s:e]]
            batch[:, 3] = number_rows(levels[s:e], no_pe, ne, pe)
            eot = torch.full((e - s,), eot_pos, dtype=torch.int32,
                             device=batch.device)
            out[s:e] = encode_text_embeds(params, batch, eot,
                                          text_cfg).cpu().numpy()
    return out


def data_preprocess(metadata_file: str,
                    text_params: Dict,
                    text_cfg: TextConfig = TextConfig(),
                    save_dir: str = "./data/gait/",
                    video_dir: str = "./datasets/tulip",
                    cfg: PreprocessConfig = PreprocessConfig(),
                    device=None) -> Dict[str, str]:
    """Write the bank, the scale dict and the NTE files (see the module
    docstring); returns their paths. `text_params` is the port's text-tower
    tree (`utils.jax_bridge.text_params_from_jax` carries a JAX one)."""
    device = resolve_device(device)
    params = tree_to(text_params, device)
    part1, unit_dict = load_metadata(metadata_file)
    os.makedirs(save_dir, exist_ok=True)

    other = ["vidname", "updrs", "diag", "leglength"]
    video_names = list(part1["vidname"])
    value_names = [k for k in part1.keys() if k not in other]
    unit_dict = {k: unit_dict.get(k, "") for k in value_names}

    diag = np.asarray(part1["diag"], int)
    updrs = np.asarray(part1["updrs"], int)
    normal_idx = np.where(diag == 0)[0]
    if normal_idx.size == 0:
        normal_idx = np.where(updrs == 1)[0]
    leg_lengths = np.asarray(part1["leglength"], float)

    d_model = cfg.d_model
    pe = sinusoidal_pe(1000, d_model)

    # --- per-parameter normalization (reference :118-165) -------------------
    new_dict: Dict[str, np.ndarray] = {}
    raw_dict: Dict[str, np.ndarray] = {}
    scale_dict: Dict[str, Dict] = {}
    max_value = 0.0
    for name in value_names:
        v = np.asarray(part1[name], float).copy()
        if ("distance" in name) or ("speed" in name) or \
                ("margin of stability" in name.lower()):
            v /= leg_lengths.mean()
        raw_dict[name] = v.copy()
        mean = v[normal_idx].mean()
        std = v.std()
        v = (v - mean) / std
        if cfg.no_pe:
            shift, weight = 0.0, 2.5 / np.abs(v).max()
        else:
            shift, weight = -v.min(), 1.0
        v = (v + shift) * weight
        if cfg.no_pe and not np.abs(v).max() < 5.0:
            raise AssertionError(f"{name}: scaled values reach "
                                 f"{np.abs(v).max()}")
        max_value = max(max_value, v.max())
        scale_dict[name] = {"mean": mean, "std": std, "shift": shift,
                            "weight": weight}
        new_dict[name] = v

    # --- parameter-name embeddings through the frozen text tower ------------
    tokens = tokenize(value_names)                       # (P, 77)
    base_embeds = encode_tokens(params, tokens, text_cfg)
    base_embeds = base_embeds / np.linalg.norm(base_embeds, axis=-1, keepdims=True)

    # --- number-embedding setup (reference :176-222) -------------------------
    l2_norm = cfg.l2_norm
    ne = np.zeros(d_model)
    if cfg.no_pe:
        ne = orthogonal_num_embedding(pe)
        graduated = 5.0 / N_LEVELS
        scale_dict["extra_info"] = {"graduated": graduated, "l2_norm": "n/a",
                                    "global_shift": N_LEVELS / 2}
    else:
        if not cfg.new_pe and l2_norm is None:
            # optimize the PE scale so two far-apart numbers appended to a
            # probe sentence land at the mean name-name similarity (:196-212)
            from scipy.optimize import minimize
            probe = encode_tokens(params, tokenize("the walking speed is"),
                                  text_cfg)[0]
            probe /= np.linalg.norm(probe)
            name_sims = base_embeds @ base_embeds.T
            pe0, pe1 = pe[0], pe[250]

            def objective(l):
                a = probe + pe0 * l
                b = probe + pe1 * l
                a /= np.linalg.norm(a)
                b /= np.linalg.norm(b)
                return (a @ b - name_sims.mean()) ** 2
            l2_norm = float(minimize(objective, x0=1.0, tol=1e-9).x[0])
        pe = pe * (l2_norm or 1.0)
        graduated = max_value / (N_LEVELS - 1)
        scale_dict["extra_info"] = {"graduated": graduated, "l2_norm": l2_norm}

    # --- "X is X" sentence template (reference :179-183) ---------------------
    ne_tok = tokenize("X is X")                          # [SOT, X, is, X, EOT]
    eot_pos = int(np.argmax(ne_tok[0] == EOT_TOKEN))

    num_rows = len(video_names)
    combos = enumerate_combinations(len(value_names))

    if cfg.filter_correlated:
        all_values = np.vstack([raw_dict[n] for n in value_names])
        pearson = np.corrcoef(all_values)
        combos = [c for c in combos
                  if all(abs(pearson[c[i], c[j]]) <= 0.4
                         for i in range(SUBSET_LEN)
                         for j in range(i + 1, SUBSET_LEN))]

    # quantized levels of every combination's four rows
    levels = []
    for comb in combos:
        values = np.vstack([new_dict[value_names[i]] for i in comb])
        scaled = values / graduated
        if cfg.no_pe:
            scaled = scaled + N_LEVELS / 2
        if scaled.min() < 0:
            raise AssertionError(f"negative number level {scaled.min()}")
        levels.append(scaled.astype(int))                # (4, num_rows)

    # the sentences of every combination, in the JAX package's order:
    # combination, then slot, then video
    n_comb = len(combos)
    if cfg.no_pe or cfg.new_pe:
        name_idx = np.concatenate([np.repeat(c, num_rows) for c in combos])
        flat_levels = np.concatenate([lv.reshape(-1) for lv in levels])
        template = params["token_embedding"][
            torch.from_numpy(ne_tok[0]).long().to(device)].float()
        pooled_all = encode_sentences(
            params, template, eot_pos,
            torch.from_numpy(base_embeds).to(device),
            torch.from_numpy(name_idx).long().to(device),
            torch.from_numpy(flat_levels).long().to(device), cfg.no_pe,
            torch.from_numpy(ne).to(device), torch.from_numpy(pe).to(device),
            text_cfg, cfg.batch_rows)
        pooled_all = pooled_all.reshape(n_comb, SUBSET_LEN, num_rows, -1)

    token_point = tokenize(".")[0, 1:3]
    output = {"embeds": [], "updrs": [], "diag": [], "tokens": [], "text": []}
    nte = np.empty((num_rows, n_comb, d_model), np.float32)

    for ci, (comb, scaled) in enumerate(zip(combos, levels)):
        embs = base_embeds[comb]                         # (4, W)
        if cfg.no_pe or cfg.new_pe:
            pooled = pooled_all[ci]
            pooled /= np.linalg.norm(pooled, axis=-1, keepdims=True)
        else:
            nes = pe[scaled.reshape(-1)].reshape(SUBSET_LEN, num_rows, d_model)
            pooled = embs[:, None, :] + nes
            pooled /= np.linalg.norm(pooled, axis=-1, keepdims=True)

        if cfg.separate:
            pooled = pooled.transpose(1, 0, 2)           # (num_rows, 4, W)
            nte[:, ci] = pooled.mean(axis=1)
        else:
            pooled = pooled.mean(axis=0)
            pooled /= np.linalg.norm(pooled, axis=-1, keepdims=True)
            nte[:, ci] = pooled

        # natural-language texts (:324-335)
        base_text = " _ , ".join(value_names[i] for i in comb) + " _"
        words = np.array(base_text.split())
        num_pos = np.where(words == "_")[0]
        texts = np.repeat(words[None], num_rows, axis=0).astype(object)
        for ip, pos in enumerate(num_pos):
            nums = np.round(raw_dict[value_names[comb[ip]]], 3).astype(str)
            unit = unit_dict[value_names[comb[ip]]]
            texts[:, pos] = [f"{n} {unit}" for n in nums]
        texts = [" ".join(t) for t in texts.tolist()]

        # joint tokens with number tokens >= VOCAB_SIZE (:336-349)
        tks = tokens[comb]
        tok = np.zeros((num_rows, MAX_TEXT_LEN), np.float32)
        end_ids = np.argmax(tks, axis=-1)
        prev = 0
        for j in range(SUBSET_LEN):
            start = 0 if j == 0 else 1
            seg = tks[j, start:end_ids[j]]
            tok[:, prev:prev + len(seg)] = seg
            tok[:, prev + len(seg)] = scaled[j] + VOCAB_SIZE
            prev += len(seg) + 1
        tok[:, prev:prev + 2] = token_point

        output["embeds"].append(pooled.astype(np.float32))
        output["updrs"].append(updrs.reshape(num_rows, 1))
        output["diag"].append(diag.reshape(num_rows, 1))
        output["tokens"].append(tok)
        output["text"].extend(texts)

    # per-video NTE files (:400-404)
    nte_dir = osp.join(video_dir, "nte")
    os.makedirs(nte_dir, exist_ok=True)
    for vid, vn in enumerate(video_names):
        np.save(osp.join(nte_dir, f"{vn}.npy"), nte[vid])

    for k in ("embeds", "updrs", "diag", "tokens"):
        output[k] = np.concatenate(output[k], axis=0)

    base = osp.basename(metadata_file).split("_")[0].replace(".", "")
    data_path = osp.join(save_dir, f"{base}_dict_basic_{SUBSET_LEN}f.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(output, f)
    scale_dict["extra_info"].update(unit_dict)
    scale_path = data_path.replace("dict", "scale_dict")
    with open(scale_path, "wb") as f:
        pickle.dump(scale_dict, f)
    return {"data": data_path, "scale": scale_path, "nte_dir": nte_dir}
