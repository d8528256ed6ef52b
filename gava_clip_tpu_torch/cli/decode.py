"""Feature -> gait-sentence decoding (port of gava_clip_tpu/cli/decode.py,
the counterpart of the reference's training/decode.py).

    python -m gava_clip_tpu_torch.cli.decode --decap_ckpt CKPT [--device cpu]
        (--features F.npy|BANK.pkl | --vlm_ckpt C --memory_bank BANK.pkl
         [--use_centroid] | --pe_probe) ...

Greedy decoding with number-token interception: tokens >= 49408 are
numbers; their quantized value is de-scaled back to physical units via the
scale-dict pickle and substituted for the '?' placeholder, with the
parameter identity recovered by byte-matching the preceding words against
the known parameter names (decode.py:127-182). The decoder runs on the
card unless `--device cpu`; the study modes' projections are numpy.
"""

import argparse
import pickle
from typing import Dict, Optional

import numpy as np

from ..models.decap import (DecapConfig, descale_number,
                            make_batched_decoder, make_greedy_decoder)
from ..text import ClipBpeTokenizer
from ..text.tokenizer import SOT_TOKEN
from ..utils.device import resolve_device, tree_to

COMMA_TOKEN = 267


def load_decap(path: str, device=None):
    """A DeCap checkpoint of either package -> (params on the resolved
    device, config)."""
    from ..utils.jax_bridge import decap_params_from_jax
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    cfg = DecapConfig(**ckpt["config"]) if "config" in ckpt else DecapConfig()
    params = decap_params_from_jax(ckpt["params"], cfg,
                                   device=resolve_device(device))
    return params, cfg


def decode_feature(params, cfg: DecapConfig, feature: np.ndarray,
                   scale_dict: Optional[Dict] = None,
                   tokenizer: Optional[ClipBpeTokenizer] = None,
                   decoder=None) -> str:
    """`decoder`: a prebuilt make_greedy_decoder(params, cfg), to share
    across many features; one is built per call without it."""
    tokenizer = tokenizer or ClipBpeTokenizer()
    tokens, numbers = (decoder or make_greedy_decoder(params, cfg))(feature)
    return render_caption(tokens, numbers, scale_dict, tokenizer)


def render_caption(tokens: list, numbers: list,
                   scale_dict: Optional[Dict],
                   tokenizer: ClipBpeTokenizer) -> str:
    """Decoded (tokens, numbers) -> final gait sentence: SOT-to-comma
    rewrite, BPE detokenize, '?' slots filled with (de-scaled) numbers."""
    # repeated SOT tokens become commas (decode.py:127-130)
    sot_ids = [i for i, t in enumerate(tokens) if t == SOT_TOKEN]
    for i in sot_ids[:-1]:
        tokens[i] = COMMA_TOKEN
    text = tokenizer.decode(tokens)
    text = text.replace("<|startoftext|>", "")
    words = text.split()
    q_ids = [i for i, w in enumerate(words) if w == "?"]

    if scale_dict is not None and q_ids:
        extra = scale_dict["extra_info"]
        names = [k for k in scale_dict if k != "extra_info"]
        # byte-match decoded words against known parameter names (:138-166)
        short = [" ".join(n.split()[:-1]) or n for n in names]
        str_len = max(len(s.replace(" ", "")) for s in short)
        key_arr = np.vstack([
            np.frombuffer((s.replace(" ", "") + "_" * str_len)[:str_len].encode(),
                          dtype=np.uint8) for s in short])
        prev = 0
        for qid, n in zip(q_ids, numbers):
            frag = "".join(words[prev:qid])
            frag = (frag + "_" * str_len)[:str_len]
            eqs = np.frombuffer(frag.encode(), np.uint8)[None, :] == key_arr
            kid = int(np.argmax(eqs.sum(1)))
            words[qid] = str(descale_number(n, scale_dict[names[kid]], extra))
            prev = qid + 1
    else:
        for qid, n in zip(q_ids, numbers):
            words[qid] = str(n)

    out = " ".join(words)
    return out.replace("<|startoftext|>", "").replace("<|endoftext|>", "").strip()


def _load_vlm_heads(path: str):
    """memory_project / tf_project / text_features of a trained VLM
    checkpoint: a .ckpt of either package or a reference torch .pth
    (decode.py:288-353). Orbax directories raise (they need JAX;
    `train/checkpoint.py` names the conversion)."""
    from ..train.checkpoint import load_checkpoint
    ckpt = load_checkpoint(path)
    text_features = ckpt.get("text_features")
    if "torch_state_dict" in ckpt:
        from ..utils.torch_convert import convert_vita_clip
        sd = ckpt["torch_state_dict"]
        n_cls = len({k.split(".")[1] for k in sd
                     if k.startswith("memory_project.")})
        params = convert_vita_clip(sd, vision_layers=12, text_layers=12,
                                   num_classes=n_cls)
    else:
        params = ckpt["params"]
    params = {k: v for k, v in params.items()
              if k in ("memory_project", "tf_project")}
    if "memory_project" not in params:
        raise ValueError(f"{path} carries no support-memory head")
    return params, (np.asarray(text_features, np.float32)
                    if text_features is not None else None)


def group_support_memory(bank: Dict, cls_type: str) -> Dict[str, np.ndarray]:
    """Group memory-bank embeds per class label — 'updrs k' / 'diag k' keys,
    invalid label -1 dropped (reference decode.py:249-268)."""
    labels = np.asarray(bank[cls_type]).flatten()
    embeds = np.asarray(bank["embeds"], np.float32)
    out: Dict[str, np.ndarray] = {}
    for lab in sorted(set(labels.tolist())):
        if lab == -1:
            continue
        out[f"{cls_type} {lab}"] = embeds[labels == lab]
    return out


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def replay_memory_projection(vlm_params: Dict, support: Dict[str, np.ndarray]):
    """Project the grouped support memory through the VLM's per-class
    memory_project MLP bank (reference decode.py:288-377): 3-view banks are
    view-averaged first; both projected and raw features are normalized."""
    mp = {k: np.asarray(v) for k, v in vlm_params["memory_project"].items()}
    sim_support, raw_support = {}, {}
    for key, v in support.items():
        c = int(key.split(" ")[-1])
        if v.ndim == 3:
            v = v.mean(axis=-2)
        h = np.tanh(v @ mp["w1"][c] + mp["b1"][c])
        sim_support[key] = _l2n(h @ mp["w2"][c] + mp["b2"][c])
        raw_support[key] = _l2n(v)
    return sim_support, raw_support


def centroid_study(decap_params, cfg, sim_support, raw_support,
                   scale, tok) -> Dict[str, str]:
    """Per-class centroid decoding (reference decode.py:446-462): the
    centroid of the projected class memory weights a linear combination of
    the raw memory, which is decoded back to a gait sentence."""
    out = {}
    decoder = make_greedy_decoder(decap_params, cfg)
    for key, emb_val in sim_support.items():
        centroid = _l2n(emb_val.mean(axis=0))
        lc_weights = emb_val @ centroid                     # (N,)
        text_embedding = _l2n(lc_weights @ raw_support[key])
        out[key] = decode_feature(decap_params, cfg, text_embedding,
                                  scale, tok, decoder=decoder)
    return out


def class_feature_study(decap_params, cfg, vlm_params, text_features,
                        sim_support, raw_support, scale, tok,
                        cls_type: str) -> Dict[str, str]:
    """Per-class learned-text-feature decoding (reference decode.py:484-497):
    replay tf_project on the checkpoint's text_features, softmax-weight the
    projected class memory by similarity, decode the weighted combination."""
    tp = vlm_params["tf_project"]
    h = np.tanh(text_features @ np.asarray(tp["fc1"]["kernel"])
                + np.asarray(tp["fc1"]["bias"]))
    tf_proj = _l2n(h @ np.asarray(tp["fc2"]["kernel"])
                   + np.asarray(tp["fc2"]["bias"]))
    out = {}
    decoder = make_greedy_decoder(decap_params, cfg)
    for c in range(tf_proj.shape[0]):
        key = f"{cls_type} {c}"
        if key not in sim_support:
            continue
        sim = tf_proj[c] @ sim_support[key].T
        w = np.exp(sim * 100 - (sim * 100).max())
        w = w / w.sum()                                     # softmax(sim*100)
        text_embedding = _l2n(w @ raw_support[key])
        out[key] = decode_feature(decap_params, cfg, text_embedding,
                                  scale, tok, decoder=decoder)
    return out


def pe_probe(decap_params, cfg, backbone_path: str, scale, tok,
             text_format: str = "the person walks with X steps per minute .",
             percents=range(30, 130, 14), text_cfg=None,
             device=None) -> Dict[int, str]:
    """PE probe (reference decode.py:52-86): the SAME sentence embedding is
    reused for every value — only the additive sinusoidal PE row varies —
    probing whether PE alone steers the decoded number. The text tower runs
    on the resolved device."""
    from ..models.text import TextConfig
    from ..offline.metadata import default_pe
    from ..offline.preprocess import encode_tokens
    from ..text import tokenize
    from ..utils.torch_convert import (convert_text_tower,
                                       load_torch_state_dict, strip_prefix)

    sd = strip_prefix(load_torch_state_dict(backbone_path), "textual.")
    tcfg = text_cfg or TextConfig()
    params = tree_to(convert_text_tower(sd, tcfg.layers),
                     resolve_device(device))
    tokens = tokenize([" ".join(text_format.split())])
    base = encode_tokens(params, tokens, tcfg)[0]

    out = {}
    pe = default_pe()
    decoder = make_greedy_decoder(decap_params, cfg)
    for percent in percents:
        emb = base + pe[round(percent), :base.shape[-1]]
        out[percent] = decode_feature(decap_params, cfg,
                                      emb.astype(np.float32), scale, tok,
                                      decoder=decoder)
    return out


def _write_lines(lines, path: str) -> None:
    for ln in lines:
        print(ln)
    with open(path, "w") as fo:
        fo.write("\n".join(lines))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--decap_ckpt", type=str, required=True)
    parser.add_argument("--features", type=str, default="",
                        help=".npy (N, 512) features or memory-bank .pkl")
    parser.add_argument("--scale_dict", type=str, default="")
    parser.add_argument("--output", type=str, default="decoded.txt")
    parser.add_argument("--limit", type=int, default=16)
    # study modes (reference decode.py:446-497, :52-86)
    parser.add_argument("--vlm_ckpt", type=str, default="",
                        help="trained VLM checkpoint whose memory/tf "
                             "projections and text_features are replayed")
    parser.add_argument("--memory_bank", type=str, default="",
                        help="memory-bank .pkl for per-class support memory")
    parser.add_argument("--use_centroid", action="store_true")
    parser.add_argument("--cls_type", type=str, default="updrs",
                        choices=["updrs", "diag"])
    parser.add_argument("--pe_probe", action="store_true")
    parser.add_argument("--backbone_path", type=str,
                        default="./pretrained/clip_pretrained.pth")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    params, cfg = load_decap(args.decap_ckpt, device)
    scale = None
    if args.scale_dict:
        with open(args.scale_dict, "rb") as f:
            scale = pickle.load(f)
    tok = ClipBpeTokenizer()

    if args.pe_probe:
        probe = pe_probe(params, cfg, args.backbone_path, scale, tok,
                         device=device)
        _write_lines([f"Percent: {p}, Generated text: {t}"
                      for p, t in probe.items()], args.output)
        return probe

    if args.memory_bank and args.vlm_ckpt:
        vlm_params, text_features = _load_vlm_heads(args.vlm_ckpt)
        with open(args.memory_bank, "rb") as f:
            bank = pickle.load(f)
        support = group_support_memory(bank, args.cls_type)
        sim_support, raw_support = replay_memory_projection(vlm_params, support)
        if args.use_centroid:
            study = centroid_study(params, cfg, sim_support, raw_support,
                                   scale, tok)
            header = "CENTROID"
        else:
            study = class_feature_study(params, cfg, vlm_params,
                                        text_features, sim_support,
                                        raw_support, scale, tok,
                                        args.cls_type)
            header = "PER-CLASS TEXT FEATURES"
        _write_lines([header] + [f"{k} : {v}" for k, v in study.items()],
                     args.output)
        return study

    if not args.features:
        parser.error("--features is required outside the study modes")
    if args.features.endswith(".pkl"):
        with open(args.features, "rb") as f:
            bank = pickle.load(f)
        feats = np.asarray(bank["embeds"], np.float32)
        if feats.ndim == 3:
            feats = feats.mean(-2)
    else:
        feats = np.load(args.features).astype(np.float32)
    feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)

    # bulk path: the batched K/V-cached decoder, 8 captions a batch
    take = feats[:args.limit]
    decoded = (make_batched_decoder(params, cfg,
                                    batch=min(8, len(take)))(take)
               if len(take) else [])
    lines = [render_caption(tokens, numbers, scale, tok)
             for tokens, numbers in decoded]
    _write_lines(lines, args.output)
    return lines


if __name__ == "__main__":
    main()
