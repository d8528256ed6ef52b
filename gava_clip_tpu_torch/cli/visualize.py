"""Embedding-space visualization (port of gava_clip_tpu/cli/visualize.py,
the counterpart of the reference's visualize.py / visualize_add.py): PCA /
t-SNE (/ UMAP when installed) projections of text / knowledge / NTE /
memory embedding spaces colored by label, modality cones, pairwise
cosine-similarity histograms and the number-word / PE studies.

    python -m gava_clip_tpu_torch.cli.visualize [--device cpu] \\
        --embeddings BANK.pkl [--method pca|tsne|umap] [--project_vlm CKPT]
        | --cones NAME=PATH ... | --pairwise NAME=PATH ... --base PATH
        | --study number|pe --backbone_path CLIP.pth

PCA runs in torch on the device (a centred SVD, with scikit-learn's sign
rule, so the points are sklearn's); t-SNE and UMAP keep their libraries
and raise SystemExit naming one that is missing. Every mode writes its
numbers (`.npz`: points and labels, similarity populations, study
matrices) and draws its figure only where matplotlib is installed (the
card's machine has neither matplotlib nor scikit-learn).
"""

import argparse
import os
import os.path as osp
import pickle

import numpy as np
import torch

from ..utils.device import resolve_device


def load_embeddings(path: str, label_key: str = "updrs"):
    """(.npy features, no labels) or memory-bank style .pkl."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32), None
    with open(path, "rb") as f:
        data = pickle.load(f)
    feats = np.asarray(data["embeds"], np.float32)
    if feats.ndim == 3:
        feats = feats.mean(-2)
    labels = np.asarray(data[label_key]).reshape(-1) if label_key in data else None
    return feats, labels


def pca(feats: np.ndarray, n_components: int = 2, device=None) -> np.ndarray:
    """Points of scikit-learn's `PCA(n_components).fit_transform(feats)`,
    computed on the device: the centred rows against the top right
    singular vectors, each vector's entry of largest magnitude made
    positive (sklearn's `svd_flip(u_based_decision=False)`); float32
    points. The SVD runs in float64: the card's float32 SVD moved the
    leading variances of 2,000 bank rows by 2e-4 relative."""
    x = torch.as_tensor(np.asarray(feats, np.float32),
                        device=resolve_device(device)).double()
    xc = x - x.mean(dim=0, keepdim=True)
    comps = torch.linalg.svd(xc, full_matrices=False)[2][:n_components]
    lead = comps.gather(1, comps.abs().argmax(dim=1, keepdim=True))
    comps = comps * torch.sign(lead)
    return (xc @ comps.T).float().cpu().numpy()


def _tsne(feats: np.ndarray, seed: int) -> np.ndarray:
    try:
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise SystemExit("scikit-learn is not installed (t-SNE)") from e
    return TSNE(n_components=2, random_state=seed, init="pca",
                perplexity=min(30, max(2, len(feats) // 4))
                ).fit_transform(feats)


def project(feats: np.ndarray, method: str = "pca", seed: int = 0,
            device=None) -> np.ndarray:
    if method == "pca":
        return pca(feats, 2, device)
    if method == "tsne":
        return _tsne(feats, seed)
    if method == "umap":
        try:
            import umap
        except ImportError as e:
            raise SystemExit("umap-learn is not installed") from e
        return umap.UMAP(n_components=2, random_state=seed).fit_transform(feats)
    raise ValueError(method)


def cosine_similarity_matrix(feats: np.ndarray) -> np.ndarray:
    n = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    return n @ n.T


def _parse_named(specs):
    """['name=path', ...] -> [(name, path)], name defaulting to basename."""
    out = []
    for s in specs:
        if "=" in s:
            name, path = s.split("=", 1)
        else:
            name, path = osp.splitext(osp.basename(s))[0], s
        out.append((name, path))
    return out


def cone_projection(named_embeds, method: str = "pca", seed: int = 0,
                    device=None):
    """Modality-cone scatter data (reference visualize.py:67-113): all
    modality groups are L2-normalized and jointly projected, to 3 PCA
    components or 2 of t-SNE; returns (points (N,3|2), labels list)."""
    feats, labels = [], []
    for name, emb in named_embeds:
        emb = np.asarray(emb, np.float32)
        feats.append(emb)
        labels.extend([name] * emb.shape[0])
    feats = np.concatenate(feats, axis=0)
    feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    if method == "pca":
        pts = pca(feats, 3, device)
    elif method == "tsne":
        pts = _tsne(feats, seed)
    else:
        raise ValueError(method)
    return pts, labels


def pairwise_similarity_split(base: np.ndarray, sub: np.ndarray):
    """Split pairwise cosine similarities of [base; sub] into base<->base
    and (base|sub)<->sub populations (reference visualize.py:116-153) —
    the per-modality histograms that expose the modality gap."""
    embed = np.concatenate([base, sub], axis=0)
    normed = embed / np.linalg.norm(embed, axis=-1, keepdims=True)
    sim = normed @ normed.T
    valid = np.triu(np.ones(sim.shape[0], dtype=bool), k=1)
    base_ids, sub_ids = valid.copy(), valid.copy()
    base_ids[:, -sub.shape[0]:] = False
    sub_ids[:, :-sub.shape[0]] = False
    return sim[base_ids].ravel(), sim[sub_ids].ravel()


def _plt():
    """pyplot, or None where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _save_matrix(mat, title, path, plt):
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(mat, interpolation="nearest", cmap="gray", origin="lower",
                   vmin=mat.min(), vmax=max(1.0, float(mat.max())))
    ax.set_title(title)
    fig.colorbar(im)
    plt.savefig(path, dpi=120)
    plt.close(fig)


def run_cones(args):
    named = [(n, load_embeddings(p, args.label_key)[0])
             for n, p in _parse_named(args.cones)]
    pts, labels = cone_projection(named, args.method, args.seed, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    stem = osp.join(args.output_dir, f"cones_{args.method}")
    np.savez(stem + ".npz", points=pts, labels=np.asarray(labels))
    out = {"npz": stem + ".npz"}
    plt = _plt()
    if plt is not None:
        fig, ax = plt.subplots(figsize=(8, 8))
        for name in dict.fromkeys(labels):      # insertion order
            m = np.asarray([l == name for l in labels])
            ax.scatter(pts[m, 0], pts[m, 1], s=8, alpha=0.6, label=name)
        ax.legend(title="modality cones")
        ax.set_title(f"modality cones ({args.method})")
        plt.savefig(stem + ".png", dpi=120)
        plt.close(fig)
        out["cones"] = stem + ".png"
    print(out)
    return {**out, "points": pts, "labels": labels}


def run_pairwise(args):
    base, _ = load_embeddings(args.base, args.label_key)
    plt = _plt()
    os.makedirs(args.output_dir, exist_ok=True)
    out = {}
    for name, path in _parse_named(args.pairwise):
        sub, _ = load_embeddings(path, args.label_key)
        bb, bs = pairwise_similarity_split(base, sub)
        print(f"{name}: mean base<->base {bb.mean():.4f}, "
              f"mean <->sub {bs.mean():.4f}, min {min(bb.min(), bs.min()):.4f}")
        stem = osp.join(args.output_dir, f"pairwise_{args.base_name}_{name}")
        np.savez(stem + ".npz", base_base=bb, base_sub=bs)
        out[name] = {"npz": stem + ".npz", "mean_base": float(bb.mean()),
                     "mean_sub": float(bs.mean())}
        if plt is not None:
            fig, ax = plt.subplots(figsize=(5, 4))
            ax.hist(bb, bins=50, alpha=0.4, label=args.base_name, density=True)
            ax.hist(bs, bins=50, alpha=0.4, label=name, density=True)
            ax.legend()
            plt.savefig(stem + ".png", dpi=120)
            plt.close(fig)
            out[name]["png"] = stem + ".png"
    return out


def run_study(args):
    """Number-word / PE geometry probes (reference
    prepare_embedding.py:35-238) against the frozen CLIP text tower, on
    the device."""
    from ..models.text import TextConfig
    from ..offline.embeddings import number_distance_study, pe_distance_study
    from ..utils.torch_convert import (convert_text_tower,
                                       load_torch_state_dict, strip_prefix)
    sd = strip_prefix(load_torch_state_dict(args.backbone_path), "textual.")
    tcfg = TextConfig(embed_dim=args.embed_dim, width=args.text_width,
                      heads=args.text_heads, layers=args.text_layers)
    params = convert_text_tower(sd, tcfg.layers)

    if args.study == "number":
        res = number_distance_study(params, tcfg, n=args.study_n,
                                    device=args.device)
        mats = {f"{key}_{kind}": (m[kind], f"{key}: {kind}")
                for key, m in res.items()
                for kind in ("similarity", "distance")}
        prefix = "number"
    else:
        res = pe_distance_study(params, tcfg, n=args.study_n,
                                device=args.device)
        mats = {kind: (res[kind], f"PE: {kind} between number words")
                for kind in ("similarity", "distance")}
        prefix = "pe"
    os.makedirs(args.output_dir, exist_ok=True)
    npz = osp.join(args.output_dir, f"{prefix}_study.npz")
    np.savez(npz, **{k: m for k, (m, _) in mats.items()})
    out = {"npz": npz}
    plt = _plt()
    if plt is not None:
        for k, (m, title) in mats.items():
            png = osp.join(args.output_dir, f"number_{k}.png"
                           if args.study == "number" else f"number_{k}_pe.png")
            _save_matrix(m, title, png, plt)
            out[k] = png
    print(out)
    return out


def _project_vlm(path: str, feats: np.ndarray, labels: np.ndarray):
    """The projected-NTE view (reference visualize_projected_NTE): each row
    through its class's memory_project MLP of a trained checkpoint,
    normalized; rows whose label has no MLP are dropped."""
    from .decode import _load_vlm_heads, replay_memory_projection
    assert labels is not None, "--project_vlm needs labeled embeddings"
    vlm_params, _ = _load_vlm_heads(path)
    n_cls = np.shape(vlm_params["memory_project"]["w1"])[0]
    valid = (labels >= 0) & (labels < n_cls)
    feats, labels = feats[valid], labels[valid]
    classes = np.unique(labels)
    sim, _ = replay_memory_projection(
        vlm_params, {f"class {c}": feats[labels == c] for c in classes})
    out = np.empty((len(feats), sim[f"class {classes[0]}"].shape[-1]),
                   np.float32)
    for c in classes:
        out[labels == c] = sim[f"class {c}"]
    return out, labels


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--embeddings", type=str, default="",
                        help=".npy features or memory-bank .pkl")
    parser.add_argument("--label_key", type=str, default="updrs")
    parser.add_argument("--method", choices=["pca", "tsne", "umap"],
                        default="pca")
    parser.add_argument("--heatmap", action="store_true",
                        help="also write a pairwise cosine-similarity heatmap")
    parser.add_argument("--max_points", type=int, default=2000)
    parser.add_argument("--output_dir", type=str, default="./vis_output")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="'cpu' to run on the host (default: the card)")
    # modality-cone scatter over several embedding files (visualize.py:67-113)
    parser.add_argument("--cones", type=str, nargs="+", default=None,
                        metavar="NAME=PATH")
    # pairwise-similarity histograms vs a base modality (visualize.py:116-153)
    parser.add_argument("--pairwise", type=str, nargs="+", default=None,
                        metavar="NAME=PATH")
    parser.add_argument("--base", type=str, default="")
    parser.add_argument("--base_name", type=str, default="metadata")
    # number-word / PE geometry studies (prepare_embedding.py:35-238)
    parser.add_argument("--study", choices=["number", "pe"], default=None)
    parser.add_argument("--study_n", type=int, default=100)
    parser.add_argument("--backbone_path", type=str,
                        default="./pretrained/clip_pretrained.pth")
    parser.add_argument("--embed_dim", type=int, default=512)
    parser.add_argument("--text_width", type=int, default=512)
    parser.add_argument("--text_heads", type=int, default=8)
    parser.add_argument("--text_layers", type=int, default=12)
    # projected-NTE view (reference visualize_add.py:84-255): project the
    # memory-bank embeds through a trained checkpoint's per-class
    # memory_project MLPs before the 2D embedding
    parser.add_argument("--project_vlm", type=str, default="")
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)   # no card, no 'cpu': raise

    if args.cones:
        return run_cones(args)
    if args.pairwise:
        assert args.base, "--pairwise requires --base"
        return run_pairwise(args)
    if args.study:
        return run_study(args)

    assert args.embeddings, "--embeddings required outside cone/pairwise/study"
    feats, labels = load_embeddings(args.embeddings, args.label_key)
    if args.project_vlm:
        feats, labels = _project_vlm(args.project_vlm, feats, labels)
    if len(feats) > args.max_points:
        idx = np.random.RandomState(args.seed).choice(
            len(feats), args.max_points, replace=False)
        feats = feats[idx]
        labels = labels[idx] if labels is not None else None

    pts = project(feats, args.method, args.seed, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    base = osp.splitext(osp.basename(args.embeddings))[0]
    stem = osp.join(args.output_dir, f"{base}_{args.method}")
    arrays = {"points": pts}
    if labels is not None:
        arrays["labels"] = labels
    if args.heatmap:
        arrays["similarity"] = cosine_similarity_matrix(feats[:256])
    np.savez(stem + ".npz", **arrays)
    out = {"npz": stem + ".npz"}

    plt = _plt()
    if plt is not None:
        fig, ax = plt.subplots(figsize=(8, 8))
        if labels is not None:
            for lab in np.unique(labels):
                m = labels == lab
                ax.scatter(pts[m, 0], pts[m, 1], s=8, label=str(lab), alpha=0.7)
            ax.legend(title=args.label_key)
        else:
            ax.scatter(pts[:, 0], pts[:, 1], s=8, alpha=0.7)
        ax.set_title(f"{base} ({args.method})")
        plt.savefig(stem + ".png", dpi=120)
        plt.close(fig)
        out["scatter"] = stem + ".png"
        if args.heatmap:
            fig, ax = plt.subplots(figsize=(8, 8))
            im = ax.imshow(arrays["similarity"], cmap="viridis")
            fig.colorbar(im)
            heat_path = osp.join(args.output_dir, f"{base}_similarity.png")
            plt.savefig(heat_path, dpi=120)
            plt.close(fig)
            out["heatmap"] = heat_path
    print(out)
    return out


if __name__ == "__main__":
    main()
