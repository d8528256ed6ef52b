"""Offline video preparation: chunking, LOSO fold assembly, label conversion,
resize caching, bbox crops and straight-walk segmentation (the port's own
copy of gava_clip_tpu/offline/video_prep.py; host only, numpy + OpenCV).

The reference's ffmpeg-subprocess tooling rebuilt with cv2's FFmpeg
backend:
  * split_videos_into_chunks — training/train_utils.py:57-177: fixed-length
    chunks (stride 30 train / non-overlapping val, tail chunk when >= 20
    frames remain, short videos padded by repeating the last frame), chunk
    files named <vid>*<i>.mp4, shuffled train/val_{diag,updrs}.csv.
  * build_loso_folds — train_utils.py:611-649: sorted-subject LOSO folds.
  * convert_3cls_csv — train_utils.py:219-248.
  * resize_videos — resize_videos.py: short-side resize cache.
  * find_turning_points / cut_straight_segments — training/tulip_utils.py:
    30-176: split a back-and-forth walking video into one-way _CC<i>
    subsequences at filtered x-trajectory extrema.

cv2 is imported when a function first decodes or encodes, as in
data/video.py: without it those functions raise, and the csv, fold and
label functions run anywhere.
"""

import csv
import os
import os.path as osp
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.video import _cv2, decode_frames, keep_aspect_resize

MIN_REST = 20
STRIDE = 30


def load_label_table(path: str) -> Dict[str, Tuple[int, int]]:
    """{vidname: (diag, score)} from xlsx (sheet label_info), csv, or pkl."""
    if path.endswith(".xlsx"):
        import pandas as pd
        df = pd.read_excel(path, sheet_name="label_info")
        return {str(r["vidname"]): (int(r["diag"]), int(r["score"]))
                for _, r in df.iterrows()}
    if path.endswith(".pkl"):
        import pickle
        with open(path, "rb") as f:
            d = pickle.load(f)
        rows = d["label_info"] if "label_info" in d else d
        return {str(v): (int(diag), int(score))
                for v, diag, score in zip(rows["vidname"], rows["diag"],
                                          rows["score"])}
    out = {}
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0] == "vidname":
                continue
            out[row[0]] = (int(row[1]), int(row[2]))
    return out


def _write_chunk(frames: np.ndarray, path: str, fps: int = 30):
    cv2 = _cv2()
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for fr in frames:
        writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
    writer.release()


def chunk_start_indices(num_frames: int, seqlen: int, is_train: bool,
                        stride: int = STRIDE, min_rest: int = MIN_REST) -> np.ndarray:
    """Chunk start frames (reference train_utils.py:104-126): train = stride
    grid trimmed so every chunk fits, plus a tail chunk when >= min_rest-1
    frames remain; val = non-overlapping."""
    last_frame = num_frames - 1
    if is_train:
        index = np.arange(0, last_frame, stride)
        while len(index) and last_frame - index[-1] < seqlen - 1:
            index = index[:-1]
        if len(index) and last_frame - index[-1] - seqlen >= min_rest - 1:
            index = np.append(index, last_frame - seqlen)
    else:
        index = np.arange(0, last_frame, seqlen)
        if len(index) and last_frame - index[-1] < seqlen - 1:
            index = index[:-1]
    return index


def split_videos_into_chunks(viddir: str, label_table: Dict[str, Tuple[int, int]],
                             outdir: str, seqlen: int = 70,
                             val_subs: Sequence[str] = ("Subject_1",),
                             fps: int = 30, seed: int = 0) -> Dict[str, List[str]]:
    if osp.isdir(outdir):
        shutil.rmtree(outdir)
    os.makedirs(outdir, exist_ok=True)
    vidnames = sorted(x.split(".")[0] for x in os.listdir(viddir)
                      if x.endswith(".mp4"))

    train_rows, val_rows = {}, {}
    train_names, val_names = [], []
    for vn in vidnames:
        sub = "_".join(vn.split("_")[:2])
        (val_names if sub in val_subs else train_names).append(vn)

    for vn in vidnames:
        is_train = vn in train_names
        base = vn.split("_CC")[0] if "CC" in vn else vn
        if base not in label_table:
            continue
        diag, score = label_table[base]
        frames = decode_frames(osp.join(viddir, vn + ".mp4"))
        last_frame = len(frames) - 1
        if last_frame < seqlen - 6:
            print(f"Video {vn} has only {last_frame + 1} frames !!")
            continue
        if last_frame < seqlen - 1:
            pad = np.repeat(frames[-1:], seqlen - 1 - last_frame, axis=0)
            frames = np.concatenate([frames, pad])
            last_frame = seqlen - 1
        index = chunk_start_indices(last_frame + 1, seqlen, is_train)
        assert len(index) > 0
        for i, st in enumerate(index):
            name = f"{vn}*{i}.mp4"
            _write_chunk(frames[st:st + seqlen], osp.join(outdir, name), fps)
            (train_rows if is_train else val_rows)[name] = (diag, score)

    rs = np.random.RandomState(seed)
    for rows, split in ((train_rows, "train"), (val_rows, "val")):
        keys = list(rows.keys())
        keys = [keys[i] for i in rs.permutation(len(keys))]
        with open(osp.join(outdir, f"{split}_diag.csv"), "w", newline="") as f:
            w = csv.writer(f)
            for k in keys:
                w.writerow([k, rows[k][0]])
        with open(osp.join(outdir, f"{split}_updrs.csv"), "w", newline="") as f:
            w = csv.writer(f)
            for k in keys:
                w.writerow([k, rows[k][1]])
    return {"train": train_names, "val": val_names}


def build_loso_folds(viddir: str, label_table: Dict[str, Tuple[int, int]],
                     out_root: str, nfold: int = 10, seqlen: int = 70) -> Dict:
    """Leave-one-subject-out fold assembly (train_utils.py:611-641)."""
    subnames = sorted({"_".join(v.split("_")[:2]) for v in label_table},
                      key=lambda x: int(x.split("_")[1]))
    per_fold = len(subnames) // nfold
    if per_fold == 0:
        raise ValueError(f"{len(subnames)} subjects cannot fill {nfold} folds")
    sets = [subnames[i * per_fold:(i + 1) * per_fold] for i in range(nfold - 1)]
    sets.append(subnames[(nfold - 1) * per_fold:])
    split_names = {}
    for n in range(nfold):
        split_names[n] = split_videos_into_chunks(
            viddir, label_table, osp.join(out_root, f"chunks_{n}"),
            seqlen=seqlen, val_subs=sets[n])
    return split_names


def convert_3cls_csv(diag_csv: str, score_csv: str, no_healthy: bool = False):
    """Multi-class -> 3-class label conversion (train_utils.py:219-248):
    diag {0}->0, {1,3}->1, rest->2 (shifted down when no_healthy);
    score clipped at 2. Writes *_3cls.csv next to the inputs."""
    def remap_diag(v):
        if v == 0:
            if no_healthy:
                raise ValueError("healthy samples present with no_healthy")
            return 0
        if v in (1, 3):
            return 0 if no_healthy else 1
        return 1 if no_healthy else 2

    for path, remap in ((diag_csv, remap_diag),
                        (score_csv, lambda v: min(v, 2))):
        rows = []
        with open(path) as f:
            for row in csv.reader(f):
                if row:
                    rows.append([row[0], remap(int(row[1]))])
        with open(path.replace(".csv", "_3cls.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerows(rows)


def resize_videos(src_dir: str, dst_dir: str, short_side: int = 256,
                  fps: Optional[int] = None):
    """Short-side-resize video cache (reference resize_videos.py, cv2-based)."""
    cv2 = _cv2()
    os.makedirs(dst_dir, exist_ok=True)
    done = []
    for fn in sorted(os.listdir(src_dir)):
        if not fn.endswith((".mp4", ".avi", ".mkv", ".webm")):
            continue
        frames = decode_frames(osp.join(src_dir, fn))
        if min(frames.shape[1:3]) > short_side:
            frames = keep_aspect_resize(frames, short_side)
        out = osp.join(dst_dir, osp.splitext(fn)[0] + ".mp4")
        cap = cv2.VideoCapture(osp.join(src_dir, fn))
        src_fps = fps or int(round(cap.get(cv2.CAP_PROP_FPS))) or 30
        cap.release()
        _write_chunk(frames, out, src_fps)
        done.append(out)
    return done


def find_turning_points(x_center: np.ndarray, fps: int = 30,
                        cutoff_hz: float = 0.25, offset: float = 0.1) -> List[int]:
    """Turning points of a back-and-forth walk: extrema of the low-pass
    filtered horizontal center trajectory, excluding the near-edge band
    (reference tulip_utils.py:30-90 semantics)."""
    from scipy import signal
    x = np.asarray(x_center, float)
    b, a = signal.butter(2, min(cutoff_hz / (fps / 2), 0.99))
    xf = signal.filtfilt(b, a, x)
    lo = x.min() + offset * (x.max() - x.min())
    hi = x.max() - offset * (x.max() - x.min())
    maxima = signal.argrelextrema(xf, np.greater, order=fps // 2)[0]
    minima = signal.argrelextrema(xf, np.less, order=fps // 2)[0]
    pts = sorted(int(p) for p in np.concatenate([maxima, minima])
                 if xf[p] <= lo or xf[p] >= hi)
    return pts


def cut_straight_segments(video_path: str, x_center: np.ndarray,
                          out_dir: str, fps: int = 30,
                          min_len: int = 30) -> List[str]:
    """Cut a video into one-way walking subsequences `_CC<i>.mp4` at the
    turning points (reference tulip_utils.py:100-176)."""
    os.makedirs(out_dir, exist_ok=True)
    frames = decode_frames(video_path)
    pts = find_turning_points(x_center, fps)
    bounds = [0] + pts + [len(frames)]
    base = osp.splitext(osp.basename(video_path))[0]
    outs = []
    seg_id = 0
    for st, ed in zip(bounds[:-1], bounds[1:]):
        if ed - st < min_len:
            continue
        out = osp.join(out_dir, f"{base}_CC{seg_id}.mp4")
        _write_chunk(frames[st:ed], out, fps)
        outs.append(out)
        seg_id += 1
    return outs


def crop_frame_with_bbox(frame: np.ndarray, c_x: float, c_y: float,
                         bsize: float, out_size: int = 256) -> np.ndarray:
    """Crop one frame around a tracking bbox and resize to out_size²
    (reference train_utils.py:495-574 inner loop): the box half-size is
    bsize*224/2, the crop is clamped to the image, zero-padded to square on
    the bottom/right, then resized."""
    half = int(bsize * 224 / 2)
    x1, y1 = int(c_x) - half, int(c_y) - half
    x2, y2 = int(c_x) + half, int(c_y) + half
    x1, y1 = max(x1, 0), max(y1, 0)
    y2, x2 = min(y2, frame.shape[0]), min(x2, frame.shape[1])
    crop = frame[y1:y2, x1:x2]
    w, h = x2 - x1, y2 - y1
    if w > h:
        crop = np.concatenate(
            [crop, np.zeros((w - h, w, 3), dtype=np.uint8)], axis=0)
    elif h > w:
        crop = np.concatenate(
            [crop, np.zeros((h, h - w, 3), dtype=np.uint8)], axis=1)
    return _cv2().resize(crop, (out_size, out_size))


def crop_videos_with_bbox(vid_dir: str, bbox_path: str, out_dir: str,
                          fps: int = 30, out_size: int = 256) -> List[str]:
    """Crop videos to per-subsequence tracking bboxes and write 256²
    subsequence clips (reference train_utils.py crop_video_with_bbox,
    :495-574) — cv2 decode/encode replaces the reference's tmp-PNG + ffmpeg
    round trip. The bbox file is a pickled/joblib dict
    {seqname: {'bbox': (N,3) [cx, cy, size], 'frame_ids': (N,)}} where
    seqname starts with the source video stem."""
    os.makedirs(out_dir, exist_ok=True)
    try:
        import joblib
        bbox_dict = joblib.load(bbox_path)
    except ImportError:
        import pickle
        with open(bbox_path, "rb") as f:
            bbox_dict = pickle.load(f)
    outs = []
    for vn in sorted(x for x in os.listdir(vid_dir) if x.endswith(".mp4")):
        stem = vn.split(".")[0]
        seqnames = [s for s in bbox_dict if s.startswith(stem)]
        if not seqnames:
            continue
        frames = decode_frames(osp.join(vid_dir, vn))  # RGB
        for sn in seqnames:
            bbox = np.asarray(bbox_dict[sn]["bbox"], float)
            fids = np.asarray(bbox_dict[sn]["frame_ids"], int)
            crops = np.stack([
                crop_frame_with_bbox(frames[fid], *bbox[i], out_size=out_size)
                for i, fid in enumerate(fids) if fid < len(frames)])
            out = osp.join(out_dir, f"{sn}.mp4")
            _write_chunk(crops, out, fps)
            outs.append(out)
    return outs


def gold_standard_to_label(csv_file: str, vid_dir: str,
                           out_path: str = "data/tulip_label_60.xlsx") -> str:
    """Gold-standard csv -> label table with a `label_info` sheet (reference
    train_utils.py gold_standard2label, :576-609): per camera video, look up
    the subject's diag ('HT' -> 0, else 1) and gold-standard score. Falls
    back to .pkl with the same column dict when no xlsx engine is installed
    (load_label_table reads both)."""
    import pandas as pd
    data = pd.read_csv(csv_file, header=0)
    data = data[["Subject", "gold_standard", "diag"]].to_numpy()
    label_info = {"vidname": [], "diag": [], "score": []}
    vid_names = [x for x in os.listdir(vid_dir) if x.endswith(".mp4")]
    vid_names = sorted(vid_names, key=lambda x: int(
        x.split("_")[1] + x.split("Camera")[1][0]))
    for vn in vid_names:
        sub_id = int(vn.split("_")[1])
        row = np.where(data[:, 0] == sub_id)[0]
        diag = 0 if data[row, 2][0] == "HT" else 1
        label_info["vidname"].append(vn.split(".")[0])
        label_info["diag"].append(diag)
        label_info["score"].append(data[row, 1][0])
    try:
        with pd.ExcelWriter(out_path) as writer:
            pd.DataFrame(label_info).to_excel(writer, sheet_name="label_info",
                                              index=False)
    except (ImportError, ValueError, ModuleNotFoundError):
        import pickle
        out_path = out_path.rsplit(".", 1)[0] + ".pkl"
        with open(out_path, "wb") as f:
            pickle.dump({"label_info": label_info}, f)
    return out_path


def annotations_to_csv(video_dir: str, out_csv: str,
                       class_to_label: Optional[Dict[str, int]] = None):
    """Directory-of-class-folders -> `<path>,<label>` csv (reference
    prepare_csv.py K400 path)."""
    rows = []
    classes = sorted(d for d in os.listdir(video_dir)
                     if osp.isdir(osp.join(video_dir, d)))
    class_to_label = class_to_label or {c: i for i, c in enumerate(classes)}
    for c in classes:
        for fn in sorted(os.listdir(osp.join(video_dir, c))):
            if fn.endswith((".mp4", ".avi", ".mkv", ".webm")):
                rows.append([osp.join(c, fn), class_to_label[c]])
    with open(out_csv, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return rows


def class_distribution(chunks_root: str, nfold: Optional[int] = None) -> Dict:
    """Per-class sample counts across folds (reference
    train_utils.get_average_class_distribution, :250-296)."""
    import csv as _csv
    folds = sorted(d for d in os.listdir(chunks_root)
                   if d.startswith("chunks_") and
                   osp.isdir(osp.join(chunks_root, d)))
    if nfold is not None:
        folds = folds[:nfold]
    score_counts: Dict[int, int] = {}
    diag_counts: Dict[int, int] = {}
    for fold in folds:
        for split in ("train", "val"):
            for name, counts in (("diag", diag_counts), ("updrs", score_counts)):
                path = osp.join(chunks_root, fold, f"{split}_{name}.csv")
                if not osp.isfile(path):
                    continue
                with open(path) as f:
                    for row in _csv.reader(f):
                        if row:
                            lab = int(row[1])
                            counts[lab] = counts.get(lab, 0) + 1
    n = max(len(folds), 1)
    return {"updrs": {k: v / n for k, v in sorted(score_counts.items())},
            "diag": {k: v / n for k, v in sorted(diag_counts.items())},
            "nfold": len(folds)}
