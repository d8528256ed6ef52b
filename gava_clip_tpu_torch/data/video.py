"""Host-side video decode and clip preparation for serving (the port's own
copy of what it needs from gava_clip_tpu/data/video.py; numpy + OpenCV).

OpenCV is imported when a function first needs it, not with the module:
a machine that only classifies ready-made clips needs no decoder.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

# seek only pays when skipping more than roughly one GOP: an ffmpeg
# POS_FRAMES seek lands on the keyframe before the target and decodes
# forward internally, so short gaps are cheaper to read through
SEEK_MIN_GAP = 32


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV (cv2) is required for video decode and "
                           "resize") from e
    cv2.setNumThreads(0)
    return cv2


def parse_classes_file(path: str) -> Tuple[List[str], List[str]]:
    """Returns (classnames, class_labels). Lines starting with '*' are class
    labels and their count defines num_classes; a list without '*' lines
    (k400 / ucf / hmdb) makes every line a class."""
    with open(path) as f:
        lines = [x for x in f.read().strip().split("\n") if x.strip()]
    classnames = [x for x in lines if x[0] != "*"]
    labels = [x[1:] for x in lines if x[0] == "*"]
    if not labels:
        labels = list(classnames)
    return classnames, labels


def decode_frames(path: str, indices: Optional[Sequence[int]] = None,
                  allow_seek: bool = True) -> np.ndarray:
    """Decode a video to RGB uint8 frames (T, H, W, 3). With `indices`, only
    those (sorted, possibly repeated) frames are returned. Sparse index
    sets seek when a gap exceeds SEEK_MIN_GAP; every seek is validated by
    its landing position (undershoot reads forward, overshoot disables
    seeking and restarts sequentially). allow_seek=False forces one
    sequential pass."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    frames = []
    if indices is None:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    else:
        want = list(indices)
        decoded = {}
        pos = 0                       # index of the next frame cap will return
        seek_ok = allow_seek
        for i in sorted(set(want)):
            if i < pos:               # already passed (only after a re-open)
                continue
            if seek_ok and i - pos > SEEK_MIN_GAP:
                cap.set(cv2.CAP_PROP_POS_FRAMES, i)
                landed = int(cap.get(cv2.CAP_PROP_POS_FRAMES))
                if 0 <= landed <= i:
                    pos = landed
                else:                 # unreliable seek: restart sequentially
                    seek_ok = False
                    cap.release()
                    cap = cv2.VideoCapture(path)
                    pos = 0
            ok = True
            while ok and pos <= i:
                ok, frame = cap.read()
                if ok:
                    if pos == i:
                        decoded[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    pos += 1
            if not ok:
                break                 # ran off the end; clamp below
        if not decoded:
            raise IOError(f"no frames decoded: {path}")
        last = max(decoded)
        frames = [decoded.get(min(i, last), decoded[last]) for i in want]
    cap.release()
    return np.stack(frames)


def video_num_frames(path: str) -> int:
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if n <= 0:
        # fallback: count by decoding
        n = 0
        while cap.read()[0]:
            n += 1
    cap.release()
    return n


def temporal_crop_indices(num_video_frames: int, num_frames: int,
                          sampling_rate: int,
                          num_temporal_views: int) -> List[List[int]]:
    """Deterministic temporal crops with last-frame padding."""
    seg_len = (num_frames - 1) * sampling_rate + 1
    padded_len = max(num_video_frames, seg_len)
    slide = padded_len - seg_len
    crops = []
    for i in range(num_temporal_views):
        st = slide // 2 if num_temporal_views == 1 else round(
            slide / (num_temporal_views - 1) * i)
        crops.append([min(st + k * sampling_rate, num_video_frames - 1)
                      for k in range(num_frames)])
    return crops


def keep_aspect_resize(frames: np.ndarray, spatial_size: int,
                       interpolation=None) -> np.ndarray:
    """Short-side resize on uint8 frames, bilinear with half-pixel
    centers."""
    cv2 = _cv2()
    T, H, W, C = frames.shape
    if H < W:
        new_h, new_w = spatial_size, W * spatial_size // H
    else:
        new_h, new_w = H * spatial_size // W, spatial_size
    interpolation = interpolation or cv2.INTER_LINEAR
    out = np.empty((T, new_h, new_w, C), frames.dtype)
    for t in range(T):
        out[t] = cv2.resize(frames[t], (new_w, new_h),
                            interpolation=interpolation)
    return out


def center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    H, W = frames.shape[1:3]
    h0 = (H - size) // 2
    w0 = (W - size) // 2
    return frames[:, h0:h0 + size, w0:w0 + size]
