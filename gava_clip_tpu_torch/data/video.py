"""Host-side video decode, frame sampling and clip preparation (the port's
own copy of gava_clip_tpu/data/video.py; numpy + OpenCV). Decode is
need-driven: frame indices are chosen first and only those frames are
converted; resize and crop run on uint8.

OpenCV is imported when a function first needs it, not with the module:
a machine that only classifies ready-made clips, or trains from the
decoded-view cache, needs no decoder.
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


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def parse_data_list(list_path: str) -> List[Tuple[str, int]]:
    """`<path>,<label>` per line."""
    out = []
    with open(list_path) as f:
        for line in f.read().splitlines():
            if not line.strip():
                continue
            path, label = line.rsplit(",", 1)
            out.append((path, int(label)))
    return out


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


def sample_frame_indices(num_video_frames: int, num_frames: int,
                         sampling_rate: int, random_sample: bool,
                         rng: Optional[np.random.RandomState] = None
                         ) -> List[int]:
    """Random / TSN / strided sampling."""
    rng = rng or np.random
    if random_sample:
        if sampling_rate < 0:  # TSN
            seg = (num_video_frames - 1) / num_frames
            return [int(rng.randint(round(seg * i), round(seg * (i + 1)) + 1))
                    for i in range(num_frames)]
        if sampling_rate * (num_frames - 1) + 1 >= num_video_frames:
            out = []
            for i in range(num_frames):
                out.append(i * sampling_rate
                           if i * sampling_rate < num_video_frames
                           else out[-1])
            return out
        start = int(rng.randint(
            num_video_frames - sampling_rate * (num_frames - 1)))
        return list(range(start, start + sampling_rate * num_frames,
                          sampling_rate))
    raise ValueError("use temporal_crop_indices for deterministic sampling")


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
                       interpolation=None, use_native: bool = False
                       ) -> np.ndarray:
    """Short-side resize on uint8 frames, bilinear with half-pixel
    centers. cv2 is the usual path; the native frame pipeline serves where
    cv2 is absent and on explicit request."""
    T, H, W, C = frames.shape
    if H < W:
        new_h, new_w = spatial_size, W * spatial_size // H
    else:
        new_h, new_w = H * spatial_size // W, spatial_size
    if (use_native or not _have_cv2()) and frames.dtype == np.uint8 \
            and interpolation is None:
        from . import native
        if native.available():
            return native.resize_bilinear(frames, new_h, new_w)
    cv2 = _cv2()
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


def spatial_crops(frames: np.ndarray, size: int,
                  num_views: int) -> List[np.ndarray]:
    """1 center crop or 3 sliding crops."""
    H, W = frames.shape[1:3]
    if num_views == 1:
        assert min(H, W) >= size
        return [center_crop(frames, size)]
    if num_views == 3:
        assert min(H, W) == size
        margin = max(H, W) - size
        crops = []
        for st in (0, margin // 2, margin):
            if H > W:
                crops.append(frames[:, st:st + size, :])
            else:
                crops.append(frames[:, :, st:st + size])
        return crops
    raise NotImplementedError(num_views)


def random_resized_crop_params(height: int, width: int,
                               scale=(0.08, 1.0),
                               ratio=(3.0 / 4.0, 4.0 / 3.0),
                               rng: Optional[np.random.RandomState] = None,
                               max_tries: int = 10
                               ) -> Tuple[int, int, int, int]:
    """Inception-style crop box: area / log-ratio sampling with a center
    fallback."""
    rng = rng or np.random
    area = height * width
    for _ in range(max_tries):
        target_area = float(rng.uniform(*scale)) * area
        ar = float(np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]))))
        w = int(round(np.sqrt(target_area * ar)))
        h = int(round(np.sqrt(target_area / ar)))
        if 0 < w <= width and 0 < h <= height:
            i = int(rng.randint(0, height - h + 1))
            j = int(rng.randint(0, width - w + 1))
            return i, j, h, w
    # fallback: center crop at in-range aspect
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def random_short_side_scale_jitter(frames: np.ndarray, min_size: int,
                                   max_size: int,
                                   inverse_uniform_sampling: bool = False,
                                   rng: Optional[np.random.RandomState] = None
                                   ) -> np.ndarray:
    """Short-side scale jitter on (T, H, W, C) frames: a target short side
    uniform in [min_size, max_size] (or the reciprocal of a uniform inverse
    scale), bilinear resize keeping aspect."""
    rng = rng or np.random
    if inverse_uniform_sampling:
        size = int(round(1.0 / rng.uniform(1.0 / max_size, 1.0 / min_size)))
    else:
        size = int(round(rng.uniform(min_size, max_size)))
    T, H, W, C = frames.shape
    if (W <= H and W == size) or (H <= W and H == size):
        return frames
    new_h = new_w = size
    if W < H:
        new_h = int(np.floor(float(H) / W * size))
    else:
        new_w = int(np.floor(float(W) / H * size))
    cv2 = _cv2()
    out = np.empty((T, new_h, new_w, C), frames.dtype)
    for t in range(T):
        out[t] = cv2.resize(frames[t], (new_w, new_h),
                            interpolation=cv2.INTER_LINEAR)
    return out


def horizontal_flip(prob: float, frames: np.ndarray,
                    rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Horizontal flip with probability `prob` on (T, H, W, C) frames."""
    rng = rng or np.random
    if rng.uniform() < prob:
        return frames[:, :, ::-1]
    return frames


def resized_crop_with_shift(frames: np.ndarray, size: int,
                            box_first, box_last) -> np.ndarray:
    """Linearly interpolate two (i, j, h, w) crop boxes across the frames,
    crop and bilinear-resize each frame to size x size."""
    cv2 = _cv2()
    T = frames.shape[0]
    coords = np.stack([np.linspace(a, b, T) for a, b in
                       zip(box_first, box_last)], axis=1).astype(int)
    out = np.empty((T, size, size, frames.shape[3]), frames.dtype)
    for t, (i, j, h, w) in enumerate(coords):
        out[t] = cv2.resize(frames[t, i:i + h, j:j + w], (size, size),
                            interpolation=cv2.INTER_LINEAR)
    return out


def random_resized_crop_with_shift(frames: np.ndarray, size: int,
                                   scale=(0.8, 1.0),
                                   ratio=(3.0 / 4.0, 4.0 / 3.0),
                                   rng: Optional[np.random.RandomState] = None
                                   ) -> np.ndarray:
    """Per-frame shifted random resized crop: two independent crop boxes
    for the first and the last frame, interpolated between."""
    H, W = frames.shape[1:3]
    b0 = random_resized_crop_params(H, W, scale, ratio, rng)
    b1 = random_resized_crop_params(H, W, scale, ratio, rng)
    return resized_crop_with_shift(frames, size, b0, b1)


def random_resized_crop(frames: np.ndarray, size: int,
                        scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                        rng: Optional[np.random.RandomState] = None,
                        use_native: bool = False) -> np.ndarray:
    """Temporally consistent random resized crop on uint8 frames."""
    i, j, h, w = random_resized_crop_params(frames.shape[1], frames.shape[2],
                                            scale, ratio, rng)
    if (use_native or not _have_cv2()) and frames.dtype == np.uint8:
        from . import native
        if native.available():
            return native.crop_resize(frames, i, j, h, w, size, size)
    cv2 = _cv2()
    cropped = frames[:, i:i + h, j:j + w]
    out = np.empty((frames.shape[0], size, size, frames.shape[3]),
                   frames.dtype)
    for t in range(cropped.shape[0]):
        out[t] = cv2.resize(cropped[t], (size, size),
                            interpolation=cv2.INTER_LINEAR)
    return out
