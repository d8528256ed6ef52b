"""Datasets: video (train/val/eval), support memory, dummies (the port's own
copy of gava_clip_tpu/data/datasets.py; numpy only).

Behaviour mirrors the reference's video_dataset/dataset.py. The datasets
emit uint8 frame arrays; the float normalize runs on the device
(data/device_preprocess.py).
"""

import os
import os.path as osp
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import video as V

NUM_COMB = 70


@dataclass
class VideoDatasetConfig:
    list_path: str = ""
    data_root: str = ""
    num_spatial_views: int = 1
    num_temporal_views: int = 1
    random_sample: bool = False
    num_frames: int = 8
    sampling_rate: int = 1          # -1 = TSN
    spatial_size: int = 224
    mirror: bool = False
    auto_augment: Optional[str] = None
    is_train: bool = True
    add_nte: bool = False
    cls_type: str = ""
    num_folds: int = 1
    nte_dim: int = 512
    return_all_views: bool = False  # beyond parity: reference keeps view 0
    allow_seek: bool = True         # False = sequential decode (ref parity)
    # beyond parity: uint8 decoded-view cache. The deterministic (non-
    # random_sample) path always produces the same views for a clip, so the
    # decode + resize + crop work can be paid once and reread as raw npy.
    # The reference's offline resize_videos.py plays the same role one stage
    # earlier (re-encoded smaller video).
    cache_dir: str = ""


class VideoDataset:
    """Decode + sample + spatially prepare one clip; returns uint8 frames.

    __getitem__ ->
      train: (frames (V?,T,S,S,3) uint8, label, nte (70,512) f32)
      eval:  (frames, label, vidname)
    matching reference dataset.py:79-158 (with V views stacked; the reference
    keeps only view 0 at train, reproduced here).
    """

    def __init__(self, cfg: VideoDatasetConfig, seed: int = 0):
        self.cfg = cfg
        self.nte_root = osp.join(cfg.data_root, "nte")
        self.rng = np.random.RandomState(seed)
        if cfg.num_folds > 1:
            # multi-fold eval list assembly (reference dataset.py:59-69)
            assert cfg.cls_type in ("updrs", "updrs_3cls", "diag", "diag_3cls")
            self.data_list = []
            for nf in range(cfg.num_folds):
                lp = osp.join(cfg.data_root, f"chunks_{nf}", f"val_{cfg.cls_type}.csv")
                for path, label in V.parse_data_list(lp):
                    self.data_list.append((osp.join(f"chunks_{nf}", path), label))
        else:
            self.data_list = V.parse_data_list(cfg.list_path)

    def __len__(self):
        return len(self.data_list)

    def _cache_path(self, rel_path: str) -> Optional[str]:
        cfg = self.cfg
        if not cfg.cache_dir:
            return None
        import hashlib
        key = (f"{rel_path}|{cfg.spatial_size}|{cfg.num_frames}|"
               f"{cfg.sampling_rate}|{cfg.num_spatial_views}|"
               f"{cfg.num_temporal_views}")
        return osp.join(cfg.cache_dir,
                        hashlib.sha1(key.encode()).hexdigest()[:20] + ".npy")

    def _cached_views(self, rel_path: str) -> Optional[np.ndarray]:
        p = self._cache_path(rel_path)
        if p is not None and osp.isfile(p):
            return np.load(p)
        return None

    def _cache_store(self, rel_path: str, views: np.ndarray) -> None:
        p = self._cache_path(rel_path)
        if p is None:
            return
        os.makedirs(self.cfg.cache_dir, exist_ok=True)
        # write-to-temp + rename: loader worker threads may race on the
        # same clip; rename is atomic so readers never see a partial file
        tmp = f"{p}.{os.getpid()}.{id(views):x}.tmp.npy"
        np.save(tmp, views)
        os.replace(tmp, p)

    def _load_nte(self, rel_path: str) -> np.ndarray:
        """NTE side-channel (reference dataset.py:141-155)."""
        if "SUB" in rel_path:
            npy_fn = "_".join(osp.basename(rel_path).split("_")[:-1]) + ".npy"
        else:
            npy_fn = rel_path.replace("fvid", "vid").split("*")[0].split(".")[0] + ".npy"
        p = osp.join(self.nte_root, npy_fn)
        if osp.isfile(p):
            return np.load(p).astype(np.float32)
        return np.zeros((NUM_COMB, self.cfg.nte_dim), np.float32)

    def __getitem__(self, idx: int):
        cfg = self.cfg
        rel_path, label = self.data_list[idx]
        path = osp.join(cfg.data_root, rel_path)

        if cfg.random_sample:
            n = V.video_num_frames(path)
            indices = V.sample_frame_indices(n, cfg.num_frames, cfg.sampling_rate,
                                             random_sample=True, rng=self.rng)
            frames = V.decode_frames(path, indices, allow_seek=cfg.allow_seek)
            # DOCUMENTED DEVIATION (augmentation order): the reference
            # RandAugments full decoded frames and random-resized-crops
            # afterwards (video_dataset/dataset.py:98-113). Here the crop
            # happens host-side FIRST (so only S x S uint8 pixels cross to
            # the device) and RandAugment runs on-device on the cropped clip
            # (data/device_preprocess.make_train_augment). Distributionally
            # close (geometric ops commute with the crop up to border
            # handling, colour ops are pixelwise) but not the literal
            # reference recipe.
            if cfg.mirror and self.rng.rand() < 0.5:
                frames = frames[:, :, ::-1]
            frames = V.random_resized_crop(frames, cfg.spatial_size, rng=self.rng)
            views = frames[None]
        else:
            views = self._cached_views(rel_path)
            if views is None:
                frames = V.decode_frames(path)
                frames = V.keep_aspect_resize(frames, cfg.spatial_size)
                sp = V.spatial_crops(frames, cfg.spatial_size,
                                     cfg.num_spatial_views)
                views = []
                for crop in sp:
                    for tidx in V.temporal_crop_indices(
                            crop.shape[0], cfg.num_frames,
                            cfg.sampling_rate, cfg.num_temporal_views):
                        views.append(crop[tidx])
                views = np.stack(views)
                self._cache_store(rel_path, views)

        if cfg.is_train:
            frames_out = views[0]  # reference keeps view 0 (dataset.py:139)
            nte = self._load_nte(rel_path) if cfg.add_nte else np.zeros(
                (NUM_COMB, cfg.nte_dim), np.float32)
            return frames_out, label, nte
        vidname = osp.basename(path).split(".")[0]
        if cfg.return_all_views:
            # beyond parity: expose every spatial x temporal view for
            # logit-averaged evaluation (the reference always keeps view 0,
            # dataset.py:137-139)
            return views, label, vidname
        return views[0], label, vidname


class DummyDataset:
    """All-zero videos for speed tests (reference dataset.py:220-236)."""

    def __init__(self, list_path: str, num_frames: int, num_views: int,
                 spatial_size: int, nte_dim: int = 512):
        if list_path and osp.isfile(list_path):
            with open(list_path) as f:
                self._len = len(f.read().splitlines())
        else:
            self._len = 64
        self.num_frames = num_frames
        self.num_views = num_views
        self.spatial_size = spatial_size
        self.nte_dim = nte_dim

    def __len__(self):
        return self._len

    def __getitem__(self, _):
        shape = (self.num_frames, self.spatial_size, self.spatial_size, 3)
        if self.num_views != 1:
            shape = (self.num_views,) + shape
        return (np.zeros(shape, np.uint8), 0,
                np.zeros((NUM_COMB, self.nte_dim), np.float32))


class DummyMemoDataset:
    """Zero memory embeddings (reference dataset.py:238-250)."""

    def __init__(self, num_cls: int = 2, batch_size: int = 64, embed_size: int = 512):
        self.num_cls = num_cls
        self.batch_size = batch_size
        self.embed_size = embed_size

    def __len__(self):
        return self.batch_size * 1000

    def __getitem__(self, idx):
        return np.zeros((self.num_cls, self.embed_size), np.float32), 0


class MemoryDataset:
    """Precomputed gait-parameter sentence embeddings + labels from the
    memory-bank pickle (reference dataset.py:252-297): label filtering,
    4->3-class remap, zero-shot diag label surgery, one-time shuffle."""

    def __init__(self, data_path: str, cls_type: str, batch_size: int = 64,
                 for_zero_shot: bool = True, shuffle_seed: Optional[int] = 0):
        self.batch_size = batch_size
        cls_type = cls_type.lower()
        base = cls_type.split("_")[0]
        assert base in ("updrs", "diag")
        with open(data_path, "rb") as f:
            data = pickle.load(f)
        embeds = np.asarray(data["embeds"], np.float32)
        labels = np.asarray(data[base]).reshape(-1)

        valid = labels >= 0
        labels, embeds = labels[valid], embeds[valid]

        if cls_type in ("diag_3cls", "updrs_3cls") and labels.max() > 2:
            remap = np.vectorize(lambda x: 0 if x == 0 else 1 if x in (1, 3) else 2)
            labels = remap(labels)
        if for_zero_shot and cls_type == "diag":
            early_ad = np.where(labels == 2)[0]
            severe_ad = np.where(labels == 4)[0]
            labels[labels == 3] = 2
            drop = np.concatenate([early_ad, severe_ad])
            labels = np.delete(labels, drop)
            embeds = np.delete(embeds, drop, axis=0)
        elif for_zero_shot and cls_type == "diag_3cls":
            keep = labels > 0
            labels, embeds = labels[keep] - 1, embeds[keep]

        perm = (np.random.RandomState(shuffle_seed).permutation(len(labels))
                if shuffle_seed is not None else np.random.permutation(len(labels)))
        self.labels = labels[perm].astype(np.int64)
        self.data = embeds[perm]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        return self.data[idx], self.labels[idx]
