"""Batch loaders (the port's own copy of gava_clip_tpu/data/loader.py; numpy
batches): deterministic step-driven train / memory loaders and strided
val / eval loaders, with a thread-pool prefetcher (cv2 releases the GIL
during decode / resize, so threads parallelize the IO-bound path; the
compute-bound normalize runs on the device).

Mirrors the factory surface of video_dataset/dataloader.py:
create_train_loader / create_val_loader / create_eval_loader /
create_memory_loader, driven by the same config fields.
"""

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from .datasets import (DummyDataset, DummyMemoDataset, MemoryDataset,
                       VideoDataset, VideoDatasetConfig)
from .sampler import eval_sampler, step_sampler


@dataclass
class LoaderConfig:
    # paths
    train_list_path: str = ""
    val_list_path: str = ""
    eval_list_path: str = ""
    data_root: str = ""
    train_data_root: str = ""
    val_data_root: str = ""
    eval_data_root: str = ""
    # shapes
    batch_size: int = 4
    num_frames: int = 8
    sampling_rate: int = 1
    tsn_sampling: bool = False
    spatial_size: int = 224
    num_spatial_views: int = 1
    num_temporal_views: int = 10
    # normalize (host mean/std kept for config parity; applied on device)
    mean: Optional[List[float]] = None
    std: Optional[List[float]] = None
    # augment
    auto_augment: Optional[str] = None
    mirror: bool = True
    # memory
    use_support_memory: bool = False
    memory_data_path: str = ""
    mem_batch_size: int = 64
    for_zero_shot: bool = False
    # misc
    allow_seek: bool = True  # False = sequential decode (VFR-safe parity)
    cache_dir: str = ""      # uint8 decoded-view cache (datasets.py)
    num_workers: int = 4
    dummy_dataset: bool = False
    eval_all_views: bool = False
    add_nte: bool = False
    num_steps: int = 0
    type: str = "updrs"
    nfold: int = 1
    embed_dim: int = 512


class _Prefetcher:
    """Index-driven thread-pool prefetcher preserving order."""

    def __init__(self, fetch_fn, index_batches: List[np.ndarray],
                 num_workers: int = 4, prefetch: int = 2):
        self.fetch_fn = fetch_fn
        self.index_batches = index_batches
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.index_batches)

    def __iter__(self) -> Iterator:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = [pool.submit(self.fetch_fn, idxs)
                           for idxs in self.index_batches[:self.prefetch + 1]]
                next_submit = self.prefetch + 1
                for i in range(len(self.index_batches)):
                    if stop.is_set():
                        break
                    out_q.put(futures[i].result())
                    if next_submit < len(self.index_batches):
                        futures.append(pool.submit(self.fetch_fn,
                                                   self.index_batches[next_submit]))
                        next_submit += 1
            out_q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()


def _collate_video(dataset, idxs) -> Dict[str, np.ndarray]:
    frames, labels, ntes = [], [], []
    for i in idxs:
        f, l, n = dataset[int(i)]
        frames.append(f)
        labels.append(l)
        ntes.append(n)
    return {"video": np.stack(frames), "labels": np.asarray(labels, np.int32),
            "nte": np.stack(ntes)}


def _collate_eval(dataset, idxs):
    frames, labels, names = [], [], []
    for i in idxs:
        f, l, n = dataset[int(i)]
        frames.append(f)
        labels.append(l)
        names.append(n)
    return {"video": np.stack(frames), "labels": np.asarray(labels, np.int32),
            "names": names}


def _collate_memory(dataset, idxs):
    embeds, labels = [], []
    for i in idxs:
        e, l = dataset[int(i)]
        embeds.append(e)
        labels.append(l)
    return {"memory": np.stack(embeds).astype(np.float32),
            "mt_labels": np.asarray(labels, np.int32)}


def create_train_loader(cfg: LoaderConfig, resume_step: int = 0,
                        rank: int = 0, world_size: int = 1):
    if cfg.dummy_dataset:
        ds = DummyDataset(cfg.train_list_path, cfg.num_frames, 1,
                          cfg.spatial_size, nte_dim=cfg.embed_dim)
    else:
        ds = VideoDataset(VideoDatasetConfig(
            list_path=cfg.train_list_path,
            data_root=cfg.train_data_root or cfg.data_root,
            num_spatial_views=1, num_temporal_views=1,
            random_sample=False,  # matches reference (dataloader.py:92)
            num_frames=cfg.num_frames,
            sampling_rate=-1 if cfg.tsn_sampling else cfg.sampling_rate,
            spatial_size=cfg.spatial_size, mirror=False, auto_augment=None,
            is_train=True, add_nte=cfg.add_nte, nte_dim=cfg.embed_dim,
            allow_seek=cfg.allow_seek, cache_dir=cfg.cache_dir))
    grid = step_sampler(len(ds), cfg.num_steps, cfg.batch_size,
                        rank=rank, world_size=world_size, resume_step=resume_step)
    return _Prefetcher(lambda idxs: _collate_video(ds, idxs), list(grid),
                       num_workers=cfg.num_workers)


def create_val_loader(cfg: LoaderConfig, rank: int = 0, world_size: int = 1):
    if cfg.dummy_dataset:
        ds = DummyDataset(cfg.val_list_path, cfg.num_frames,
                          cfg.num_spatial_views * cfg.num_temporal_views,
                          cfg.spatial_size)
    else:
        ds = VideoDataset(VideoDatasetConfig(
            list_path=cfg.val_list_path,
            data_root=cfg.val_data_root or cfg.data_root,
            num_spatial_views=cfg.num_spatial_views,
            num_temporal_views=cfg.num_temporal_views,
            random_sample=False, num_frames=cfg.num_frames,
            sampling_rate=-1 if cfg.tsn_sampling else cfg.sampling_rate,
            spatial_size=cfg.spatial_size, is_train=False,
            return_all_views=cfg.eval_all_views, allow_seek=cfg.allow_seek,
            cache_dir=cfg.cache_dir))
    order = eval_sampler(len(ds), rank, world_size)
    batches = [order[i:i + cfg.batch_size]
               for i in range(0, len(order), cfg.batch_size)]
    collate = _collate_video if cfg.dummy_dataset else _collate_eval
    return _Prefetcher(lambda idxs: collate(ds, idxs), batches,
                       num_workers=cfg.num_workers)


def create_eval_loader(cfg: LoaderConfig, rank: int = 0, world_size: int = 1):
    assert not cfg.dummy_dataset
    ds = VideoDataset(VideoDatasetConfig(
        list_path=cfg.eval_list_path, data_root=cfg.eval_data_root,
        num_spatial_views=cfg.num_spatial_views,
        num_temporal_views=cfg.num_temporal_views, random_sample=False,
        num_frames=cfg.num_frames, sampling_rate=1,
        spatial_size=cfg.spatial_size, is_train=False,
        num_folds=cfg.nfold, cls_type=cfg.type, allow_seek=cfg.allow_seek,
        cache_dir=cfg.cache_dir))
    order = eval_sampler(len(ds), rank, world_size)
    batches = [order[i:i + cfg.batch_size]
               for i in range(0, len(order), cfg.batch_size)]
    return _Prefetcher(lambda idxs: _collate_eval(ds, idxs), batches,
                       num_workers=cfg.num_workers)


def create_memory_loader(cfg: LoaderConfig, resume_step: int = 0,
                         rank: int = 0, world_size: int = 1):
    if cfg.use_support_memory:
        ds = MemoryDataset(cfg.memory_data_path, cfg.type.split("_")[0],
                           batch_size=cfg.mem_batch_size,
                           for_zero_shot=cfg.for_zero_shot)
    else:
        ds = DummyMemoDataset(batch_size=cfg.mem_batch_size,
                              embed_size=cfg.embed_dim)
    grid = step_sampler(len(ds), cfg.num_steps, cfg.mem_batch_size,
                        rank=rank, world_size=world_size, resume_step=resume_step)
    return _Prefetcher(lambda idxs: _collate_memory(ds, idxs), list(grid),
                       num_workers=min(2, cfg.num_workers))
