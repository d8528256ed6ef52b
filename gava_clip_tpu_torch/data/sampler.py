"""Deterministic step-based samplers with exact resume semantics.

Reimplements the reference's manual sampler (video_dataset/dataloader.py:
113-120, 224-231): pre-generate num_steps x batch indices from per-epoch
seeded permutations, slice by rank and resume step. The permutations use
torch.Generator(seed=epoch).randperm: bit-identical data order to the
reference and to gava_clip_tpu/data/sampler.py (the port's own copy of it).
"""

from typing import List

import numpy as np
import torch


def _randperm(n: int, seed: int) -> np.ndarray:
    g = torch.Generator()
    g.manual_seed(seed)
    return torch.randperm(n, generator=g).numpy()


def step_sampler(dataset_len: int, num_steps: int, batch_size: int,
                 rank: int = 0, world_size: int = 1,
                 resume_step: int = 0, batch_split: int = 1) -> np.ndarray:
    """Return (num_steps - resume_step, batch_per_rank) index matrix.

    batch_split S > 1 (a step of S micro-batches): rank r takes rows
    [i*B/S + r*B/(S*W), i*B/S + (r+1)*B/(S*W)) of each micro-batch i, so
    that micro-batch i gathered over the ranks is the global micro-batch i
    of one process (parallel/mesh.local_rows). S = 1 is the contiguous
    per-rank block."""
    assert batch_size % (world_size * batch_split) == 0
    per_rank = batch_size // world_size
    chunks: List[np.ndarray] = []
    epoch = 0
    while len(chunks) * dataset_len < num_steps * batch_size:
        chunks.append(_randperm(dataset_len, seed=epoch))
        epoch += 1
    flat = np.concatenate(chunks)[:num_steps * batch_size]
    grid = flat.reshape(num_steps, batch_size)[resume_step:]
    if batch_split > 1:
        n = per_rank // batch_split
        grid = grid.reshape(len(grid), batch_split, world_size, n)
        return grid[:, :, rank].reshape(len(grid), per_rank)
    return grid[:, per_rank * rank: per_rank * (rank + 1)]


def eval_sampler(dataset_len: int, rank: int = 0, world_size: int = 1) -> np.ndarray:
    """Rank-strided eval sampler (dataloader.py:159,192)."""
    return np.arange(rank, dataset_len, world_size)
