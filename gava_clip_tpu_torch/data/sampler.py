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
                 resume_step: int = 0) -> np.ndarray:
    """Return (num_steps - resume_step, batch_per_rank) index matrix."""
    assert batch_size % world_size == 0
    per_rank = batch_size // world_size
    chunks: List[np.ndarray] = []
    epoch = 0
    while len(chunks) * dataset_len < num_steps * batch_size:
        chunks.append(_randperm(dataset_len, seed=epoch))
        epoch += 1
    flat = np.concatenate(chunks)[:num_steps * batch_size]
    grid = flat.reshape(num_steps, batch_size)
    return grid[resume_step:, per_rank * rank: per_rank * (rank + 1)]


def eval_sampler(dataset_len: int, rank: int = 0, world_size: int = 1) -> np.ndarray:
    """Rank-strided eval sampler (dataloader.py:159,192)."""
    return np.arange(rank, dataset_len, world_size)
