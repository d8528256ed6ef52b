"""Process-group start-up and rank helpers (port of
gava_clip_tpu/parallel/distributed.py).

PyTorch runs one process per card: `python -m torch.distributed.run
--nproc_per_node N -m gava_clip_tpu_torch.cli.train ...` starts N
processes, and each calls `init_distributed()` once before it touches the
card. The loaders then slice their deterministic samplers by (rank,
world_size), as the reference's did (dataloader.py:113-120).
"""

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def _init_method(address: str) -> str:
    """'host:port' as a tcp:// URL; a URL ('tcp://...', 'file://...') as
    it is."""
    return address if "://" in address else f"tcp://{address}"


def _bind_card(backend: str, local_rank: int) -> None:
    """Make cuda:LOCAL_RANK this process's current card. NCCL needs a card
    of its own for every rank; gloo lets ranks share the cards, one after
    another (several ranks on one card, as a check on one card runs)."""
    n = torch.cuda.device_count()
    if local_rank >= n:
        if backend == "nccl":
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own ({n} "
                f"visible) and NCCL refuses two ranks on one card")
        print(f"[distributed] local rank {local_rank} shares cuda:"
              f"{local_rank % n} ({n} card(s), gloo backend)", flush=True)
    torch.cuda.set_device(local_rank % n)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> Tuple[int, int]:
    """Start the process group when the run has several processes; returns
    (rank, world_size).

    Settings resolve in the JAX function's order: explicit arguments,
    then the launcher's environment (MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK / LOCAL_RANK, which torch.distributed.run sets: the
    counterpart of JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID). With neither there is no group: (0, 1).

    backend: None picks NCCL where the run's `device` is the card (None
    means the card) and gloo on the CPU; 'gloo' may be named on the card
    too. NCCL without a card raises. On the card each rank's current
    device becomes cuda:LOCAL_RANK, which `utils.device.resolve_device`
    then returns."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    address = coordinator_address
    if address is None and os.environ.get("MASTER_ADDR"):
        address = (f"{os.environ['MASTER_ADDR']}:"
                   f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if address is None or num_processes is None or process_id is None:
        return 0, 1
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device; pass "
                           "backend='gloo' to run the group on the host")
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the card by "
                "default; pass device='cpu' to run on the host")
        local = _env_int("LOCAL_RANK")
        _bind_card(backend, process_id if local is None else local)
    dist.init_process_group(backend, init_method=_init_method(address),
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def world() -> Tuple[int, int]:
    """(rank, world_size) of the process group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """Rank 0 (or no group): the process that writes logs and files."""
    return world()[0] == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Every rank at a barrier, then the process group torn down (a
    program's last act under torch.distributed.run)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def local_batch_slice(global_batch: int) -> int:
    count = world()[1]
    assert global_batch % count == 0
    return global_batch // count
