"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

import numpy as np
import torch
import torch.distributed


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None. Asking for the card (by name or by
    default) without one raises: nothing falls back to the host quietly.
    Under a process group 'cuda' is the rank's card (cuda:LOCAL_RANK)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device='cpu' to run on the host")
    if dev.type == "cuda" and dev.index is None and \
            torch.distributed.is_initialized():
        # a rank of a process group: its own card, which
        # parallel.distributed.init_distributed made the current one
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tree_to(tree, device):
    """A nested dict / list of tensors or numpy arrays as tensors on
    `device` (numpy leaves copied)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else \
        torch.from_numpy(np.array(tree))
    return t.to(device)
