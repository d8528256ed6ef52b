"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None. Asking for the card (by name or by
    default) without one raises: nothing falls back to the host quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device='cpu' to run on the host")
    return dev
