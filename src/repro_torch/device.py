"""The port's device rule: CUDA unless the caller names the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default. Raises when
    CUDA is asked for (or left to the default) and no card is present;
    the CPU only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU; pass "
            "device='cpu' to run on the CPU")
    return dev
