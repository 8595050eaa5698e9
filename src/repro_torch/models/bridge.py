"""Carry weights across from the JAX package.

The port keeps the JAX package's param names and axis layouts (stacked
layers, ``wq [L, D, H*hd]``, ``embed [Vp, D]``, the scorer's
``w1 [D, 512]``), so the mapping is one to one: a param pytree fetched to
numpy (``jax.device_get``) becomes the same nested dict of tensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(x)
    name = arr.dtype.name
    if name not in _DTYPES:
        raise TypeError(f"unsupported param dtype {name!r}")
    if name == "bfloat16":  # numpy has no bf16 of its own: carry the bits
        arr = arr.view(np.int16)
    t = torch.from_numpy(np.array(arr, copy=True))
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_from_numpy(tree: dict, device=None,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """JAX param pytree as numpy (nested dicts of arrays) -> the port's
    params (nested dicts of tensors on ``device``: CUDA unless the caller
    names the CPU), cast to ``dtype`` when given."""
    device = resolve_device(device)
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else _tensor(v, device, dtype))
            for k, v in tree.items()}


def scorer_from_numpy(tree: dict, device=None) -> dict:
    """JAX scorer dict {w1, b1, w2, b2} as numpy -> f32 tensors on
    ``device`` (CUDA unless the caller names the CPU)."""
    device = resolve_device(device)
    return {k: _tensor(v, device, torch.float32) for k, v in tree.items()}
