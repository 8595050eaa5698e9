"""Dependency-free checkpointing: param tree <-> ``.npz``, in the JAX
package's format, so an artifact saved by either package loads in the
other.

``leaf_i`` is the i-th leaf in JAX's flatten order (dict keys sorted,
depth first); bf16 leaves are stored as f32 (``.npz`` has no bf16);
``__treedef__`` holds the structure's ``PyTreeDef`` repr as bytes.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.training import tree as T


def save_pytree(path: str, tree: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {}
    for i, x in enumerate(T.leaves(tree)):
        x = x.detach()
        if x.dtype == torch.bfloat16:  # numpy .npz cannot round-trip bf16
            x = x.float()
        arrays[f"leaf_{i}"] = x.cpu().numpy()
    arrays["__treedef__"] = np.frombuffer(T.treedef_repr(tree).encode(),
                                          dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like: dict) -> dict:
    """Load leaves into the structure of ``like``: each leaf takes the
    dtype and device of its counterpart there (shapes must match)."""
    data = np.load(path, allow_pickle=False)
    out = []
    for i, ref in enumerate(T.leaves(like)):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {i}: {arr.shape} != "
                             f"{tuple(ref.shape)}")
        out.append(torch.from_numpy(arr).to(device=ref.device,
                                            dtype=ref.dtype))
    return T.unflatten(like, out)
