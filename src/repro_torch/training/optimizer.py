"""AdamW and the cosine schedule, ported from ``repro/training/optimizer.py``.

The JAX optimizer returns new param and moment trees; at full width the
f32 moments alone take 32 GB, so the port updates each parameter and its
moments IN PLACE, one block of at most ``BLOCK_ELEMENTS`` at a time
(leading rows of a larger tensor): the f32 temporaries of one block are
the only extra memory (a whole stacked MLP weight of qwen3-4b would need
about 20 GB of them). The arithmetic is the JAX package's, elementwise and
in the same order: f32 math, moments stored in ``moment_dtype``,
global-norm gradient clipping, bias corrections and the schedule in f32.

DTensor params (the production dry run's) are updated shard by shard: a
gradient is first laid out as its param (the data-parallel reduction),
the moments are laid out as the params already, and the elementwise
update runs on each rank's local shards, which is exact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.training import tree as T


# elements per in-place update block (2 GB of f32 temporaries at most)
BLOCK_ELEMENTS = 2 ** 26


def _blocks(*tensors):
    """Matching blocks of same-shaped tensors: each whole, or split into
    runs of leading rows of at most ``BLOCK_ELEMENTS`` elements (views)."""
    t = tensors[0]
    if t.numel() <= BLOCK_ELEMENTS:
        return [tensors]
    rows = max(1, BLOCK_ELEMENTS // (t.numel() // t.shape[0]))
    return zip(*(x.split(rows) for x in tensors))


def local_shard(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or ``x`` itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def _as_param(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor):
    """Local shards of a param, its gradient and moments (a DTensor
    gradient laid out as its param first; the moments must be)."""
    if isinstance(p, DTensor):
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        for x in (m, v):
            if tuple(x.placements) != tuple(p.placements):
                raise ValueError(f"a moment laid out as {x.placements} "
                                 f"for a param laid out as {p.placements}")
    return tuple(map(local_shard, (p, g, m, v)))


class AdamState(NamedTuple):
    step: int
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Callable[[int], float]] = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    # Low-precision moment storage: the math stays f32, only storage
    # rounds.
    moment_dtype: str = "float32"

    def init(self, params: dict) -> AdamState:
        md = getattr(torch, self.moment_dtype)
        return AdamState(
            step=0,
            mu=T.map_tree(lambda p: torch.zeros_like(p, dtype=md), params),
            nu=T.map_tree(lambda p: torch.zeros_like(p, dtype=md), params))

    def _lr(self, step: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(step))
        return self.learning_rate

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict):
        """One step, in place: ``params`` and the moments of ``state`` are
        overwritten. Returns (params, the new state), the same objects."""
        step = state.step + 1
        gs = T.leaves(grads)
        scale = None
        if self.grad_clip is not None:
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in gs))
            if isinstance(gnorm, DTensor):
                gnorm = gnorm.full_tensor()
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        lr = self._lr(step)
        # bias corrections in f32, as the JAX package computes them
        b1c = float(np.float32(1) - np.float32(self.b1) ** np.float32(step))
        b2c = float(np.float32(1) - np.float32(self.b2) ** np.float32(step))
        for leaf in zip(T.leaves(params), gs, T.leaves(state.mu),
                        T.leaves(state.nu)):
            for p, g, m, v in _blocks(*_as_param(*leaf)):
                g = g.float() if scale is None else g.float() * scale
                m_new = self.b1 * m.float() + (1 - self.b1) * g
                v_new = self.b2 * v.float() + (1 - self.b2) * g.square()
                m.copy_(m_new)
                v.copy_(v_new)
                u = (m.float() / b1c) / (torch.sqrt(v.float() / b2c)
                                         + self.eps)
                if self.weight_decay:
                    u = u + self.weight_decay * p.float()
                p.copy_(p.float() - lr * u)
        return params, AdamState(step=step, mu=state.mu, nu=state.nu)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up to ``peak_lr``, then a cosine decay to ``floor *
    peak_lr`` at ``total``; computed in f32 as the JAX schedule is."""
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(peak_lr) * s / f32(max(warmup, 1)))
        frac = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0), f32(1))
        cos = f32(peak_lr) * (f32(floor) + f32((1 - floor) * 0.5)
                              * (f32(1) + np.cos(f32(math.pi) * frac)))
        return float(cos)
    return fn
