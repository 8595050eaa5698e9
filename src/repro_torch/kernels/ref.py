"""The oracles of the JAX package's ``kernels/ref.py``, under its names,
argument orders and layouts, over the port's plain versions (the
allclose ground truth of the kernels).

Where the reference rounds differently from the plain version that
computes the same function, the oracle keeps the reference's rounding:
``mha_ref`` and ``paged_attention_ref`` round the softmax weights to the
values' dtype before P.V and return the values' dtype;
``paged_attention_prefill_ref`` returns f32. On f32 inputs each equals
its plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import attention_mask
from repro_torch.kernels.paged_attention import (gather_kv,
                                                 paged_attention_prefill_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.kernels.step_score import step_score_plain


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """Full attention. q/k/v [B, H, S, hd] (kv heads already broadcast)."""
    S, hd = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(S, causal, window, q.device)
    scores = torch.where(mask[None, None], scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        cache_lens: torch.Tensor, scale: float
                        ) -> torch.Tensor:
    """Decode attention over a paged pool.

    q [B, H, hd]; pools [NB, bs, KVH, hd]; block_tables [B, bp];
    cache_lens [B]. Returns [B, H, hd]; a row with no valid slot emits
    zeros.
    """
    B, H, hd = q.shape
    KVH = k_pool.shape[2]
    k = gather_kv(k_pool, block_tables)
    v = gather_kv(v_pool, block_tables)
    qg = q.reshape(B, KVH, H // KVH, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) * scale
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             < cache_lens[:, None])[:, None, None, :]
    probs = torch.softmax(torch.where(valid, scores, -torch.inf), dim=-1)
    probs = torch.where(valid, probs, 0.0)
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(v.dtype), v)
    return out.reshape(B, H, hd)


def paged_attention_prefill_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                prefix_lens: torch.Tensor,
                                num_valid: torch.Tensor,
                                own_k: torch.Tensor, own_v: torch.Tensor,
                                scale: float,
                                window: Optional[int] = None
                                ) -> torch.Tensor:
    """Chunked-prefill paged attention oracle.

    q [B, C, H, hd]; pools [NB, bs, KVH, hd]; block_tables [B, bp];
    prefix_lens [B] pooled tokens before the chunk (== chunk start,
    slot == position); num_valid [B] real tokens in the chunk;
    own_k/own_v [B, C, KVH, hd]. Returns [B, C, H, hd] in f32; padded
    queries and empty rows emit zeros.
    """
    return paged_attention_prefill_plain(
        q.float(), k_pool, v_pool, block_tables, prefix_lens, num_valid,
        own_k, own_v, scale, window)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 initial_state: Optional[torch.Tensor] = None):
    """Sequential SSD recurrence (the definitionally-correct oracle).

    x [B,S,H,P]; dt [B,S,H]; A [H]; Bm/Cm [B,S,N].
    h_t = h_{t-1} * exp(dt_t A) + dt_t B_t x_t ;  y_t = C_t h_t.
    Returns (y [B,S,H,P], final_state [B,H,P,N]), in f32.
    """
    return ssd_scan_plain(x, dt, A, Bm, Cm, initial_state)


def step_score_ref(hidden: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Fused 2-layer MLP scorer. hidden [B, D] -> scores [B]."""
    return step_score_plain(hidden, w1, b1, w2, b2)
