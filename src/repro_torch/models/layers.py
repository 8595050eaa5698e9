"""Primitive layers of the dense stack (plain functions on tensors, params
as dicts of tensors), ported from ``repro/models/layers.py``.

All matmul weights are 2-D ``[in, out]`` as in the JAX package. Norms,
softmax and attention accumulate in f32; weights and activations are
bf16 (or f32 with f32 params). The paged pools are updated IN PLACE
(indexed assignment into the layer's slice of the stacked pool) where the
JAX package returned new pools from donated buffers. A quantized (int8 /
fp8) pool travels with its per-slot scales ``k_scale``/``v_scale``
``[N_blocks, bs, KVH]`` (one layer's slice), which are written in place
beside it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import kv_quant as KQ
from repro_torch.kernels.paged_attention import (
    check_index, masked_softmax_pv, paged_attention_plain,
    paged_attention_prefill_plain)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions [...]; returns cos/sin [..., dim/2] in f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., H, hd]; cos/sin broadcastable [..., 1, hd/2]."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------

def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """p: {w_gate [D,F], w_up [D,F], w_down [F,D]}"""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    act = F.silu(g.float()).to(x.dtype) * u
    return act @ p["w_down"]


# ---------------------------------------------------------------------------
# dense GQA attention — full sequence (one-shot prefill)
# ---------------------------------------------------------------------------

# Above this sequence length the S^2 score tensor is not materialised:
# attention runs the chunked online-softmax loop instead.
CHUNKED_ATTN_THRESHOLD = 1024
ATTN_CHUNK = 512


def chunked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                window: Optional[int] = None, chunk: int = ATTN_CHUNK,
                causal: bool = True) -> torch.Tensor:
    """Blockwise online-softmax attention, O(S * chunk) memory.
    q/k/v [B, H, S, hd] (kv heads pre-broadcast), scaled q expected."""
    B, H, S, hd = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} not a multiple of chunk {chunk}")
    dev = q.device
    q_pos = torch.arange(S, device=dev)
    m = torch.full((B, H, S, 1), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    for i in range(S // chunk):
        k_blk = k[:, :, i * chunk:(i + 1) * chunk]
        v_blk = v[:, :, i * chunk:(i + 1) * chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k_blk.float())
        k_pos = i * chunk + torch.arange(chunk, device=dev)
        mask = torch.ones((S, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > (q_pos[:, None] - window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v_blk.dtype).float(), v_blk.float())
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype)


def _attn_mask(q_len: int, kv_len: int, window: Optional[int],
               device) -> torch.Tensor:
    """Causal (optionally sliding-window) boolean mask [q_len, kv_len]."""
    q_pos = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > (q_pos - window)
    return mask


def gqa_attention_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor,
                       window: Optional[int] = None,
                       return_kv: bool = False,
                       use_kernel: bool = False):
    """Full-sequence GQA attention.

    p: {wq [D, H*hd], wk [D, KVH*hd], wv [D, KVH*hd], wo [H*hd, D],
        (qk_norm) q_norm [hd], k_norm [hd]}
    x: [B, S, D]; positions: [B, S] absolute positions.
    ``use_kernel`` runs the attention through the flash-attention wrapper
    (the CUDA kernel on a CUDA tensor, its plain version on the CPU),
    with the kv heads broadcast to the query heads first. The wrapper has
    no backward, as the JAX kernel has none.
    """
    B, S, D = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KVH, hd)
    v = (x @ p["wv"]).reshape(B, S, KVH, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)  # [B,S,hd/2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    group = H // KVH
    if use_kernel:
        kb = k.repeat_interleave(group, dim=2)  # broadcast kv heads
        vb = v.repeat_interleave(group, dim=2)
        out = kops.flash_attention(
            q.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2),
            window=window, scale=1.0 / math.sqrt(hd))
        out = out.transpose(1, 2).reshape(B, S, H * hd)
    elif S > CHUNKED_ATTN_THRESHOLD:
        kb = k.repeat_interleave(group, dim=2)
        vb = v.repeat_interleave(group, dim=2)
        out = chunked_mha(
            q.transpose(1, 2) * (1.0 / math.sqrt(hd)),
            kb.transpose(1, 2), vb.transpose(1, 2),
            window=window, chunk=ATTN_CHUNK)
        out = out.transpose(1, 2).reshape(B, S, H * hd)
    else:
        qg = q.reshape(B, S, KVH, group, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
        scores = scores * (1.0 / math.sqrt(hd))
        mask = _attn_mask(S, S, window, x.device)
        out = masked_softmax_pv(scores, mask[None, None, None], v,
                                "bkgqs,bskh->bqkgh")
        out = out.to(x.dtype).reshape(B, S, H * hd)
    out = out @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# paged GQA attention — decode (one new token per sequence)
# ---------------------------------------------------------------------------

def _slot_ids(block_tables: torch.Tensor, slot: torch.Tensor, bs: int,
              n_blocks: int, what: str):
    """Pool slots [B, ...] -> (block ids, offsets) through the block
    tables (index-checked on the CPU)."""
    block_idx = (slot // bs).long()
    if block_tables.device.type == "cpu":
        check_index(block_idx, block_tables.shape[1], f"{what} block index")
    flat = block_idx.reshape(block_idx.shape[0], -1)
    block_ids = block_tables.long().gather(1, flat).reshape(block_idx.shape)
    if block_tables.device.type == "cpu":
        check_index(block_ids, n_blocks, f"{what} block id")
    return block_ids, (slot % bs).long()


def paged_kv_update(pool: torch.Tensor, block_tables: torch.Tensor,
                    slot_positions: torch.Tensor,
                    new_kv: torch.Tensor) -> None:
    """Write one token's K or V per sequence into the paged pool, IN PLACE.

    pool [N_blocks, bs, KVH, hd] (one layer's slice of the stacked pool);
    block_tables [B, bp]; slot_positions [B] (position within the cache
    window); new_kv [B, KVH, hd].

    Frozen decode lanes all point at the scratch block, so several lanes
    may write the same scratch slot: harmless (scratch is never read
    unmasked), but which lane's value lands there is nondeterministic on
    CUDA.
    """
    paged_kv_update_quant(pool, None, block_tables, slot_positions, new_kv)


def paged_kv_update_quant(pool: torch.Tensor, scale: Optional[torch.Tensor],
                          block_tables: torch.Tensor,
                          slot_positions: torch.Tensor,
                          new_kv: torch.Tensor) -> None:
    """:func:`paged_kv_update` into an int8/fp8 pool with its f32 ``scale``
    [N_blocks, bs, KVH], IN PLACE (``scale`` None: a float pool). Each
    lane's new token is quantized against its own per-head absmax and
    its codes and scales written to its slot; no other slot is touched."""
    block_ids, offset = _slot_ids(block_tables, slot_positions,
                                  pool.shape[1], pool.shape[0], "decode")
    KQ.write_slots(pool, scale, (block_ids, offset), new_kv)


def paged_chunk_update_quant(pool: torch.Tensor, scale: Optional[torch.Tensor],
                             block_tables: torch.Tensor, slot: torch.Tensor,
                             valid: torch.Tensor,
                             new_vals: torch.Tensor) -> None:
    """Scatter one prefill chunk into the pool, IN PLACE: pool
    [N_blocks, bs, KVH, hd] int8/fp8 with scale [N_blocks, bs, KVH] f32
    (or a float pool with ``scale`` None); slot [B, C]; valid [B, C];
    new_vals [B, C, KVH, hd]. Each chunk token is quantized against its
    own per-head absmax and written to its slot. Padded entries go to the
    scratch block 0: the JAX package writes their slot's old content back
    instead, and both leave every slot that is ever read unmasked as it
    was."""
    block_ids, offs = _slot_ids(block_tables, slot, pool.shape[1],
                                pool.shape[0], "chunk")
    block_ids = torch.where(valid, block_ids, 0)
    KQ.write_slots(pool, scale, (block_ids, offs), new_vals)


def paged_attention_decode(pool_k: torch.Tensor, pool_v: torch.Tensor,
                           q: torch.Tensor, block_tables: torch.Tensor,
                           cache_lens: torch.Tensor, scale: float,
                           use_kernel: bool = False,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode attention over the paged pool: q [B, H, hd]; pools
    [N_blocks, bs, KVH, hd]; block_tables [B, bp]; cache_lens [B] i32;
    k_scale/v_scale [N_blocks, bs, KVH] mark a quantized pool, whose
    gathered pages are dequantized (f32 cast, times the slot's scale)
    before the scores. Returns [B, H, hd]. ``use_kernel`` goes through the
    kernel wrapper (the CUDA kernel on a CUDA tensor, its plain version on
    the CPU), which dequantizes inside its page loop."""
    if use_kernel:
        return kops.paged_attention(q, pool_k, pool_v, block_tables,
                                    cache_lens, scale=scale,
                                    k_scale=k_scale, v_scale=v_scale)
    return paged_attention_plain(q, pool_k, pool_v, block_tables,
                                 cache_lens, scale, k_scale, v_scale)


def gqa_attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                         positions: torch.Tensor, cache: dict
                         ) -> torch.Tensor:
    """One-token decode step with the paged KV cache for one layer.

    x [B, 1, D]; positions [B]; cache holds this layer's k_pool/v_pool
    slices (and, for a quantized pool, its k_scale/v_scale slices) plus
    block_tables, window_len and use_kernel. The pools are written in
    place. Returns out [B, 1, D].
    """
    B, _, D = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, H, hd)
    k = (x @ p["wk"]).reshape(B, KVH, hd)
    v = (x @ p["wv"]).reshape(B, KVH, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)  # [B, hd/2]
    cos, sin = cos[:, None, :], sin[:, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)  # rope applied at write time

    window_len = cache["window_len"]  # python int: cache capacity (tokens)
    # the rolling window: the write slot wraps at the cache capacity
    slot = positions % window_len if window_len > 0 else positions
    k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
    paged_kv_update_quant(cache["k_pool"], k_scale, cache["block_tables"],
                          slot, k)
    paged_kv_update_quant(cache["v_pool"], v_scale, cache["block_tables"],
                          slot, v)
    new_lens = (torch.clamp(positions + 1, max=window_len) if window_len > 0
                else positions + 1).to(torch.int32)
    out = paged_attention_decode(
        cache["k_pool"], cache["v_pool"], q, cache["block_tables"],
        new_lens, scale=1.0 / math.sqrt(hd),
        use_kernel=cache.get("use_kernel", False),
        k_scale=k_scale, v_scale=v_scale)
    return out.reshape(B, 1, H * hd) @ p["wo"]


def gqa_attention_prefill_chunk(p: dict, cfg: ModelConfig, x: torch.Tensor,
                                positions: torch.Tensor, valid: torch.Tensor,
                                k_pool: torch.Tensor, v_pool: torch.Tensor,
                                block_tables: torch.Tensor, window_len: int,
                                window: Optional[int] = None,
                                use_kernel: bool = False,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Prefill one chunk of a prompt against the paged KV cache.

    x [B, C, D]; positions [B, C] absolute prompt positions (contiguous
    across the chunk, padding included); valid [B, C] marks real tokens.
    The chunk's K/V is written into this layer's pools in place (padded
    slots write to block 0, the scratch block); then the chunk's queries
    attend over the pooled prefix plus the chunk's own exact K/V. Assumes
    prompt_len <= window_len so slot == position. k_scale/v_scale
    [N_blocks, bs, KVH] mark a quantized pool: the chunk is written
    through the quantizing scatter and the pooled prefix is read
    dequantized (the own K/V stays exact). Returns out [B, C, D].
    """
    B, C, D = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, C, H, hd)
    k = (x @ p["wk"]).reshape(B, C, KVH, hd)
    v = (x @ p["wv"]).reshape(B, C, KVH, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)  # [B,C,hd/2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    # scatter the chunk's KV into the pool (padded slots -> scratch 0)
    slot = (positions % window_len).long()             # [B, C] == positions
    paged_chunk_update_quant(k_pool, k_scale, block_tables, slot, valid, k)
    paged_chunk_update_quant(v_pool, v_scale, block_tables, slot, valid, v)

    scale = 1.0 / math.sqrt(hd)
    # positions are contiguous across the chunk (engine contract), so the
    # chunk start doubles as the pooled-prefix length
    prefix_lens = positions[:, 0].to(torch.int32)
    num_valid = valid.sum(dim=1, dtype=torch.int32)
    if use_kernel:
        out = kops.paged_attention_prefill(
            q, k_pool, v_pool, block_tables, prefix_lens, num_valid, k, v,
            scale=scale, window=window, k_scale=k_scale, v_scale=v_scale)
    else:
        # the dense path joins the own chunk to the prefix as the JAX
        # package's dense layer does: in a float pool's dtype, exact (f32)
        # beside a quantized pool, which reads back as f32
        own_k, own_v = ((k, v) if k_scale is not None
                        else (k.to(k_pool.dtype), v.to(v_pool.dtype)))
        out = paged_attention_prefill_plain(
            q, k_pool, v_pool, block_tables, prefix_lens, num_valid, own_k,
            own_v, scale, window, k_scale, v_scale)
    return out.reshape(B, C, H * hd) @ p["wo"]
