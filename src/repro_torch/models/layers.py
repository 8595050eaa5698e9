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
# the one-token Mamba2 steps live beside their fused kernel
from repro_torch.kernels.ssm_decode import (  # noqa: F401
    causal_conv1d_step, ssd_decode_step, ssm_decay, ssm_decode_plain)


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
    may write the same scratch slot; which lane's value lands there is
    nondeterministic on CUDA. That is harmless where only frozen lanes
    read it and nothing of theirs persists; the hybrid passes each
    lane's :func:`last_writer` to :func:`gqa_attention_decode` instead.
    """
    paged_kv_update_quant(pool, None, block_tables, slot_positions, new_kv)


def last_writer(block_tables: torch.Tensor, positions: torch.Tensor,
                window_len: int, bs: int) -> torch.Tensor:
    """[B] lane indices: for each lane, the last lane whose decode write
    this step lands in the same pool slot (itself where no later lane
    shares it). Frozen lanes all write the scratch block, so they share
    slots; a CPU scatter keeps the last lane's value, a CUDA one any
    lane's. The hybrid's frozen lanes read those slots back unmasked and
    carry what they read into their recurrent state (ROADMAP C, the
    horizon drift), so it writes every shared slot with its last lane's
    value: the same result on both devices, and the same in every run."""
    slot = positions % window_len if window_len > 0 else positions
    block = block_tables.long().gather(1, (slot // bs).long()[:, None])[:, 0]
    target = block * bs + slot % bs
    lanes = torch.arange(target.shape[0], device=target.device)
    same = target[:, None] == target[None, :]
    return torch.where(same, lanes[None, :], -1).amax(dim=1)


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
                         positions: torch.Tensor, cache: dict,
                         writer: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One-token decode step with the paged KV cache for one layer.

    x [B, 1, D]; positions [B]; cache holds this layer's k_pool/v_pool
    slices (and, for a quantized pool, its k_scale/v_scale slices) plus
    block_tables, window_len and use_kernel. ``writer`` [B] (the hybrid:
    :func:`last_writer`) gives each lane the lane whose K/V it writes.
    The pools are written in place. Returns out [B, 1, D].
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
    if writer is not None:   # lanes sharing a slot write its last writer's
        k, v = k[writer], v[writer]

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


# ---------------------------------------------------------------------------
# Mamba2 (SSD): chunked full-sequence scan and single-step decode
# ---------------------------------------------------------------------------

def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = cs_i - cs_j for j <= i (cs the inclusive cumsum of
    ``a`` over its last axis), -inf above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False):
    """SSD (state-space duality) scan, chunked.

    x [B, S, H, P]; dt [B, S, H] (softplus'd step sizes); A [H] (negative
    decay rates); Bm/Cm [B, S, N] (shared across heads, ngroups = 1).
    Returns (y [B, S, H, P], final_state [B, H, P, N]). ``use_kernel``
    goes through the SSD scan wrapper (the CUDA kernel on a CUDA tensor,
    its plain version on the CPU), which starts from a zero state."""
    if use_kernel:
        return kops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                             initial_state=initial_state)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xc = x.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    Bc = Bm.reshape(B, nc, chunk, N)
    Cc = Cm.reshape(B, nc, chunk, N)

    dA = (dtc * A[None, None, None, :]).movedim(-1, 2)   # [B, nc, H, l]
    dA_cumsum = torch.cumsum(dA, dim=-1)

    # 1. intra-chunk (quadratic within the chunk)
    Lmat = torch.exp(_segsum(dA))                         # [B, nc, H, l, l]
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)[:, :, None] * Lmat
    y_diag = torch.einsum("bchls,bcsh,bcshp->bclhp", scores, dtc, xc)

    # 2. chunk states
    decay_states = torch.exp(dA_cumsum[..., -1:] - dA_cumsum)  # [B,nc,H,l]
    states = torch.einsum("bcln,bchl,bclh,bclhp->bchpn",
                          Bc, decay_states, dtc, xc)

    # 3. inter-chunk recurrence: the state BEFORE each chunk
    chunk_decay = torch.exp(dA_cumsum[..., -1])           # [B, nc, H]
    h = (initial_state if initial_state is not None
         else torch.zeros((B, H, P, N), dtype=states.dtype,
                          device=x.device))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # [B, nc, H, P, N]

    # 4. state -> output contribution
    state_decay = torch.exp(dA_cumsum)                    # [B, nc, H, l]
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", Cc, h_prev, state_decay)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x [B, S, C]; w [W, C]; b [C]."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def _ssm_inputs(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """Split the input projection: (z, xbc, dt) along the last axis."""
    di, N = cfg.d_inner, cfg.ssm_state_size
    return (zxbcdt[..., :di], zxbcdt[..., di:di + di + 2 * N],
            zxbcdt[..., di + di + 2 * N:])


def _ssm_out(p: dict, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Gate, norm and output projection of the mixer. y [..., H, P] with
    the skip term added; z [..., di]."""
    y = y.reshape(*z.shape).to(dtype)
    y = rms_norm(y * F.silu(z.float()).to(dtype), p["norm_w"], cfg.norm_eps)
    return y @ p["w_out"]


def mamba2_mixer_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      use_kernel: bool = False, return_state: bool = False):
    """Full-sequence Mamba2 mixer. x [B, S, D].

    p: {w_in [D, 2di+2N+H], conv_w [W, di+2N], conv_b, A_log [H], D [H],
    dt_bias [H], norm_w [di], w_out [di, D]}. The scan runs in f32 over S
    padded to a multiple of the chunk with dt = 0 (decay 1, input 0: the
    state is exactly unchanged). With ``return_state`` also returns
    (ssm_state [B, H, P, N] f32, conv_state [B, W-1, di+2N] in x's dtype)
    for decode continuation."""
    B, S, _ = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state_size, cfg.ssm_heads
    P = cfg.ssm_head_dim
    z, xbc_raw, dt = _ssm_inputs(cfg, x @ p["w_in"])
    xbc = F.silu(causal_conv1d(xbc_raw, p["conv_w"], p["conv_b"])
                 .float()).to(x.dtype)
    xs = xbc[..., :di].reshape(B, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt, A = ssm_decay(dt, p["dt_bias"], p["A_log"])

    chunk = min(cfg.ssm_chunk_size, S)
    pad = (-S) % chunk
    xs_f, Bm_f, Cm_f, dt_p = xs.float(), Bm.float(), Cm.float(), dt
    if pad:
        xs_f = F.pad(xs_f, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        Bm_f = F.pad(Bm_f, (0, 0, 0, pad))
        Cm_f = F.pad(Cm_f, (0, 0, 0, pad))
    y, final_state = ssd_chunked(xs_f, dt_p, A, Bm_f, Cm_f, chunk=chunk,
                                 use_kernel=use_kernel)
    out = _ssm_out(p, cfg, y[:, :S] + xs.float() * p["D"].float()[:, None],
                   z, x.dtype)
    if return_state:
        W = cfg.ssm_conv_width
        conv_state = (xbc_raw[:, S - (W - 1):, :] if S >= W - 1
                      else F.pad(xbc_raw, (0, 0, W - 1 - S, 0)))
        return out, final_state, conv_state.to(x.dtype)
    return out


def mamba2_mixer_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        ssm_state: torch.Tensor, conv_state: torch.Tensor,
                        use_kernel: bool = False):
    """One-token Mamba2 step. x [B, 1, D]. Returns (out [B, 1, D],
    new_ssm [B, H, P, N] f32, new_conv [B, W-1, di+2N]).

    ``use_kernel`` runs the state update through the ssm_decode wrapper
    (the CUDA kernel on a CUDA tensor, its plain version on the CPU),
    which writes the new states into ``ssm_state`` / ``conv_state`` in
    place and returns them."""
    z, xbc, dt = _ssm_inputs(cfg, x[:, 0] @ p["w_in"])
    args = (xbc, dt, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
            p["D"])
    if use_kernel:
        y = kops.ssm_decode(conv_state, ssm_state, *args)
        new_state, new_conv = ssm_state, conv_state
    else:
        y, new_state, new_conv = ssm_decode_plain(conv_state, ssm_state,
                                                  *args)
    return _ssm_out(p, cfg, y, z, x.dtype)[:, None, :], new_state, \
        new_conv
