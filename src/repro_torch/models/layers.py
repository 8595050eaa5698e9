"""Primitive layers of every stack of the zoo (plain functions on
tensors, params as dicts of tensors), ported from
``repro/models/layers.py``: GQA attention (full, paged decode, chunked
prefill), MLA (full and the absorbed paged decode over the latent pool),
cross-attention, the MoE and SwiGLU feed-forwards, and the Mamba2 mixer.

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

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_glue as kglue
from repro_torch.kernels import ops as kops
from repro_torch.models import kv_quant as KQ
from repro_torch.kernels.paged_attention import (
    check_index, masked_softmax_pv, paged_attention_plain,
    gather_pages, paged_attention_prefill_plain)
# RMSNorm and RoPE's rotation live beside the kernels that fuse them
from repro_torch.kernels.decode_glue import apply_rope, rms_norm  # noqa: F401
# the one-token Mamba2 steps live beside their fused kernel
from repro_torch.kernels.ssm_decode import (  # noqa: F401
    causal_conv1d_step, ssd_decode_step, ssm_decay, ssm_decode_plain)


# ---------------------------------------------------------------------------
# a rank's place on the serving mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank of a ``("data", "model")`` serving mesh, as the layers
    see it. Its params are the rank's shards under
    ``launch.shardings.serving_param_specs``: the column-parallel weights
    hold a ``1/model_n`` slice of their output columns, the embedding a
    slice of its vocab rows, the rest is whole. The rank runs lanes
    :meth:`lanes` of the decode batch and, when :attr:`heads_aligned`
    (the config's ``num_heads`` and ``num_kv_heads`` both divide
    "model"), its own query and kv heads; its pools hold those kv heads.

    Where the reference places ``with_sharding_constraint``s, the layers
    call the all-gathers below; a float is never reduced across ranks,
    so each rank computes exactly the single-device values of its
    slice. ``stage_host``: the group is gloo and the tensors are on a
    card, so each gather goes through host copies."""
    model_group: object
    model_rank: int
    model_n: int
    data_group: object
    data_rank: int
    data_n: int
    num_heads: int
    num_kv_heads: int
    vocab_rows: int          # the whole embedding's rows (padded vocab)
    stage_host: bool = False

    @property
    def heads_aligned(self) -> bool:
        return all(n >= self.model_n and n % self.model_n == 0
                   for n in (self.num_heads, self.num_kv_heads))

    def lanes(self, batch: int) -> slice:
        """This rank's lanes of a ``batch``-lane decode batch."""
        n = batch // self.data_n
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    def _gather(self, x: torch.Tensor, group, n: int, dim: int):
        if n == 1:
            return x
        src = x.contiguous()
        if self.stage_host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    def gather_model(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The "model" ranks' pieces of ``x``, joined along ``dim``."""
        return self._gather(x, self.model_group, self.model_n, dim)

    def gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The "data" ranks' pieces of ``x`` (their lanes), joined along
        ``dim``."""
        return self._gather(x, self.data_group, self.data_n, dim)

    def full_cols(self, y: torch.Tensor, width: int) -> torch.Tensor:
        """``y`` with its whole last dim of ``width``: the output of a
        column-parallel product is gathered over "model" where the
        weight was split (a no-op where it is whole)."""
        if y.shape[-1] == width:
            return y
        return self.gather_model(y, dim=-1)


def _heads(tp: Optional[TensorParallel], y: torch.Tensor, n: int,
           hd: int) -> torch.Tensor:
    """A projection's output [..., cols] as heads [..., n_local, hd]. On a
    mesh whose heads do not align, a split output is gathered whole
    first (its columns need not fall on head boundaries), and attention
    runs on every head on each "model" rank."""
    if tp is not None and not tp.heads_aligned:
        y = tp.full_cols(y, n * hd)
    return y.reshape(*y.shape[:-1], -1, hd)


def constrain(x, placements):
    """The sharding hook at the JAX package's
    ``with_sharding_constraint`` points: a DTensor ``x`` redistributed to
    ``placements`` (one per dim of its mesh; itself where it has them
    already), and ``x`` itself when it is a plain tensor or
    ``placements`` is None. So a path of plain tensors is unchanged bit
    for bit. A caller mixing DTensors with the plain tensors that the
    layers build (rope tables, masks, positions) runs under
    ``torch.distributed.tensor.experimental.implicit_replication``."""
    if placements is None or not isinstance(x, DTensor) \
            or tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions [...]; returns cos/sin [..., dim/2] in f32."""
    inv_freq = kglue.rope_inv_freq(dim, theta, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------

def silu_gate(g: torch.Tensor, u: torch.Tensor,
              use_kernel: bool = False) -> torch.Tensor:
    """SwiGLU's gate: silu(g) in f32, rounded to g's dtype, times u. Under
    ``use_kernel``, the ``silu_mul`` kernel (the same arithmetic, one
    launch) where it takes the operands (``decode_glue.silu_mul_fits``:
    bf16 on a card, no gradient); else the ops."""
    if use_kernel and kglue.silu_mul_fits(g, u):
        return kops.silu_mul(g, u)
    return kglue.silu_mul_plain(g, u)


def swiglu(p: dict, x: torch.Tensor,
           tp: Optional[TensorParallel] = None,
           use_kernel: bool = False) -> torch.Tensor:
    """p: {w_gate [D,F], w_up [D,F], w_down [F,D]}

    ``tp`` (serving mesh): the column-parallel gate/up outputs are this
    rank's slice of F; the activation is gathered whole over "model"
    before the whole ``w_down``, so the contraction over F is the
    single-device one (a split contraction would sum partial products
    across ranks, in another rounding)."""
    act = silu_gate(x @ p["w_gate"], x @ p["w_up"], use_kernel)
    if tp is not None:
        act = tp.full_cols(act, p["w_down"].shape[-2])
    return act @ p["w_down"]


# ---------------------------------------------------------------------------
# MoE (top-k router, capacity-based dispatch/combine)
# ---------------------------------------------------------------------------

# Above this many tokens the groups run a chunk of groups at a time, which
# bounds the live [groups, E, C, *] dispatch buffers (the same numbers).
MOE_CHUNK_TOKENS = 524288


def _moe_group_size(T: int, E: int) -> int:
    """GShard-style dispatch group size: the largest divisor of ``T`` that
    is at most 1024 (256 from 32 experts on)."""
    target = 256 if E >= 32 else 1024
    gs = min(T, target)
    while T % gs:
        gs -= 1
    return gs


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``idx [...] -> [..., n]``; an index outside [0, n) gives a zero row.
    A comparison with ``arange(n)``: ``F.one_hot`` reads the device to
    check its range, which a captured decode horizon must not."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(x: torch.Tensor, k: int):
    """The ``k`` largest along the last axis, ties to the lower index (as
    ``jax.lax.top_k``): a stable descending sort keeps equal values in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_queue(sel: torch.Tensor, E: int, capacity: int):
    """Expert choices ``sel [G, gs, K]`` -> (their one-hots [G, gs, K, E]
    int32, each (token, k)'s place in its expert's queue [G, gs, K], and
    whether it is kept [G, gs, K]). The queue fills in the flattened
    ``gs * K`` order; a pair at ``capacity`` or past it is dropped."""
    G, gs, K = sel.shape
    sel_oh = _one_hot(sel, E, torch.int32)
    flat = sel_oh.reshape(G, gs * K, E)
    pos = ((flat.cumsum(dim=1) - flat).reshape(G, gs, K, E)
           * sel_oh).sum(dim=-1)
    return sel_oh, pos, pos < capacity


def _moe_groups(pe: dict, xg: torch.Tensor, sel: torch.Tensor,
                w: torch.Tensor, E: int, capacity: int,
                ex_in_spec=None, use_kernel: bool = False) -> torch.Tensor:
    """Dispatch, expert SwiGLU and combine for groups ``xg [G, gs, D]``
    with their choices ``sel``/``w [G, gs, K]`` (:func:`moe_queue` drops
    the pairs past ``capacity``). ``ex_in_spec``: the placements of the
    dispatched inputs [G, E, C, D] (:func:`constrain`); ``use_kernel``:
    the expert gate through :func:`silu_gate`'s kernel. Returns
    [G, gs, D]."""
    G, gs, K = sel.shape
    D = xg.shape[-1]
    sel_oh, pos, keep = moe_queue(sel, E, capacity)
    disp = (sel_oh.bool() & keep[..., None]).to(xg.dtype)   # [G, gs, K, E]
    pos_oh = _one_hot(torch.where(keep, pos, capacity), capacity, xg.dtype)
    dispatch = torch.einsum("gtke,gtkc->gtec", disp, pos_oh)
    combine = torch.einsum("gtke,gtkc->gtec",
                           disp * w.to(xg.dtype)[..., None], pos_oh)
    # [G, E*C, gs] @ [G, gs, D]: each slot holds its token's x (or zeros)
    ex_in = dispatch.reshape(G, gs, E * capacity).transpose(1, 2) @ xg
    ex_in = constrain(ex_in.reshape(G, E, capacity, D), ex_in_spec)
    xe = ex_in.transpose(0, 1).reshape(E, G * capacity, D)
    act = silu_gate(xe @ pe["w_gate"], xe @ pe["w_up"], use_kernel)
    ex_out = (act @ pe["w_down"]).reshape(E, G, capacity, D).transpose(0, 1)
    return combine.reshape(G, gs, E * capacity) \
        @ ex_out.reshape(G, E * capacity, D)


def moe_layer(p: dict, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: Optional[float] = None,
              expert_weight_spec: Optional[dict] = None,
              ex_in_spec=None, use_kernel: bool = False):
    """Top-k MoE with optional shared experts and group-wise capacity
    dispatch (GShard/Switch semantics), as ``repro/models/layers.py``.

    p: {router [D, E], experts {w_gate [E, D, F], w_up [E, D, F],
    w_down [E, F, D]}, (optional) shared {w_gate, w_up, w_down}};
    x [B, S, D]. The router's softmax is f32; the top-k weights are
    renormalised. The B*S tokens fall in groups of
    :func:`_moe_group_size`, each expert taking at most ``capacity =
    max(1, int(cf * gs * K / E))`` of a group's (token, k) pairs in
    order: a dropped pair adds nothing (a token that loses both gets no
    MoE output). Every shape is static, so the layer captures in a CUDA
    graph. Returns (out [B, S, D], the Switch load-balancing aux loss).

    ``expert_weight_spec`` ({w_gate, w_up, w_down} -> placements) lays
    the expert weights out before the group loop (a weight sharded for
    FSDP is then gathered once per layer, not per chunk of groups);
    ``ex_in_spec`` lays out the dispatched inputs (see
    :func:`constrain`). ``use_kernel`` runs the expert and shared gates
    through :func:`silu_gate`'s kernel where it fits."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xt = x.reshape(T, D)
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    experts = p["experts"]
    if expert_weight_spec is not None:
        experts = {k: constrain(v, expert_weight_spec[k])
                   for k, v in experts.items()}

    gates = torch.softmax((xt @ p["router"]).float(), dim=-1)
    weights, sel = _top_k(gates, K)                          # [T, K]
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
    # load-balancing aux loss (Switch-style)
    me = gates.mean(dim=0)
    ce = _one_hot(sel, E, torch.float32).sum(dim=1).mean(dim=0)
    aux_loss = E * (me * ce).sum()

    gs = _moe_group_size(T, E)
    G = T // gs
    capacity = max(1, int(capacity_factor * gs * K / E))
    args = (xt.reshape(G, gs, D), sel.reshape(G, gs, K),
            weights.reshape(G, gs, K))
    # the hook and the kernel only where given: ``_moe_groups``' positional
    # call stays
    extra = {} if ex_in_spec is None else {"ex_in_spec": ex_in_spec}
    if use_kernel:
        extra["use_kernel"] = True
    chunk_groups = max(1, (MOE_CHUNK_TOKENS + gs - 1) // gs)
    if G > chunk_groups:
        while G % chunk_groups:
            chunk_groups -= 1
        # recomputed in the backward pass, as the JAX package's chunk scan
        out = torch.cat([
            checkpoint(_moe_groups, experts,
                       *(a[i:i + chunk_groups] for a in args), E, capacity,
                       use_reentrant=False, **extra)
            for i in range(0, G, chunk_groups)])
    else:
        out = _moe_groups(experts, *args, E, capacity, **extra)
    out = out.reshape(T, D)
    if cfg.num_shared_experts:
        out = out + swiglu(p["shared"], xt, use_kernel=use_kernel)
    return out.reshape(B, S, D), aux_loss


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
    # the running max, sum and output, laid out as q and v (a DTensor
    # q's shards: see ``constrain``)
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    m = torch.full_like(q[..., :1], -1e30, **f32)
    l = torch.zeros_like(q[..., :1], **f32)
    acc = l.expand(B, H, S, v.shape[-1]).contiguous()
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
                       use_kernel: bool = False,
                       tp: Optional[TensorParallel] = None):
    """Full-sequence GQA attention.

    p: {wq [D, H*hd], wk [D, KVH*hd], wv [D, KVH*hd], wo [H*hd, D],
        (qk_norm) q_norm [hd], k_norm [hd]}
    x: [B, S, D]; positions: [B, S] absolute positions.
    ``use_kernel`` runs the attention through the flash-attention wrapper
    (the CUDA kernel on a CUDA tensor, its plain version on the CPU),
    with the kv heads broadcast to the query heads first. The wrapper has
    no backward, as the JAX kernel has none. ``tp`` (serving mesh, a
    batch-1 prefill that every "data" rank runs whole): the rank attends
    over its own heads (all of them where heads do not align), returns
    those K/V, and gathers the heads over "model" before ``wo``.
    """
    B, S, D = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _heads(tp, x @ p["wq"], H, hd)
    k = _heads(tp, x @ p["wk"], KVH, hd)
    v = _heads(tp, x @ p["wv"], KVH, hd)
    H, KVH = q.shape[2], k.shape[2]
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
    if tp is not None:
        out = tp.full_cols(out, p["wo"].shape[-2])
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
    read it and nothing of theirs persists; the hybrid and the MoE stacks
    pass each lane's :func:`last_writer` to :func:`gqa_attention_decode`
    instead.
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
    horizon drift), and an MoE's frozen lanes take expert capacity from
    the live lanes by what they read, so both write every shared slot
    with its last lane's value: the same result on both devices, and the
    same in every run."""
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
                           v_scale: Optional[torch.Tensor] = None,
                           tp: Optional[TensorParallel] = None
                           ) -> torch.Tensor:
    """Decode attention over the paged pool: q [B, H, hd]; pools
    [N_blocks, bs, KVH, hd]; block_tables [B, bp]; cache_lens [B] i32;
    k_scale/v_scale [N_blocks, bs, KVH] mark a quantized pool, whose
    gathered pages are dequantized (f32 cast, times the slot's scale)
    before the scores. Returns [B, H, hd]. ``use_kernel`` goes through the
    kernel wrapper (the CUDA kernel on a CUDA tensor, its plain version on
    the CPU), which dequantizes inside its page loop. ``tp`` (serving
    mesh): q holds this rank's lanes and heads, the pools its kv heads,
    while the tables and lengths cover the whole batch; the kernel goes
    through the sharded route."""
    if tp is not None:
        if use_kernel:
            return kops.paged_attention_sharded(
                tp, q, pool_k, pool_v, block_tables, cache_lens, scale=scale,
                k_scale=k_scale, v_scale=v_scale)
        lanes = tp.lanes(block_tables.shape[0])
        block_tables, cache_lens = block_tables[lanes], cache_lens[lanes]
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

    ``cache["tp"]`` (serving mesh): x holds this rank's lanes of the
    batch, while positions and the block tables cover the whole batch.
    The new K/V of every lane is gathered over "data" and written by
    each rank into its copy of the pool (its kv heads of every block), so
    the copies stay the same; the rank then attends for its own lanes
    and heads and gathers the heads over "model" before ``wo``.
    """
    B, _, D = x.shape
    hd = cfg.head_dim
    tp = cache.get("tp")
    all_positions = positions
    if tp is not None:
        positions = positions[tp.lanes(positions.shape[0])]
    q = _heads(tp, (x @ p["wq"]).reshape(B, -1), cfg.num_heads, hd)
    k = _heads(tp, (x @ p["wk"]).reshape(B, -1), cfg.num_kv_heads, hd)
    v = _heads(tp, (x @ p["wv"]).reshape(B, -1), cfg.num_kv_heads, hd)
    H = q.shape[1]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)  # [B, hd/2]
    cos, sin = cos[:, None, :], sin[:, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)  # rope applied at write time
    if tp is not None:       # every rank writes every lane's K/V
        k, v = tp.gather_data(k), tp.gather_data(v)
        positions = all_positions
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
        k_scale=k_scale, v_scale=v_scale, tp=tp)
    out = out.reshape(B, 1, H * hd)
    if tp is not None:
        out = tp.full_cols(out, p["wo"].shape[-2])
    return out @ p["wo"]


def glue_route(cfg: ModelConfig, x: torch.Tensor, cache: dict,
               use_kernel: bool,
               tp: Optional[TensorParallel] = None) -> str:
    """How a decode step runs the glue between its layers' products:
    "fused" through the kernels of ``kernels/decode_glue.py`` (the residual
    add with the next norm, the attention prologue; SwiGLU's gate takes
    ``silu_mul`` wherever :func:`silu_gate` can) or "chain", the PyTorch
    ops. Fused under ``use_kernel`` for a bf16 batch ``x`` on a card over
    a bf16 pool (no int8 / fp8 scales), with no mesh or a mesh of one rank
    (whose gathers are no-ops), on the dense or MoE GQA stack (not the
    ssm, the hybrid, MLA or the encoder-decoder) at head dim 64, 80 or
    128; every other case keeps the chain."""
    pool = cache.get("k_pool")
    split = tp is not None and (tp.model_n > 1 or tp.data_n > 1)
    fused = (use_kernel and x.is_cuda and x.dtype == torch.bfloat16
             and not split
             and cfg.arch_type not in ("ssm", "hybrid") and not cfg.use_mla
             and not cfg.is_encoder_decoder and pool is not None
             and pool.dtype == torch.bfloat16 and "k_scale" not in cache
             and cfg.head_dim in kglue.HEAD_DIMS)
    return "fused" if fused else "chain"


def gqa_attention_decode_fused(p: dict, cfg: ModelConfig, x: torch.Tensor,
                               positions: torch.Tensor, cache: dict,
                               writer: Optional[torch.Tensor],
                               lens: torch.Tensor,
                               write_lens: bool) -> torch.Tensor:
    """:func:`gqa_attention_decode` on the fused route (:func:`glue_route`):
    x [B, D] (ln1's output); the products, then one ``attn_prologue``
    launch (qk-norm, RoPE, the K/V write into the layer's pool slices,
    under ``writer`` by the lanes that own their slot), the paged
    attention over ``lens`` [B] int32, which the prologue fills where
    ``write_lens`` (once an iteration: every layer attends over the same
    lengths), and ``wo``. Returns [B, D]."""
    B = x.shape[0]
    hd = cfg.head_dim
    norms = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
    q = kops.attn_prologue(
        x @ p["wq"], x @ p["wk"], x @ p["wv"], *norms, cfg.norm_eps,
        positions, kglue.rope_table(hd, cfg.rope_theta, x.device),
        cache["block_tables"], cache["window_len"], cache["k_pool"],
        cache["v_pool"], writer, lens if write_lens else None)
    out = paged_attention_decode(
        cache["k_pool"], cache["v_pool"], q, cache["block_tables"], lens,
        scale=1.0 / math.sqrt(hd), use_kernel=cache.get("use_kernel", False))
    return out.reshape(B, -1) @ p["wo"]


def gqa_attention_prefill_chunk(p: dict, cfg: ModelConfig, x: torch.Tensor,
                                positions: torch.Tensor, valid: torch.Tensor,
                                k_pool: torch.Tensor, v_pool: torch.Tensor,
                                block_tables: torch.Tensor, window_len: int,
                                window: Optional[int] = None,
                                use_kernel: bool = False,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None,
                                tp: Optional[TensorParallel] = None
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

    ``tp`` (serving mesh): every "data" rank runs the (batch-1) chunk
    whole, over its own heads and its pools' kv heads, and gathers the
    heads over "model" before ``wo``.
    """
    B, C, D = x.shape
    hd = cfg.head_dim
    q = _heads(tp, x @ p["wq"], cfg.num_heads, hd)
    k = _heads(tp, x @ p["wk"], cfg.num_kv_heads, hd)
    v = _heads(tp, x @ p["wv"], cfg.num_kv_heads, hd)
    H = q.shape[2]
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
    if use_kernel and tp is not None:
        out = kops.paged_attention_prefill_sharded(
            tp, q, k_pool, v_pool, block_tables, prefix_lens, num_valid, k,
            v, scale=scale, window=window, k_scale=k_scale, v_scale=v_scale)
    elif use_kernel:
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
    out = out.reshape(B, C, H * hd)
    if tp is not None:
        out = tp.full_cols(out, p["wo"].shape[-2])
    return out @ p["wo"]


# ---------------------------------------------------------------------------
# contiguous-cache decode attention (the launcher's decode step)
# ---------------------------------------------------------------------------
# Each sequence owns a dense ring buffer [B, cap, ...] (configs.base's
# kv_cache_specs): slot = position % cap, and the visible length is
# min(position + 1, cap). Dense, as in the JAX package: no kernel reads a
# contiguous cache.

def contiguous_kv_update(cache: torch.Tensor, slot: torch.Tensor,
                         new: torch.Tensor) -> torch.Tensor:
    """cache [B, cap, ...]; slot [B]; new [B, ...]: row b's slot takes
    new[b], in place (cast to the cache's dtype). Returns the cache."""
    if cache.device.type == "cpu":
        check_index(slot, cache.shape[1], "contiguous cache slot")
    cache[torch.arange(cache.shape[0], device=cache.device),
          slot.long()] = new.to(cache.dtype)
    return cache


def _ring(positions: torch.Tensor, cap: int):
    """(write slot, visible slots mask [B, cap]) of a ring buffer."""
    lens = torch.clamp(positions + 1, max=cap)
    valid = (torch.arange(cap, device=positions.device)[None, :]
             < lens[:, None])
    return positions % cap, valid


def gqa_attention_decode_contiguous(p: dict, cfg: ModelConfig,
                                    x: torch.Tensor, positions: torch.Tensor,
                                    k_cache: torch.Tensor,
                                    v_cache: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode over contiguous caches k/v_cache
    [B, cap, KVH, hd] (written in place). x [B, 1, D]; positions [B].
    f32 scores and softmax; returns out [B, 1, D]."""
    B = x.shape[0]
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, H, hd)
    k = (x @ p["wk"]).reshape(B, KVH, hd)
    v = (x @ p["wv"]).reshape(B, KVH, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    cos, sin = cos[:, None, :], sin[:, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    slot, valid = _ring(positions, k_cache.shape[1])
    contiguous_kv_update(k_cache, slot, k)
    contiguous_kv_update(v_cache, slot, v)
    qg = q.reshape(B, KVH, H // KVH, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    scores = scores * (1.0 / math.sqrt(hd))
    out = masked_softmax_pv(scores, valid[:, None, None, :], v_cache,
                            "bkgs,bskh->bkgh")
    return out.to(x.dtype).reshape(B, 1, H * hd) @ p["wo"]


def mla_attention_decode_contiguous(p: dict, cfg: ModelConfig,
                                    x: torch.Tensor, positions: torch.Tensor,
                                    kv_cache: torch.Tensor) -> torch.Tensor:
    """Absorbed MLA decode over a contiguous latent cache
    [B, cap, kv_lora + rope] (written in place), in the rounding order of
    :func:`mla_attention_decode`: ``q_abs`` in x's dtype, f32 scores,
    probabilities cast to x's dtype before the latent P.V, a cache of
    another dtype read in their promotion. Returns out [B, 1, D]."""
    B = x.shape[0]
    H = cfg.num_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    Lk = cfg.kv_lora_rank
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x[:, 0], positions)
    slot, valid = _ring(positions, kv_cache.shape[1])
    contiguous_kv_update(kv_cache, slot, torch.cat([c_kv, k_rope], dim=-1))

    q_abs = torch.einsum("bhd,lhd->bhl", q_nope,
                         p["wk_b"].reshape(Lk, H, nd))
    c_seq, kr_seq = kv_cache[..., :Lk], kv_cache[..., Lk:]
    scores = (torch.einsum("bhl,bsl->bhs", q_abs.float(), c_seq.float())
              + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_seq.float()))
    scores = scores * (1.0 / math.sqrt(nd + rd))
    probs = torch.softmax(torch.where(valid[:, None, :], scores, -1e30),
                          dim=-1).to(x.dtype)
    dt = torch.promote_types(x.dtype, kv_cache.dtype)
    o_lat = torch.einsum("bhs,bsl->bhl", probs.to(dt), c_seq.to(dt))
    out = torch.einsum("bhl,lhd->bhd", o_lat,
                       p["wv_b"].reshape(Lk, H, vd).to(dt))
    return (out.reshape(B, 1, H * vd) @ p["wo"].to(dt)).to(x.dtype)


# ---------------------------------------------------------------------------
# cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] attends over all of the encoder's K/V ``enc_k``/``enc_v``
    [B, T, KVH, hd] (no mask, no rope): f32 scores, probabilities cast to
    x's dtype before P.V. A K/V cache of another dtype than x (the JAX
    package's bf16 cross cache under f32 params) is read in x's dtype,
    as the JAX package's promotion does."""
    B, S, D = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = (x @ p["wq"]).reshape(B, S, KVH, H // KVH, hd)
    scores = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), enc_k.float())
    probs = torch.softmax(scores * (1.0 / math.sqrt(hd)), dim=-1) \
        .to(x.dtype)
    out = torch.einsum("bkgqt,btkh->bqkgh", probs, enc_v.to(x.dtype))
    return out.reshape(B, S, H * hd) @ p["wo"]


def cross_kv(p: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention's K/V of the encoder output [B, T, D]: each
    [B, T, KVH, hd]."""
    B, T, _ = enc_out.shape
    KVH, hd = cfg.num_kv_heads, cfg.head_dim
    return ((enc_out @ p["wk"]).reshape(B, T, KVH, hd),
            (enc_out @ p["wv"]).reshape(B, T, KVH, hd))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def _mla_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """The low-rank projections of x [..., D] at ``positions`` [...]:
    (q_nope [..., H, nope], q_rope [..., H, rope] roped, the normed
    latent c_kv [..., kv_lora], the shared roped key k_rope [..., rope])."""
    H = cfg.num_heads
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    Lk = cfg.kv_lora_rank
    q_lat = rms_norm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    q = (q_lat @ p["wq_b"]).reshape(*x.shape[:-1], H, nd + rd)
    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :Lk], p["kv_a_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
    cos, sin = cos[..., None, :], sin[..., None, :]
    q_rope = apply_rope(q[..., nd:], cos, sin)
    k_rope = apply_rope(kv_a[..., None, Lk:], cos, sin)[..., 0, :]
    return q[..., :nd], q_rope, c_kv, k_rope


def mla_attention_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, return_kv: bool = False):
    """Full-sequence MLA (one-shot prefill and training), causal.

    p: {wq_a [D, q_lora], wq_b [q_lora, H*(nope+rope)],
    wkv_a [D, kv_lora+rope], wk_b [kv_lora, H*nope], wv_b [kv_lora, H*v],
    wo [H*v, D], q_a_norm [q_lora], kv_a_norm [kv_lora]}; x [B, S, D].
    Up to ``CHUNKED_ATTN_THRESHOLD`` tokens the nope and rope scores are
    two f32 einsums over the materialised [S, S] scores; beyond, the
    shared roped key is folded into per-head keys and the attention runs
    :func:`chunked_mha`. With ``return_kv`` also returns the paged pool's
    entry of each token, [latent (kv_lora) | roped key (rope)]
    [B, S, kv_lora + rope]."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    k_nope = (c_kv @ p["wk_b"]).reshape(B, S, H, nd)
    v = (c_kv @ p["wv_b"]).reshape(B, S, H, vd)
    scale = 1.0 / math.sqrt(nd + rd)
    if S > CHUNKED_ATTN_THRESHOLD:
        qh = torch.cat([q_nope, q_rope], dim=-1) * scale
        kh = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, rd)],
                       dim=-1)
        out = chunked_mha(qh.transpose(1, 2), kh.transpose(1, 2),
                          v.transpose(1, 2), chunk=ATTN_CHUNK)
        out = out.transpose(1, 2).reshape(B, S, H * vd)
    else:
        scores = (torch.einsum("bqhd,bshd->bhqs", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                                 k_rope.float())) * scale
        mask = _attn_mask(S, S, None, x.device)
        probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1) \
            .to(x.dtype)
        out = torch.einsum("bhqs,bshd->bqhd", probs, v).reshape(B, S, H * vd)
    out = out @ p["wo"]
    if return_kv:
        return out, torch.cat([c_kv, k_rope], dim=-1)
    return out


def mla_attention_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                         positions: torch.Tensor, cache: dict,
                         writer: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Absorbed-weight MLA decode over the paged latent pool, one layer.

    x [B, 1, D]; positions [B]; cache holds this layer's ``kv_pool``
    [N_blocks, bs, kv_lora + rope] (written in place), ``block_tables``
    and ``window_len`` (the engine's capacity: the slot wraps at it and
    the lengths are capped by it). ``wk_b`` is folded into the query
    (q_abs [B, H, kv_lora], in x's dtype) and ``wv_b`` into the output,
    so attention runs in the latent space: f32 scores, probabilities cast
    to x's dtype before P.latent. ``writer`` [B] (:func:`last_writer`)
    gives each lane the lane whose entry it writes, as the GQA decode's.
    Returns out [B, 1, D]."""
    B = x.shape[0]
    H = cfg.num_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    Lk = cfg.kv_lora_rank
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x[:, 0], positions)
    entry = torch.cat([c_kv, k_rope], dim=-1)          # [B, kv_lora + rope]
    if writer is not None:   # lanes sharing a slot write its last writer's
        entry = entry[writer]

    pool, bt = cache["kv_pool"], cache["block_tables"]
    window_len = cache["window_len"]
    slot = positions % window_len if window_len > 0 else positions
    block_ids, offs = _slot_ids(bt, slot, pool.shape[1], pool.shape[0],
                                "decode")
    pool[block_ids, offs] = entry.to(pool.dtype)
    new_lens = (torch.clamp(positions + 1, max=window_len) if window_len > 0
                else positions + 1)

    q_abs = torch.einsum("bhd,lhd->bhl", q_nope,
                         p["wk_b"].reshape(Lk, H, nd))
    entries = gather_pages(pool, bt)                   # [B, bp * bs, Lk+rd]
    c_seq, kr_seq = entries[..., :Lk], entries[..., Lk:]
    scores = (torch.einsum("bhl,bsl->bhs", q_abs.float(), c_seq.float())
              + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_seq.float()))
    scores = scores * (1.0 / math.sqrt(nd + rd))
    valid = (torch.arange(entries.shape[1], device=x.device)[None, :]
             < new_lens[:, None])
    probs = torch.softmax(torch.where(valid[:, None, :], scores, -1e30),
                          dim=-1).to(x.dtype)
    # the pool's dtype and x's meet in their promotion, as in the JAX
    # package (a bf16 pool under f32 params is read as f32)
    dt = torch.promote_types(x.dtype, pool.dtype)
    o_lat = torch.einsum("bhs,bsl->bhl", probs.to(dt), c_seq.to(dt))
    out = torch.einsum("bhl,lhd->bhd", o_lat,
                       p["wv_b"].reshape(Lk, H, vd).to(dt))
    return (out.reshape(B, 1, H * vd) @ p["wo"].to(dt)).to(x.dtype)


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
