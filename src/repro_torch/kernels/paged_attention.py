"""Paged attention over the paged KV pool: the plain PyTorch version and
the wrapper of the hand-written CUDA kernel (``csrc/paged_attention.cu``).

The kernel replaces the TPU kernel
``src/repro/kernels/paged_attention.py::_mq_paged_kernel`` on both of
its faces:

  * DECODE (``paged_attention``): one new query token per sequence over
    the pooled cache — called once per layer per decode iteration;
  * CHUNKED PREFILL (``paged_attention_prefill``): a chunk of C query
    tokens over the pooled prefix (slots before the chunk) plus the
    chunk's own exact K/V, causal within the chunk, with right-padding
    (``num_valid``) and an optional sliding window.

Either face reads an f32, bf16, int8 or fp8 pool. A quantized pool comes
with ``k_scale``/``v_scale`` ``[NB, page, KVH]`` f32, one per slot and kv
head, and each page is dequantized inside the loop (cast to f32, times
its scale column), as the JAX kernel's ``has_scales`` variant does. The
chunk's own K/V is exact and never scaled.

Numerics contract (shared by the kernel, the plain version and the dense
layer path): f32 scores, softmax and P.V; a row with no visible key
emits ZEROS, never a softmax over the masked fill.

On a CPU tensor each wrapper runs the plain version (what the tests and a
CPU engine with ``use_kernel=True`` reach). On a CUDA tensor it launches
the kernel or raises: there is no fallback. Each kernel launch adds one
to ``LAUNCHES[face]`` (``decode``/``prefill`` over a float pool,
``decode_quant``/``prefill_quant`` over a quantized one).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
LAUNCHES = {"decode": 0, "prefill": 0, "decode_quant": 0,
            "prefill_quant": 0}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
# pool dtype -> the kernel's pool-type code (csrc/paged_attention.cu)
_POOL_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_lib = None


# ---------------------------------------------------------------------------
# plain PyTorch version (mirrors repro/kernels/ref.py and the dense layer)
# ---------------------------------------------------------------------------

def masked_softmax_pv(scores: torch.Tensor, mask: torch.Tensor,
                      v: torch.Tensor, pv_einsum: str) -> torch.Tensor:
    """Masked softmax + P.V in f32 with the empty-row convention: rows
    whose mask is all-False emit ZEROS. Returns f32."""
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    return torch.einsum(pv_einsum, p, v.float())


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """pool [NB, bs, ...] through block_tables [B, bp] -> [B, bp * bs, ...]
    (each sequence's pages, in slot order; also gathers the scales
    [NB, bs, KVH] of a quantized pool)."""
    B, bp = block_tables.shape
    bs = pool.shape[1]
    if pool.device.type == "cpu":
        check_index(block_tables, pool.shape[0], "block_tables")
    return pool[block_tables.long()].reshape(B, bp * bs, *pool.shape[2:])


def gather_kv(pool: torch.Tensor, block_tables: torch.Tensor,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gathered pages of one pool, [B, bp * bs, KVH, hd]: dequantized
    to f32 when ``scale`` [NB, bs, KVH] marks a quantized pool, else in
    the pool's dtype."""
    pages = gather_pages(pool, block_tables)
    if scale is None:
        return pages
    return pages.float() * gather_pages(scale, block_tables)[..., None]


def check_index(idx: torch.Tensor, n: int, what: str) -> None:
    """Raise unless every entry of ``idx`` lies in [0, n). JAX clamps an
    out-of-range gather and drops an out-of-range scatter; torch raises
    on the CPU and faults on CUDA, so the CPU path checks it here (a
    check on CUDA would cost a device sync)."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"{what} out of range [0, {n}): "
                         f"[{int(idx.min())}, {int(idx.max())}]")


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          cache_lens: torch.Tensor, scale: float,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Decode: q [B, H, hd]; pools [NB, bs, KVH, hd]; block_tables
    [B, bp]; cache_lens [B] valid slots; k_scale/v_scale [NB, bs, KVH]
    for a quantized pool. Returns [B, H, hd] in q's dtype."""
    B, H, hd = q.shape
    KVH = k_pool.shape[2]
    k = gather_kv(k_pool, block_tables, k_scale)
    v = gather_kv(v_pool, block_tables, v_scale)
    qg = q.reshape(B, KVH, H // KVH, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) * scale
    slots = torch.arange(k.shape[1], device=q.device)
    valid = slots[None, :] < cache_lens[:, None]
    out = masked_softmax_pv(scores, valid[:, None, None, :], v,
                            "bkgs,bskh->bkgh")
    return out.to(q.dtype).reshape(B, H, hd)


def paged_attention_prefill_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  prefix_lens: torch.Tensor,
                                  num_valid: torch.Tensor,
                                  own_k: torch.Tensor, own_v: torch.Tensor,
                                  scale: float,
                                  window: Optional[int] = None,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Chunked prefill: q [B, C, H, hd] over the pooled prefix (slots <
    prefix_lens[b], slot == position) plus the chunk's own K/V
    [B, C, KVH, hd]. Query c of row b sits at position prefix_lens[b] + c;
    queries and own keys at c >= num_valid[b] are padding. k_scale/v_scale
    [NB, bs, KVH] dequantize a quantized pool (the own K/V is exact).
    Returns [B, C, H, hd] in q's dtype; padded queries emit zeros."""
    B, C, H, hd = q.shape
    KVH = k_pool.shape[2]
    dev = q.device
    kc = gather_kv(k_pool, block_tables, k_scale)
    vc = gather_kv(v_pool, block_tables, v_scale)
    S = kc.shape[1]
    keys = torch.cat([kc.float(), own_k.float()], dim=1)
    vals = torch.cat([vc.float(), own_v.float()], dim=1)
    positions = prefix_lens[:, None] + torch.arange(C, device=dev)[None, :]
    valid = torch.arange(C, device=dev)[None, :] < num_valid[:, None]
    q_pos = positions[:, :, None]                           # [B, C, 1]
    pool_pos = torch.arange(S, device=dev)[None, None, :]   # slot == pos
    pool_mask = (pool_pos < prefix_lens[:, None, None]).expand(B, C, S)
    own_mask = (positions[:, None, :] <= q_pos) & valid[:, None, :]
    mask = torch.cat([pool_mask, own_mask], dim=2)
    if window is not None:
        all_pos = torch.cat([pool_pos.expand(B, 1, S),
                             positions[:, None, :]], dim=2)
        mask = mask & (all_pos > (q_pos - window))
    mask = mask & valid[:, :, None]
    qg = q.reshape(B, C, KVH, H // KVH, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), keys) * scale
    out = masked_softmax_pv(scores, mask[:, None, None], vals,
                            "bkgqs,bskh->bqkgh")
    return out.to(q.dtype).reshape(B, C, H, hd)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def flatten_queries(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, C, H, hd] -> [B, KVH, C*G, hd]: the kernel's query tile, row
    c*G + g = chunk token c, query head kvh*G + g."""
    B, C, H, hd = q.shape
    G = H // kv_heads
    return q.reshape(B, C, kv_heads, G, hd).transpose(1, 2) \
        .reshape(B, kv_heads, C * G, hd)


def unflatten_queries(out: torch.Tensor, chunk: int) -> torch.Tensor:
    """Inverse of :func:`flatten_queries`."""
    B, KVH, CG, hd = out.shape
    G = CG // chunk
    return out.reshape(B, KVH, chunk, G, hd).transpose(1, 2) \
        .reshape(B, chunk, KVH * G, hd)


def _library():
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_paged_attention.argtypes = (
            [p] * 11 + [i] * 10 + [ctypes.c_float, i, p])
        lib.repro_paged_attention.restype = i
        _lib = lib
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def _launch(qf, k_pool, v_pool, block_tables, lens, nvalid, own_k, own_v,
            k_scale, v_scale, *, scale: float, window: Optional[int]
            ) -> torch.Tensor:
    """Check the operands and launch on the current stream. qf
    [B, KVH, C*G, hd]; own_k/own_v [B, KVH, C, hd] or None (decode);
    k_scale/v_scale [NB, page, KVH] f32 or None (float pool)."""
    B, KVH, CG, hd = qf.shape
    NB, page, pool_kvh, pool_hd = k_pool.shape
    bp = block_tables.shape[1]
    has_own = own_k is not None
    has_scales = k_scale is not None
    C = own_k.shape[2] if has_own else 1
    tensors = [qf, k_pool, v_pool, block_tables, lens]
    if has_own:
        tensors += [nvalid, own_k, own_v]
    if has_scales:
        tensors += [k_scale, v_scale]
    for t in tensors:
        _require(t.device == qf.device, "operands on different devices")
        _require(t.is_contiguous(), "operands must be contiguous")
    _require(hd in (64, 128), f"head_dim {hd} not in (64, 128)")
    _require((pool_kvh, pool_hd) == (KVH, hd), "pool/query head mismatch")
    _require(v_pool.shape == k_pool.shape, "k/v pool shapes differ")
    _require(qf.dtype in _FLOAT_DTYPES, f"query dtype {qf.dtype}")
    _require(k_pool.dtype in _POOL_KINDS
             and v_pool.dtype == k_pool.dtype, f"pool dtype {k_pool.dtype}")
    _require(has_scales == (k_pool.dtype not in _FLOAT_DTYPES),
             "scales go with an int8/fp8 pool and only with one")
    if has_scales:
        _require(k_scale.dtype == torch.float32 and v_scale.dtype
                 == torch.float32 and k_scale.shape == (NB, page, KVH)
                 and v_scale.shape == k_scale.shape,
                 "scales must be [NB, page, KVH] f32")
    _require(block_tables.dtype == torch.int32
             and block_tables.shape[0] == B, "block_tables must be [B, bp] i32")
    _require(lens.dtype == torch.int32 and lens.shape == (B,),
             "lengths must be [B] i32")
    _require(CG % C == 0, "query rows not a multiple of the chunk")
    if has_own:
        _require(nvalid.dtype == torch.int32 and nvalid.shape == (B,),
                 "num_valid must be [B] i32")
        _require(own_k.shape == (B, KVH, C, hd) and own_v.shape == own_k.shape
                 and own_k.dtype == qf.dtype and own_v.dtype == qf.dtype,
                 "own K/V must be [B, KVH, C, hd] in the query dtype")
    out = torch.empty_like(qf)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _library().repro_paged_attention(
        ptr(qf), ptr(k_pool), ptr(v_pool), ptr(block_tables), ptr(lens),
        ptr(nvalid), ptr(own_k), ptr(own_v), ptr(k_scale), ptr(v_scale),
        ptr(out), B, KVH, CG, C, CG // C, bp, page, hd,
        int(qf.dtype == torch.bfloat16), _POOL_KINDS[k_pool.dtype],
        scale, -1 if window is None else int(window),
        torch.cuda.current_stream(qf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    cache_lens: torch.Tensor, *, scale: float,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Decode face: q [B, H, hd]; one layer's pools [NB, page, KVH, hd];
    block_tables [B, bp] i32; cache_lens [B] i32; k_scale/v_scale
    [NB, page, KVH] f32 for an int8/fp8 pool. Returns [B, H, hd]."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     cache_lens, scale, k_scale, v_scale)
    B, H, hd = q.shape
    KVH = k_pool.shape[2]
    # [B, KVH, G, hd]: the G query heads of a kv head form one tile (a view)
    qf = q.contiguous().reshape(B, KVH, H // KVH, hd)
    out = _launch(qf, k_pool, v_pool, block_tables, cache_lens, None, None,
                  None, k_scale, v_scale, scale=scale, window=None)
    LAUNCHES["decode" if k_scale is None else "decode_quant"] += 1
    return out.reshape(B, H, hd)


def paged_attention_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            prefix_lens: torch.Tensor,
                            num_valid: torch.Tensor, own_k: torch.Tensor,
                            own_v: torch.Tensor, *, scale: float,
                            window: Optional[int] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Chunked-prefill face: q [B, C, H, hd]; own_k/own_v [B, C, KVH, hd];
    prefix_lens, num_valid [B] i32; k_scale/v_scale [NB, page, KVH] f32
    for an int8/fp8 pool. Returns [B, C, H, hd]."""
    if q.device.type == "cpu":
        return paged_attention_prefill_plain(
            q, k_pool, v_pool, block_tables, prefix_lens, num_valid,
            own_k, own_v, scale, window, k_scale, v_scale)
    C = q.shape[1]
    KVH = k_pool.shape[2]
    qf = flatten_queries(q, KVH).contiguous()
    ok = own_k.transpose(1, 2).contiguous()   # [B, KVH, C, hd]
    ov = own_v.transpose(1, 2).contiguous()
    out = _launch(qf, k_pool, v_pool, block_tables, prefix_lens, num_valid,
                  ok, ov, k_scale, v_scale, scale=scale, window=window)
    LAUNCHES["prefill" if k_scale is None else "prefill_quant"] += 1
    return unflatten_queries(out, C)
