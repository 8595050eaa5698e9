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
head, as the JAX kernel's ``has_scales`` variant does. The kernel folds
them in per slot (``s_j = k_scale_j * (q . code_j) * scale``, ``p_j *
v_scale_j`` before the product with the codes) where the plain version
dequantizes the gathered pages; the two agree up to f32 rounding order.
The chunk's own K/V is exact and never scaled.

The decode kernel may cut each lane's page range into parts whose
partial softmax states are merged by log-sum-exp (split-K);
:func:`split_count` picks the number of parts from shapes alone, and
:func:`paged_attention_split_plain` is the same algebra in PyTorch. On
the tensor-core prefill route the kernel rounds P to bf16 before P.V,
as :func:`tiled_softmax_pv` does with ``p_dtype=torch.bfloat16``.

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
# decode split-K: aim at this many CTAs (4 per SM of the H100's 132) and
# give each part at least MIN_SPLIT_PAGES pages of the block table
TARGET_CTAS = 4 * 132
MIN_SPLIT_PAGES = 32
# the head dims the kernel is built for (csrc/paged_attention.cu)
HEAD_DIMS = (32, 64, 80, 128)
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
# the kernels' algebra in PyTorch: partial softmax states and their merge,
# per-slot scale folding, P rounded before P.V
# ---------------------------------------------------------------------------

def split_count(bp: int, heads: int) -> int:
    """Parts of each lane's page range for the decode kernel, from the
    block-table width ``bp`` and ``heads`` = B * KVH alone. It never
    reads the lengths: they live on the device, and reading them would
    cost a sync per layer and break CUDA-graph capture."""
    return max(1, min(bp // MIN_SPLIT_PAGES, -(-TARGET_CTAS // heads)))


def softmax_partial(scores: torch.Tensor, mask: torch.Tensor,
                    v: torch.Tensor, p_scale: Optional[torch.Tensor] = None
                    ):
    """The unnormalised softmax state of one part of the keys: scores
    [..., Q, K] f32, mask [..., Q, K], v [..., K, hd]. ``p_scale``
    [..., 1, K] multiplies p after l is summed (a quantized pool's
    v scales). Returns (m [..., Q], l [..., Q], acc [..., Q, hd]) in f32;
    a row with no visible key has m = -inf, l = 0, acc = 0."""
    if scores.shape[-1] == 0:   # a part past the end of the table
        l = scores.new_zeros(scores.shape[:-1])
        acc = scores.new_zeros(*scores.shape[:-1], v.shape[-1])
        return torch.full_like(l, float("-inf")), l, acc
    s = torch.where(mask, scores, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if p_scale is not None:
        p = p * p_scale
    acc = p @ v.float()
    return torch.where(l > 0, m, float("-inf")), l, acc


def merge_partials(parts) -> torch.Tensor:
    """Merge (m, l, acc) states of disjoint key parts by log-sum-exp into
    acc / l; a row empty in every part emits zeros."""
    m = torch.stack([p[0] for p in parts])
    l = torch.stack([p[1] for p in parts])
    acc = torch.stack([p[2] for p in parts])
    big = m.amax(dim=0)
    w = torch.where(m == float("-inf"), 0.0, torch.exp(m - big))
    L = (w * l).sum(dim=0)
    O = (w[..., None] * acc).sum(dim=0)
    return O / torch.where(L == 0.0, 1.0, L)[..., None]


def paged_attention_split_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                cache_lens: torch.Tensor, scale: float,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None,
                                splits: Optional[int] = None
                                ) -> torch.Tensor:
    """The decode kernel's algebra: each lane's ``bp`` pages cut into
    ``splits`` parts of ``ceil(bp / splits)`` pages (default
    :func:`split_count`), a partial softmax state per part, merged by
    log-sum-exp. A quantized pool's scales are folded in per slot (scores
    of the codes times ``k_scale``, p times ``v_scale``), never applied to
    the codes. Same signature and result as :func:`paged_attention_plain`.
    """
    B, H, hd = q.shape
    NB, page, KVH, _ = k_pool.shape
    bp = block_tables.shape[1]
    G = H // KVH
    if splits is None:
        splits = split_count(bp, B * KVH)
    k = gather_pages(k_pool, block_tables).float()   # codes, not scaled
    v = gather_pages(v_pool, block_tables).float()
    qg = q.reshape(B, KVH, G, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k)
    ks = vs = None
    if k_scale is not None:
        ks = gather_pages(k_scale, block_tables).transpose(1, 2)  # [B,KVH,S]
        vs = gather_pages(v_scale, block_tables).transpose(1, 2)
        scores = scores * ks[:, :, None, :]
    scores = scores * scale
    slots = torch.arange(bp * page, device=q.device)
    valid = (slots[None, :] < cache_lens[:, None])[:, None, None, :]
    per = -(-bp // splits) * page
    parts = []
    for s in range(splits):
        cut = slice(s * per, (s + 1) * per)
        parts.append(softmax_partial(
            scores[..., cut], valid[..., cut],
            v.transpose(1, 2)[:, :, cut],
            None if vs is None else vs[:, :, None, cut]))
    out = merge_partials(parts)
    return out.to(q.dtype).reshape(B, H, hd)


def tiled_softmax_pv(scores: torch.Tensor, mask: torch.Tensor,
                     v: torch.Tensor, block: int = 64,
                     p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The tensor-core tile's online softmax over key blocks of ``block``:
    scores [..., Q, K] f32, mask [..., Q, K], v [..., K, hd]. Per block
    the running max, the rescale and l summed in f32 from the unrounded
    p; ``p_dtype`` (bf16 on the tensor cores) rounds p before P.V, as
    ``ref.py::mha_ref`` rounds its probabilities to v's dtype. Returns
    f32 [..., Q, hd]; a row with no visible key emits zeros."""
    K = scores.shape[-1]
    m = torch.full(scores.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=scores.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(*scores.shape[:-1], v.shape[-1], dtype=torch.float32,
                      device=scores.device)
    for k0 in range(0, K, block):
        s = scores[..., k0:k0 + block]
        vis = mask[..., k0:k0 + block]
        s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = acc * alpha[..., None] + p @ v[..., k0:k0 + block, :].float()
        m = m_new
    return acc / torch.where(l == 0.0, 1.0, l)[..., None]


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_paged_attention.argtypes = (
            [p] * 13 + [i] * 10 + [ctypes.c_float, i, i, p])
        lib.repro_paged_attention.restype = i
        _lib = lib
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def _launch(q, k_pool, v_pool, block_tables, lens, nvalid, own_k, own_v,
            k_scale, v_scale, *, scale: float, window: Optional[int]
            ) -> torch.Tensor:
    """Check the operands and launch on the current stream. q
    [B, C, H, hd] (decode: C = 1); own_k/own_v [B, C, KVH, hd] or None
    (decode); k_scale/v_scale [NB, page, KVH] f32 or None (float pool).
    The kernel reads the G query heads of each kv head in place."""
    B, C, H, hd = q.shape
    NB, page, KVH, pool_hd = k_pool.shape
    bp = block_tables.shape[1]
    has_own = own_k is not None
    has_scales = k_scale is not None
    tensors = [q, k_pool, v_pool, block_tables, lens]
    if has_own:
        tensors += [nvalid, own_k, own_v]
    if has_scales:
        tensors += [k_scale, v_scale]
    for t in tensors:
        _require(t.device == q.device, "operands on different devices")
        _require(t.is_contiguous(), "operands must be contiguous")
    for t in (q, k_pool, v_pool, own_k, own_v):   # read 16 bytes at a time
        _require(t is None or t.data_ptr() % 16 == 0,
                 "queries, pools and own K/V must be 16-byte aligned")
    _require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _require(H % KVH == 0 and pool_hd == hd, "pool/query head mismatch")
    _require(v_pool.shape == k_pool.shape, "k/v pool shapes differ")
    _require(q.dtype in _FLOAT_DTYPES, f"query dtype {q.dtype}")
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
    if has_own:
        _require(nvalid.dtype == torch.int32 and nvalid.shape == (B,),
                 "num_valid must be [B] i32")
        _require(own_k.shape == (B, C, KVH, hd) and own_v.shape == own_k.shape
                 and own_k.dtype == q.dtype and own_v.dtype == q.dtype,
                 "own K/V must be [B, C, KVH, hd] in the query dtype")
    out = torch.empty_like(q)
    # decode only: partial states of the parts of each lane's page range
    splits = 1 if has_own else split_count(bp, B * KVH)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty(splits, B * H, hd, dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty(2, splits, B * H, dtype=torch.float32,
                              device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _library().repro_paged_attention(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(block_tables), ptr(lens),
        ptr(nvalid), ptr(own_k), ptr(own_v), ptr(k_scale), ptr(v_scale),
        ptr(out), ptr(part_o), ptr(part_ml), B, KVH, C * (H // KVH), C,
        H // KVH, bp, page, hd, int(q.dtype == torch.bfloat16),
        _POOL_KINDS[k_pool.dtype], scale,
        -1 if window is None else int(window), splits,
        torch.cuda.current_stream(q.device).cuda_stream)
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
    out = _launch(q.contiguous()[:, None], k_pool, v_pool, block_tables,
                  cache_lens, None, None, None, k_scale, v_scale,
                  scale=scale, window=None)
    LAUNCHES["decode" if k_scale is None else "decode_quant"] += 1
    return out[:, 0]


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
    out = _launch(q.contiguous(), k_pool, v_pool, block_tables, prefix_lens,
                  num_valid, own_k.contiguous(), own_v.contiguous(), k_scale,
                  v_scale, scale=scale, window=window)
    LAUNCHES["prefill" if k_scale is None else "prefill_quant"] += 1
    return out
