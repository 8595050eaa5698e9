"""Paged attention over the paged KV pool: the plain PyTorch version and
the wrappers of the hand-written CUDA kernels (``csrc/paged_attention.cu``
and, for the decode face, ``csrc/paged_decode.cu``).

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

The decode face has two kernels, chosen by :func:`decode_face` from the
dtypes, the head dim and the page size alone. bf16 queries over a bf16,
int8 or fp8 pool at hd 64, 80 or 128, with pages of 8 slots or a multiple
of 16, take the cluster face (``csrc/paged_decode.cu``): a
thread-block cluster per (lane, kv head) shares the lane's 16-slot chunks
(:func:`decode_plan`, from shapes alone), folds them on the tensor cores
with P rounded to bf16, and merges its CTAs' partial softmax states
through distributed shared memory in the same launch;
:func:`paged_attention_cluster_plain` is its algebra in PyTorch. f32
queries or pools, and hd 32, take ``decode_kernel``
(:func:`paged_attention_split`), which cuts each lane's page range into
parts merged by log-sum-exp in a second launch (split-K);
:func:`split_count` picks the number of parts from shapes alone, and
:func:`paged_attention_split_plain` is the same algebra. On
the tensor-core prefill routes the kernel rounds P to bf16 before P.V,
as :func:`tiled_softmax_pv` does with ``p_dtype=torch.bfloat16``.

The prefill face has three kernels. bf16 queries over a bf16, int8 or fp8
pool at hd 64 or 128 take the Hopper kernel (wgmma products, TMA page
loads) where :func:`prefill_rows` gives it a number of query rows per
CTA; its schedule, which key tiles each CTA visits and which of them need
a mask, is :func:`prefill_plan`. Other bf16 queries take the mma.sync
tensor-core kernel, f32 queries or an f32 pool the f32 kernel.

Numerics contract (shared by the kernel, the plain version and the dense
layer path): f32 scores, softmax and P.V; a row with no visible key
emits ZEROS, never a softmax over the masked fill.

On a CPU tensor each wrapper runs the plain version (what the tests and a
CPU engine with ``use_kernel=True`` reach). On a CUDA tensor it launches
the kernel or raises: there is no fallback. Each kernel launch adds one
to ``LAUNCHES[face]`` (``decode``/``prefill`` over a float pool,
``decode_quant``/``prefill_quant`` over a quantized one), except that a
launch of the wgmma prefill kernel adds one to ``prefill_wgmma`` (or
``prefill_quant_wgmma``) and one of the cluster decode face to
``decode_cluster`` (or ``decode_quant_cluster``) instead, so a run shows
which kernel of each face ran.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
LAUNCHES = {"decode": 0, "prefill": 0, "decode_quant": 0,
            "prefill_quant": 0, "prefill_wgmma": 0, "prefill_quant_wgmma": 0,
            "decode_cluster": 0, "decode_quant_cluster": 0}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
# decode split-K: aim at this many CTAs (4 per SM of the H100's 132) and
# give each part at least MIN_SPLIT_PAGES pages of the block table
TARGET_CTAS = 4 * 132
MIN_SPLIT_PAGES = 32
# the head dims the kernel is built for (csrc/paged_attention.cu), and
# those of its wgmma prefill kernel
HEAD_DIMS = (32, 64, 80, 128)
WGMMA_HEAD_DIMS = (64, 128)
# keys per tile of the prefill kernels
PREFILL_BLOCK = 64
# the cluster decode face (csrc/paged_decode.cu, :func:`decode_plan`):
# head dims, slots per chunk (one k-step of P.V), warp groups per CTA,
# query rows per CTA (three 16-row tiles), the cap on a cluster (the
# portable size), the CTAs aimed at (2 per SM of the H100's 132: a
# cluster's CTAs must fit one GPC at once), its ring of chunks where a
# CTA's share of a full row does not fit (one stage per warp group)
CLUSTER_HEAD_DIMS = (64, 80, 128)
DECODE_CHUNK = 16
WARP_GROUPS = 4
CLUSTER_ROWS = 48
MAX_CLUSTER = 8
CLUSTER_TARGET_CTAS = 2 * 132
MAX_STAGES = 4
# pool dtype -> the kernel's pool-type code (csrc/paged_attention.cu)
_POOL_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_lib = None
_cluster_lib = None


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
    qg = q.reshape(B, KVH, H // KVH, hd).float().contiguous()
    # each kv head's scores from its own contiguous [S, hd] keys: a layout
    # whose per-head products do not change with the number of heads,
    # so a mesh rank that holds some of the heads gets their bits
    kh = k.float().permute(0, 2, 1, 3).contiguous()
    scores = (qg @ kh.transpose(-1, -2)) * scale
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
    kc = gather_kv(k_pool, block_tables, k_scale)
    vc = gather_kv(v_pool, block_tables, v_scale)
    keys = torch.cat([kc.float(), own_k.float()], dim=1)
    vals = torch.cat([vc.float(), own_v.float()], dim=1)
    mask = prefill_mask(prefix_lens, num_valid, C, kc.shape[1], window)
    qg = q.reshape(B, C, KVH, H // KVH, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), keys) * scale
    out = masked_softmax_pv(scores, mask[:, None, None], vals,
                            "bkgqs,bskh->bqkgh")
    return out.to(q.dtype).reshape(B, C, H, hd)


def prefill_mask(prefix_lens: torch.Tensor, num_valid: torch.Tensor, C: int,
                 S: int, window: Optional[int] = None) -> torch.Tensor:
    """The chunked prefill's visibility, [B, C, S + C] bool: query c of
    row b (position prefix_lens[b] + c) against the S pooled slots (slot
    == position, visible below prefix_lens[b]) and then the chunk's own C
    keys (causal, real below num_valid[b]); under a ``window`` a key is
    visible only at a position above the query's minus the window. Padded
    queries (c >= num_valid[b]) see nothing."""
    dev = prefix_lens.device
    B = prefix_lens.shape[0]
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
    return mask & valid[:, :, None]


# ---------------------------------------------------------------------------
# the wgmma prefill kernel's route and schedule (csrc/paged_attention.cu:
# launch_prefill and TilePlan), from shapes on the host, from the lengths
# on the device
# ---------------------------------------------------------------------------

def prefill_rows(C: int, G: int, hd: int, page: int, q_dtype: torch.dtype,
                 pool_dtype: torch.dtype) -> int:
    """Query rows per CTA of the wgmma prefill kernel for a chunk of C
    tokens, G query heads per kv head, head dim ``hd`` and pages of
    ``page`` slots, or 0 where another prefill kernel takes the call. It
    takes bf16 queries over a bf16, int8 or fp8 pool at hd 64 or 128 (a
    bf16 row is one 128-byte TMA box per 64 columns) with pages of 8, 16
    or 32 slots or a multiple of 64 (a 64-key tile is whole pages, or a
    64-slot piece of one, each box 1024-byte aligned for the swizzle) and
    G <= 128. It takes 128 rows (two consumer warpgroups, each K/V tile
    serving both) unless C*G <= 64, where a second warpgroup would hold
    no row."""
    if (q_dtype != torch.bfloat16 or pool_dtype == torch.float32
            or hd not in WGMMA_HEAD_DIMS or page < 8
            or (PREFILL_BLOCK % page and page % PREFILL_BLOCK) or G > 128):
        return 0
    return 64 if C * G <= 64 else 128


def prefill_plan(C: int, G: int, rows: int, prefix_len: int,
                 num_valid: int, window: Optional[int] = None) -> list:
    """The wgmma prefill kernel's schedule for one lane and kv head: a
    CTA holds ``rows // G`` whole chunk tokens (its rows: their G query
    heads each), and visits pool tiles (slots ``64 t`` ..) and then own
    tiles (chunk keys ``64 u`` ..). Returns one dict per CTA:
    ``tokens`` (its first token and one past its last), ``live`` (the same
    for its real tokens, below ``num_valid``: the rest emit zeros),
    ``pool`` and ``own``, lists of ``(tile, masked)`` in visiting order. A
    tile is visited iff some live row sees a key of it, and ``masked``
    unless every key of it is visible to every live row."""
    T, block = rows // G, PREFILL_BLOCK
    ctas = []
    for c0 in range(0, C, T):
        c_end = min(C, num_valid, c0 + T)
        cta = {"tokens": (c0, min(C, c0 + T)), "live": (c0, max(c0, c_end)),
               "pool": [], "own": []}
        ctas.append(cta)
        if c_end <= c0 or window == 0:
            continue
        c_lo, c_hi = c0, c_end - 1
        lo = 0 if window is None else max(0, prefix_len + c_lo - window + 1)
        if lo < prefix_len:
            for t in range(lo // block, -(-prefix_len // block)):
                free = ((t + 1) * block <= prefix_len and
                        (window is None
                         or t * block > prefix_len + c_hi - window))
                cta["pool"].append((t, not free))
        olo = 0 if window is None else max(0, c_lo - window + 1)
        for u in range(olo // block, c_hi // block + 1):
            free = (u * block + block - 1 <= c_lo and
                    (window is None or u * block > c_hi - window))
            cta["own"].append((u, not free))
    return ctas


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
# the cluster decode face (csrc/paged_decode.cu): its route, its schedule
# from shapes on the host, and its algebra in PyTorch
# ---------------------------------------------------------------------------

def decode_face(q_dtype: torch.dtype, pool_dtype: torch.dtype,
                hd: int, page: int) -> str:
    """The decode kernel for queries of ``q_dtype`` over a pool of
    ``pool_dtype`` at head dim ``hd`` with pages of ``page`` slots, from
    dtypes and shapes alone: "cluster" (``csrc/paged_decode.cu``) for
    bf16 queries over a bf16, int8 or fp8 pool at hd 64, 80 or 128 with
    pages of 8 slots or a multiple of 16 (its TMA boxes and 16-slot
    chunks); "split" (``decode_kernel`` of ``csrc/paged_attention.cu``,
    split-K and a merge launch, any page) for f32 queries or an f32 pool,
    hd 32, and every other page size."""
    if (q_dtype == torch.bfloat16 and pool_dtype != torch.float32
            and hd in CLUSTER_HEAD_DIMS
            and (page == 8 or page % DECODE_CHUNK == 0)):
        return "cluster"
    return "split"


def decode_plan(bp: int, heads: int, page: int) -> dict:
    """The cluster face's launch, from the block-table width ``bp``,
    ``heads`` (clusters: B * KVH * head groups of at most CLUSTER_ROWS)
    and the page size alone, never the device lengths (reading them
    would cost a sync per layer and break graph capture): ``cluster`` S,
    the CTAs that share one (lane, kv head); ``stages``, the shared-memory
    ring of 16-slot chunks each CTA keeps in flight (its whole share of a
    full row where that is at most MAX_STAGES chunks, else MAX_STAGES: a
    ring that wraps holds one stage per warp group, so that each stage
    is always folded by the same group, in order); ``chunks``, the
    16-slot chunks of a full row. Chunk c of a lane goes to the CTA of
    rank c % S, as its (c // S)-th chunk; the k-th chunk of a CTA to its
    warp group k % 4 (:func:`decode_shares`). The lengths only decide
    which chunks hold a live slot."""
    chunks = -(-bp * page // DECODE_CHUNK)
    S = max(1, min(MAX_CLUSTER, chunks, CLUSTER_TARGET_CTAS // heads))
    return {"cluster": S, "stages": min(MAX_STAGES, -(-chunks // S)),
            "chunks": chunks}


def decode_shares(plan: dict) -> list:
    """Per CTA rank, per warp group, the chunks it folds in order (all
    chunks of a full row; past a lane's length a chunk is skipped)."""
    S, n = plan["cluster"], plan["chunks"]
    return [[list(range(r, n, S))[w::WARP_GROUPS]
             for w in range(WARP_GROUPS)] for r in range(S)]


def _fold(state, s, valid, v, vs, scale, p_dtype):
    """One warp's online softmax over a chunk: s [..., G, 16] raw scores
    (times k_scale), valid [..., 1, 16], v [..., 16, hd], vs [..., 1, 16]
    or None. The running max and l in f32 from the unrounded p; p times
    the v scale rounded to ``p_dtype`` before P.V."""
    m, l, acc = state
    s = torch.where(valid, s, NEG_INF)
    mx = torch.maximum(m, s.amax(-1))
    base = torch.where(mx == NEG_INF, 0.0, mx)
    alpha = torch.exp((m - base) * scale)
    p = torch.exp((s - base[..., None]) * scale)
    l = l * alpha + p.sum(-1)
    if vs is not None:
        p = p * vs
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    return mx, l, acc * alpha[..., None] + p @ v


def _merge(states, scale):
    """Merge (m, l, acc) states into one by their common max, in order."""
    M = torch.stack([st[0] for st in states]).amax(0)
    out_l = out_acc = 0.0
    for m, l, acc in states:
        e = torch.exp((m - M) * scale)
        out_l = out_l + e * l
        out_acc = out_acc + e[..., None] * acc
    return M, out_l, out_acc


def paged_attention_cluster_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  cache_lens: torch.Tensor, scale: float,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None,
                                  p_dtype: Optional[torch.dtype] =
                                  torch.bfloat16) -> torch.Tensor:
    """The cluster face's algebra (``csrc/paged_decode.cu``): each lane's
    row cut into 16-slot chunks, dealt to the CTAs of a cluster and their
    four warp groups by :func:`decode_plan`; each warp group an online
    softmax over its chunks, in order (scores of the codes times
    ``k_scale``; p times ``v_scale`` and rounded to ``p_dtype`` before
    P.V, l from the unrounded p); the warp groups of a CTA merged as
    (0 with 2) with (1 with 3); the CTAs merged in rank order, divided by
    l (a row no slot reaches emits zeros). Same signature and result as
    :func:`paged_attention_plain` (``p_dtype=None`` keeps p in f32)."""
    B, H, hd = q.shape
    NB, page, KVH, _ = k_pool.shape
    bp = block_tables.shape[1]
    G = H // KVH
    plan = decode_plan(bp, B * KVH * -(-G // CLUSTER_ROWS), page)
    n = plan["chunks"] * DECODE_CHUNK
    k = gather_pages(k_pool, block_tables).float().transpose(1, 2)
    v = gather_pages(v_pool, block_tables).float().transpose(1, 2)
    pad = n - k.shape[2]                      # a partial last chunk
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    s = q.reshape(B, KVH, G, hd).float() @ k.transpose(-1, -2)
    vs = None
    if k_scale is not None:
        ks, vs = (torch.nn.functional.pad(
            gather_pages(t, block_tables).transpose(1, 2), (0, pad))[:, :,
                                                                    None]
            for t in (k_scale, v_scale))     # [B, KVH, 1, n]
        s = s * ks
    valid = (torch.arange(n, device=q.device)
             < cache_lens.clamp(max=bp * page)[:, None])[:, None, None, :]
    empty = (torch.full((B, KVH, G), NEG_INF, device=q.device),
             q.new_zeros(B, KVH, G, dtype=torch.float32),
             q.new_zeros(B, KVH, G, hd, dtype=torch.float32))
    ctas = []
    for groups in decode_shares(plan):
        warps = []
        for chunks in groups:
            state = empty
            for c in chunks:
                cut = slice(c * DECODE_CHUNK, (c + 1) * DECODE_CHUNK)
                state = _fold(state, s[..., cut], valid[..., cut],
                              v[:, :, cut], None if vs is None
                              else vs[..., cut], scale, p_dtype)
            warps.append(state)
        ctas.append(_merge([_merge([warps[0], warps[2]], scale),
                            _merge([warps[1], warps[3]], scale)], scale))
    _, l, acc = _merge(ctas, scale)
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.to(q.dtype).reshape(B, H, hd)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_paged_attention.argtypes = (
            [p] * 13 + [i] * 10 + [ctypes.c_float, i, i, i, i, p])
        lib.repro_paged_attention.restype = i
        _lib = lib
    return _lib


def _cluster_library():
    global _cluster_lib
    if _cluster_lib is None:
        lib = build.load("paged_decode")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_paged_decode.argtypes = (
            [p] * 8 + [i] * 7 + [ctypes.c_float, i, i, i, p])
        lib.repro_paged_decode.restype = i
        _cluster_lib = lib
    return _cluster_lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def _check(q, k_pool, v_pool, block_tables, lens, nvalid, own_k, own_v,
           k_scale, v_scale) -> None:
    """Raise on operands the kernels do not take. q [B, C, H, hd]
    (decode: C = 1); own_k/own_v [B, C, KVH, hd] or None (decode);
    k_scale/v_scale [NB, page, KVH] f32 or None (float pool)."""
    B, C, H, hd = q.shape
    NB, page, KVH, pool_hd = k_pool.shape
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


def _launch(q, k_pool, v_pool, block_tables, lens, nvalid, own_k, own_v,
            k_scale, v_scale, *, scale: float, window: Optional[int],
            rows: int = 0) -> torch.Tensor:
    """Check the operands and launch ``csrc/paged_attention.cu`` on the
    current stream: the split decode face (own_k None) or a prefill
    kernel; ``rows`` > 0 (prefill) takes the wgmma kernel
    (:func:`prefill_rows`). The kernel reads the G query heads of each kv
    head in place."""
    _check(q, k_pool, v_pool, block_tables, lens, nvalid, own_k, own_v,
           k_scale, v_scale)
    B, C, H, hd = q.shape
    NB, page, KVH, _ = k_pool.shape
    bp = block_tables.shape[1]
    has_own = own_k is not None
    if rows:   # TMA tensor maps: every stride above the innermost dim of
        #        q, the pools and the own K/V a multiple of 16 bytes
        _require(has_own and hd * q.element_size() % 16 == 0
                 and hd * k_pool.element_size() % 16 == 0,
                 "the wgmma prefill's tensor maps need 16-byte strides")
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
        -1 if window is None else int(window), splits, rows, NB,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out


def _launch_cluster(q, k_pool, v_pool, block_tables, lens, k_scale,
                    v_scale, *, scale: float) -> torch.Tensor:
    """Check the operands and launch the cluster decode face
    (``csrc/paged_decode.cu``) on the current stream: q [B, H, hd] bf16,
    at the cluster and ring of :func:`decode_plan`."""
    _check(q[:, None], k_pool, v_pool, block_tables, lens, None, None, None,
           k_scale, v_scale)
    B, H, hd = q.shape
    NB, page, KVH, _ = k_pool.shape
    bp = block_tables.shape[1]
    G = H // KVH
    _require(page == 8 or page % DECODE_CHUNK == 0,
             f"the cluster decode takes pages of 8 or a multiple of 16 "
             f"slots, not {page}")
    plan = decode_plan(bp, B * KVH * -(-G // CLUSTER_ROWS), page)
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _cluster_library().repro_paged_decode(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(block_tables), ptr(lens),
        ptr(k_scale), ptr(v_scale), ptr(out), B, KVH, G, bp, page, hd,
        _POOL_KINDS[k_pool.dtype], scale, plan["cluster"], plan["stages"],
        NB, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention cluster decode launch failed: "
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
    [NB, page, KVH] f32 for an int8/fp8 pool. Returns [B, H, hd]. On a
    CUDA tensor it launches the kernel :func:`decode_face` picks."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, block_tables,
                                     cache_lens, scale, k_scale, v_scale)
    if decode_face(q.dtype, k_pool.dtype, q.shape[-1],
                   k_pool.shape[1]) == "split":
        return paged_attention_split(q, k_pool, v_pool, block_tables,
                                     cache_lens, scale=scale,
                                     k_scale=k_scale, v_scale=v_scale)
    out = _launch_cluster(q.contiguous(), k_pool, v_pool, block_tables,
                          cache_lens, k_scale, v_scale, scale=scale)
    LAUNCHES["decode_cluster" if k_scale is None
             else "decode_quant_cluster"] += 1
    return out


def paged_attention_split(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          cache_lens: torch.Tensor, *, scale: float,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The split decode face, ``decode_kernel``, for any operands
    :func:`paged_attention` takes: what it runs for f32 queries or pools
    and at hd 32; called directly, it times the two faces on one input.
    On a CPU tensor, its algebra (:func:`paged_attention_split_plain`)."""
    if q.device.type == "cpu":
        return paged_attention_split_plain(q, k_pool, v_pool, block_tables,
                                           cache_lens, scale, k_scale,
                                           v_scale)
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
    B, C, H, hd = q.shape
    rows = prefill_rows(C, H // k_pool.shape[2], hd, k_pool.shape[1],
                        q.dtype, k_pool.dtype)
    out = _launch(q.contiguous(), k_pool, v_pool, block_tables, prefix_lens,
                  num_valid, own_k.contiguous(), own_v.contiguous(), k_scale,
                  v_scale, scale=scale, window=window, rows=rows)
    face = "prefill" if k_scale is None else "prefill_quant"
    LAUNCHES[face + "_wgmma" if rows else face] += 1
    return out
