"""Forward passes of the dense GQA stack, the ssm (Mamba2) stack and the
hybrid (zamba2: groups of Mamba2 layers, each followed by one shared
attention block), ported from ``repro/models/model.py``.

  forward_full(...)       — full-sequence forward (one-shot prefill and
                            training; ``use_kernel`` runs its attention
                            through the flash-attention kernel);
  lm_loss(...)            — next-token cross-entropy over forward_full;
  decode_step(...)        — one-token decode against the paged KV cache,
                            also returning the last hidden state so the
                            STEP scorer can run fused with generation;
  multi_decode_step(...)  — the fused K-token decode horizon;
  prefill_chunk_step(...) — one prompt chunk against the paged cache.

``lax.scan`` over layers and over the decode horizon becomes a Python
loop. The paged pools (``[L, NB, bs, KVH, hd]``) and, for an int8/fp8
pool, their scales (``k_scale``/``v_scale`` ``[L, NB, bs, KVH]``) are
updated IN PLACE where the JAX package donated them to its jitted steps;
so is an ssm or hybrid stack's per-slot recurrent state (``ssm_state``
``[L, B, H, P, N]`` f32, ``conv_state`` ``[L, B, W-1, di+2N]``). The
returned cache dicts hold the same tensors.

The hybrid's params stack its Mamba2 layers ``[G, per, ...]`` (G =
``num_layers / hybrid_attn_every`` groups of ``per`` layers) beside one
``shared_attn`` decoder layer; its recurrent state stays stacked over
all ``num_layers`` (layer ``g * per + i``) and its pools over the G
shared-attention invocations, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import kv_quant
from repro_torch.models import layers as L


# the block-addressed cache entries: the pools and a quantized pool's scales
POOL_KEYS = ("k_pool", "v_pool", "k_scale", "v_scale")


def check_ported(cfg: ModelConfig) -> None:
    """The stacks the port runs: dense GQA, the ssm (Mamba2) stack and
    the hybrid. MoE, MLA and encoder-decoder archs are ROADMAP A9."""
    if cfg.arch_type not in ("dense", "ssm", "hybrid") or cfg.use_mla \
            or cfg.is_encoder_decoder or cfg.uses_moe:
        raise NotImplementedError(
            f"repro_torch does not run {cfg.arch_type!r} stacks yet "
            f"(MoE, MLA and enc-dec are ROADMAP A9)")


def _check_dense(cfg: ModelConfig) -> None:
    """Chunked prefill is the dense paged-attention stack's."""
    check_ported(cfg)
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"chunked prefill covers the dense GQA stack, not "
            f"{cfg.arch_type!r} (as in the JAX package)")


def _index(tree: dict, i: int) -> dict:
    """Entry ``i`` of the leading axis of every tensor of ``tree``
    (views)."""
    return {k: (_index(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _layer(params: dict, l: int) -> dict:
    """Layer ``l``'s slice of the stacked layer params (views)."""
    return _index(params["layers"], l)


def _groups(cfg: ModelConfig):
    """The hybrid's (G groups, per Mamba2 layers in a group)."""
    per = cfg.hybrid_attn_every
    return cfg.num_layers // per, per


def _embed(params, cfg, tokens):
    return params["embed"][tokens.long()]


def _logits(params, cfg, h):
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


# ---------------------------------------------------------------------------
# full-sequence forward (one-shot prefill)
# ---------------------------------------------------------------------------

def _forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    return_kv: bool, use_kernel: bool):
    """The layer stack of :func:`forward_full`: (final hidden [B, S, D],
    kvs or None)."""
    check_ported(cfg)
    B, S = tokens.shape
    h = _embed(params, cfg, tokens)
    if cfg.arch_type == "ssm":
        h, kvs = _ssm_stack_full(params["layers"], cfg.num_layers, cfg, h,
                                 return_kv, use_kernel)
        return L.rms_norm(h, params["final_norm"], cfg.norm_eps), kvs
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    if cfg.arch_type == "hybrid":
        h, kvs = _hybrid_stack_full(params, cfg, h, positions, return_kv,
                                    use_kernel)
        return L.rms_norm(h, params["final_norm"], cfg.norm_eps), kvs
    ks, vs = [], []
    for l in range(cfg.num_layers):
        h, kv = _attn_block_full(_layer(params, l), cfg, h, positions,
                                 return_kv, use_kernel)
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    hidden = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    return hidden, kvs


def _attn_block_full(lp: dict, cfg: ModelConfig, h: torch.Tensor,
                     positions: torch.Tensor, return_kv: bool,
                     use_kernel: bool):
    """One decoder layer (``ln1`` -> GQA -> residual, ``ln2`` -> SwiGLU ->
    residual) over a full sequence: (h, (k, v) or None)."""
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    kv = None
    if return_kv:
        a, kv = L.gqa_attention_full(
            lp["attn"], cfg, a_in, positions, window=cfg.sliding_window,
            return_kv=True, use_kernel=use_kernel)
    else:
        a = L.gqa_attention_full(lp["attn"], cfg, a_in, positions,
                                 window=cfg.sliding_window,
                                 use_kernel=use_kernel)
    h = h + a
    h = h + L.swiglu(lp["mlp"], L.rms_norm(h, lp["ln2"], cfg.norm_eps))
    return h, kv


def _hybrid_stack_full(params: dict, cfg: ModelConfig, h: torch.Tensor,
                       positions: torch.Tensor, return_kv: bool,
                       use_kernel: bool):
    """The hybrid's G groups over a full sequence, each ``per`` Mamba2
    layers and then the shared attention block: (h, ((ssm_state
    [G, per, B, H, P, N], conv_state [G, per, B, W-1, di+2N]), (k, v)
    each [G, B, S, KVH, hd])) or (h, None)."""
    G, per = _groups(cfg)
    sa = params["shared_attn"]
    states, ks, vs = [], [], []
    for g in range(G):
        h, st = _ssm_stack_full(_index(params["layers"], g), per, cfg, h,
                                return_kv, use_kernel)
        h, kv = _attn_block_full(sa, cfg, h, positions, return_kv,
                                 use_kernel)
        if return_kv:
            states.append(st)
            ks.append(kv[0])
            vs.append(kv[1])
    if not return_kv:
        return h, None
    return h, ((torch.stack([s for s, _ in states]),
                torch.stack([c for _, c in states])),
               (torch.stack(ks), torch.stack(vs)))


def _ssm_stack_full(layers: dict, n: int, cfg: ModelConfig, h: torch.Tensor,
                    return_kv: bool, use_kernel: bool):
    """``n`` Mamba2 layers (``layers``: {norm, mixer} stacked over them)
    over a full sequence: (h, (ssm_state [n, B, H, P, N] f32, conv_state
    [n, B, W-1, di+2N]) or None)."""
    ss, cs = [], []
    for l in range(n):
        lp = _index(layers, l)
        x_in = L.rms_norm(h, lp["norm"], cfg.norm_eps)
        if return_kv:
            out, s_l, c_l = L.mamba2_mixer_full(
                lp["mixer"], cfg, x_in, use_kernel=use_kernel,
                return_state=True)
            ss.append(s_l)
            cs.append(c_l)
        else:
            out = L.mamba2_mixer_full(lp["mixer"], cfg, x_in,
                                      use_kernel=use_kernel)
        h = h + out
    return h, ((torch.stack(ss), torch.stack(cs)) if return_kv else None)


def forward_full(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 return_kv: bool = False, use_kernel: bool = False) -> dict:
    """tokens [B, S]. Returns {logits, hidden, aux_loss[, kvs]}, with
    kvs = (k, v) each [L, B, S, KVH, hd] (rope applied) for the dense
    stack, (ssm_state [L, B, H, P, N] f32, conv_state [L, B, W-1, di+2N])
    for the ssm stack, and ((ssm_state, conv_state) each [G, per, B, ...],
    (k, v) each [G, B, S, KVH, hd]) for the hybrid. ``use_kernel`` runs
    each attention layer through the flash-attention wrapper, and each
    Mamba2 layer's scan through the SSD scan wrapper (forward only:
    neither has a backward)."""
    hidden, kvs = _forward_hidden(params, cfg, tokens, return_kv,
                                  use_kernel)
    out = {"logits": _logits(params, cfg, hidden), "hidden": hidden,
           "aux_loss": torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)}
    if return_kv:
        out["kvs"] = kvs
    return out


# ---------------------------------------------------------------------------
# one-token decode against the paged cache
# ---------------------------------------------------------------------------

def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: dict, window_len: int,
                use_kernel: bool = False) -> dict:
    """tokens [B, 1]; positions [B]; cache {k_pool, v_pool, block_tables,
    and k_scale/v_scale for an int8/fp8 pool} for the dense stack,
    {ssm_state, conv_state, ...} for the ssm stack.

    window_len: cache capacity in tokens (rolling buffer when the
    sequence outgrows it). The pools, or the recurrent state, are written
    in place (the state of every lane, as the JAX package's step does).
    ``use_kernel`` runs the paged attention, or each Mamba2 layer's state
    update, through the kernel wrappers. Nothing here syncs the host or
    sizes a tensor from data, so the step captures in a CUDA graph.
    Returns {logits [B, Vp], hidden [B, D], cache}."""
    check_ported(cfg)
    h = _embed(params, cfg, tokens)  # [B, 1, D]
    if cfg.arch_type == "ssm":
        for l in range(cfg.num_layers):
            h = _mamba_decode(_layer(params, l), cfg, h, cache, l,
                              use_kernel)
    elif cfg.arch_type == "hybrid":
        G, per = _groups(cfg)
        writer = L.last_writer(cache["block_tables"], positions,
                               window_len, cfg.kv_block_size)
        for g in range(G):
            gp = _index(params["layers"], g)
            for i in range(per):
                h = _mamba_decode(_index(gp, i), cfg, h, cache, g * per + i,
                                  use_kernel)
            h = _attn_decode(params["shared_attn"], cfg, h, positions,
                             cache, g, window_len, use_kernel, writer)
    else:
        for l in range(cfg.num_layers):
            h = _attn_decode(_layer(params, l), cfg, h, positions, cache, l,
                             window_len, use_kernel)
    hidden = L.rms_norm(h[:, 0], params["final_norm"], cfg.norm_eps)
    return {"logits": _logits(params, cfg, hidden), "hidden": hidden,
            "cache": dict(cache)}


def _mamba_decode(lp: dict, cfg: ModelConfig, h: torch.Tensor, cache: dict,
                  l: int, use_kernel: bool) -> torch.Tensor:
    """One Mamba2 layer's decode over layer ``l`` of the recurrent state
    (updated in place)."""
    out, ns, nc = L.mamba2_mixer_decode(
        lp["mixer"], cfg, L.rms_norm(h, lp["norm"], cfg.norm_eps),
        cache["ssm_state"][l], cache["conv_state"][l], use_kernel=use_kernel)
    if not use_kernel:  # the kernel wrote the layer's state in place
        cache["ssm_state"][l] = ns
        cache["conv_state"][l] = nc
    return h + out


def _attn_decode(lp: dict, cfg: ModelConfig, h: torch.Tensor,
                 positions: torch.Tensor, cache: dict, idx: int,
                 window_len: int, use_kernel: bool,
                 writer: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder layer's decode against entry ``idx`` of the paged
    pools (written in place; ``writer``: ``layers.last_writer``)."""
    layer_cache = {"block_tables": cache["block_tables"],
                   "window_len": window_len, "use_kernel": use_kernel}
    for key in POOL_KEYS:
        if key in cache:
            layer_cache[key] = cache[key][idx]
    a = L.gqa_attention_decode(
        lp["attn"], cfg, L.rms_norm(h, lp["ln1"], cfg.norm_eps), positions,
        layer_cache, writer=writer)
    h = h + a
    return h + L.swiglu(lp["mlp"], L.rms_norm(h, lp["ln2"], cfg.norm_eps))


# ---------------------------------------------------------------------------
# fused multi-token decode horizon: K decode iterations per host sync
# ---------------------------------------------------------------------------

def multi_decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      positions: torch.Tensor, limits: torch.Tensor,
                      cache: dict, *, window_len: int, horizon: int,
                      rng: Optional[torch.Generator], sample_fn,
                      eos_id: int, step_id: int, score_fn=None,
                      scratch_block: int = 0,
                      use_kernel: bool = False) -> dict:
    """Run ``horizon`` decode iterations; the host consumes the [B, K]
    bursts once per K tokens.

    tokens [B] (the previous sampled token per lane), positions [B] (its
    write position), limits [B] (per-lane iteration cap <= horizon; 0
    marks a dead slot). ``sample_fn(rng, logits [B, Vp]) -> (tokens [B],
    conf [B])`` draws from ``rng`` (a ``torch.Generator``; greedy draws
    nothing). ``score_fn(hidden [B, D]) -> [B]`` is the step scorer,
    evaluated every iteration and validity-masked to step boundaries
    (input token == ``step_id``).

    A lane is active until it emits ``eos_id`` or exhausts its limit.
    Inactive lanes keep decoding (the batch shape is fixed) but their
    block-table row points at ``scratch_block``, so their KV writes land
    in scratch, their positions freeze and their outputs are masked.

    Nothing here syncs the host or sizes a tensor from data: on a CUDA
    engine the whole horizon is captured as one CUDA graph
    (``serving/cuda_graph.py``), the counterpart of the JAX package's
    jitted scan.

    Returns {tokens, confidences, scores, token_valid, score_valid} each
    [B, K], final_tokens [B], positions [B] and cache (the pools, without
    block_tables)."""
    B = tokens.shape[0]
    active = limits > 0
    bt = torch.where(active[:, None], cache["block_tables"], scratch_block)
    pools = {k: v for k, v in cache.items() if k != "block_tables"}
    ct, pos = tokens, positions
    outs = []
    for k in range(horizon):
        out = decode_step(params, cfg, ct[:, None], pos,
                          {**pools, "block_tables": bt},
                          window_len=window_len, use_kernel=use_kernel)
        nt, conf = sample_fn(rng, out["logits"])
        if score_fn is not None:
            scores = score_fn(out["hidden"])
        else:
            scores = torch.zeros((B,), dtype=torch.float32, device=ct.device)
        token_valid = active
        # the hidden state belongs to the input token; boundary => the
        # previous token closed a reasoning step
        score_valid = active & (ct == step_id)
        nt = torch.where(active, nt, ct)  # frozen lanes re-feed their token
        outs.append((nt, conf, scores, token_valid, score_valid))
        active = active & (nt != eos_id) & (k + 1 < limits)
        pos = pos + token_valid.to(pos.dtype)
        bt = torch.where(active[:, None], bt, scratch_block)
        ct = nt
    toks, confs, scores, tok_valid, score_valid = (
        torch.stack(x, dim=1) for x in zip(*outs))
    return {"tokens": toks, "confidences": confs, "scores": scores,
            "token_valid": tok_valid, "score_valid": score_valid,
            "final_tokens": ct, "positions": pos, "cache": pools}


# ---------------------------------------------------------------------------
# chunked prefill against the paged cache (continuous-batching engine)
# ---------------------------------------------------------------------------

def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill covers the paged-attention dense stack."""
    return (cfg.arch_type not in ("ssm", "hybrid")
            and not cfg.use_mla and not cfg.is_encoder_decoder)


def prefill_chunk_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       positions: torch.Tensor, valid: torch.Tensor,
                       cache: dict, window_len: int,
                       use_kernel: bool = False) -> dict:
    """Prefill one prompt chunk into the paged KV cache (in place).

    tokens [B, C] (right-padded to the chunk width); positions [B, C]
    absolute prompt positions; valid [B, C] marks real tokens. Earlier
    chunks' KV must already be in the pool. Returns {logits [B, C, Vp],
    hidden, cache}."""
    _check_dense(cfg)
    quant = "k_scale" in cache  # int8/fp8 pool
    h = _embed(params, cfg, tokens)  # [B, C, D]
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        a = L.gqa_attention_prefill_chunk(
            lp["attn"], cfg, L.rms_norm(h, lp["ln1"], cfg.norm_eps),
            positions, valid, cache["k_pool"][l], cache["v_pool"][l],
            cache["block_tables"], window_len, window=cfg.sliding_window,
            use_kernel=use_kernel,
            k_scale=cache["k_scale"][l] if quant else None,
            v_scale=cache["v_scale"][l] if quant else None)
        h = h + a
        h = h + L.swiglu(lp["mlp"], L.rms_norm(h, lp["ln2"], cfg.norm_eps))
    hidden = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return {"logits": _logits(params, cfg, hidden), "hidden": hidden,
            "cache": dict(cache)}


# ---------------------------------------------------------------------------
# cache construction / prefill population (serving engine path)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int,
                      num_blocks: Optional[int] = None,
                      kv_dtype: str = "bf16",
                      device=None) -> dict:
    """Zeroed paged pools [L, NB, bs, KVH, hd] plus default block tables
    (sequence b owns blocks [b*bp, (b+1)*bp)), on ``device`` (CUDA unless
    the caller names the CPU). ``capacity`` = per-sequence token capacity
    (the window); ``num_blocks`` sizes the shared pool. ``kv_dtype``
    selects the pool storage (f32|bf16|int8|fp8); the quantized dtypes add
    ``k_scale``/``v_scale`` [L, NB, bs, KVH] of unit f32 scales (see
    ``models.kv_quant``). The ssm stack has no pools (no attention
    layer) but the block tables; the hybrid has one pool entry per
    shared-attention invocation. Both have per-slot recurrent state:
    zeroed ``ssm_state`` [L, batch, H, P, N] f32 and ``conv_state``
    [L, batch, W-1, di+2N] bf16, whatever the params' dtype (as in the
    JAX package)."""
    check_ported(cfg)
    device = resolve_device(device)
    bs = cfg.kv_block_size
    bp = -(-capacity // bs)
    nb = num_blocks if num_blocks is not None else batch * bp
    cache = {"block_tables": (torch.arange(batch * bp, dtype=torch.int32,
                                           device=device).reshape(batch, bp)
                              % max(nb, 1))}
    if cfg.attention_layer_ids():
        shape = (len(cfg.attention_layer_ids()), nb, bs, cfg.num_kv_heads,
                 cfg.head_dim)
        dt = kv_quant.kv_pool_dtype(kv_dtype)
        cache["k_pool"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v_pool"] = torch.zeros(shape, dtype=dt, device=device)
        scales = kv_quant.init_scales(cfg, nb, kv_dtype, device=device)
        if scales is not None:
            cache["k_scale"] = scales
            cache["v_scale"] = scales.clone()
    if cfg.arch_type in ("ssm", "hybrid"):
        L_ = cfg.num_layers
        cache["ssm_state"] = torch.zeros(
            (L_, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_size),
            dtype=torch.float32, device=device)
        cache["conv_state"] = torch.zeros(
            (L_, batch, cfg.ssm_conv_width - 1,
             cfg.d_inner + 2 * cfg.ssm_state_size),
            dtype=torch.bfloat16, device=device)
    return cache


def write_prefill_kv(cfg: ModelConfig, cache: dict, kvs,
                     seq_lens: torch.Tensor) -> dict:
    """Scatter prefill K/V (from forward_full(return_kv=True), each
    [L, B, S, KVH, hd]) into the paged pools in place. Assumes
    prompt_len <= capacity (slot = position). A quantized pool (the cache
    holds ``k_scale``/``v_scale``) takes each token's codes and scale,
    quantized against its own per-head absmax: the same bytes the chunked
    and decode writes store for that token. For the ssm stack ``kvs`` is
    the end state (ssm_state, conv_state) of the whole batch, which
    replaces the cache's, dtypes included, as in the JAX package; the
    hybrid's ``kvs`` is (its end state stacked [G, per, ...], its
    attention K/V), which replace the state and scatter into the pools.
    """
    if cfg.arch_type == "ssm":
        cache["ssm_state"], cache["conv_state"] = kvs
        return cache
    if cfg.arch_type == "hybrid":
        (ss, cs), kvs = kvs
        cache["ssm_state"] = ss.reshape(-1, *ss.shape[2:])
        cache["conv_state"] = cs.reshape(-1, *cs.shape[2:])
    return write_pool_kv(cfg, cache, kvs)


def write_pool_kv(cfg: ModelConfig, cache: dict, kvs) -> dict:
    """Scatter attention K/V (k, v) each [La, B, S, KVH, hd] into the
    paged pools of ``cache`` (with its block tables) in place, slot =
    position; the attention half of :func:`write_prefill_kv`."""
    bt = cache["block_tables"].long()
    bs = cfg.kv_block_size
    k, v = kvs
    Bn, S = k.shape[1], k.shape[2]
    pos = torch.arange(S, device=k.device)[None].expand(Bn, S)
    if k.device.type == "cpu":
        L.check_index(pos // bs, bt.shape[1], "prefill block index")
    block_ids = bt.gather(1, pos // bs)   # [B, S]
    offs = pos % bs
    # positions past a row's length are harmless: attention masks by length
    for name, vals in (("k", k), ("v", v)):
        kv_quant.write_slots(cache[f"{name}_pool"], cache.get(f"{name}_scale"),
                             (slice(None), block_ids, offs), vals)
    return cache


def copy_kv_block(cfg: ModelConfig, cache: dict, src: int, dst: int) -> dict:
    """Device-side copy of one paged KV block, in place:
    pool[:, dst] = pool[:, src] (the copy-on-write step of prefix
    sharing). A quantized pool's scales are block-addressed too and ride
    the copy."""
    for key in POOL_KEYS:
        if key in cache:
            cache[key][:, dst] = cache[key][:, src]
    return cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

# Above this token count the [B, S, V] f32 logits dominate training memory
# (qwen3's 152k vocab): the loss then runs a sequence-chunked cross-entropy
# whose per-chunk logits are recomputed in the backward pass.
CHUNKED_CE_THRESHOLD = 1024
CE_CHUNK = 256


def _ce_chunk_sum(h_c: torch.Tensor, w: torch.Tensor, y_c: torch.Tensor,
                  m_c: torch.Tensor) -> torch.Tensor:
    logits = (h_c @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, torch.where(m_c, y_c, 0).long()[..., None])
    return ((lse - gold[..., 0]) * m_c).sum()


def _chunked_ce(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor, chunk: int) -> torch.Tensor:
    """hidden [B, S, D]; w [D, V]; labels/valid [B, S]. Returns the summed
    NLL, one rematerialised chunk of the sequence at a time."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} not a multiple of chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(_ce_chunk_sum, hidden[:, sl], w,
                                   labels[:, sl], valid[:, sl],
                                   use_reentrant=False)
    return total


def lm_loss(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Mean next-token NLL over the labels inside [0, vocab_size) (the
    others are masked). tokens/labels [B, S]. Neither ported stack has an
    auxiliary loss (the JAX package adds its zero ``aux_loss``)."""
    hidden, _ = _forward_hidden(params, cfg, tokens, False, use_kernel)
    valid = (labels >= 0) & (labels < cfg.vocab_size)
    n = valid.sum().clamp(min=1)
    if tokens.shape[1] > CHUNKED_CE_THRESHOLD:
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return _chunked_ce(hidden, w, labels, valid, CE_CHUNK) / n
    logits = _logits(params, cfg, hidden).float()
    logp = F.log_softmax(logits, dim=-1)
    safe = torch.where(valid, labels, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum() / n
