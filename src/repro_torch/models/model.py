"""Forward passes of the dense stack, ported from ``repro/models/model.py``.

  forward_full(...)       — full-sequence forward (one-shot prefill);
  decode_step(...)        — one-token decode against the paged KV cache,
                            also returning the last hidden state so the
                            STEP scorer can run fused with generation;
  multi_decode_step(...)  — the fused K-token decode horizon;
  prefill_chunk_step(...) — one prompt chunk against the paged cache.

``lax.scan`` over layers and over the decode horizon becomes a Python
loop. The paged pools (``[L, NB, bs, KVH, hd]``) are updated IN PLACE
where the JAX package donated them to its jitted steps; the returned
cache dicts hold the same tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kv_quant
from repro_torch.models import layers as L


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense" or cfg.use_mla or cfg.is_encoder_decoder \
            or cfg.uses_moe:
        raise NotImplementedError(
            f"repro_torch runs the dense GQA stack only, not "
            f"{cfg.arch_type!r} (ROADMAP A9)")


def _layer(params: dict, l: int) -> dict:
    """Layer ``l``'s slice of the stacked layer params (views)."""
    return {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                else v[l])
            for k, v in params["layers"].items()}


def _embed(params, cfg, tokens):
    return params["embed"][tokens.long()]


def _logits(params, cfg, h):
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


# ---------------------------------------------------------------------------
# full-sequence forward (one-shot prefill)
# ---------------------------------------------------------------------------

def forward_full(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 return_kv: bool = False) -> dict:
    """tokens [B, S]. Returns {logits, hidden, aux_loss[, kvs]}, with
    kvs = (k, v) each [L, B, S, KVH, hd] (rope applied)."""
    _check_dense(cfg)
    B, S = tokens.shape
    h = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        if return_kv:
            a, (k, v) = L.gqa_attention_full(
                lp["attn"], cfg, a_in, positions,
                window=cfg.sliding_window, return_kv=True)
            ks.append(k)
            vs.append(v)
        else:
            a = L.gqa_attention_full(lp["attn"], cfg, a_in, positions,
                                     window=cfg.sliding_window)
        h = h + a
        h = h + L.swiglu(lp["mlp"], L.rms_norm(h, lp["ln2"], cfg.norm_eps))
    hidden = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    out = {"logits": _logits(params, cfg, hidden), "hidden": hidden,
           "aux_loss": torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)}
    if return_kv:
        out["kvs"] = (torch.stack(ks), torch.stack(vs))
    return out


# ---------------------------------------------------------------------------
# one-token decode against the paged cache
# ---------------------------------------------------------------------------

def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: dict, window_len: int,
                use_kernel: bool = False) -> dict:
    """tokens [B, 1]; positions [B]; cache {k_pool, v_pool, block_tables}.

    window_len: cache capacity in tokens (rolling buffer when the
    sequence outgrows it). The pools are written in place. Returns
    {logits [B, Vp], hidden [B, D], cache}."""
    _check_dense(cfg)
    h = _embed(params, cfg, tokens)  # [B, 1, D]
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        a = L.gqa_attention_decode(
            lp["attn"], cfg, L.rms_norm(h, lp["ln1"], cfg.norm_eps),
            positions,
            {"k_pool": cache["k_pool"][l], "v_pool": cache["v_pool"][l],
             "block_tables": cache["block_tables"],
             "window_len": window_len, "use_kernel": use_kernel})
        h = h + a
        h = h + L.swiglu(lp["mlp"], L.rms_norm(h, lp["ln2"], cfg.norm_eps))
    hidden = L.rms_norm(h[:, 0], params["final_norm"], cfg.norm_eps)
    return {"logits": _logits(params, cfg, hidden), "hidden": hidden,
            "cache": dict(cache)}


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
    h = _embed(params, cfg, tokens)  # [B, C, D]
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        a = L.gqa_attention_prefill_chunk(
            lp["attn"], cfg, L.rms_norm(h, lp["ln1"], cfg.norm_eps),
            positions, valid, cache["k_pool"][l], cache["v_pool"][l],
            cache["block_tables"], window_len, window=cfg.sliding_window,
            use_kernel=use_kernel)
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
                      device="cpu") -> dict:
    """Zeroed paged pools [L, NB, bs, KVH, hd] plus default block tables
    (sequence b owns blocks [b*bp, (b+1)*bp)). ``capacity`` = per-sequence
    token capacity (the window); ``num_blocks`` sizes the shared pool."""
    _check_dense(cfg)
    bs = cfg.kv_block_size
    bp = -(-capacity // bs)
    nb = num_blocks if num_blocks is not None else batch * bp
    shape = (len(cfg.attention_layer_ids()), nb, bs, cfg.num_kv_heads,
             cfg.head_dim)
    dt = kv_quant.kv_pool_dtype(kv_dtype)
    return {
        "k_pool": torch.zeros(shape, dtype=dt, device=device),
        "v_pool": torch.zeros(shape, dtype=dt, device=device),
        "block_tables": (torch.arange(batch * bp, dtype=torch.int32,
                                      device=device).reshape(batch, bp)
                         % max(nb, 1)),
    }


def write_prefill_kv(cfg: ModelConfig, cache: dict, kvs,
                     seq_lens: torch.Tensor) -> dict:
    """Scatter prefill K/V (from forward_full(return_kv=True), each
    [L, B, S, KVH, hd]) into the paged pools in place. Assumes
    prompt_len <= capacity (slot = position)."""
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
    for name, vals in (("k_pool", k), ("v_pool", v)):
        pool = cache[name]
        pool[:, block_ids, offs] = vals.to(pool.dtype)
    return cache


def copy_kv_block(cfg: ModelConfig, cache: dict, src: int, dst: int) -> dict:
    """Device-side copy of one paged KV block, in place:
    pool[:, dst] = pool[:, src] (the copy-on-write step of prefix
    sharing)."""
    for key in ("k_pool", "v_pool"):
        if key in cache:
            cache[key][:, dst] = cache[key][:, src]
    return cache
