"""Forward passes of every stack of the zoo, ported from
``repro/models/model.py``: the dense GQA stack (with the MoE feed-forward
of ``moe`` archs, MLA attention where ``use_mla``, the vision embeddings
of ``vlm`` archs, and the encoder and cross-attention of an
encoder-decoder), the ssm (Mamba2) stack and the hybrid (zamba2: groups
of Mamba2 layers, each followed by one shared attention block).

  forward_full(...)       — full-sequence forward (one-shot prefill and
                            training; ``use_kernel`` runs its attention
                            through the flash-attention kernel);
  encode(...)             — the encoder stack of an encoder-decoder;
  lm_loss(...)            — next-token cross-entropy over forward_full;
  decode_step(...)        — one-token decode against the paged KV cache,
                            also returning the last hidden state so the
                            STEP scorer can run fused with generation;
  multi_decode_step(...)  — the fused K-token decode horizon;
  prefill_chunk_step(...) — one prompt chunk against the paged cache;
  serve_decode_step(...)  — one-token decode against the contiguous
                            per-sequence caches of ``kv_cache_specs``
                            (the launchers' decode step; dense).

``lax.scan`` over layers and over the decode horizon becomes a Python
loop. The paged pools (``[L, NB, bs, KVH, hd]``; MLA's latent pool
``kv_pool [L, NB, bs, kv_lora + rope]``) and, for an int8/fp8 pool, their
scales (``k_scale``/``v_scale`` ``[L, NB, bs, KVH]``) are updated IN
PLACE where the JAX package donated them to its jitted steps; so is an
ssm or hybrid stack's per-slot recurrent state (``ssm_state``
``[L, B, H, P, N]`` f32, ``conv_state`` ``[L, B, W-1, di+2N]``). The
returned cache dicts hold the same tensors. An encoder-decoder's decode
cache also holds the cross-attention K/V of the encoder output
(``cross_k``/``cross_v`` ``[L, B, T, KVH, hd]``, from
:func:`build_cross_cache`), which decode only reads.

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
from repro_torch.kernels import ops as kops
from repro_torch.models import kv_quant
from repro_torch.models import layers as L


# the block-addressed cache entries: the GQA pools, a quantized pool's
# scales and MLA's latent pool
POOL_KEYS = ("k_pool", "v_pool", "k_scale", "v_scale", "kv_pool")
ARCH_TYPES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def check_ported(cfg: ModelConfig) -> None:
    """The stacks of the JAX package's zoo: dense GQA (with MoE layers
    for ``moe``, MLA attention where ``use_mla``, taking vision
    embeddings for ``vlm``), the ssm (Mamba2) stack, the hybrid, and the
    encoder-decoder (``audio``). Another arch type raises."""
    if cfg.arch_type not in ARCH_TYPES:
        raise NotImplementedError(
            f"no stack for arch_type {cfg.arch_type!r}; the zoo has "
            f"{ARCH_TYPES}")


def _check_dense(cfg: ModelConfig) -> None:
    """Chunked prefill is the GQA paged-attention stack's (dense, MoE,
    vlm)."""
    check_ported(cfg)
    if not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"chunked prefill covers the dense GQA stack, not "
            f"{cfg.arch_type!r} with use_mla={cfg.use_mla} "
            f"(as in the JAX package)")


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


def _embed(params, cfg, tokens, tp: Optional[L.TensorParallel] = None):
    """Token embeddings. On a mesh whose embedding is split over "model"
    by vocab rows, each rank looks up the rows it holds; the ranks'
    lookups are gathered and each token takes its owner's row, which is
    exact (a gather, not a sum)."""
    emb = params["embed"]
    t = tokens.long()
    if tp is None or emb.shape[0] == tp.vocab_rows:
        return emb[t]
    rows = emb.shape[0]
    owner = t // rows
    local = emb[(t - tp.model_rank * rows).clamp(0, rows - 1)]
    every = tp.gather_model(local[None], dim=0)         # [model_n, ..., D]
    return torch.take_along_dim(every, owner[None, ..., None], dim=0)[0]


def _logits(params, cfg, h, tp: Optional[L.TensorParallel] = None):
    """Logits over the padded vocab; on a mesh the rank's vocab columns
    are gathered over "model"."""
    out = h @ (params["embed"].T if cfg.tie_embeddings
               else params["lm_head"])
    return out if tp is None else tp.full_cols(out, tp.vocab_rows)


def _ffn(lp: dict, cfg: ModelConfig, x: torch.Tensor,
         tp: Optional[L.TensorParallel] = None,
         kv_specs: Optional[dict] = None, ex_in: bool = False,
         use_kernel: bool = False):
    """A decoder layer's feed-forward: (the MoE's output and aux loss), or
    (the SwiGLU's output, None). An MoE takes ``kv_specs["moe_experts"]``
    for its expert weights and, with ``ex_in`` (decode),
    ``kv_specs["moe_ex_in"]`` for its dispatched inputs. ``use_kernel``:
    the gate through ``layers.silu_gate``'s kernel where it fits."""
    if cfg.uses_moe:
        specs = kv_specs or {}
        return L.moe_layer(lp["moe"], cfg, x,
                           expert_weight_spec=specs.get("moe_experts"),
                           ex_in_spec=specs.get("moe_ex_in") if ex_in
                           else None, use_kernel=use_kernel)
    return L.swiglu(lp["mlp"], x, tp, use_kernel), None


def _kv_hook(kv_specs: Optional[dict], key: str, x):
    """``kv_specs[key]`` (placements) on a layer's emitted K/V or state:
    the JAX package's ``_wsc_kv``; see ``layers.constrain``."""
    if kv_specs is None or x is None:
        return x
    return L.constrain(x, kv_specs.get(key))


def _body(remat: bool, fn, *args):
    """``fn(*args)``; under ``remat`` through a non-reentrant checkpoint,
    which keeps only the body's inputs and recomputes its intermediates in
    the backward pass."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# full-sequence forward (one-shot prefill)
# ---------------------------------------------------------------------------

def _forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    return_kv: bool, use_kernel: bool,
                    modality_embeds: Optional[torch.Tensor] = None,
                    encoder_embeds: Optional[torch.Tensor] = None,
                    remat: bool = False,
                    tp: Optional[L.TensorParallel] = None,
                    act_spec=None, kv_specs: Optional[dict] = None):
    """The layer stack of :func:`forward_full`: (final hidden [B, S, D],
    kvs or None, the summed aux loss of the MoE layers: f32, 0 without
    them)."""
    check_ported(cfg)
    enc_out = None
    if cfg.is_encoder_decoder:
        if encoder_embeds is None:
            raise ValueError("an encoder-decoder's forward needs "
                             "encoder_embeds [B, T, D]")
        enc_out = encode(params, cfg, encoder_embeds, remat=remat,
                         act_spec=act_spec)
    B, S = tokens.shape
    h = L.constrain(_embed(params, cfg, tokens, tp), act_spec)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.modality == "vision" and modality_embeds is not None:
        # the stub frontend's embeddings replace the first n positions'
        n = modality_embeds.shape[1]
        h = torch.cat([modality_embeds.to(h.dtype), h[:, n:]], dim=1)
    if cfg.arch_type == "ssm":
        h, kvs = _ssm_stack_full(params["layers"], cfg.num_layers, cfg, h,
                                 return_kv, use_kernel, remat, act_spec,
                                 kv_specs)
        return L.rms_norm(h, params["final_norm"], cfg.norm_eps), kvs, aux
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    if cfg.arch_type == "hybrid":
        h, kvs = _hybrid_stack_full(params, cfg, h, positions, return_kv,
                                    use_kernel, remat, act_spec, kv_specs)
        return L.rms_norm(h, params["final_norm"], cfg.norm_eps), kvs, aux
    kvs = []
    for l in range(cfg.num_layers):
        h, kv, aux_l = _body(remat, _attn_block_full, _layer(params, l), cfg,
                             h, positions, return_kv, use_kernel, enc_out, tp,
                             act_spec, kv_specs)
        if aux_l is not None:
            aux = aux + aux_l
        kvs.append(kv)
    hidden = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if not return_kv:
        return hidden, None, aux
    if cfg.use_mla:
        return hidden, torch.stack(kvs), aux
    return hidden, (torch.stack([k for k, _ in kvs]),
                    torch.stack([v for _, v in kvs])), aux


def _attn_block_full(lp: dict, cfg: ModelConfig, h: torch.Tensor,
                     positions: torch.Tensor, return_kv: bool,
                     use_kernel: bool,
                     enc_out: Optional[torch.Tensor] = None,
                     tp: Optional[L.TensorParallel] = None,
                     act_spec=None, kv_specs: Optional[dict] = None):
    """One decoder layer (``ln1`` -> GQA or MLA -> residual, with
    ``enc_out`` ``ln_cross`` -> cross-attention -> residual, ``ln2`` ->
    SwiGLU or MoE -> residual) over a full sequence: (h, (k, v), MLA's
    latent entries [B, S, kv_lora + rope] or None, the MoE's aux loss or
    None). MLA has no kernel path: ``use_kernel`` leaves it dense, as in
    the JAX package. The sharding hooks (:func:`forward_full`) lay out
    the emitted K/V and the layer's output."""
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        res = L.mla_attention_full(lp["attn"], cfg, a_in, positions,
                                   return_kv=return_kv)
    else:
        res = L.gqa_attention_full(lp["attn"], cfg, a_in, positions,
                                   window=cfg.sliding_window,
                                   return_kv=return_kv,
                                   use_kernel=use_kernel, tp=tp)
    a, kv = res if return_kv else (res, None)
    if cfg.use_mla:
        kv = _kv_hook(kv_specs, "mla", kv)
    elif kv is not None:
        kv = (_kv_hook(kv_specs, "kv", kv[0]), _kv_hook(kv_specs, "kv", kv[1]))
    h = h + a
    if enc_out is not None:
        h = h + L.cross_attention(
            lp["cross"], cfg, L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
            *L.cross_kv(lp["cross"], cfg, enc_out))
    m, aux = _ffn(lp, cfg, L.rms_norm(h, lp["ln2"], cfg.norm_eps), tp,
                  kv_specs, use_kernel=use_kernel)
    return L.constrain(h + m, act_spec), kv, aux


def encode(params: dict, cfg: ModelConfig, encoder_embeds: torch.Tensor,
           remat: bool = False, act_spec=None) -> torch.Tensor:
    """The encoder of an encoder-decoder over the stub frontend's
    embeddings [B, T, D]: ``num_encoder_layers`` blocks of GQA attention
    and SwiGLU, then ``encoder_norm``. Its attention is CAUSAL (rope at
    positions 0..T-1), because the JAX package's encoder calls
    ``gqa_attention_full(window=None)``, whose mask is causal (ROADMAP
    C); it stays dense under ``use_kernel``, as there. ``remat``
    checkpoints each block; ``act_spec`` lays out the residual stream
    (:func:`forward_full`). Returns [B, T, D]."""
    check_ported(cfg)
    h = L.constrain(encoder_embeds, act_spec)
    B, T, _ = h.shape
    positions = torch.arange(T, device=h.device)[None].expand(B, T)
    enc = params["encoder"]
    for l in range(cfg.num_encoder_layers):
        h = _body(remat, _encoder_block, _index(enc, l), cfg, h, positions,
                  act_spec)
    return L.rms_norm(h, params["encoder_norm"], cfg.norm_eps)


def _encoder_block(lp: dict, cfg: ModelConfig, h: torch.Tensor,
                   positions: torch.Tensor, act_spec=None) -> torch.Tensor:
    h = h + L.gqa_attention_full(
        lp["attn"], cfg, L.rms_norm(h, lp["ln1"], cfg.norm_eps), positions,
        window=None)
    return L.constrain(
        h + L.swiglu(lp["mlp"], L.rms_norm(h, lp["ln2"], cfg.norm_eps)),
        act_spec)


def _hybrid_group_full(gp: dict, sa: dict, cfg: ModelConfig,
                       h: torch.Tensor, positions: torch.Tensor,
                       return_kv: bool, use_kernel: bool, act_spec=None,
                       kv_specs: Optional[dict] = None):
    """One hybrid group: its ``per`` Mamba2 layers, then the shared
    attention block: (h, the group's end state or None, (k, v) or
    None). ``act_spec`` lays out the group's output, as the JAX
    package's hybrid does (not its Mamba2 layers')."""
    h, st = _ssm_stack_full(gp, cfg.hybrid_attn_every, cfg, h, return_kv,
                            use_kernel, kv_specs=kv_specs)
    h, kv, _ = _attn_block_full(sa, cfg, h, positions, return_kv,
                                use_kernel, act_spec=act_spec,
                                kv_specs=kv_specs)
    return h, st, kv


def _hybrid_stack_full(params: dict, cfg: ModelConfig, h: torch.Tensor,
                       positions: torch.Tensor, return_kv: bool,
                       use_kernel: bool, remat: bool = False,
                       act_spec=None, kv_specs: Optional[dict] = None):
    """The hybrid's G groups over a full sequence, each ``per`` Mamba2
    layers and then the shared attention block (``remat`` checkpoints
    each group): (h, ((ssm_state [G, per, B, H, P, N], conv_state
    [G, per, B, W-1, di+2N]), (k, v) each [G, B, S, KVH, hd])) or
    (h, None)."""
    G, _ = _groups(cfg)
    sa = params["shared_attn"]
    states, ks, vs = [], [], []
    for g in range(G):
        h, st, kv = _body(remat, _hybrid_group_full,
                          _index(params["layers"], g), sa, cfg, h, positions,
                          return_kv, use_kernel, act_spec, kv_specs)
        if return_kv:
            states.append(st)
            ks.append(kv[0])
            vs.append(kv[1])
    if not return_kv:
        return h, None
    return h, ((torch.stack([s for s, _ in states]),
                torch.stack([c for _, c in states])),
               (torch.stack(ks), torch.stack(vs)))


def _ssm_layer_full(lp: dict, cfg: ModelConfig, h: torch.Tensor,
                    return_kv: bool, use_kernel: bool, act_spec=None,
                    kv_specs: Optional[dict] = None):
    """One Mamba2 layer over a full sequence: (h, (ssm_state, conv_state)
    or None)."""
    x_in = L.rms_norm(h, lp["norm"], cfg.norm_eps)
    if return_kv:
        out, s_l, c_l = L.mamba2_mixer_full(lp["mixer"], cfg, x_in,
                                            use_kernel=use_kernel,
                                            return_state=True)
        return (L.constrain(h + out, act_spec),
                (_kv_hook(kv_specs, "ssm", s_l),
                 _kv_hook(kv_specs, "conv", c_l)))
    return L.constrain(h + L.mamba2_mixer_full(lp["mixer"], cfg, x_in,
                                               use_kernel=use_kernel),
                       act_spec), None


def _ssm_stack_full(layers: dict, n: int, cfg: ModelConfig, h: torch.Tensor,
                    return_kv: bool, use_kernel: bool, remat: bool = False,
                    act_spec=None, kv_specs: Optional[dict] = None):
    """``n`` Mamba2 layers (``layers``: {norm, mixer} stacked over them)
    over a full sequence, ``remat`` checkpointing each: (h, (ssm_state
    [n, B, H, P, N] f32, conv_state [n, B, W-1, di+2N]) or None)."""
    states = []
    for l in range(n):
        h, st = _body(remat, _ssm_layer_full, _index(layers, l), cfg, h,
                      return_kv, use_kernel, act_spec, kv_specs)
        states.append(st)
    if not return_kv:
        return h, None
    return h, (torch.stack([s for s, _ in states]),
               torch.stack([c for _, c in states]))


def forward_full(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 return_kv: bool = False, use_kernel: bool = False,
                 modality_embeds: Optional[torch.Tensor] = None,
                 encoder_embeds: Optional[torch.Tensor] = None,
                 remat: bool = False,
                 tp: Optional[L.TensorParallel] = None,
                 act_spec=None, kv_specs: Optional[dict] = None) -> dict:
    """tokens [B, S]. Returns {logits, hidden, aux_loss[, kvs]}, with
    kvs = (k, v) each [L, B, S, KVH, hd] (rope applied) for the dense
    stack, MLA's latent entries [L, B, S, kv_lora + rope], (ssm_state
    [L, B, H, P, N] f32, conv_state [L, B, W-1, di+2N]) for the ssm
    stack, and ((ssm_state, conv_state) each [G, per, B, ...], (k, v)
    each [G, B, S, KVH, hd]) for the hybrid. ``use_kernel`` runs each GQA
    self-attention layer through the flash-attention wrapper, and each
    Mamba2 layer's scan through the SSD scan wrapper (forward only:
    neither has a backward); MLA and an encoder stay dense. Attention is
    causal within ``cfg.sliding_window``. ``modality_embeds`` [B, n, D]
    (a ``vision`` arch's stub frontend) replace the first n token
    embeddings; an encoder-decoder needs ``encoder_embeds`` [B, T, D],
    whose :func:`encode` output every decoder layer's cross-attention
    reads. ``aux_loss`` is the sum of the MoE layers' load-balancing
    losses (f32 0 without MoE). ``remat`` checkpoints each layer (each
    group of the hybrid, each encoder block): the backward pass recomputes
    a layer's intermediates from its input instead of keeping them, as
    the JAX package's ``jax.checkpoint`` does. ``tp`` (serving mesh, the
    dense GQA stack): every "data" rank runs the batch whole, over its
    own heads, and the kvs hold the kv heads its pools hold; the logits
    are gathered over "model".

    The sharding hooks (the production dry run, over DTensors; see
    ``layers.constrain``): ``act_spec`` (placements of the residual
    stream [B, S, D]) lays out the embeddings and each layer's output,
    ``kv_specs`` ({"kv", "mla", "ssm", "conv"} -> placements of one
    layer's emitted K/V or state, and "moe_experts" for the expert
    weights) the kvs, as the JAX package's ``with_sharding_constraint``s
    do. On plain tensors they change nothing."""
    hidden, kvs, aux = _forward_hidden(params, cfg, tokens, return_kv,
                                       use_kernel, modality_embeds,
                                       encoder_embeds, remat, tp, act_spec,
                                       kv_specs)
    out = {"logits": _logits(params, cfg, hidden, tp), "hidden": hidden,
           "aux_loss": aux}
    if return_kv:
        out["kvs"] = kvs
    return out


# ---------------------------------------------------------------------------
# one-token decode against the paged cache
# ---------------------------------------------------------------------------

def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                positions: torch.Tensor, cache: dict, window_len: int,
                use_kernel: bool = False,
                tp: Optional[L.TensorParallel] = None) -> dict:
    """tokens [B, 1]; positions [B]; cache {k_pool, v_pool, block_tables,
    and k_scale/v_scale for an int8/fp8 pool} for the dense stack
    ({kv_pool, block_tables} with MLA; an encoder-decoder's also holds
    cross_k/cross_v), {ssm_state, conv_state, ...} for the ssm stack.

    window_len: cache capacity in tokens (rolling buffer when the
    sequence outgrows it). The pools, or the recurrent state, are written
    in place (the state of every lane, as the JAX package's step does).
    ``use_kernel`` runs the paged attention, or each Mamba2 layer's state
    update, through the kernel wrappers (MLA has no kernel path: it
    stays dense, as in the JAX package). Nothing here syncs the host or
    sizes a tensor from data, so the step captures in a CUDA graph.
    ``tp`` (serving mesh, the dense GQA stack): tokens, positions and the
    block tables cover the whole batch; the rank runs its lanes (its
    heads of them), writes every lane's K/V into its pools, and gathers
    the logits over "model" and "data", while the hidden state stays
    the rank's lanes'.
    Returns {logits [B, Vp], hidden [B, D], cache}."""
    check_ported(cfg)
    if tp is not None:
        tokens = tokens[tp.lanes(tokens.shape[0])]
    h = _embed(params, cfg, tokens, tp)  # [B, 1, D]
    hidden = None   # the final norm's output, where a stack makes it
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
        # frozen lanes read the scratch block back, and an MoE routes them
        # beside the live lanes, whose expert capacity they share: their
        # shared scratch slots take the last lane's K/V, as for the hybrid.
        # A dense stack's frozen lanes reach no live lane (their outputs
        # are dropped), so it keeps the CUDA scatter's choice of writer
        # and spares two gathers per layer
        writer = (L.last_writer(cache["block_tables"], positions, window_len,
                                cfg.kv_block_size)
                  if cfg.uses_moe else None)
        if L.glue_route(cfg, h, cache, use_kernel, tp) == "fused":
            hidden = _decode_fused(params, cfg, h[:, 0], positions, cache,
                                   window_len, use_kernel, writer)
        else:
            for l in range(cfg.num_layers):
                h = _attn_decode(_layer(params, l), cfg, h, positions, cache,
                                 l, window_len, use_kernel, writer, tp)
    if hidden is None:
        hidden = L.rms_norm(h[:, 0], params["final_norm"], cfg.norm_eps)
    logits = _logits(params, cfg, hidden, tp)
    if tp is not None:
        logits = tp.gather_data(logits)
    return {"logits": logits, "hidden": hidden, "cache": dict(cache)}


def _decode_fused(params: dict, cfg: ModelConfig, h: torch.Tensor,
                  positions: torch.Tensor, cache: dict, window_len: int,
                  use_kernel: bool,
                  writer: Optional[torch.Tensor]) -> torch.Tensor:
    """The dense / MoE stack's layers on the fused glue
    (``layers.glue_route``): each residual add runs with the norm after it
    (``add_rms_norm``: ln1, ln2, then the next layer's ln1 or the final
    norm), the attention through ``layers.gqa_attention_decode_fused``.
    h [B, D] is the embedding; returns the final norm's output [B, D]."""
    lens = torch.empty((h.shape[0],), dtype=torch.int32, device=h.device)
    delta = None
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        layer_cache = {"block_tables": cache["block_tables"],
                       "window_len": window_len, "use_kernel": use_kernel,
                       "k_pool": cache["k_pool"][l],
                       "v_pool": cache["v_pool"][l]}
        h, x = kops.add_rms_norm(h, delta, lp["ln1"], cfg.norm_eps)
        a = L.gqa_attention_decode_fused(lp["attn"], cfg, x, positions,
                                         layer_cache, writer, lens, l == 0)
        h, x = kops.add_rms_norm(h, a, lp["ln2"], cfg.norm_eps)
        delta = _ffn(lp, cfg, x[:, None], use_kernel=use_kernel)[0][:, 0]
    return kops.add_rms_norm(h, delta, params["final_norm"], cfg.norm_eps)[1]


def _mamba_decode(lp: dict, cfg: ModelConfig, h: torch.Tensor, cache: dict,
                  l: int, use_kernel: bool,
                  kv_specs: Optional[dict] = None) -> torch.Tensor:
    """One Mamba2 layer's decode over layer ``l`` of the recurrent state
    (updated in place; ``kv_specs`` lays out the new state first)."""
    out, ns, nc = L.mamba2_mixer_decode(
        lp["mixer"], cfg, L.rms_norm(h, lp["norm"], cfg.norm_eps),
        cache["ssm_state"][l], cache["conv_state"][l], use_kernel=use_kernel)
    if not use_kernel:  # the kernel wrote the layer's state in place
        cache["ssm_state"][l] = _kv_hook(kv_specs, "ssm", ns)
        cache["conv_state"][l] = _kv_hook(kv_specs, "conv", nc)
    return h + out


def _attn_decode(lp: dict, cfg: ModelConfig, h: torch.Tensor,
                 positions: torch.Tensor, cache: dict, idx: int,
                 window_len: int, use_kernel: bool,
                 writer: Optional[torch.Tensor] = None,
                 tp: Optional[L.TensorParallel] = None) -> torch.Tensor:
    """One decoder layer's decode against entry ``idx`` of the paged
    pools (written in place; ``writer``: ``layers.last_writer``) and, for
    an encoder-decoder, of the cross caches."""
    layer_cache = {"block_tables": cache["block_tables"],
                   "window_len": window_len, "use_kernel": use_kernel,
                   "tp": tp}
    for key in POOL_KEYS:
        if key in cache:
            layer_cache[key] = cache[key][idx]
    attend = L.mla_attention_decode if cfg.use_mla else L.gqa_attention_decode
    h = h + attend(lp["attn"], cfg, L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                   positions, layer_cache, writer=writer)
    if cfg.is_encoder_decoder:
        h = h + L.cross_attention(
            lp["cross"], cfg, L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
            cache["cross_k"][idx], cache["cross_v"][idx])
    return h + _ffn(lp, cfg, L.rms_norm(h, lp["ln2"], cfg.norm_eps), tp,
                    use_kernel=use_kernel)[0]


# ---------------------------------------------------------------------------
# fused multi-token decode horizon: K decode iterations per host sync
# ---------------------------------------------------------------------------

def multi_decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      positions: torch.Tensor, limits: torch.Tensor,
                      cache: dict, *, window_len: int, horizon: int,
                      rng: Optional[torch.Generator], sample_fn,
                      eos_id: int, step_id: int, score_fn=None,
                      scratch_block: int = 0,
                      use_kernel: bool = False,
                      tp: Optional[L.TensorParallel] = None) -> dict:
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
    jitted scan. ``tp`` (serving mesh): each iteration's
    :func:`decode_step` runs on the rank's lanes and returns the whole
    batch's logits, which every rank samples from alike, so the lanes'
    state here is the whole batch's on every rank; ``score_fn`` gets the
    rank's lanes' hidden states and returns the whole batch's scores.

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
                          window_len=window_len, use_kernel=use_kernel,
                          tp=tp)
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
    """Chunked prefill covers the paged-attention dense stack (MoE and
    vlm included)."""
    return (cfg.arch_type not in ("ssm", "hybrid")
            and not cfg.use_mla and not cfg.is_encoder_decoder)


def prefill_chunk_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       positions: torch.Tensor, valid: torch.Tensor,
                       cache: dict, window_len: int,
                       use_kernel: bool = False,
                       tp: Optional[L.TensorParallel] = None) -> dict:
    """Prefill one prompt chunk into the paged KV cache (in place).

    tokens [B, C] (right-padded to the chunk width); positions [B, C]
    absolute prompt positions; valid [B, C] marks real tokens. Earlier
    chunks' KV must already be in the pool. The chunk attends within
    ``cfg.sliding_window``; an MoE layer routes all B*C slots, the
    padded ones too (they take expert capacity, as in the JAX package).
    ``tp`` (serving mesh): every "data" rank runs the chunk whole, over
    its own heads and pools; the logits are gathered over "model".
    Returns {logits [B, C, Vp], hidden, cache}."""
    _check_dense(cfg)
    quant = "k_scale" in cache  # int8/fp8 pool
    h = _embed(params, cfg, tokens, tp)  # [B, C, D]
    for l in range(cfg.num_layers):
        lp = _layer(params, l)
        a = L.gqa_attention_prefill_chunk(
            lp["attn"], cfg, L.rms_norm(h, lp["ln1"], cfg.norm_eps),
            positions, valid, cache["k_pool"][l], cache["v_pool"][l],
            cache["block_tables"], window_len, window=cfg.sliding_window,
            use_kernel=use_kernel,
            k_scale=cache["k_scale"][l] if quant else None,
            v_scale=cache["v_scale"][l] if quant else None, tp=tp)
        h = h + a
        h = h + _ffn(lp, cfg, L.rms_norm(h, lp["ln2"], cfg.norm_eps), tp,
                     use_kernel=use_kernel)[0]
    hidden = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return {"logits": _logits(params, cfg, hidden, tp), "hidden": hidden,
            "cache": dict(cache)}


# ---------------------------------------------------------------------------
# the launchers' decode step: contiguous per-sequence caches
# ---------------------------------------------------------------------------

def serve_decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      positions: torch.Tensor, cache: dict,
                      kv_specs: Optional[dict] = None) -> dict:
    """tokens [B, 1]; positions [B]; cache as ``configs.base``'s
    ``kv_cache_specs`` lays it out: ring buffers ``k_cache``/``v_cache``
    [La, B, cap, KVH, hd] (MLA: ``kv_cache`` [La, B, cap, kv_lora +
    rope]), an ssm or hybrid stack's ``ssm_state`` [L, B, H, P, N] and
    ``conv_state`` [L, B, W-1, di+2N], an encoder-decoder's ``cross_k`` /
    ``cross_v`` [La, B, T, KVH, hd]. Every entry is written in place (the
    hybrid's state through its [G, per, ...] view, its caches one per
    group); the cross caches are only read. Dense throughout, as in the
    JAX package. ``kv_specs`` (the production dry run, over DTensors; see
    :func:`forward_full`) lays out each layer's new cache entry or
    state ("kv", "mla", "ssm", "conv") and an MoE's expert weights and
    dispatched inputs ("moe_experts", "moe_ex_in"). Returns
    {logits [B, Vp], hidden [B, D], cache}."""
    check_ported(cfg)
    h = _embed(params, cfg, tokens)  # [B, 1, D]
    if cfg.arch_type == "ssm":
        for l in range(cfg.num_layers):
            h = _mamba_decode(_layer(params, l), cfg, h, cache, l, False,
                              kv_specs)
    elif cfg.arch_type == "hybrid":
        G, per = _groups(cfg)
        for g in range(G):
            gp = _index(params["layers"], g)
            for i in range(per):
                h = _mamba_decode(_index(gp, i), cfg, h, cache, g * per + i,
                                  False, kv_specs)
            h = _attn_decode_contiguous(params["shared_attn"], cfg, h,
                                        positions, cache, g, kv_specs)
    else:
        for l in range(cfg.num_layers):
            h = _attn_decode_contiguous(_layer(params, l), cfg, h, positions,
                                        cache, l, kv_specs)
    hidden = L.rms_norm(h[:, 0], params["final_norm"], cfg.norm_eps)
    return {"logits": _logits(params, cfg, hidden), "hidden": hidden,
            "cache": dict(cache)}


def _attn_decode_contiguous(lp: dict, cfg: ModelConfig, h: torch.Tensor,
                            positions: torch.Tensor, cache: dict,
                            idx: int,
                            kv_specs: Optional[dict] = None) -> torch.Tensor:
    """One decoder layer's decode against entry ``idx`` of the contiguous
    caches (and, for an encoder-decoder, of the cross caches). The layer
    reads and writes its entry laid out by ``kv_specs``; an entry laid
    out otherwise than the cache's is written back into the cache."""
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    keys = ("kv_cache",) if cfg.use_mla else ("k_cache", "v_cache")
    entries = [cache[k][idx] for k in keys]
    layer = [_kv_hook(kv_specs, "mla" if cfg.use_mla else "kv", e)
             for e in entries]
    if cfg.use_mla:
        a = L.mla_attention_decode_contiguous(lp["attn"], cfg, a_in,
                                              positions, *layer)
    else:
        a = L.gqa_attention_decode_contiguous(lp["attn"], cfg, a_in,
                                              positions, *layer)
    for e, new in zip(entries, layer):
        if new is not e:
            e.copy_(new)
    h = h + a
    if cfg.is_encoder_decoder:
        h = h + L.cross_attention(
            lp["cross"], cfg, L.rms_norm(h, lp["ln_cross"], cfg.norm_eps),
            cache["cross_k"][idx], cache["cross_v"][idx])
    return h + _ffn(lp, cfg, L.rms_norm(h, lp["ln2"], cfg.norm_eps),
                    kv_specs=kv_specs, ex_in=True)[0]


def write_contiguous_kv(cfg: ModelConfig, cache: dict, kvs) -> dict:
    """Seed a contiguous decode cache (:func:`serve_decode_step`'s) in
    place from a prefill's ``kvs`` (``forward_full(return_kv=True)``):
    each sequence's K/V (MLA: latent entries) at slot = position, for a
    prompt no longer than the capacity; an ssm stack's end state, or the
    hybrid's ([G, per, ...] state, K/V per group), replaces the cache's
    state. The cross caches of an encoder-decoder are the caller's
    (:func:`build_cross_cache`)."""
    if cfg.arch_type == "ssm":
        kvs = (kvs, None)
    if cfg.arch_type in ("ssm", "hybrid"):
        (ss, cs), kvs = kvs
        cache["ssm_state"].copy_(ss.reshape(cache["ssm_state"].shape))
        cache["conv_state"].copy_(cs.reshape(cache["conv_state"].shape))
        if kvs is None:
            return cache
    pairs = ((("kv_cache", kvs),) if cfg.use_mla
             else (("k_cache", kvs[0]), ("v_cache", kvs[1])))
    for key, vals in pairs:
        S, cap = vals.shape[2], cache[key].shape[2]
        if S > cap:
            raise ValueError(f"a {S}-token prefill does not fit a "
                             f"{cap}-slot cache")
        cache[key][:, :, :S] = vals
    return cache


# ---------------------------------------------------------------------------
# cache construction / prefill population (serving engine path)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, capacity: int,
                      num_blocks: Optional[int] = None,
                      kv_dtype: str = "bf16",
                      device=None, encoder_len: Optional[int] = None,
                      kv_heads: Optional[int] = None) -> dict:
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
    JAX package). MLA keeps one latent pool ``kv_pool`` [L, NB, bs,
    kv_lora + rope] (f32 or bf16; a quantized ``kv_dtype`` leaves it
    bf16, as in the JAX package, whose engine refuses one first). An
    encoder-decoder adds zeroed bf16 ``cross_k``/``cross_v`` [L, batch,
    T, KVH, hd] for T = ``encoder_len`` (default: the config's
    ``encoder_seq_len``, else 1024), which the caller replaces with
    :func:`build_cross_cache`'s. ``kv_heads`` sizes the GQA pools and
    their scales with fewer kv heads than the config's: a rank of a
    serving mesh holds only its own."""
    check_ported(cfg)
    device = resolve_device(device)
    kvh = cfg.num_kv_heads if kv_heads is None else kv_heads
    bs = cfg.kv_block_size
    bp = -(-capacity // bs)
    nb = num_blocks if num_blocks is not None else batch * bp
    cache = {"block_tables": (torch.arange(batch * bp, dtype=torch.int32,
                                           device=device).reshape(batch, bp)
                              % max(nb, 1))}
    la = len(cfg.attention_layer_ids())
    if cfg.use_mla:
        cache["kv_pool"] = torch.zeros(
            (la, nb, bs, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            dtype=(kv_quant.kv_pool_dtype(kv_dtype)
                   if kv_dtype in ("f32", "bf16") else torch.bfloat16),
            device=device)
    elif la:
        shape = (la, nb, bs, kvh, cfg.head_dim)
        dt = kv_quant.kv_pool_dtype(kv_dtype)
        cache["k_pool"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v_pool"] = torch.zeros(shape, dtype=dt, device=device)
        scales = kv_quant.init_scales(cfg, nb, kv_dtype, device=device,
                                      kv_heads=kvh)
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
    if cfg.is_encoder_decoder:
        T = encoder_len or cfg.encoder_seq_len or 1024
        for key in ("cross_k", "cross_v"):
            cache[key] = torch.zeros((la, batch, T, cfg.num_kv_heads,
                                      cfg.head_dim),
                                     dtype=torch.bfloat16, device=device)
    return cache


def build_cross_cache(params: dict, cfg: ModelConfig,
                      enc_out: torch.Tensor):
    """Every decoder layer's cross-attention K/V of the encoder output
    [B, T, D]: (cross_k, cross_v) each [L, B, T, KVH, hd], in the
    params' dtype."""
    ks, vs = zip(*(L.cross_kv(_layer(params, l)["cross"], cfg, enc_out)
                   for l in range(cfg.num_layers)))
    return torch.stack(ks), torch.stack(vs)


def write_prefill_kv(cfg: ModelConfig, cache: dict, kvs,
                     seq_lens: torch.Tensor) -> dict:
    """Scatter prefill K/V (from forward_full(return_kv=True), each
    [L, B, S, KVH, hd], or MLA's latent entries [L, B, S, kv_lora +
    rope]) into the paged pools in place. Assumes
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
    """Scatter attention K/V (k, v) each [La, B, S, KVH, hd], or MLA's
    latent entries [La, B, S, kv_lora + rope], into the paged pools of
    ``cache`` (with its block tables) in place, slot = position; the
    attention half of :func:`write_prefill_kv`."""
    bt = cache["block_tables"].long()
    bs = cfg.kv_block_size
    first = kvs if cfg.use_mla else kvs[0]
    Bn, S = first.shape[1], first.shape[2]
    pos = torch.arange(S, device=first.device)[None].expand(Bn, S)
    if first.device.type == "cpu":
        L.check_index(pos // bs, bt.shape[1], "prefill block index")
    block_ids = bt.gather(1, pos // bs)   # [B, S]
    offs = pos % bs
    # positions past a row's length are harmless: attention masks by length
    if cfg.use_mla:
        kv_quant.write_slots(cache["kv_pool"], None,
                             (slice(None), block_ids, offs), kvs)
        return cache
    for name, vals in (("k", kvs[0]), ("v", kvs[1])):
        kv_quant.write_slots(cache[f"{name}_pool"], cache.get(f"{name}_scale"),
                             (slice(None), block_ids, offs), vals)
    return cache


def copy_kv_block(cfg: ModelConfig, cache: dict, src: int, dst: int) -> dict:
    """Device-side copy of one paged KV block, in place:
    pool[:, dst] = pool[:, src] (the copy-on-write step of prefix
    sharing), for the GQA pools or MLA's latent pool. A quantized pool's
    scales are block-addressed too and ride the copy."""
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
            labels: torch.Tensor, aux_weight: float = 0.01,
            use_kernel: bool = False,
            modality_embeds: Optional[torch.Tensor] = None,
            encoder_embeds: Optional[torch.Tensor] = None,
            remat: bool = False, act_spec=None,
            kv_specs: Optional[dict] = None) -> torch.Tensor:
    """Mean next-token NLL over the labels inside [0, vocab_size) (the
    others are masked), plus ``aux_weight`` times the MoE layers' summed
    load-balancing loss (0 without MoE). tokens/labels [B, S]; an
    encoder-decoder's decoder reads ``encoder_embeds`` [B, T, D].
    ``remat``, ``act_spec`` and ``kv_specs``: see :func:`forward_full`."""
    hidden, _, aux = _forward_hidden(params, cfg, tokens, False, use_kernel,
                                     modality_embeds, encoder_embeds, remat,
                                     act_spec=act_spec, kv_specs=kv_specs)
    valid = (labels >= 0) & (labels < cfg.vocab_size)
    n = valid.sum().clamp(min=1)
    if tokens.shape[1] > CHUNKED_CE_THRESHOLD:
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return _chunked_ce(hidden, w, labels, valid, CE_CHUNK) / n \
            + aux_weight * aux
    logits = _logits(params, cfg, hidden).float()
    logp = F.log_softmax(logits, dim=-1)
    safe = torch.where(valid, labels, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum() / n + aux_weight * aux
