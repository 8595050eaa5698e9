"""Parameter initialization for every architecture of the zoo (dense,
MoE, vlm, ssm, hybrid, MLA, encoder-decoder).

Layer params are STACKED along a leading [num_layers] axis, in the JAX
package's names and layouts (``wq [L, D, H*hd]``, ``embed [Vp, D]``); the
hybrid stacks its Mamba2 layers [groups, layers_per_group, ...] beside a
single ``shared_attn`` decoder layer; an MLA layer's attention holds the
low-rank projections (``wq_a``, ``wq_b``, ``wkv_a``, ``wk_b``, ``wv_b``,
``wo`` and two norms); an encoder-decoder adds an ``encoder`` stack and
``encoder_norm``, and gives each decoder layer ``ln_cross`` and a
``cross`` attention. So
``models.bridge`` maps one package's weights onto the other one to one.
Scales and the bf16 storage follow ``repro/models/init.py``; the random
numbers come from a ``torch.Generator`` and so differ from JAX's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import check_ported

DTYPE = torch.bfloat16
# A stacked weight of more elements than this (granite-20b's MLP: 7.9e9;
# mixtral-8x7b's experts: 1.5e10 at 32 layers; deepseek-v2's: 1.3e9 per
# layer) is drawn one leading slice
# (layer) at a time, so that its f32 draw never holds
# more than a slice (a whole one would take 31 GB beside the params).
# Slice-wise draws need not give the numbers of one whole draw, so the
# threshold keeps every smaller weight, and the seeded scenarios built on
# it, as one draw made it.
DRAW_SLICE_ABOVE = 2 ** 31


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (the JAX package's layout)."""
    return -(-cfg.vocab_size // 256) * 256


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random params of ``cfg``'s stack on ``generator``'s device."""
    check_ported(cfg)
    dev = generator.device

    def dense(fan_in, *shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        if math.prod(shape) <= DRAW_SLICE_ABOVE:
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (w * scale).to(DTYPE)
        out = torch.empty(shape, dtype=DTYPE, device=dev)
        for w_i in out:   # one f32 slice alive at a time
            w_i.copy_(torch.randn(shape[1:], generator=generator, device=dev,
                                  dtype=torch.float32).mul_(scale))
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=DTYPE, device=dev)

    L, D = cfg.num_layers, cfg.d_model
    params = {
        "embed": dense(D, padded_vocab(cfg), D, scale=0.02),
        "final_norm": ones(D),
    }
    if cfg.arch_type == "ssm":
        params["layers"] = {"norm": ones(L, D),
                            "mixer": _mamba_params(cfg, dense, dev, (L,))}
    elif cfg.arch_type == "hybrid":
        if L % cfg.hybrid_attn_every:
            raise ValueError(f"num_layers {L} is not a multiple of "
                             f"hybrid_attn_every {cfg.hybrid_attn_every}")
        stack = (L // cfg.hybrid_attn_every, cfg.hybrid_attn_every)
        params["layers"] = {"norm": ones(*stack, D),
                            "mixer": _mamba_params(cfg, dense, dev, stack)}
        params["shared_attn"] = _dense_layers(cfg, dense, ones, ())
    elif cfg.is_encoder_decoder:
        Le = (cfg.num_encoder_layers,)
        params["encoder"] = {"ln1": ones(*Le, D),
                             "attn": _attn_params(cfg, dense, ones, Le),
                             "ln2": ones(*Le, D),
                             "mlp": _mlp_params(cfg, dense, Le, cfg.d_ff)}
        params["encoder_norm"] = ones(D)
        params["layers"] = _dense_layers(cfg, dense, ones, (L,), cross=True)
    else:
        params["layers"] = _dense_layers(cfg, dense, ones, (L,))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(D, D, padded_vocab(cfg))
    return params


def init_param_shapes(cfg: ModelConfig) -> dict:
    """The tree of :func:`init_params` as ``meta`` tensors: the same
    names, shapes and dtypes, and no storage (the counterpart of the JAX
    package's ``jax.eval_shape(init_params)``). The draws run under a
    ``FakeTensorMode``, which allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator("cpu"))

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")

    return meta(fake)


def _dense_layers(cfg: ModelConfig, dense, ones, stack: tuple,
                  cross: bool = False) -> dict:
    """Decoder layers stacked over ``stack`` (``(L,)``, or ``()`` for the
    hybrid's one shared block), with MLA attention when ``cfg.use_mla``
    and, with ``cross``, a cross-attention to the encoder; the output
    scales count all ``num_layers``, as the JAX package's do."""
    D = cfg.d_model
    attn = (_mla_params(cfg, dense, ones, stack) if cfg.use_mla
            else _attn_params(cfg, dense, ones, stack))
    layer = {"ln1": ones(*stack, D), "attn": attn, "ln2": ones(*stack, D)}
    if cfg.uses_moe:
        layer["moe"] = _moe_params(cfg, dense, stack)
    else:
        layer["mlp"] = _mlp_params(cfg, dense, stack, cfg.d_ff)
    if cross:
        layer["ln_cross"] = ones(*stack, D)
        layer["cross"] = _attn_params(cfg, dense, ones, stack)
    return layer


def _attn_params(cfg: ModelConfig, dense, ones, stack: tuple) -> dict:
    """GQA attention: ``wq [D, H*hd]``, ``wk``/``wv [D, KVH*hd]``, ``wo``
    and, with qk-norm, ``q_norm``/``k_norm [hd]``."""
    D = cfg.d_model
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    depth = math.sqrt(2 * max(cfg.num_layers, 1))
    attn = {
        "wq": dense(D, *stack, D, H * hd),
        "wk": dense(D, *stack, D, KVH * hd),
        "wv": dense(D, *stack, D, KVH * hd),
        "wo": dense(H * hd, *stack, H * hd, D,
                    scale=1.0 / math.sqrt(H * hd) / depth),
    }
    if cfg.qk_norm:
        attn["q_norm"] = ones(*stack, hd)
        attn["k_norm"] = ones(*stack, hd)
    return attn


def _mla_params(cfg: ModelConfig, dense, ones, stack: tuple) -> dict:
    """``repro/models/init.py::_mla_params``: the query's low-rank pair
    (``wq_a [D, q_lora]``, ``wq_b [q_lora, H*(nope+rope)]``), the shared
    latent and roped key (``wkv_a [D, kv_lora+rope]``), their per-head
    up-projections (``wk_b [kv_lora, H*nope]``, ``wv_b [kv_lora, H*v]``),
    ``wo [H*v, D]``, and the two latents' norms."""
    D, H = cfg.d_model, cfg.num_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    Lk, Lq = cfg.kv_lora_rank, cfg.q_lora_rank
    return {
        "wq_a": dense(D, *stack, D, Lq),
        "wq_b": dense(Lq, *stack, Lq, H * (nd + rd)),
        "wkv_a": dense(D, *stack, D, Lk + rd),
        "wk_b": dense(Lk, *stack, Lk, H * nd),
        "wv_b": dense(Lk, *stack, Lk, H * vd),
        "wo": dense(H * vd, *stack, H * vd, D,
                    scale=1.0 / math.sqrt(H * vd)
                    / math.sqrt(2 * cfg.num_layers)),
        "q_a_norm": ones(*stack, Lq),
        "kv_a_norm": ones(*stack, Lk),
    }


def _mlp_params(cfg: ModelConfig, dense, stack: tuple, F: int) -> dict:
    D = cfg.d_model
    depth = math.sqrt(2 * max(cfg.num_layers, 1))
    return {
        "w_gate": dense(D, *stack, D, F),
        "w_up": dense(D, *stack, D, F),
        "w_down": dense(F, *stack, F, D, scale=1.0 / math.sqrt(F) / depth),
    }


def _moe_params(cfg: ModelConfig, dense, stack: tuple) -> dict:
    """``repro/models/init.py::_moe_params``: the router [D, E], the
    experts' SwiGLU stacked over E (``w_gate``/``w_up`` [E, D, F],
    ``w_down`` [E, F, D]) and, with shared experts, one SwiGLU of width
    ``F * num_shared_experts``."""
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    down = 1.0 / math.sqrt(F) / math.sqrt(2 * cfg.num_layers)
    p = {
        "router": dense(D, *stack, D, E),
        "experts": {
            "w_gate": dense(D, *stack, E, D, F),
            "w_up": dense(D, *stack, E, D, F),
            "w_down": dense(F, *stack, E, F, D, scale=down),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = _mlp_params(cfg, dense, stack,
                                  F * cfg.num_shared_experts)
    return p


def _mamba_params(cfg: ModelConfig, dense, dev, stack: tuple) -> dict:
    """The Mamba2 mixer of ``repro/models/init.py::_mamba_params``,
    stacked over ``stack``: ``A_log`` = log(1..H), ``D`` = 1 and
    ``dt_bias`` = softplus^-1(0.01) stay f32 beside the bf16 matrices."""
    D = cfg.d_model
    di, N, H, W = (cfg.d_inner, cfg.ssm_state_size, cfg.ssm_heads,
                   cfg.ssm_conv_width)
    conv_ch = di + 2 * N

    def f32_rows(row):
        return row.to(dev).expand(*stack, H).contiguous()

    return {
        "w_in": dense(D, *stack, D, 2 * di + 2 * N + H),
        "conv_w": dense(W, *stack, W, conv_ch),
        "conv_b": torch.zeros((*stack, conv_ch), dtype=DTYPE, device=dev),
        "A_log": f32_rows(torch.log(torch.arange(1, H + 1,
                                                 dtype=torch.float32))),
        "D": torch.ones((*stack, H), dtype=torch.float32, device=dev),
        "dt_bias": f32_rows(torch.log(torch.expm1(
            torch.full((H,), 0.01, dtype=torch.float32)))),
        "norm_w": torch.ones((*stack, di), dtype=DTYPE, device=dev),
        "w_out": dense(di, *stack, di, D,
                       scale=1.0 / math.sqrt(di)
                       / math.sqrt(2 * cfg.num_layers)),
    }


def count_params(params: dict) -> int:
    total = 0
    for v in params.values():
        total += count_params(v) if isinstance(v, dict) else v.numel()
    return total
