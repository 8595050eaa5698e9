"""Parameter initialization for the ported architectures (dense, ssm,
hybrid).

Layer params are STACKED along a leading [num_layers] axis, in the JAX
package's names and layouts (``wq [L, D, H*hd]``, ``embed [Vp, D]``); the
hybrid stacks its Mamba2 layers [groups, layers_per_group, ...] beside a
single ``shared_attn`` decoder layer. So
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
# A stacked weight of more elements than this (granite-20b's MLP: 7.9e9)
# is drawn one leading slice at a time, so that its f32 draw never holds
# more than a slice (a whole one would take 31 GB beside the params).
# Slice-wise draws need not give the numbers of one whole draw, so the
# threshold keeps every smaller weight, and the seeded scenarios built on
# it, as one draw made it.
DRAW_SLICE_ABOVE = 2 ** 31


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (the JAX package's layout)."""
    return -(-cfg.vocab_size // 256) * 256


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random params of a dense, ssm or hybrid stack on ``generator``'s
    device."""
    check_ported(cfg)
    dev = generator.device

    def dense(fan_in, *shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        if math.prod(shape) <= DRAW_SLICE_ABOVE:
            w = torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32)
            return (w * scale).to(DTYPE)
        out = torch.empty(shape, dtype=DTYPE, device=dev)
        for w_i in out:
            w_i.copy_(torch.randn(shape[1:], generator=generator, device=dev,
                                  dtype=torch.float32) * scale)
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
    else:
        params["layers"] = _dense_layers(cfg, dense, ones, (L,))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(D, D, padded_vocab(cfg))
    return params


def _dense_layers(cfg: ModelConfig, dense, ones, stack: tuple) -> dict:
    """Decoder layers stacked over ``stack`` (``(L,)``, or ``()`` for the
    hybrid's one shared block); the output scales count all
    ``num_layers``, as the JAX package's do."""
    D, F = cfg.d_model, cfg.d_ff
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
    return {
        "ln1": ones(*stack, D),
        "attn": attn,
        "ln2": ones(*stack, D),
        "mlp": {
            "w_gate": dense(D, *stack, D, F),
            "w_up": dense(D, *stack, D, F),
            "w_down": dense(F, *stack, F, D,
                            scale=1.0 / math.sqrt(F) / depth),
        },
    }


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
