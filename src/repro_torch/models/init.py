"""Parameter initialization for the ported architectures (dense, ssm).

Layer params are STACKED along a leading [num_layers] axis, in the JAX
package's names and layouts (``wq [L, D, H*hd]``, ``embed [Vp, D]``), so
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


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (the JAX package's layout)."""
    return -(-cfg.vocab_size // 256) * 256


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random params of a dense or ssm stack on ``generator``'s device."""
    check_ported(cfg)
    dev = generator.device

    def dense(fan_in, *shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(DTYPE)

    def ones(*shape):
        return torch.ones(shape, dtype=DTYPE, device=dev)

    L, D = cfg.num_layers, cfg.d_model
    params = {
        "embed": dense(D, padded_vocab(cfg), D, scale=0.02),
        "final_norm": ones(D),
    }
    if cfg.arch_type == "ssm":
        params["layers"] = {"norm": ones(L, D),
                            "mixer": _mamba_params(cfg, dense, dev)}
    else:
        params["layers"] = _dense_layers(cfg, dense, ones)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(D, D, padded_vocab(cfg))
    return params


def _dense_layers(cfg: ModelConfig, dense, ones) -> dict:
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    depth = math.sqrt(2 * max(L, 1))
    attn = {
        "wq": dense(D, L, D, H * hd),
        "wk": dense(D, L, D, KVH * hd),
        "wv": dense(D, L, D, KVH * hd),
        "wo": dense(H * hd, L, H * hd, D,
                    scale=1.0 / math.sqrt(H * hd) / depth),
    }
    if cfg.qk_norm:
        attn["q_norm"] = ones(L, hd)
        attn["k_norm"] = ones(L, hd)
    return {
        "ln1": ones(L, D),
        "attn": attn,
        "ln2": ones(L, D),
        "mlp": {
            "w_gate": dense(D, L, D, F),
            "w_up": dense(D, L, D, F),
            "w_down": dense(F, L, F, D, scale=1.0 / math.sqrt(F) / depth),
        },
    }


def _mamba_params(cfg: ModelConfig, dense, dev) -> dict:
    """The stacked Mamba2 mixer of ``repro/models/init.py::_mamba_params``:
    ``A_log`` = log(1..H), ``D`` = 1 and ``dt_bias`` = softplus^-1(0.01)
    stay f32 beside the bf16 matrices."""
    L, D = cfg.num_layers, cfg.d_model
    di, N, H, W = (cfg.d_inner, cfg.ssm_state_size, cfg.ssm_heads,
                   cfg.ssm_conv_width)
    conv_ch = di + 2 * N

    def f32_rows(row):
        return row.to(dev).expand(L, H).contiguous()

    return {
        "w_in": dense(D, L, D, 2 * di + 2 * N + H),
        "conv_w": dense(W, L, W, conv_ch),
        "conv_b": torch.zeros((L, conv_ch), dtype=DTYPE, device=dev),
        "A_log": f32_rows(torch.log(torch.arange(1, H + 1,
                                                 dtype=torch.float32))),
        "D": torch.ones((L, H), dtype=torch.float32, device=dev),
        "dt_bias": f32_rows(torch.log(torch.expm1(
            torch.full((H,), 0.01, dtype=torch.float32)))),
        "norm_w": torch.ones((L, di), dtype=DTYPE, device=dev),
        "w_out": dense(di, L, di, D,
                       scale=1.0 / math.sqrt(di) / math.sqrt(2 * L)),
    }


def count_params(params: dict) -> int:
    total = 0
    for v in params.values():
        total += count_params(v) if isinstance(v, dict) else v.numel()
    return total
