"""Parameter initialization for the ported (dense) architectures.

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

DTYPE = torch.bfloat16


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (the JAX package's layout)."""
    return -(-cfg.vocab_size // 256) * 256


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random dense-stack params on ``generator``'s device."""
    if cfg.arch_type != "dense" or cfg.use_mla or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"repro_torch initializes the dense stack only, not "
            f"{cfg.arch_type!r} (ROADMAP A9)")
    dev = generator.device

    def dense(fan_in, *shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(DTYPE)

    def ones(*shape):
        return torch.ones(shape, dtype=DTYPE, device=dev)

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
    params = {
        "embed": dense(D, padded_vocab(cfg), D, scale=0.02),
        "final_norm": ones(D),
        "layers": {
            "ln1": ones(L, D),
            "attn": attn,
            "ln2": ones(L, D),
            "mlp": {
                "w_gate": dense(D, L, D, F),
                "w_up": dense(D, L, D, F),
                "w_down": dense(F, L, F, D,
                                scale=1.0 / math.sqrt(F) / depth),
            },
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(D, D, padded_vocab(cfg))
    return params


def count_params(params: dict) -> int:
    total = 0
    for v in params.values():
        total += count_params(v) if isinstance(v, dict) else v.numel()
    return total
