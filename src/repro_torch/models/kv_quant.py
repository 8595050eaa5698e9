"""Paged-KV pool dtypes and byte accounting.

The paged pools (``k_pool``/``v_pool``: ``[layers, blocks, block_size,
kv_heads, head_dim]``) are stored in the dtype ``EngineConfig.kv_dtype``
selects. The port covers the float pools, ``f32`` and ``bf16`` (the
default). The quantized pools of the JAX package (``int8``/``fp8`` with
per-slot f32 scales, dequantized inside the paged-attention kernel) are
ROADMAP A7 with kernel B3 and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

KV_DTYPES = ("f32", "bf16", "int8", "fp8")


def _not_ported(kv_dtype: str) -> NotImplementedError:
    return NotImplementedError(
        f"kv_dtype={kv_dtype!r}: the quantized KV pool is not ported to "
        f"repro_torch yet (ROADMAP A7, kernel B3)")


def kv_pool_dtype(kv_dtype: str) -> torch.dtype:
    """Map a ``kv_dtype`` setting to the pool storage dtype."""
    if kv_dtype == "f32":
        return torch.float32
    if kv_dtype == "bf16":
        return torch.bfloat16
    if kv_dtype in ("int8", "fp8"):
        raise _not_ported(kv_dtype)
    raise ValueError(
        f"unknown kv_dtype {kv_dtype!r}; expected one of {KV_DTYPES}")


def is_quantized(kv_dtype: str) -> bool:
    return kv_dtype in ("int8", "fp8")


def kv_bytes_per_scalar(kv_dtype: str) -> int:
    """Pool storage bytes per cached scalar."""
    return {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}[kv_dtype]


def resolve_kv_dtype(setting: str, cfg: ModelConfig,
                     chunk_supported: bool) -> str:
    """Validate a ``kv_dtype`` setting against what the port covers."""
    if setting not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {setting!r}; expected one of {KV_DTYPES}")
    if is_quantized(setting):
        raise _not_ported(setting)
    return setting


def pool_block_bytes(cfg: ModelConfig, kv_dtype: str) -> int:
    """Device bytes one KV block occupies across all attention layers
    (what ``AdmissionPressure`` byte accounting reports per block)."""
    la = len(cfg.attention_layer_ids())
    return (la * cfg.kv_block_size * cfg.kv_cache_dims_per_token
            * kv_bytes_per_scalar(kv_dtype))
