"""Paged-KV pool dtypes, per-slot quantization and byte accounting.

The paged pools (``k_pool``/``v_pool``: ``[layers, blocks, block_size,
kv_heads, head_dim]``) are stored in the dtype ``EngineConfig.kv_dtype``
selects:

- ``f32`` / ``bf16`` — plain floating-point pools, no scales; ``bf16``
  is the default.
- ``int8`` / ``fp8`` — quantized pools (``fp8`` is
  ``torch.float8_e4m3fn``) with one f32 scale per (layer, block, slot,
  kv head), stored as the cache entries ``k_scale``/``v_scale`` of shape
  ``[layers, blocks, block_size, kv_heads]``. Dequantization is
  ``code.float() * scale``; the scale is ``absmax / qmax`` over the
  token's ``head_dim`` vector.

The scale is per SLOT, not per page: each cached token quantizes from its
own absmax, so a slot's stored code is a pure function of the token
written there. Every write path (one-shot prefill, chunked prefill,
decode appends, copy-on-write block copies) therefore stores the same
bytes for the same tokens, and a recycled block carries no history. The
cost is one f32 per (slot, kv head) for K and for V, which
``pool_block_bytes`` counts.

The dense read paths and the paged-attention kernel apply the same
dequantization (cast to f32, multiply by the slot's scale), so the two
stay aligned under every ``kv_dtype``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

KV_DTYPES = ("f32", "bf16", "int8", "fp8")
FP8 = torch.float8_e4m3fn

# Largest representable magnitude per quantized dtype: int8 uses the
# symmetric range [-127, 127]; float8_e4m3fn tops out at 448.
_QMAX_INT8 = 127.0
_QMAX_FP8 = 448.0

_POOL_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8, "fp8": FP8}


def kv_pool_dtype(kv_dtype: str) -> torch.dtype:
    """Map a ``kv_dtype`` setting to the pool storage dtype."""
    if kv_dtype not in _POOL_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r}; expected one of {KV_DTYPES}")
    return _POOL_DTYPES[kv_dtype]


def is_quantized(kv_dtype: str) -> bool:
    return kv_dtype in ("int8", "fp8")


def kv_bytes_per_scalar(kv_dtype: str) -> int:
    """Pool storage bytes per cached scalar (excluding scale overhead)."""
    return {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1}[kv_dtype]


def quantize_pages(x: torch.Tensor, qdtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize KV values ``[..., head_dim]`` to ``qdtype`` (int8 or fp8)
    with a fresh absmax scale per leading index (one per token vector).

    Returns ``(codes, scale)`` with ``scale`` shaped ``x.shape[:-1]``, f32.
    An all-zero vector gets scale 1.0. Scales are rounded to the bf16 grid
    (f32 -> bf16 -> f32): an 8-bit code times an 8-bit-mantissa scale is
    then exact in f32, so every read path's dequantized values are
    identical whatever order it sums them in. ``torch.round`` rounds half
    to even, as ``jnp.round`` does."""
    xf = x.float()
    qmax = _QMAX_INT8 if qdtype == torch.int8 else _QMAX_FP8
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0.0, absmax / qmax, 1.0)
    scale = scale.to(torch.bfloat16).float()
    y = xf / scale[..., None]
    if qdtype == torch.int8:
        codes = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        codes = torch.clamp(y, -qmax, qmax).to(qdtype)
    return codes, scale


def dequantize_pages(codes: torch.Tensor, scale: torch.Tensor
                     ) -> torch.Tensor:
    """Inverse of :func:`quantize_pages`: ``codes [..., hd]`` with
    ``scale [...]`` back to f32 (leading batch axes broadcast, so a
    gathered pool slice and its gathered scales work as they are)."""
    return codes.float() * scale[..., None]


def _storage_view(t: torch.Tensor) -> torch.Tensor:
    """A view of ``t`` that indexed assignment accepts on every build:
    fp8 as its raw bytes (``uint8``, the same size; ``index_copy_`` has
    no fp8 kernel), anything else as itself."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def write_slots(pool: torch.Tensor, scale: Optional[torch.Tensor], idx,
                vals: torch.Tensor) -> None:
    """``pool[idx] = vals``, IN PLACE. A float pool (``scale`` None) takes
    ``vals`` cast to its dtype; an int8/fp8 pool takes each token vector's
    codes, and ``scale[idx]`` its scale (:func:`quantize_pages`), so a
    slot's bytes are a pure function of the token written there."""
    if scale is None:
        pool[idx] = vals.to(pool.dtype)
        return
    codes, s = quantize_pages(vals, pool.dtype)
    _storage_view(pool)[idx] = _storage_view(codes)
    scale[idx] = s


def resolve_kv_dtype(setting: str, cfg: ModelConfig,
                     chunk_supported: bool) -> str:
    """Validate a ``kv_dtype`` setting against the architecture: the
    quantized pools cover the dense-GQA paged-attention stack (the family
    chunked prefill serves), as in the JAX package."""
    if setting not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {setting!r}; expected one of {KV_DTYPES}")
    if is_quantized(setting) and not chunk_supported:
        raise NotImplementedError(
            f"kv_dtype={setting!r} is only supported for dense GQA "
            f"architectures (arch_type={cfg.arch_type!r}, "
            f"use_mla={cfg.use_mla})")
    return setting


def pool_block_bytes(cfg: ModelConfig, kv_dtype: str) -> int:
    """Device bytes one KV block occupies across all attention layers:
    pool storage plus, for the quantized dtypes, the f32 scales (what
    ``AdmissionPressure`` byte accounting reports per block)."""
    la = len(cfg.attention_layer_ids())
    n = (la * cfg.kv_block_size * cfg.kv_cache_dims_per_token
         * kv_bytes_per_scalar(kv_dtype))
    if is_quantized(kv_dtype):
        # one f32 scale per (layer, block, slot, kv head), for K and V
        n += la * 2 * cfg.kv_block_size * cfg.num_kv_heads * 4
    return n


def init_scales(cfg: ModelConfig, num_blocks: int, kv_dtype: str,
                device="cpu") -> Optional[torch.Tensor]:
    """Unit scales ``[attn_layers, num_blocks, block_size, kv_heads]`` for
    a quantized pool (a zero-filled pool dequantizes to exact zeros), or
    ``None`` for a float pool."""
    if not is_quantized(kv_dtype):
        return None
    la = len(cfg.attention_layer_ids())
    return torch.ones((la, num_blocks, cfg.kv_block_size, cfg.num_kv_heads),
                      dtype=torch.float32, device=device)
