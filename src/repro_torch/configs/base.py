"""Configuration system for the repro framework.

Every assigned architecture is described by a single frozen `ModelConfig`.
`full_config()` in each ``configs/<arch>.py`` returns the exact published
configuration; ``smoke_config()`` returns a reduced same-family variant
(<=2 layers, d_model<=512, <=4 experts) used by CPU smoke tests.

Input shapes are global; ``input_specs`` and ``kv_cache_specs`` build
stand-ins on the ``meta`` device (shapes and dtypes, no storage), so a
launcher can size its inputs and caches without allocating anything.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single architecture description covering all 6 assigned families."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation for the config

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- attention options -------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # native SWA (e.g. mixtral)
    # Window applied only for the long_500k decode shape (beyond-paper
    # rolling-buffer variant that makes dense archs sub-quadratic).
    long_context_window: Optional[int] = 8192

    # --- MLA (DeepSeek-V2) --------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    # capacity = cf * T * top_k / E. Production configs use 1.25 (tokens may
    # drop, Switch-style); smoke configs use a no-drop factor so the
    # decode==full consistency invariant is exact.
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state_size: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk_size: int = 256

    # --- hybrid (Zamba2): shared attention block every k mamba layers ---------
    hybrid_attn_every: int = 0  # 0 => not hybrid

    # --- encoder-decoder -------------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0  # frontend tokens seen by the encoder

    # --- modality frontends (stubs per assignment carve-out) -------------------
    modality: str = "text"  # text | vision | audio
    num_modality_tokens: int = 0  # prepended embedding tokens (vlm)

    # --- numerics / serving -----------------------------------------------------
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    kv_block_size: int = 16  # paged KV block size (tokens)
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        if self.ssm_num_heads:
            return self.ssm_num_heads
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def kv_cache_dims_per_token(self) -> int:
        """Per-layer per-token cache scalar count (drives block bytes)."""
        if self.use_mla:
            # MLA caches the compressed latent + decoupled rope key.
            return self.kv_lora_rank + self.qk_rope_head_dim
        if self.arch_type == "ssm":
            return 0
        return 2 * self.num_kv_heads * self.head_dim

    def attention_layer_ids(self) -> Tuple[int, ...]:
        """Indices of layers that carry a KV cache."""
        if self.arch_type == "ssm":
            return ()
        if self.hybrid_attn_every:
            return tuple(
                i for i in range(self.num_layers)
                if (i + 1) % self.hybrid_attn_every == 0
            )
        return tuple(range(self.num_layers))

    def effective_cache_len(self, shape: ShapeSpec) -> int:
        """Sequence length actually held in KV cache for a shape."""
        length = shape.seq_len
        if self.sliding_window is not None:
            length = min(length, self.sliding_window)
        if shape.name == "long_500k" and self.long_context_window is not None:
            length = min(length, self.long_context_window)
        return length

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            if self.arch_type in ("ssm", "hybrid"):
                return True
            # dense/moe/vlm/audio run long_500k only via the sliding-window
            # variant (see DESIGN.md §long_500k applicability)
            return (self.sliding_window is not None
                    or self.long_context_window is not None)
        return True


# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins, no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-tensor stand-ins for every model input of the step fn.

    train  -> {tokens, labels[, encoder_embeds / modality_embeds]}
    prefill-> {tokens[, ...frontend embeds]}
    decode -> {tokens (1 new), positions}
    """
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((b, s), torch.int32)
        specs["labels"] = _meta((b, s), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = _meta((b, s), torch.int32)
    else:  # decode
        specs["tokens"] = _meta((b, 1), torch.int32)
        specs["positions"] = _meta((b,), torch.int32)
    if cfg.modality == "vision" and shape.kind in ("train", "prefill"):
        # precomputed ViT/projector patch embeddings (stub frontend)
        n = cfg.num_modality_tokens or 256
        specs["modality_embeds"] = _meta((b, n, cfg.d_model), torch.bfloat16)
    if cfg.is_encoder_decoder and shape.kind in ("train", "prefill"):
        # precomputed frame embeddings for the encoder (stub); at decode
        # time the encoder output lives in the cross-attention cache
        enc_len = cfg.encoder_seq_len or 1024
        specs["encoder_embeds"] = _meta((b, enc_len, cfg.d_model),
                                        torch.bfloat16)
    return specs


def kv_cache_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-tensor stand-ins of the contiguous decode cache that
    ``models.model.serve_decode_step`` consumes, for a decode shape.

    Each sequence owns a dense ring buffer (capacity: the effective cache
    length rounded up to whole KV blocks):
      k/v_cache:  [num_layers_attn, batch, capacity, KVH, head_dim]
      kv_cache:   [num_layers_attn, batch, capacity, kv_lora+rope]  (MLA)
      ssm_state:  [num_ssm_layers, batch, heads, head_dim, state] f32
      conv_state: [num_ssm_layers, batch, conv_width-1, d_conv_channels]
      cross_k/v:  [num_layers_attn, batch, encoder_len, KVH, head_dim]
    """
    shape = SHAPES[shape_name]
    if shape.kind != "decode":
        raise ValueError(f"kv_cache_specs takes a decode shape, not "
                         f"{shape_name!r} ({shape.kind})")
    b = shape.global_batch
    bs = cfg.kv_block_size
    capacity = -(-cfg.effective_cache_len(shape) // bs) * bs
    specs: dict = {}
    attn_layers = cfg.attention_layer_ids()
    dt = torch.bfloat16
    la = len(attn_layers)
    if la:
        if cfg.use_mla:
            kv_dims = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            specs["kv_cache"] = _meta((la, b, capacity, kv_dims), dt)
        else:
            for key in ("k_cache", "v_cache"):
                specs[key] = _meta(
                    (la, b, capacity, cfg.num_kv_heads, cfg.head_dim), dt)
    if cfg.arch_type in ("ssm", "hybrid"):
        # hybrid: ALL num_layers are mamba; the shared attention blocks
        # between groups are counted by attention_layer_ids()
        n_ssm = cfg.num_layers
        specs["ssm_state"] = _meta(
            (n_ssm, b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_size),
            torch.float32)
        specs["conv_state"] = _meta(
            (n_ssm, b, cfg.ssm_conv_width - 1,
             cfg.d_inner + 2 * cfg.ssm_state_size), dt)
    if cfg.is_encoder_decoder:
        # cross-attention K/V computed once at prefill from the encoder
        enc_len = cfg.encoder_seq_len or 1024
        for key in ("cross_k", "cross_v"):
            specs[key] = _meta(
                (la, b, enc_len, cfg.num_kv_heads, cfg.head_dim), dt)
    return specs
