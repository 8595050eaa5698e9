"""Configuration system for the repro framework.

Every assigned architecture is described by a single frozen `ModelConfig`.
`full_config()` in each ``configs/<arch>.py`` returns the exact published
configuration; ``smoke_config()`` returns a reduced same-family variant
(<=2 layers, d_model<=512, <=4 experts) used by CPU smoke tests.

Input shapes are global. The shape stand-ins of the JAX package
(``input_specs`` / ``kv_cache_specs``) wait for the port's launchers
(ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
