"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        source="arXiv:2401.04088 (Mixtral of Experts)",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,          # kept for reference; experts use moe_d_ff
        vocab_size=32000,
        num_experts=8,
        num_experts_per_tok=2,
        moe_d_ff=14336,
        sliding_window=4096,  # native SWA
        rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        arch_type="moe",
        source="reduced variant of arXiv:2401.04088",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        num_experts=4,
        num_experts_per_tok=2,
        moe_d_ff=512,
        sliding_window=128,
        moe_capacity_factor=8.0,
    )
