"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        arch_type="dense",
        source="arXiv:2412.08905 (Phi-4)",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200064,
        rope_theta=10000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b-smoke",
        arch_type="dense",
        source="reduced variant of arXiv:2412.08905",
        num_layers=2,
        d_model=192,
        num_heads=3,
        num_kv_heads=1,
        head_dim=64,
        d_ff=384,
        vocab_size=512,
        tie_embeddings=True,
    )
