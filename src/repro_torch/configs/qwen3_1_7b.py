"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        arch_type="dense",
        source="hf:Qwen/Qwen3-8B family (Qwen3 tech report arXiv:2505.09388)",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-smoke",
        arch_type="dense",
        source="reduced variant of hf:Qwen/Qwen3-8B",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        qk_norm=True,
        tie_embeddings=True,
    )
