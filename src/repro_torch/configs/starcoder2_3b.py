"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        arch_type="dense",
        source="arXiv:2402.19173 (StarCoder2)",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        rope_theta=999999.4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke",
        arch_type="dense",
        source="reduced variant of arXiv:2402.19173",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
