"""granite-20b [dense] — llama-arch code model [arXiv:2405.04324].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        arch_type="dense",
        source="arXiv:2405.04324 (Granite Code Models)",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        arch_type="dense",
        source="reduced variant of arXiv:2405.04324",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=1,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
