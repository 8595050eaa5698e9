"""mamba2-2.7b [ssm] — SSD (state-space duality), attn-free [arXiv:2405.21060].

64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        arch_type="ssm",
        source="arXiv:2405.21060 (Mamba2 / SSD)",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state_size=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk_size=256,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke",
        arch_type="ssm",
        source="reduced variant of arXiv:2405.21060",
        num_layers=2,
        d_model=128,
        vocab_size=512,
        ssm_state_size=16,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk_size=32,
        tie_embeddings=True,
    )
