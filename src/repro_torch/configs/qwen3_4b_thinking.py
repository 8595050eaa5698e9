"""qwen3-4b-thinking-2507 — the paper's own primary evaluation model
[arXiv:2505.09388; STEP §5.1].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, qk_norm.
Included beyond the 10 assigned architectures because it is the model the
paper itself evaluates; the step-scorer input dim (2560) matches Appendix A.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-thinking",
        arch_type="dense",
        source="arXiv:2505.09388 (Qwen3); STEP paper §5.1 primary model",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-thinking-smoke",
        arch_type="dense",
        source="reduced variant of the STEP paper's primary model",
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
