"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.

The shared attention block (one set of weights, invoked periodically) is
modeled as an attention layer every ``hybrid_attn_every`` layers; only the
attention layers carry a KV cache, which is what makes the hybrid family
sub-quadratic enough for long_500k.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        source="arXiv:2411.15242 (Zamba2)",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state_size=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk_size=256,
        hybrid_attn_every=6,   # 9 shared-attention invocations over 54 layers
        long_context_window=8192,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        arch_type="hybrid",
        source="reduced variant of arXiv:2411.15242",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        ssm_state_size=16,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk_size=32,
        hybrid_attn_every=2,
    )
