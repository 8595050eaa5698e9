"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434].

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400, MoE 160e top-6.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        arch_type="moe",
        source="arXiv:2405.04434 (DeepSeek-V2)",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,    # MLA: all heads read the shared latent
        head_dim=128,
        d_ff=1536,
        vocab_size=102400,
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=160,
        num_experts_per_tok=6,
        num_shared_experts=2,
        moe_d_ff=1536,
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        arch_type="moe",
        source="reduced variant of arXiv:2405.04434",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=128,
        vocab_size=512,
        use_mla=True,
        kv_lora_rank=64,
        q_lora_rank=96,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        num_experts=4,
        num_experts_per_tok=2,
        num_shared_experts=1,
        moe_d_ff=128,
        moe_capacity_factor=8.0,
)
