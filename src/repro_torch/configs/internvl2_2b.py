"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

Per the assignment carve-out, the vision frontend (InternViT + projector) is
a STUB: ``input_specs()`` provides precomputed patch embeddings of shape
(batch, 256, d_model); this config implements the InternLM2 language decoder
that consumes them.
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        arch_type="vlm",
        source="arXiv:2404.16821 (InternVL2); LM backbone InternLM2-1.8B",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        modality="vision",
        num_modality_tokens=256,
        rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-smoke",
        arch_type="vlm",
        source="reduced variant of arXiv:2404.16821",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        modality="vision",
        num_modality_tokens=16,
    )
