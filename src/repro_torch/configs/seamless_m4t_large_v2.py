"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596].

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.

The audio frontend (mel-spectrogram + conformer conv feature extractor)
is a STUB: the caller provides precomputed frame embeddings
(batch, 1024, d_model), which the text encoder-decoder transformer
consumes (``models.model.encode``).
"""
from repro_torch.configs.base import ModelConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        arch_type="audio",
        source="arXiv:2308.11596 (SeamlessM4T v2)",
        num_layers=24,            # decoder layers
        num_encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        is_encoder_decoder=True,
        encoder_seq_len=1024,
        modality="audio",
        long_context_window=8192,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke",
        arch_type="audio",
        source="reduced variant of arXiv:2308.11596",
        num_layers=2,
        num_encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        is_encoder_decoder=True,
        encoder_seq_len=32,
        modality="audio",
    )
