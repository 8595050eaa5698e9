"""Architecture registry of the PyTorch port: every arch of the JAX
package's zoo, by the same names. An unknown arch raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      input_specs, kv_cache_specs)
from repro_torch.data.tokenizer import get_tokenizer

_ARCH_MODULES: Dict[str, str] = {
    # The paper's own evaluation model: the dense GQA serving path.
    "qwen3-4b-thinking": "repro_torch.configs.qwen3_4b_thinking",
    # The attention-free SSD stack: recurrent per-slot state, the SSD scan.
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    # The hybrid: Mamba2 groups with one shared attention block (hd 80).
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    # Dense GQA archs on the qwen3 path: qk-norm or not, tied or not,
    # granite-20b's 48 query heads over one kv head.
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    # The vlm: the dense stack, whose forward takes the vision embeddings
    # of a stub frontend in place of the first prompt embeddings.
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    # MoE (8 experts, top 2, capacity dispatch) over sliding-window
    # attention.
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    # MoE (160 routed experts top 6, 2 shared) over multi-head latent
    # attention: the paged pool holds one latent entry per token.
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    # Encoder-decoder: an encoder over stub frontend embeddings, a decoder
    # with cross-attention to it.
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

ALL_ARCHS = tuple(_ARCH_MODULES)
# every arch but the paper's own model (the dry run's --all)
ASSIGNED_ARCHS = tuple(k for k in _ARCH_MODULES if k != "qwen3-4b-thinking")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.smoke_config() if smoke else mod.full_config()


def serving_config(arch: str = "qwen3-4b-thinking") -> ModelConfig:
    """Smoke-scale config wired to the synthetic-task tokenizer, used by
    the serving engine benchmarks (the model actually sampled from)."""
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, vocab_size=get_tokenizer().vocab_size)


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


__all__ = [
    "ALL_ARCHS",
    "ASSIGNED_ARCHS",
    "get_config",
    "serving_config",
    "get_shape",
    "input_specs",
    "kv_cache_specs",
    "SHAPES",
]
