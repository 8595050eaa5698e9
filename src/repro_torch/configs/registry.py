"""Architecture registry of the PyTorch port.

The port covers the architectures its slices have brought over; every
other arch of the JAX package raises ``KeyError`` naming the ROADMAP item
that ports it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig
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
}

# Archs of the JAX package not ported yet (ROADMAP A9: the arch zoo).
_NOT_PORTED = (
    "internvl2-2b", "mixtral-8x7b", "deepseek-v2-236b",
    "seamless-m4t-large-v2",
)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported to repro_torch yet "
                       f"(ROADMAP A9); ported: {sorted(_ARCH_MODULES)}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.smoke_config() if smoke else mod.full_config()


def serving_config(arch: str = "qwen3-4b-thinking") -> ModelConfig:
    """Smoke-scale config wired to the synthetic-task tokenizer, used by
    the serving engine benchmarks (the model actually sampled from)."""
    cfg = get_config(arch, smoke=True)
    return dataclasses.replace(cfg, vocab_size=get_tokenizer().vocab_size)

