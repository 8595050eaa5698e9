"""Public entry points of the port's kernels, their launch counts and
their build.

Each wrapper runs its plain PyTorch version on a CPU tensor and its CUDA
kernel on a CUDA tensor (see the kernel modules). ``launch_counts``
reads how often each kernel was launched, which is how a run shows that
the main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import step_score as _score
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.paged_attention import (  # noqa: F401
    paged_attention, paged_attention_prefill)
from repro_torch.kernels.step_score import step_score  # noqa: F401

# CUDA sources under csrc/, one shared library each
SOURCES = ("paged_attention", "step_score", "flash_attention")


def step_score_params(hidden, params: dict):
    """Scorer params dict -> fused scorer call."""
    return step_score(hidden, params["w1"], params["b1"], params["w2"],
                      params["b2"])


def launch_counts() -> Dict[str, int]:
    return {"paged_attention_decode": _paged.LAUNCHES["decode"],
            "paged_attention_prefill": _paged.LAUNCHES["prefill"],
            "paged_attention_decode_quant": _paged.LAUNCHES["decode_quant"],
            "paged_attention_prefill_quant":
                _paged.LAUNCHES["prefill_quant"],
            "step_score": _score.LAUNCHES["step_score"],
            "flash_attention": _flash.LAUNCHES["flash"]}


def reset_launch_counts() -> None:
    for counts in (_paged.LAUNCHES, _score.LAUNCHES, _flash.LAUNCHES):
        for name in counts:
            counts[name] = 0


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source (in parallel); returns the nvcc
    ``-Xptxas -v`` output per source."""
    return build.build_all(SOURCES)
