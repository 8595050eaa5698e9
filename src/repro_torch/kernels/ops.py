"""Public entry points of the port's kernels, their launch counts and
their build.

Each wrapper runs its plain PyTorch version on a CPU tensor and its CUDA
kernel on a CUDA tensor (see the kernel modules). ``launch_counts``
reads how often each kernel was launched, which is how a run shows that
the main path went through the kernels.
"""
from __future__ import annotations

import contextlib
from typing import Dict

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssm_decode as _ssm
from repro_torch.kernels import step_score as _score
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.paged_attention import (  # noqa: F401
    paged_attention, paged_attention_prefill)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
from repro_torch.kernels.ssm_decode import ssm_decode  # noqa: F401
from repro_torch.kernels.step_score import step_score  # noqa: F401

# CUDA sources under csrc/, one shared library each
SOURCES = ("paged_attention", "step_score", "flash_attention", "ssd_scan",
           "ssm_decode")

# public name -> (the wrapper module's LAUNCHES dict, its key)
_KERNELS = {
    "paged_attention_decode": (_paged.LAUNCHES, "decode"),
    "paged_attention_prefill": (_paged.LAUNCHES, "prefill"),
    "paged_attention_decode_quant": (_paged.LAUNCHES, "decode_quant"),
    "paged_attention_prefill_quant": (_paged.LAUNCHES, "prefill_quant"),
    "step_score": (_score.LAUNCHES, "step_score"),
    "flash_attention": (_flash.LAUNCHES, "flash"),
    "ssd_scan": (_ssd.LAUNCHES, "ssd_scan"),
    "ssm_decode": (_ssm.LAUNCHES, "ssm_decode"),
}
# decode-horizon graphs (serving/cuda_graph.py): captures, and replays,
# each of which adds its capture's kernel launches to the counts above
GRAPHS = {"decode_graph_replays": 0, "decode_graph_captures": 0}


def step_score_params(hidden, params: dict):
    """Scorer params dict -> fused scorer call."""
    return step_score(hidden, params["w1"], params["b1"], params["w2"],
                      params["b2"])


def _kernel_counts() -> Dict[str, int]:
    return {name: d[k] for name, (d, k) in _KERNELS.items()}


def launch_counts() -> Dict[str, int]:
    """Kernel launches on the device per kernel (a graph replay counts
    the launches its capture recorded), then the graph counters."""
    return {**_kernel_counts(), **GRAPHS}


def reset_launch_counts() -> None:
    for d, k in _KERNELS.values():
        d[k] = 0
    for name in GRAPHS:
        GRAPHS[name] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (public kernel names) to the launch counts."""
    for name, n in counts.items():
        d, k = _KERNELS[name]
        d[k] += n


@contextlib.contextmanager
def launches_withheld():
    """Leave the counts as they were around the block, and fill the
    yielded dict with what the block's wrapper calls counted: a graph
    capture records launches without making them."""
    before = _kernel_counts()
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        after = _kernel_counts()
        made.update({name: after[name] - before[name] for name in after
                     if after[name] != before[name]})
        add_launches({name: -n for name, n in made.items()})


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source (in parallel); returns the nvcc
    ``-Xptxas -v`` output per source."""
    return build.build_all(SOURCES)
