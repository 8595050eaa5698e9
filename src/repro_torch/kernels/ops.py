"""Public entry points of the port's kernels, their launch counts and
their build.

Each wrapper runs its plain PyTorch version on a CPU tensor and its CUDA
kernel on a CUDA tensor (see the kernel modules). ``launch_counts``
reads how often each kernel was launched, which is how a run shows that
the main path went through the kernels. The ``*_sharded`` routes are the
paged attention on one rank of a serving mesh (the JAX package's
``shard_map`` wrappers): the same kernels over the rank's lanes and
heads.
"""
from __future__ import annotations

import contextlib
from typing import Dict

from repro_torch.kernels import build
from repro_torch.kernels import decode_glue as _glue
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssm_decode as _ssm
from repro_torch.kernels import step_score as _score
from repro_torch.kernels.decode_glue import (  # noqa: F401
    add_rms_norm, attn_prologue, silu_mul)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.paged_attention import (  # noqa: F401
    paged_attention, paged_attention_prefill)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
from repro_torch.kernels.ssm_decode import ssm_decode  # noqa: F401
from repro_torch.kernels.step_score import step_score  # noqa: F401

# CUDA sources under csrc/, one shared library each
SOURCES = ("paged_attention", "paged_decode", "step_score",
           "flash_attention", "ssd_scan", "ssd_wgmma", "ssm_decode",
           "decode_glue")

# public name -> (the wrapper module's LAUNCHES dict, its key)
_KERNELS = {
    "paged_attention_decode": (_paged.LAUNCHES, "decode"),
    "paged_attention_prefill": (_paged.LAUNCHES, "prefill"),
    "paged_attention_decode_quant": (_paged.LAUNCHES, "decode_quant"),
    "paged_attention_prefill_quant": (_paged.LAUNCHES, "prefill_quant"),
    "paged_attention_prefill_wgmma": (_paged.LAUNCHES, "prefill_wgmma"),
    "paged_attention_prefill_quant_wgmma": (_paged.LAUNCHES,
                                            "prefill_quant_wgmma"),
    "paged_attention_decode_cluster": (_paged.LAUNCHES, "decode_cluster"),
    "paged_attention_decode_quant_cluster": (_paged.LAUNCHES,
                                             "decode_quant_cluster"),
    "step_score": (_score.LAUNCHES, "step_score"),
    "flash_attention": (_flash.LAUNCHES, "flash"),
    "flash_attention_wgmma": (_flash.LAUNCHES, "flash_wgmma"),
    "flash_attention_tile": (_flash.LAUNCHES, "flash_tile"),
    "flash_attention_f32_tc": (_flash.LAUNCHES, "flash_f32_tc"),
    "ssd_scan": (_ssd.LAUNCHES, "ssd_scan"),
    "ssd_scan_wgmma": (_ssd.LAUNCHES, "ssd_scan_wgmma"),
    "ssd_scan_tile": (_ssd.LAUNCHES, "ssd_scan_tile"),
    "ssm_decode": (_ssm.LAUNCHES, "ssm_decode"),
    "add_rms_norm": (_glue.LAUNCHES, "add_rms_norm"),
    "attn_prologue": (_glue.LAUNCHES, "attn_prologue"),
    "silu_mul": (_glue.LAUNCHES, "silu_mul"),
}
# decode-horizon graphs (serving/cuda_graph.py): captures, and replays,
# each of which adds its capture's kernel launches to the counts above
GRAPHS = {"decode_graph_replays": 0, "decode_graph_captures": 0}


def step_score_params(hidden, params: dict):
    """Scorer params dict -> fused scorer call."""
    return step_score(hidden, params["w1"], params["b1"], params["w2"],
                      params["b2"])


def _check_heads(tp, q, k_pool, head_dim: int) -> None:
    """A rank's query heads and its pool's kv heads must be its share of
    the whole: ``tp.model_n`` of them make the config's heads."""
    H, KVH = q.shape[head_dim], k_pool.shape[2]
    if not (tp.heads_aligned and H * tp.model_n == tp.num_heads
            and KVH * tp.model_n == tp.num_kv_heads):
        raise ValueError(
            f"the sharded paged attention takes a rank's share of "
            f"{tp.num_heads} query heads over {tp.num_kv_heads} on a "
            f"'model' axis of {tp.model_n}: got {H} over {KVH}")


def paged_attention_sharded(tp, q, k_pool, v_pool, block_tables, cache_lens,
                            *, scale: float, k_scale=None, v_scale=None):
    """Mesh decode (the JAX package's ``shard_map`` over "data" lanes and
    "model" kv heads), on one rank: q [B/data, H/model, hd] holds the
    rank's lanes and heads, the pools (and scales) its kv heads of every
    block; ``block_tables`` [B, bp] and ``cache_lens`` [B] cover the whole
    batch, and the rank takes its lanes' rows. Each (lane, kv head) cell
    of the kernel is independent, so the rank's call computes exactly its
    slice of the single-device call, with no collective. Launches count
    as :func:`paged_attention`'s."""
    _check_heads(tp, q, k_pool, 1)
    lanes = tp.lanes(block_tables.shape[0])
    if q.shape[0] != lanes.stop - lanes.start:
        raise ValueError(f"q holds {q.shape[0]} lanes; this rank's share of "
                         f"{block_tables.shape[0]} is "
                         f"{lanes.stop - lanes.start}")
    return paged_attention(q, k_pool, v_pool, block_tables[lanes],
                           cache_lens[lanes], scale=scale, k_scale=k_scale,
                           v_scale=v_scale)


def paged_attention_prefill_sharded(tp, q, k_pool, v_pool, block_tables,
                                    prefix_lens, num_valid, own_k, own_v, *,
                                    scale: float, window=None, k_scale=None,
                                    v_scale=None):
    """Mesh chunked prefill, on one rank. A chunk job is one prompt (batch
    1), which every "data" rank runs whole; q [1, C, H/model, hd] and the
    own K/V [1, C, KVH/model, hd] hold the rank's heads, the pools its kv
    heads. Launches count as :func:`paged_attention_prefill`'s."""
    _check_heads(tp, q, k_pool, 2)
    if own_k.shape[2] != k_pool.shape[2]:
        raise ValueError(f"the chunk's own K/V hold {own_k.shape[2]} kv "
                         f"heads, the pool {k_pool.shape[2]}")
    return paged_attention_prefill(q, k_pool, v_pool, block_tables,
                                   prefix_lens, num_valid, own_k, own_v,
                                   scale=scale, window=window,
                                   k_scale=k_scale, v_scale=v_scale)


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
