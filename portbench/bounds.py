"""The yardstick's table of peaks and the counts that the metrics share.

Peaks are the published figures of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense, no sparsity): 989 TFLOP/s in bf16, 3.35 TB/s of HBM3. A
share of a peak is stated against them, with the card's power limit
beside it in ``PERF.md``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2          # bytes
F32 = 4


def matmul_params_per_token(cfg: dict) -> int:
    """Weights one token multiplies through: every layer's projections,
    its feed-forward (an MoE: the router and the experts it is routed
    to) and the output head over the vocabulary."""
    D, H, KVH, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                     cfg["head_dim"])
    attn = D * (H + 2 * KVH) * hd + H * hd * D
    if cfg.get("num_experts"):
        ffn = (D * cfg["num_experts"]
               + cfg["num_experts_per_tok"] * 3 * D * cfg["moe_d_ff"])
    else:
        ffn = 3 * D * cfg["d_ff"]
    return cfg["num_layers"] * (attn + ffn) + D * cfg["vocab_size"]


def model_flops(cfg: dict, tokens: int, ctx: int) -> float:
    """Operations of ``tokens`` tokens whose attended lengths sum to
    ``ctx``: two per weight multiplied, and per layer four per
    (query head, head dim, attended slot) for the scores and the
    weighted sum."""
    attn = 4 * cfg["num_layers"] * cfg["num_heads"] * cfg["head_dim"] * ctx
    return 2.0 * matmul_params_per_token(cfg) * tokens + attn


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile, linear between closest ranks (numpy's
    default); ``None`` for no samples."""
    xs = sorted(xs)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def kernel_seconds(profile: dict, pattern) -> float:
    """Device seconds of the profiled stretch's operations whose name
    matches ``pattern`` (a compiled regular expression)."""
    return sum(d for name, d in profile["ops"] if pattern.search(name))
